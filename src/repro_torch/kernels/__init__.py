"""Hot-path kernels of the port: CUDA C++ for sm_90a, plain PyTorch twins."""
