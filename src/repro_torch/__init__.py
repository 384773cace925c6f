"""PageANN in PyTorch for one NVIDIA H100: the port of ``src/repro``.

``repro_torch`` imports torch and numpy only — never jax and nothing of the
``repro`` package — so a GPU host needs no JAX. Module names mirror
``src/repro`` one for one (``repro_torch.core.search`` is the counterpart of
``repro.core.search``). Entry points take ``device=`` and default to
``"cuda"``; with no GPU present they raise instead of quietly running on
the CPU. The hot-path kernels are hand-written CUDA C++ for ``sm_90a``
(``repro_torch.kernels``), each with a plain PyTorch version that CPU
tensors dispatch to.
"""
