"""How a window sends its work: one module per loop, named by a mix's
``loop`` key, each defining ``drive(system, inputs, traffic, seconds, *,
trace)``."""
