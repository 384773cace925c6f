"""The optimizers of ``repro.optim`` in PyTorch, updating in place."""
from repro_torch.optim.adafactor import Adafactor, AdafactorState, make_optimizer
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm

__all__ = [
    "Adafactor", "AdafactorState", "AdamW", "AdamWState",
    "global_norm", "make_optimizer",
]
