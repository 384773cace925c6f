"""serve_step / prefill builders: the serving half of ``repro.train.step``.

``make_serve_step`` returns the decode-one-token function; ``make_prefill``
the prompt forward that returns logits. Training (``init_train_state``,
``TrainState``, ``make_train_step`` and the optimizers) comes with ROADMAP
A13c. PyTorch runs eagerly, so the builders return plain closures where the
reference returns functions for ``jax.jit``.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf


def make_serve_step(cfg: ArchConfig):
    """decode one token: (model, cache, token, pos[, positions3])."""

    def serve_step(model, cache, token, pos, positions3=None):
        if positions3 is not None:
            raise NotImplementedError(
                "M-RoPE positions are not ported yet (ROADMAP A13b)")
        return tf.decode_step(model, cache, token, pos, cfg)

    return serve_step


def make_prefill(cfg: ArchConfig):
    def prefill_step(model, batch):
        logits, aux = tf.forward_train(model, batch, cfg)
        return logits

    return prefill_step
