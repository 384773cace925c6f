"""Input specs per (arch x shape): the counterpart of
``repro.models.frontend``. Stand-ins for every model input are tensors on
the ``meta`` device: the right shape and dtype, no storage.

Modality frontends are STUBS, as in the reference: ``[audio]`` supplies
precomputed frame embeddings (``FRONTEND_DIM`` wide), ``[vlm]`` M-RoPE
position triples (the dynamic-resolution encoding); both bypass the real
CNN/ViT towers.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.transformer import FRONTEND_DIM, init_cache


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(arch: ArchConfig, shape: ShapeConfig) -> dict:
    b, t = shape.global_batch, shape.seq_len
    specs: dict = {}
    if arch.embed_inputs:
        specs["tokens"] = _meta((b, t), torch.int32)
    else:
        specs["embeds"] = _meta((b, t, FRONTEND_DIM), torch.bfloat16)
    specs["labels"] = _meta((b, t), torch.int32)
    specs["positions"] = _meta((b, t), torch.int32)
    if arch.mrope:
        specs["positions3"] = _meta((3, b, t), torch.int32)
    return specs


def decode_input_specs(arch: ArchConfig, shape: ShapeConfig) -> dict:
    """serve_step inputs: one new token against a seq_len KV cache."""
    b = shape.global_batch
    specs: dict = {"token": _meta((b,), torch.int32),
                   "pos": _meta((), torch.int32)}
    if arch.mrope:
        specs["positions3"] = _meta((3, b, 1), torch.int32)
    return specs


def cache_specs(arch: ArchConfig, batch: int, max_len: int) -> dict:
    """The cache pytree of ``transformer.init_cache``, on the meta device."""
    return init_cache(arch, batch, max_len, device="meta")


def make_train_batch(arch: ArchConfig, b: int, t: int,
                     generator: torch.Generator) -> dict:
    """Concrete small batch for smoke tests, drawn from ``generator`` (on
    its own device)."""
    dev = generator.device
    batch: dict = {
        "labels": torch.randint(0, arch.vocab_size, (b, t),
                                generator=generator, device=dev,
                                dtype=torch.int32),
        "positions": torch.arange(t, dtype=torch.int32,
                                  device=dev)[None].expand(b, t),
    }
    if arch.embed_inputs:
        batch["tokens"] = torch.randint(0, arch.vocab_size, (b, t),
                                        generator=generator, device=dev,
                                        dtype=torch.int32)
    else:
        batch["embeds"] = torch.randn((b, t, FRONTEND_DIM),
                                      generator=generator,
                                      device=dev).to(torch.bfloat16)
    if arch.mrope:
        batch["positions3"] = torch.arange(
            t, dtype=torch.int32, device=dev)[None, None].expand(3, b, t)
    return batch
