"""granite-3-2b's full width cut to 2 layers, the same weights on the card
and on the CPU: how far the decode logits lie apart with the serving
cache's bfloat16 k and v, and with a float32 cache (the cache dtype is
swapped here only, for the diagnosis; the port's cache stays bfloat16).

    PYTHONPATH=src python3 tools/lm_cut_card_vs_cpu.py   # needs one card

Prints one JSON line per cache dtype: the largest logit difference of each
of 16 teacher-forced steps, the share of cache k elements that differ
between the two devices, and the logits' largest magnitude.
"""
from __future__ import annotations

import copy
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf

STEPS = 16


def main() -> None:
    dev = resolve_device("cuda")
    cut = dataclasses.replace(get_arch("granite-3-2b"), num_layers=2)
    cpu = tf.init_params(cut, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cut.vocab_size, (2, STEPS)), dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        caches = []
        for d in ("cpu", dev):
            c = tf.init_cache(cut, 2, STEPS, device=d)["layers"]
            caches.append({"layers": {k: v.to(dtype) for k, v in c.items()}})
        worst, scale = [], 0.0
        for t in range(STEPS):
            want, _ = tf.decode_step(cpu, caches[0], toks[:, t], t, cut)
            got, _ = tf.decode_step(card, caches[1], toks[:, t].to(dev), t, cut)
            want = want[:, :cut.vocab_size]
            worst.append(float((got.cpu()[:, :cut.vocab_size] - want)
                               .abs().max()))
            scale = max(scale, float(want.abs().max()))
        k_cpu = caches[0]["layers"]["k"].float()
        k_card = caches[1]["layers"]["k"].float().cpu()
        print(json.dumps({
            "cache": str(dtype).removeprefix("torch."),
            "max_logit_diff_per_step": worst,
            "k_elements_differing": float((k_cpu != k_card).float().mean()),
            "logit_scale": scale,
            "device": torch.cuda.get_device_name(dev),
        }), flush=True)


if __name__ == "__main__":
    main()
