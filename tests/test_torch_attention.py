"""The port's pair-scan attention and M-RoPE (``repro_torch.models.layers``)
against the reference's (``repro.models.layers``) on the CPU.

Inputs come from numpy seeds and go through both packages, held at
rtol = atol = 1e-5 (the frameworks reduce in different orders). The
reference's ``tests/test_attention.py::test_pairscan_matches_naive`` runs
over the port at its own tolerances; its gradient test waits for training
(ROADMAP A13c).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import layers as jl
from repro_torch.configs.registry import get_arch
from repro_torch.models import layers as tl

# six test workers share the host's cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _qkv(B, Tq, Tk, H, KvH, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Tk, KvH, hd)).astype(np.float32),
            rng.standard_normal((B, Tk, KvH, hd)).astype(np.float32))


PAIR_CASES = {
    # name: (Tq, Tk, H, KvH, causal, window, q_chunk, kv_chunk, q_offset)
    "causal": (48, 48, 4, 2, True, 0, 16, 16, 0),
    "window": (48, 48, 4, 2, True, 9, 16, 16, 0),
    "ragged-chunks": (33, 33, 4, 1, True, 0, 8, 16, 0),
    "window-kv-chunk": (40, 40, 4, 4, True, 6, 8, 4, 0),
    "bidirectional": (12, 20, 4, 1, False, 0, 8, 8, 0),
    "offset": (8, 24, 4, 2, True, 0, 4, 8, 16),
}


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pairscan_attention_equals_reference(case):
    Tq, Tk, H, KvH, causal, window, qc, kc, off = PAIR_CASES[case]
    q, k, v = _qkv(2, Tq, Tk, H, KvH, 8, seed=len(case))
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc,
              q_offset=off)
    got = tl.pairscan_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = jl.pairscan_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert tuple(got.shape) == (2, Tq, H, 8)
    _close(got, want)
    # the same numbers as the masked blockwise loop
    _close(got, tl.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                       **kw))


def naive_attention(q, k, v, causal, window=0):
    """``tests/test_attention.py``'s dense softmax reference, in numpy."""
    B, Tq, H, hd = q.shape
    Tk, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    kk, vv = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(hd)
    qpos, kpos = np.arange(Tq)[:, None], np.arange(Tk)[None, :]
    mask = np.ones((Tq, Tk), bool)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = np.where(mask[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


@pytest.mark.parametrize("window", [0, 9])
def test_pairscan_matches_naive(window):
    """``test_attention.py::test_pairscan_matches_naive`` over the port."""
    q, k, v = _qkv(2, 48, 48, 4, 2, 8, seed=3)
    out = tl.pairscan_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=True, window=window, q_chunk=16,
                                kv_chunk=16)
    want = naive_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("sections,theta", [((2, 3, 3), 10000.0),
                                            ((16, 24, 24), 1e6)])
def test_apply_mrope_equals_reference(sections, theta):
    hd = 2 * sum(sections)
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 4, hd)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (3, 2, 7)).astype(np.int32)
    got = tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                         sections, theta)
    _close(got, jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections,
                               theta))


def test_mrope_with_equal_streams_is_rope():
    """Three equal position streams rotate every section alike: RoPE."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 5, 4, 16)).astype(np.float32))
    pos = torch.as_tensor(rng.integers(0, 100, (2, 5)), dtype=torch.int32)
    _close(tl.apply_mrope(x, pos[None].expand(3, 2, 5), (2, 3, 3)),
           tl.apply_rope(x, pos))


@pytest.mark.parametrize("with_positions3", [True, False],
                         ids=["mrope", "rope-fallback"])
def test_attention_qkv_mrope_branch_equals_reference(with_positions3):
    """``attention_qkv`` takes M-RoPE when the config has it and positions3
    is given, RoPE otherwise (``repro/models/layers.py:320-326``)."""
    cfg = get_arch("qwen2-vl-72b", smoke=True)
    jcfg = jget_arch("qwen2-vl-72b", smoke=True)
    d, H, KvH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, 16
    rng = np.random.default_rng(6)
    p = {"wq": (d, H, hd), "wk": (d, KvH, hd), "wv": (d, KvH, hd),
         "bq": (H, hd), "bk": (KvH, hd), "bv": (KvH, hd)}
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.2
         for n, s in p.items()}
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32)[None], (2, 1))
    pos3 = rng.integers(0, 30, (3, 2, 6)).astype(np.int32) \
        if with_positions3 else None
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tpos3 = None if pos3 is None else torch.from_numpy(pos3)
    got = tl.attention_qkv(tp, torch.from_numpy(x), cfg,
                           torch.from_numpy(pos), tpos3)
    want = jl.attention_qkv({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jcfg, jnp.asarray(pos),
                            None if pos3 is None else jnp.asarray(pos3))
    for g, w in zip(got, want):
        _close(g, w)
    # a config without mrope rotates by ``positions`` whatever positions3 is
    plain = dataclasses.replace(cfg, mrope=False)
    rope = tl.attention_qkv(tp, torch.from_numpy(x), cfg,
                            torch.from_numpy(pos), None)[0]
    _close(tl.attention_qkv(tp, torch.from_numpy(x), plain,
                            torch.from_numpy(pos),
                            torch.from_numpy(pos[None].repeat(3, 0) + 5))[0],
           rope)
