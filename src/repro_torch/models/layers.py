"""Shared transformer layers, dense subset: RMSNorm, RoPE, blockwise
(flash-style) GQA attention, decode attention, gated MLP, and their inits.

Port of ``repro.models.layers``. Parameters are mappings of tensors keyed
by the reference's leaf names (a plain dict, or the ``nn.ParameterDict``s
of ``models.transformer``), so each function reads as the reference's. None
of these is a Pallas kernel in the reference (XLA fuses them), so they stay
plain PyTorch: einsums and matrix products in full float32 (TF32 is off on
the card, ``device.resolve_device``). The attention computes the
reference's chunked online softmax itself; no library attention is called.
``apply_mrope`` and ``pairscan_attention`` come with the other model
families (ROADMAP A13b).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rms_norm(x, scale, eps=1e-6):
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


# ------------------------------------------------------------------- RoPE ---
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x, positions, theta=10000.0):
    """x: (B, T, H, hd); positions: (B, T) int32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs     # (B, T, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention ---
def blockwise_attention(
    q, k, v, *, causal: bool, window: int = 0,
    q_chunk: int = 512, kv_chunk: int = 1024, q_offset: int = 0,
    fwd_only: bool = False,
):
    """Flash-style online-softmax attention with GQA and optional local
    window: the reference's chunk loop, q chunk by q chunk and, inside, kv
    chunk by kv chunk, with its masks, its exact zeros for masked scores and
    its padding of both T dims to chunk multiples. Memory is O(q_chunk x
    kv_chunk) per step instead of O(T^2).

    q: (B, Tq, H, hd); k, v: (B, Tk, KvH, hd). Returns (B, Tq, H, hd).
    Causal masking assumes q positions are ``q_offset + [0, Tq)`` against
    k positions ``[0, Tk)``. ``fwd_only`` (with ``causal``) skips the kv
    chunks that are entirely masked for a q chunk, as the reference's
    forward-only path does; masked contributions are exact zeros either way.
    """
    B, Tq, H, hd = q.shape
    Tk, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    q_chunk = min(q_chunk, Tq)
    kv_chunk = min(kv_chunk, Tk)
    # pad T dims to chunk multiples
    pq = -Tq % q_chunk
    pk = -Tk % kv_chunk
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    Tqp, Tkp = Tq + pq, Tk + pk
    nq, nk = Tqp // q_chunk, Tkp // kv_chunk
    dev = q.device

    scale = hd ** -0.5
    qr = (q * scale).reshape(B, Tqp, KvH, G, hd).permute(0, 2, 3, 1, 4)
    kr = k.permute(0, 2, 1, 3)            # (B, KvH, Tkp, hd)
    vr = v.permute(0, 2, 1, 3)

    blocks = []
    for iq in range(nq):
        qi = qr[:, :, :, iq * q_chunk:(iq + 1) * q_chunk]
        qpos = q_offset + iq * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KvH, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KvH, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KvH, G, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        lo, hi = 0, nk
        if causal and fwd_only:
            hi_pos = q_offset + (iq + 1) * q_chunk
            hi = min((hi_pos + kv_chunk - 1) // kv_chunk, nk)
            if window:
                lo_pos = q_offset + iq * q_chunk - (window - 1)
                lo = max(max(lo_pos, 0) // kv_chunk, 0)
        for ik in range(lo, hi):
            kj = kr[:, :, ik * kv_chunk:(ik + 1) * kv_chunk]
            vj = vr[:, :, ik * kv_chunk:(ik + 1) * kv_chunk]
            s = torch.einsum("bkgqh,bkch->bkgqc", qi.to(torch.float32),
                             kj.to(torch.float32))
            kpos = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = (kpos[None, :] < Tk).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            new_m = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - new_m[..., None])
            p = torch.where(s <= NEG_INF / 2, 0.0, p)
            corr = torch.exp(m - new_m)
            corr = torch.where(m <= NEG_INF / 2, 0.0, corr)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkch->bkgqh", p, vj.to(torch.float32))
            m = new_m
        blocks.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(blocks, 0)                # (nq, B, KvH, G, qc, hd)
    out = out.permute(1, 2, 3, 0, 4, 5).reshape(B, KvH, G, Tqp, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tqp, H, hd)
    return out[:, :Tq].to(q.dtype)


def decode_attention(q1, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-token attention against a KV cache.

    q1: (B, H, hd); caches: (B, S, KvH, hd) (bfloat16 in the serving cache,
    upcast to float32 for both products, as the reference's einsums promote
    them); cache_len: an int or a (B,) tensor of valid lengths (the new
    token's position is cache_len - 1 after append).
    """
    B, H, hd = q1.shape
    S, KvH = k_cache.shape[1], k_cache.shape[2]
    G = H // KvH
    scale = hd ** -0.5
    qr = (q1 * scale).reshape(B, KvH, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qr.to(torch.float32),
                     k_cache.to(torch.float32))
    pos = torch.arange(S, device=q1.device)
    cl = torch.as_tensor(cache_len, device=q1.device).reshape(-1, 1)
    mask = pos[None, :] < cl                          # (B or 1, S)
    if window:
        mask = mask & (pos[None, :] >= cl - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(torch.float32))
    return out.reshape(B, H, hd).to(q1.dtype)


# ------------------------------------------------------------------- MLP ---
def gated_mlp(params, x):
    """SwiGLU MLP. x: (..., d)."""
    h = torch.nn.functional.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ------------------------------------------------------------------ inits ---
def dense_init(generator: torch.Generator, shape, in_axis=0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal draws scaled by fan_in ** -0.5, drawn with ``generator`` on
    its own device and placed on ``device``."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else 1
    std = fan_in ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * std
    return w.to(device=device, dtype=dtype)


def init_attention(generator, cfg, dtype, device=None) -> dict:
    d, H, KvH = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(generator, (d, H, hd), 0, dtype, device),
        "wk": dense_init(generator, (d, KvH, hd), 0, dtype, device),
        "wv": dense_init(generator, (d, KvH, hd), 0, dtype, device),
        "wo": dense_init(generator, (H, hd, d), 0, dtype, device)
        / (2 * cfg.num_layers) ** 0.5,
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KvH, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KvH, hd), dtype=dtype, device=device)
    return p


def init_mlp(generator, d, ff, dtype, num_layers=1, device=None) -> dict:
    return {
        "w_gate": dense_init(generator, (d, ff), 0, dtype, device),
        "w_up": dense_init(generator, (d, ff), 0, dtype, device),
        "w_down": dense_init(generator, (ff, d), 0, dtype, device)
        / (2 * num_layers) ** 0.5,
    }


def attention_qkv(params, x, cfg, positions=None):
    """Project + rotate. Returns q (B,T,H,hd), k, v (B,T,KvH,hd)."""
    q = torch.einsum("btd,dhx->bthx", x, params["wq"])
    k = torch.einsum("btd,dhx->bthx", x, params["wk"])
    v = torch.einsum("btd,dhx->bthx", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_out(params, attn):
    return torch.einsum("bthx,hxd->btd", attn, params["wo"])
