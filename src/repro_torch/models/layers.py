"""Shared transformer layers: RMSNorm, RoPE / M-RoPE, blockwise
(flash-style) and pair-scan GQA attention, decode attention, gated MLP, and
their inits.

Port of ``repro.models.layers``. Parameters are mappings of tensors keyed
by the reference's leaf names (a plain dict, or the ``nn.ParameterDict``s
of ``models.transformer``), so each function reads as the reference's. None
of these is a Pallas kernel in the reference (XLA fuses them), so they stay
plain PyTorch: einsums and matrix products in full float32 (TF32 is off on
the card, ``device.resolve_device``). The attention computes the
reference's chunked online softmax itself; no library attention is called.
Where the reference asks an einsum for a float32 result
(``preferred_element_type``) of bfloat16 operands, the port upcasts the
operands first: a product of two bfloat16 values is exact in float32.
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


def apply_mrope(x, positions3, sections, theta=10000.0):
    """Multimodal RoPE (Qwen2-VL): three position streams (t, h, w) rotate
    disjoint sections of the head dim. positions3: (3, B, T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    # a per-frequency position: the stream of the frequency's section
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])      # (hd/2,)
    pos = torch.as_tensor(positions3, device=x.device).to(torch.float32)
    pos_per_freq = pos[sec]                                 # (hd/2, B, T)
    ang = torch.movedim(pos_per_freq, 0, -1) * freqs        # (B, T, hd/2)
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
    ch = _Chunks(q, k, v, q_chunk, kv_chunk)
    blocks = []
    for iq in range(ch.nq):
        state = ch.empty()
        lo, hi = 0, ch.nk
        if causal and fwd_only:
            hi_pos = q_offset + (iq + 1) * ch.q_chunk
            hi = min((hi_pos + ch.kv_chunk - 1) // ch.kv_chunk, ch.nk)
            if window:
                lo_pos = q_offset + iq * ch.q_chunk - (window - 1)
                lo = max(max(lo_pos, 0) // ch.kv_chunk, 0)
        for ik in range(lo, hi):
            state = ch.step(state, iq, ik, causal=causal, window=window,
                            q_offset=q_offset)
        blocks.append(ch.finish(state))
    return ch.assemble(blocks, q.dtype)


class _Chunks:
    """The chunked online softmax shared by ``blockwise_attention`` and
    ``pairscan_attention``: both T dims padded to chunk multiples, q scaled
    and grouped per KV head, and one (q chunk, kv chunk) update of a q
    chunk's (m, l, acc) state with the reference's masks and exact zeros."""

    def __init__(self, q, k, v, q_chunk, kv_chunk):
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
        self.Tq, self.Tk, self.Tqp = Tq, Tk, Tq + pq
        self.nq, self.nk = self.Tqp // q_chunk, (Tk + pk) // kv_chunk
        self.q_chunk, self.kv_chunk = q_chunk, kv_chunk
        self.shape = (B, KvH, G, H, hd)
        self.dev = q.device
        scale = hd ** -0.5
        self.qr = (q * scale).reshape(B, self.Tqp, KvH, G, hd).permute(
            0, 2, 3, 1, 4)
        self.kr = k.permute(0, 2, 1, 3)       # (B, KvH, Tkp, hd)
        self.vr = v.permute(0, 2, 1, 3)

    def empty(self):
        B, KvH, G, _, hd = self.shape
        qc, f32, dev = self.q_chunk, torch.float32, self.dev
        return (torch.full((B, KvH, G, qc), NEG_INF, dtype=f32, device=dev),
                torch.zeros((B, KvH, G, qc), dtype=f32, device=dev),
                torch.zeros((B, KvH, G, qc, hd), dtype=f32, device=dev))

    def step(self, state, iq, ik, *, causal, window, q_offset):
        m, l, acc = state
        qc, kc, dev = self.q_chunk, self.kv_chunk, self.dev
        qi = self.qr[:, :, :, iq * qc:(iq + 1) * qc]
        kj = self.kr[:, :, ik * kc:(ik + 1) * kc]
        vj = self.vr[:, :, ik * kc:(ik + 1) * kc]
        s = torch.einsum("bkgqh,bkch->bkgqc", qi.to(torch.float32),
                         kj.to(torch.float32))
        qpos = q_offset + iq * qc + torch.arange(qc, device=dev)
        kpos = ik * kc + torch.arange(kc, device=dev)
        mask = (kpos[None, :] < self.Tk).expand(qc, kc)
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
        return new_m, l, acc

    @staticmethod
    def finish(state):
        _, l, acc = state
        return acc / torch.clamp(l, min=1e-30)[..., None]

    def assemble(self, blocks, dtype):
        B, KvH, G, H, hd = self.shape
        out = torch.stack(blocks, 0)            # (nq, B, KvH, G, qc, hd)
        out = out.permute(1, 2, 3, 0, 4, 5).reshape(B, KvH, G, self.Tqp, hd)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, self.Tqp, H, hd)
        return out[:, :self.Tq].to(dtype)


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


def pairscan_attention(
    q, k, v, *, causal: bool, window: int = 0,
    q_chunk: int = 512, kv_chunk: int = 1024, q_offset: int = 0,
):
    """Triangular pair-scan attention (the reference's ``attn_pairs``
    lever): the (iq, ik) chunk pairs that causality and the window leave
    are listed statically and walked in that order, each updating the
    online-softmax state of its q chunk. The reference's order of updates,
    masks and exact zeros, so the same numbers as ``blockwise_attention``.
    """
    ch = _Chunks(q, k, v, q_chunk, kv_chunk)
    pairs = []
    for iq in range(ch.nq):
        if causal:
            hi = min(-(-(q_offset + (iq + 1) * ch.q_chunk) // ch.kv_chunk),
                     ch.nk)
        else:
            hi = ch.nk
        lo = 0
        if window:
            lo = max(0, (q_offset + iq * ch.q_chunk - (window - 1))
                     // ch.kv_chunk)
        pairs.extend((iq, ik) for ik in range(lo, hi))
    states = [ch.empty() for _ in range(ch.nq)]
    for iq, ik in pairs:
        states[iq] = ch.step(states[iq], iq, ik, causal=causal,
                             window=window, q_offset=q_offset)
    return ch.assemble([ch.finish(st) for st in states], q.dtype)


# ------------------------------------------------------------------- MLP ---
def silu(x):
    """``jax.nn.silu``. In bfloat16 the reference's XLA program rounds each
    elementwise op of ``x * (1 / (1 + exp(-x)))`` to bfloat16, and so does
    this; torch's fused silu rounds once, and a greedy token of the
    bfloat16 decode (kimi-k2) flips on the difference. Float32 takes the
    fused kernel: there the two agree to rounding."""
    if x.dtype == torch.float32:
        return torch.nn.functional.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gated_mlp(params, x):
    """SwiGLU MLP. x: (..., d)."""
    h = silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ------------------------------------------------------------------ inits ---
def dense_init(generator: torch.Generator, shape, in_axis=0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal draws scaled by fan_in ** -0.5, drawn with ``generator`` on
    its own device and placed on ``device``."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else 1
    std = fan_in ** -0.5
    # scaled in place: a full-width expert stack is 18 GB in float32
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device).mul_(std)
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


def attention_qkv(params, x, cfg, positions=None, positions3=None):
    """Project + rotate (M-RoPE where the config has it and ``positions3``
    is given, else RoPE). Returns q (B,T,H,hd), k, v (B,T,KvH,hd)."""
    q = torch.einsum("btd,dhx->bthx", x, params["wq"])
    k = torch.einsum("btd,dhx->bthx", x, params["wk"])
    v = torch.einsum("btd,dhx->bthx", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.mrope and positions3 is not None:
        q = apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_out(params, attn):
    return torch.einsum("bthx,hxd->btd", attn, params["wo"])
