"""Mamba-2 (SSD, state-space duality) layer: the counterpart of
``repro.models.ssm``. A chunked scan for training and prefill, an O(1)
recurrent state for decode; the "minimal SSD" formulation of
arXiv:2405.21060 §6 with multi-head x and one shared (B, C) group.

Shapes: d_inner = expand * d_model; heads = d_inner / head_dim; state = N.
The reference's ``lax.scan`` over chunks is a Python loop over chunks
here, with the same padding, within-chunk ``cumsum`` and float32
accumulations (the reference's ``preferred_element_type``: bfloat16
operands are upcast first, which is exact).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init, silu

_f32 = torch.float32


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_ssm(generator, cfg, dtype, device=None) -> dict:
    d = cfg.d_model
    din = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    conv_dim = din + 2 * n
    return {
        # in_proj packs [z (din) | x (din) | B (n) | C (n) | dt (h)]
        "ssm_in": dense_init(generator, (d, 2 * din + 2 * n + h), 0, dtype,
                             device),
        "ssm_out": dense_init(generator, (din, d), 0, dtype, device)
        / (2 * cfg.num_layers) ** 0.5,
        "conv_w": dense_init(generator, (cfg.conv_width, conv_dim), 0, dtype,
                             device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=_f32,
                                          device=device)),
        "D": torch.ones((h,), dtype=_f32, device=device),
        "dt_bias": torch.zeros((h,), dtype=_f32, device=device),
        "ssm_norm": torch.ones((din,), dtype=dtype, device=device),
    }


def _split_proj(params, u, cfg):
    din, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = u @ params["ssm_in"]
    return (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * n],
            zxbcdt[..., 2 * din + 2 * n:])


def _causal_conv(params, xbc, conv_state=None):
    """Depthwise causal conv over time. xbc: (B, T, conv_dim)."""
    w = params["conv_w"]                        # (W, conv_dim)
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], width - 1, xbc.shape[-1]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state                        # (B, W-1, conv_dim)
    xp = torch.cat([pad, xbc], dim=1)           # (B, T+W-1, conv_dim)
    T = xbc.shape[1]
    out = sum(xp[:, i:i + T] * w[i] for i in range(width)) + params["conv_b"]
    new_state = xp[:, -(width - 1):]
    return silu(out), new_state


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD chunked scan.

    x: (b, T, h, p); dt: (b, T, h); A: (h,) negative decay rates;
    B, C: (b, T, n). Returns y: (b, T, h, p), final_state: (b, h, p, n).
    """
    b, T, h, p = x.shape
    n = B.shape[-1]
    pad = -T % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // chunk
    xs = x.reshape(b, nc, chunk, h, p)
    dts = dt.reshape(b, nc, chunk, h)
    Bs = B.reshape(b, nc, chunk, n)
    Cs = C.reshape(b, nc, chunk, n)

    dA = dts * A[None, None, None, :]            # (b, nc, Q, h)  (negative)
    cum = torch.cumsum(dA, dim=2)                # within-chunk cumulative
    iota = torch.arange(chunk, device=x.device)
    causal = iota[:, None] >= iota[None, :]

    state = torch.zeros((b, h, p, n), dtype=_f32, device=x.device)
    ys = []
    for ci in range(nc):
        xs_c, dts_c = xs[:, ci], dts[:, ci]
        Bs_c, Cs_c, cum_c = Bs[:, ci], Cs[:, ci], cum[:, ci]
        # intra-chunk (quadratic): L[i,j] = exp(cum_i - cum_j) for i >= j
        li = cum_c[:, :, None, :] - cum_c[:, None, :, :]      # (b, Q, Q, h)
        L = torch.where(causal[None, :, :, None], torch.exp(li), 0.0)
        G = torch.einsum("bqn,bkn->bqk", Cs_c, Bs_c)           # (b, Q, Q)
        M = G[..., None] * L                                   # (b, Q, Q, h)
        y_intra = torch.einsum(
            "bqkh,bkh,bkhp->bqhp", M.to(_f32), dts_c.to(_f32),
            xs_c.to(_f32))
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum(
            "bqn,bhpn,bqh->bqhp", Cs_c.to(_f32), state,
            torch.exp(cum_c).to(_f32))
        # state update: decay the full chunk, add its outer products
        decay_chunk = torch.exp(cum_c[:, -1])                  # (b, h)
        w = torch.exp(cum_c[:, -1:, :] - cum_c)                # (b, Q, h)
        state = state * decay_chunk[:, :, None, None] + torch.einsum(
            "bqh,bqn,bqhp->bhpn", (w * dts_c).to(_f32), Bs_c.to(_f32),
            xs_c.to(_f32))
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(b, Tp, h, p)[:, :T]
    return y, state


def _gated_norm(params, y, z):
    y = y * silu(z)
    return y * torch.rsqrt(
        y.to(_f32).square().mean(dim=-1, keepdim=True) + 1e-6
    ).to(y.dtype) * params["ssm_norm"]


def ssm_forward(params, u, cfg, state=None):
    """Full mamba2 mixer. u: (B, T, d_model).

    state: None (train/prefill from scratch) or a dict with 'conv' and
    'ssd' for streaming prefill. Returns (out, new_state)."""
    din, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(params, u, cfg)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(params, xbc, conv_state)
    x, B, C = xbc[..., :din], xbc[..., din:din + n], xbc[..., din + n:]
    bsz, T = u.shape[0], u.shape[1]
    x = x.reshape(bsz, T, h, p)
    dt = _softplus(dt.to(_f32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, ssd_state = ssd_chunked(x, dt, A, B, C, cfg.ssm_chunk)
    y = y + x * params["D"][None, None, :, None]
    y = _gated_norm(params, y.reshape(bsz, T, din), z)
    return y @ params["ssm_out"], {"conv": new_conv, "ssd": ssd_state}


def ssm_decode_step(params, u1, cfg, state):
    """One-token recurrent step. u1: (B, d_model); state from prefill. The
    new state comes back as new tensors (the caller stores them)."""
    din, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(params, u1[:, None, :], cfg)
    z, xbc, dt = z[:, 0], xbc[:, 0], dt[:, 0]
    # conv ring update
    conv = state["conv"]                         # (B, W-1, conv_dim)
    w = params["conv_w"]
    xp = torch.cat([conv, xbc[:, None, :].to(conv.dtype)], dim=1)
    out = (xp * w[None]).sum(1) + params["conv_b"]
    xbc1 = silu(out)
    new_conv = xp[:, 1:]
    x, B, C = xbc1[..., :din], xbc1[..., din:din + n], xbc1[..., din + n:]
    x = x.reshape(-1, h, p)
    dt1 = _softplus(dt.to(_f32) + params["dt_bias"])          # (B, h)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt1 * A[None, :])             # (B, h)
    s = state["ssd"]                             # (B, h, p, n)
    s = s * dA[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt1.to(_f32), B.to(_f32), x.to(_f32))
    y = torch.einsum("bn,bhpn->bhp", C.to(_f32), s)
    y = y + x * params["D"][None, :, None]
    y = _gated_norm(params, y.reshape(-1, din).to(u1.dtype), z)
    return y @ params["ssm_out"], {"conv": new_conv, "ssd": s}
