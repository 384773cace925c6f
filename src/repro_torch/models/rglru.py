"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): the
counterpart of ``repro.models.rglru``.

Recurrence (per channel):
  r_t = sigmoid(x_t . W_a + b_a)              (recurrence gate)
  i_t = sigmoid(x_t . W_x + b_x)              (input gate)
  a_t = exp(c * softplus(Lambda) * (-r_t))    (learned decay, c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill scan over T in log depth; decode is the O(1)
per-token update. The surrounding block is the Griffin recurrent block:
linear in -> temporal conv (width 4) -> RG-LRU -> gated linear out.

The reference scans with ``lax.associative_scan``, which torch lacks. The
port follows that function's recursion in torch ops (pairs combined, the
half-length scan, the even positions filled in) with the reference's
``combine``: log2(T) levels of elementwise passes over (B, T, w), so a
prefill costs a few launches a level instead of T, and the products are
grouped in the reference's tree.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense_init

_C = 8.0
_f32 = torch.float32


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_rglru(generator, cfg, dtype, device=None) -> dict:
    d = cfg.d_model
    w = cfg.rnn_width or d
    return {
        "rg_in": dense_init(generator, (d, 2 * w), 0, dtype, device),  # [x | gate]
        "rg_out": dense_init(generator, (w, d), 0, dtype, device)
        / (2 * cfg.num_layers) ** 0.5,
        "rg_conv_w": dense_init(generator, (cfg.conv_width, w), 0, dtype,
                                device),
        "rg_conv_b": torch.zeros((w,), dtype=dtype, device=device),
        # softplus^-1 of the decay targets
        "rg_a_param": torch.log(torch.expm1(torch.linspace(
            0.9, 0.999, w, dtype=_f32, device=device)) + 0.0),
        "rg_wa": dense_init(generator, (w, 1), 0, _f32, device)[:, 0],
        "rg_wx": dense_init(generator, (w, 1), 0, _f32, device)[:, 0],
    }


def _gates(params, x):
    """x: (..., w) -> (a_t, gated input). Diagonal gates (elementwise)."""
    xf = x.to(_f32)
    r = torch.sigmoid(xf * params["rg_wa"])
    i = torch.sigmoid(xf * params["rg_wx"])
    log_a = -_C * _softplus(params["rg_a_param"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, b1 * a2 + b2


def _scan(elems):
    """``lax.associative_scan(_combine, elems, axis=1)``, with its
    recursion: combine adjacent pairs, scan those, then fill in the even
    positions. The same tree of products as the reference's."""
    T = elems[0].shape[1]
    if T < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _scan(reduced)
    if T % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[:, 0] = e[:, 0]
        r[:, 2::2] = ev
        r[:, 1::2] = od
        out.append(r)
    return out


def rglru_scan(params, x, h0=None):
    """x: (B, T, w). Returns (y, h_T), h_T in float32."""
    a, gx = _gates(params, x)          # (B, T, w) each
    if h0 is not None:
        # fold the carried state in as a virtual timestep contribution
        gx = torch.cat([gx[:, :1] + a[:, :1] * h0[:, None], gx[:, 1:]], dim=1)
    _, Y = _scan((a, gx))
    return Y.to(x.dtype), Y[:, -1]


def rglru_step(params, x1, h):
    """One-token step. x1: (B, w); h: (B, w) float32."""
    a, gx = _gates(params, x1)
    h_new = a * h + gx
    return h_new.to(x1.dtype), h_new


def _conv(params, x, conv_state=None):
    w = params["rg_conv_w"]
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = conv_state
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i] for i in range(width))
    return out + params["rg_conv_b"], xp[:, -(width - 1):]


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation. Below float32 the
    reference's formula op by op, each rounded to ``x``'s dtype with its
    constants (as ``layers.silu`` does); float32 takes the fused kernel."""
    if x.dtype == torch.float32:
        return torch.nn.functional.gelu(x, approximate="tanh")

    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def recurrent_block(params, u, cfg, state=None):
    """Full Griffin recurrent block. u: (B, T, d). Returns (out, new_state)."""
    proj = u @ params["rg_in"]
    x, gate = torch.chunk(proj, 2, dim=-1)
    conv_state = None if state is None else state["conv"]
    h0 = None if state is None else state["h"]
    x, new_conv = _conv(params, x, conv_state)
    y, hT = rglru_scan(params, x, h0)
    y = y * _gelu(gate)
    return y @ params["rg_out"], {"conv": new_conv, "h": hT}


def recurrent_block_step(params, u1, cfg, state):
    """One-token step. u1: (B, d). The new state comes back as new tensors
    (the caller stores them)."""
    proj = u1 @ params["rg_in"]
    x1, gate = torch.chunk(proj, 2, dim=-1)
    conv = state["conv"]
    w = params["rg_conv_w"]
    xp = torch.cat([conv, x1[:, None, :].to(conv.dtype)], dim=1)
    xc = (xp * w[None]).sum(1) + params["rg_conv_b"]
    new_conv = xp[:, 1:]
    y, h = rglru_step(params, xc, state["h"])
    y = y * _gelu(gate)
    return y @ params["rg_out"], {"conv": new_conv, "h": h}
