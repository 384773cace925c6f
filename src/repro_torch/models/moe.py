"""Token-choice top-k MoE with capacity-bounded dispatch: the counterpart of
``repro.models.moe``.

The reference dispatches per dp shard so that GSPMD can partition the
scatter and pins the activations' shardings (``context.act_shard``); on
one device there is one shard and nothing to pin, and the port keeps the
reference's sort/rank dispatch, capacity drops and dense batched product
over every expert (all E experts' capacity slots
are computed, even the empty ones). Three places are held to the
reference's order:

- top-k: ``lax.top_k`` breaks ties toward the lower expert; the port takes
  the first k of a stable descending sort (``torch.topk``'s tie order is
  unspecified);
- the dispatch scatter writes unique slots, apart from the dropped
  assignments, which all land in the discarded row ``E * C`` (kept, so
  that ``keep`` and the drops match);
- the combine adds a token's k weighted expert rows in assignment order,
  from zero, in a fixed loop over k (``index_add_`` on the card adds
  repeated indices atomically, in an order that changes from run to run).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init, silu


def init_moe(generator, cfg, dtype, device=None) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(generator, (d, e), 0, torch.float32, device),
        "we_gate": dense_init(generator, (e, d, ff), 1, dtype, device),
        "we_up": dense_init(generator, (e, d, ff), 1, dtype, device),
        # divided in place: a full-width expert stack is 18 GB in float32
        "we_down": dense_init(generator, (e, ff, d), 1, dtype, device)
        .div_((2 * cfg.num_layers) ** 0.5),
    }


def moe_capacity(tokens_per_shard: int, cfg) -> int:
    """Per-shard, per-expert capacity (8-padded for lane alignment)."""
    per = tokens_per_shard * cfg.experts_per_token / cfg.num_experts
    cap = int(per * cfg.moe_capacity_factor) + 1
    return max(8, -(-cap // 8) * 8)


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last axis, ties toward the
    lower index (a stable descending sort's first k)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_layer(params, x, cfg):
    """x: (B, T, d) -> (B, T, d)."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n = b * t
    c = moe_capacity(n, cfg)         # per-expert capacity, one shard
    dev = x.device

    xt = x.reshape(n, d)
    logits = xt.to(torch.float32) @ params["router"]            # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)                             # (N, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(n * k)
    flat_p = top_p.reshape(n * k)
    tok = torch.arange(n, device=dev).repeat_interleave(k)

    # rank of each assignment within its expert's segment
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev),
                                   side="left")                 # (E,)
    rank_sorted = torch.arange(n * k, device=dev) - seg_start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    keep = rank < c
    slot = torch.where(keep, flat_e * c + rank, e * c)          # (N*k,)

    buf = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=dev)
    buf.index_add_(0, slot, xt[tok])      # kept slots are unique
    buf = buf[:-1].reshape(e, c, d)

    # expert FFNs: one batched product over the expert axis
    h = silu(torch.bmm(buf, params["we_gate"])) * \
        torch.bmm(buf, params["we_up"])
    back = torch.bmm(h, params["we_down"]).reshape(e * c, d)   # (E*C, d)

    safe_slot = torch.clamp(slot, max=e * c - 1)
    gathered = torch.where(keep[:, None], back[safe_slot], 0.0)
    weighted = (gathered * flat_p[:, None].to(xt.dtype)).reshape(n, k, d)
    combined = torch.zeros((n, d), dtype=xt.dtype, device=dev)
    for j in range(k):               # assignment order, from zero
        combined = combined + weighted[:, j]
    return combined.reshape(b, t, d)


def moe_aux_loss(params, x, cfg):
    """Load-balancing auxiliary loss (Switch-style): E * sum(f_i * p_i)."""
    b, t, d = x.shape
    xt = x.reshape(b * t, d)
    logits = xt.to(torch.float32) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_e = torch.argmax(probs, dim=-1)
    f = torch.nn.functional.one_hot(top_e, cfg.num_experts).to(
        torch.float32).mean(dim=0)
    p = probs.mean(dim=0)
    return cfg.num_experts * torch.sum(f * p)
