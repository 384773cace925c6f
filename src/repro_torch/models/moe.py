"""Token-choice top-k MoE with capacity-bounded dispatch: the counterpart of
``repro.models.moe``.

The reference dispatches per dp shard so that GSPMD can partition the
scatter and pins the activations' shardings (``context.act_shard``). The
port does the same: with no rules there is one shard; with rules
installed (``forward_train(rules=)``) the tokens are laid out over dp, each
rank routes and scatters its own shard's tokens on local tensors (the
reference's per-shard capacity, ``current_dp_size`` shards), the shards'
buffers form one (E, S*C, d) DTensor that is laid out experts-over-'model'
for the expert products (the EP all-to-all), and the products come back to
their shard for the combine. It keeps the reference's sort/rank dispatch,
capacity drops and dense batched product over every expert (all E
experts' capacity slots are computed, even the empty ones). Three places
are held to the reference's order:

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

from repro_torch.models.context import current_dp_size, current_rules
from repro_torch.models.layers import dense, dense_init, silu
from repro_torch.models.sharding import contiguous_stride, to_layout


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


def _dispatch(xt, probs, cfg, c: int):
    """One shard's routing: (buf (E, C, d), route) for its tokens ``xt``
    (ns, d) and router ``probs`` (ns, E)."""
    n, d = xt.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    dev = xt.device
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
    return buf[:-1].reshape(e, c, d), (slot, keep, flat_p)


def _combine(back, route, cfg, c: int, n: int):
    """One shard's combine: its expert outputs ``back`` (E*C, d) summed
    back onto its ``n`` tokens."""
    slot, keep, flat_p = route
    e, k = cfg.num_experts, cfg.experts_per_token
    d = back.shape[-1]
    safe_slot = torch.clamp(slot, max=e * c - 1)
    gathered = torch.where(keep[:, None], back[safe_slot], 0.0)
    weighted = (gathered * flat_p[:, None].to(back.dtype)).reshape(n, k, d)
    combined = torch.zeros((n, d), dtype=back.dtype, device=back.device)
    for j in range(k):               # assignment order, from zero
        combined = combined + weighted[:, j]
    return combined


def _experts(params, buf):
    """Expert FFNs: one batched product over the expert axis."""
    h = silu(torch.bmm(buf, params["we_gate"])) * \
        torch.bmm(buf, params["we_up"])
    return torch.bmm(h, params["we_down"])


def moe_layer(params, x, cfg):
    """x: (B, T, d) -> (B, T, d)."""
    b, t, d = x.shape
    e = cfg.num_experts
    n = b * t
    s = current_dp_size()
    if n % s != 0:
        s = 1
    ns = n // s                       # tokens per dp shard
    c = moe_capacity(ns, cfg)         # per-shard capacity

    xt = x.reshape(n, d)
    logits = dense(xt.to(torch.float32), params["router"])     # (N, E)
    probs = torch.softmax(logits, dim=-1)
    if not _is_dtensor(xt):
        buf, route = _dispatch(xt, probs, cfg, c)
        back = _experts(params, buf).reshape(e * c, d)          # (E*C, d)
        return _combine(back, route, cfg, c, n).reshape(b, t, d)

    # one shard a dp rank: route and scatter locally (without rules, as
    # in decoding, one shard replicated on every device)
    lay = _Layout(xt.device_mesh, s)
    xs = lay(xt, "dp", None).to_local()                         # (ns, d)
    ps = lay(probs, "dp", None).to_local()
    buf_l, route = _dispatch(xs, ps, cfg, c)                    # (E, C, d)
    # the shards' buffers as one (E, S*C, d): the EP token all-to-all
    buf = lay.from_local(buf_l[:, None], (None, "dp", None, None),
                         (e, s, c, d))
    buf = lay(buf.reshape(e, s * c, d), "tp", None, None)
    out = lay(_experts(params, buf), "tp", None, None)         # (E, S*C, d)
    # return all-to-all: each shard takes back its own capacity slots
    back = lay(out.reshape(e, s, c, d), None, "dp", None, None)
    back_l = back.to_local().reshape(e * c, d)
    combined = lay.from_local(_combine(back_l, route, cfg, c, ns),
                              ("dp", None), (n, d))
    combined = lay(combined, "dp", "tp")
    return combined.reshape(b, t, d)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


class _Layout:
    """Layouts of the sharded dispatch: the installed rules' logical axes
    (``act_shard``) with ``s`` dp shards, or, with one shard, every tensor
    replicated over ``mesh``."""

    def __init__(self, mesh, s: int):
        self.mesh, self.rules = mesh, current_rules() if s > 1 else None

    def placements(self, logical, shape):
        from torch.distributed.tensor import Replicate

        from repro_torch.models.sharding import fix_spec

        if self.rules is None:
            return (Replicate(),) * self.mesh.ndim
        return self.rules.placements(fix_spec(self.rules.spec(*logical),
                                              shape, self.rules.mesh))

    def __call__(self, t, *logical):
        return to_layout(t, self.mesh, self.placements(logical, t.shape))

    def from_local(self, local, logical, shape):
        """A DTensor of global ``shape`` from this device's ``local``
        block laid out as ``logical``."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            local, self.mesh, self.placements(logical, shape),
            run_check=False, shape=torch.Size(shape),
            stride=contiguous_stride(shape))


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
