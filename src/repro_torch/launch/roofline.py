"""Roofline terms of a traced step: ``repro.launch.roofline`` in PyTorch.

Three terms per (arch x shape x mesh), in seconds:

  compute    = flops_per_device / PEAK_FLOPS_BF16
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / ICI_BW

The reference reads XLA's ``cost_analysis`` of the partitioned program and
parses its HLO text for collectives. The port traces one step eagerly on
DTensors (``launch.dryrun``) under ``TraceCounter``, a dispatch mode that
sees the local ops DTensor runs on this rank's shards (a DTensor-level op
is handed on to DTensor; the ops of DTensor's own sharding propagation are
skipped): ``flops`` are ``torch.utils.flop_counter``'s formulas over the
local ops, ``bytes`` each local op's inputs read once and outputs written
once (no fusion, as XLA's unfused "bytes accessed"), and the collectives
the output bytes of every functional collective (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``) under the
reference's kind names. The constants are an H100 SXM's data sheet
(``launch.mesh``): these are roofline estimates, not measurements.

The analytic byte and operation counts of the six search kernels live here
too (``*_counts``, ``kernel_bound``), so that the chip smoke's bounds and
``launch.dryrun_pageann``'s loop-body terms use one count.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

_COLL_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)
_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}
# views and metadata: no bytes move
_NO_BYTES = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "select", "slice", "unsqueeze", "squeeze", "as_strided", "alias",
    "detach", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "unflatten", "flatten", "diagonal", "view_as", "lift_fresh", "empty",
    "empty_like", "empty_strided", "wait_tensor",
})


@contextlib.contextmanager
def quiet_propagation():
    """DTensor derives each op's output shape by running the op on
    global-shape fake tensors under the active fake mode, where the
    counters (and ``MemTracker``) would take them for this rank's work.
    While this is active that derivation runs with every dispatch mode
    set aside (in a fake mode of its own)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        yield
        return
    orig = getattr(ShardingPropagator, name)

    def quiet(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)

    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class TraceCounter(TorchDispatchMode):
    """Per-device flops, bytes and collectives of the local ops run while
    it is active (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in _COLL_KINDS}
        self.coll_counts = {k: 0 for k in _COLL_KINDS}
        self.op_counts: dict = {}
        self._fake = None

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._guards import active_fake_mode
        from torch.utils.flop_counter import flop_registry

        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake:
            return out   # a fake mode of DTensor's own, not a local op
        packet = func.overloadpacket
        name = packet.__name__
        self.op_counts[name] = self.op_counts.get(name, 0) + 1
        kind = _FUNCOL.get(name) if "c10d" in str(packet) else None
        if kind is not None:
            self.coll[kind] += _nbytes(out)
            self.coll_counts[kind] += 1
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        out_bytes = _nbytes(out)
        if name not in _NO_BYTES and out_bytes:
            self.bytes += _nbytes((args, kwargs)) + out_bytes
        return out

    def collective_bytes(self) -> dict:
        """Per-kind byte totals + op counts (the reference's layout)."""
        out = dict(self.coll)
        out["total"] = sum(self.coll.values())
        out["counts"] = dict(self.coll_counts)
        return out

    def counters(self) -> dict:
        return {"hlo_flops": float(self.flops), "hlo_bytes": float(self.bytes),
                "collective_bytes": float(sum(self.coll.values()))}


def cost_terms(counter: TraceCounter) -> dict:
    """The three roofline terms (seconds) + raw counters."""
    coll = counter.collective_bytes()
    terms = terms_from_counters(counter.counters())
    terms["collective_breakdown"] = {k: coll[k] for k in _COLL_KINDS}
    terms["collective_counts"] = coll["counts"]
    return terms


def terms_from_counters(counters: dict) -> dict:
    """Roofline terms from (possibly calibrated) raw counters."""
    flops = counters["hlo_flops"]
    byts = counters["hlo_bytes"]
    coll = counters["collective_bytes"]
    terms = {
        "hlo_flops": flops,
        "hlo_bytes": byts,
        "collective_bytes": coll,
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": byts / HBM_BW,
        "collective_s": coll / ICI_BW,
    }
    dom = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k]
    )
    terms["bottleneck"] = dom.replace("_s", "")
    return terms


def memory_stats(tracker) -> dict:
    """Peak bytes per device from a ``MemTracker`` that watched the step
    (the state it tracked as external included)."""
    peak = tracker.get_tracker_snapshot("peak")
    per_dev = {str(dev): int(snap.get("Total", 0))
               for dev, snap in peak.items()}
    out = {"peak_by_device": per_dev}
    if per_dev:
        out["peak_bytes_per_device"] = max(per_dev.values())
    return out


def model_flops(arch, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active params), 2*N per
    generated token for decode."""
    n = arch.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


# ------------------------------------------- the search kernels' counts
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def kernel_bound(bytes_: int, ops_: int) -> dict:
    """The least time the card could take: bytes moved over the memory
    rate or operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = bytes_ / HBM_BW, ops_ / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_, operations=ops_)


def page_scan_counts(nq: int, b: int, *, records: int, cap: int, dim: int,
                     rp: int, m: int, k: int = 0, adc: bool,
                     staged: bool = False, masked: bool = False) -> tuple:
    """(bytes, operations) of one page scan over ``nq`` queries x ``b``
    pages: each record's members (cap x dim floats) and, with ADC, the rp
    columns of its ``m`` code rows, once per distinct page read by id
    (``records``) or once per staged record; the ids, queries, the LUT
    (nq, m, k), the mask and the outputs once."""
    used_m = m if adc else 0
    bytes_ = (records * (cap * dim + used_m * rp) * 4
              + (0 if staged else nq * b * 4)
              + nq * dim * 4 + (nq * m * k * 4 if adc else 0)
              + (nq * b * cap * 4 if masked else 0)
              + nq * b * (cap + (rp if adc else 0)) * 4)
    return bytes_, nq * b * (cap * dim * 3 + rp * used_m)


def pq_adc_counts(nq: int, n: int, m: int, k: int) -> tuple:
    """``pq_adc`` on pre-gathered (nq, n, m) uint8 codes."""
    return n * nq * m + nq * m * k * 4 + nq * n * 4, nq * n * m


def pq_lut_counts(nq: int, m: int, k: int, dsub: int) -> tuple:
    """``pq_lut``: the queries, the codebooks and the (nq, m, k) tables
    once; a subtract, a multiply and an add a coordinate."""
    return (nq * m * dsub + m * k * dsub + nq * m * k) * 4, 3 * nq * m * k * dsub


def pq_adc_gather_counts(nq: int, n: int, m: int, k: int, *, rows: int,
                         id_bytes: int = 4) -> tuple:
    """``pq_adc_gather``: each query's table, each id, each distinct code
    row (``rows``) and the output once."""
    return (nq * m * k * 4 + nq * n * id_bytes + rows * m + nq * n * 4,
            nq * n * m)


def hamming_counts(nq: int, s: int, w: int) -> tuple:
    """The distances alone: codes, query codes, the (nq, s) output."""
    return s * w * 4 + nq * w * 4 + nq * s * 4, nq * s * w * 3


def hamming_topk_counts(nq: int, s: int, w: int, t: int) -> tuple:
    """The sweep and its stable top-t: codes, query codes and the (nq, t)
    values and indices once."""
    return s * w * 4 + nq * w * 4 + 2 * nq * t * 4, nq * s * w * 3


def l2_counts(nq: int, n: int, d: int, keep: bool = False) -> tuple:
    """Both inputs (and the keep mask) read once, the (nq, n) output
    written once; the product's 2 nq n d flops, the norms' 2 (nq + n) d
    and the epilogue's 3 nq n."""
    return ((nq * d + n * d + nq * n) * 4 + (n if keep else 0),
            2 * nq * n * d + 2 * (nq + n) * d + 3 * nq * n)


def page_gather_counts(nq: int, b: int, cap: int, d: int, *,
                       distinct: int) -> tuple:
    """Each distinct page's members, the ids, the queries and the (nq, b,
    cap) output once."""
    return (distinct * cap * d * 4 + nq * b * 4 + nq * d * 4
            + nq * b * cap * 4, nq * b * cap * d * 3)
