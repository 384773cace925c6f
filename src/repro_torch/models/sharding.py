"""Sharding rules: logical axes -> mesh axes, ``repro.models.sharding`` in
PyTorch.

Logical axes used by param/activation annotations:
  'fsdp'   — parameter sharding axis (ZeRO-3); maps to 'data' (+'pod' for
             the >=400B archs on the multi-pod mesh)
  'tp'     — tensor-parallel axis: heads / ff / experts / vocab -> 'model'
  'dp'     — batch axis: ('pod','data') when the mesh has a pod axis
  'sp'     — sequence axis (long-context decode state) -> 'data'

The specs are the reference's, entry for entry (``PARAM_RULES`` word
for word, ``fix_spec``'s reassignment included), in the port's own
:class:`PartitionSpec` tuple. Where the reference puts a ``NamedSharding``
on a leaf, the port makes the leaf a ``torch.distributed.tensor.DTensor``:
a spec entry ``a`` on tensor dim ``i`` becomes ``Shard(i)`` on mesh dim
``a``, a tuple such as ``("pod", "data")`` ``Shard(i)`` on each of its mesh
dims, and an absent entry ``Replicate()`` (``placements``). DTensor's
sharding propagation then plays the part of XLA's partitioner.

``Rules`` takes either the port's search :class:`~repro_torch.launch.mesh.Mesh`
(one host process over a grid of devices) or a
``torch.distributed.DeviceMesh`` (one process per rank). Specs need only
the axis names and sizes; placements need a ``DeviceMesh``: for a
one-device ``Mesh`` ``Rules.device_mesh`` opens a world of size 1 where no
process group exists (NCCL on ``cuda``, gloo on ``cpu``) and builds the
``(1, 1)`` mesh over it.

In the port's parameter tree a layer stack is a :class:`~repro_torch.tree.Stack`
of per-layer tensors: ``param_specs`` gives the stacked leaf the
reference's spec (leading ``None`` included), and ``layer_spec`` drops that
entry for each per-layer tensor.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import tree as T

REPLICATE_KV_NAMES = frozenset({"wk", "wv", "bk", "bv"})


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name or a tuple of them
    (the reference's ``jax.sharding.PartitionSpec`` as a plain tuple)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


P = PartitionSpec


def mesh_sizes(mesh) -> dict:
    """Axis name -> size for a port ``Mesh`` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


_OPENED = []   # the world-1 group world_device_mesh opened, if any


def world_device_mesh(mesh):
    """The ``DeviceMesh`` over the default process group for a one-device
    port ``Mesh``, opening a world of size 1 if no group exists
    (``release_world`` closes it)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = mesh.flat[0]
    if mesh.distinct_devices != 1:
        raise ValueError(
            f"a {mesh.dims} mesh over {mesh.distinct_devices} devices in one "
            "process has no DeviceMesh: run one process per rank (torchrun) "
            "and pass a DeviceMesh")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
        _OPENED.append(dist.group.WORLD)
    if dist.get_world_size() != 1:
        raise ValueError(
            f"a one-device mesh in a world of {dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, mesh.dims,
                            mesh_dim_names=tuple(mesh.axis_names))


def release_world() -> None:
    """Destroy the world-1 group that ``world_device_mesh`` opened (a
    group opened elsewhere stays)."""
    import torch.distributed as dist

    if _OPENED and dist.is_initialized():
        dist.destroy_process_group()
    _OPENED.clear()


class Rules:
    def __init__(self, mesh, fsdp_over_pod: bool = False,
                 replicate_kv: bool = False):
        # names whose misfit axes are dropped (replicated) instead of being
        # moved to another dim (avoids row-parallel KV all-reduces)
        self.no_reassign = REPLICATE_KV_NAMES if replicate_kv else frozenset()
        self._device_mesh = mesh if _is_device_mesh(mesh) else None
        self._init_axes(mesh, fsdp_over_pod)

    def _init_axes(self, mesh, fsdp_over_pod: bool):
        names = mesh_axis_names(mesh)
        self.has_pod = "pod" in names
        self.dp = ("pod", "data") if self.has_pod else ("data",)
        self.fsdp = (
            ("pod", "data") if (self.has_pod and fsdp_over_pod) else ("data",)
        )
        self.tp = "model"
        self.sp = "data"
        self.mesh = mesh

    @property
    def sizes(self) -> dict:
        return mesh_sizes(self.mesh)

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` the placements live on (built on first use)."""
        if self._device_mesh is None:
            self._device_mesh = world_device_mesh(self.mesh)
        return self._device_mesh

    def spec(self, *logical) -> P:
        out = []
        for ax in logical:
            if ax is None:
                out.append(None)
            elif ax == "fsdp":
                if not self.fsdp:          # ZeRO-1 mode: params not sharded
                    out.append(None)
                else:
                    out.append(
                        self.fsdp if len(self.fsdp) > 1 else self.fsdp[0]
                    )
            elif ax == "dp":
                out.append(self.dp if len(self.dp) > 1 else self.dp[0])
            elif ax == "tp":
                out.append(self.tp)
            elif ax == "sp":
                out.append(self.sp)
            else:
                raise ValueError(f"unknown logical axis {ax}")
        return P(*out)

    def placements(self, spec) -> tuple:
        return placements(spec, self.device_mesh)

    def shard(self, x, *logical):
        """``x`` laid out as ``spec(*logical)`` (the reference's
        ``with_sharding_constraint``): a DTensor is redistributed, a plain
        tensor (the same global value on every rank) distributed."""
        return to_layout(x, self.device_mesh, self.placements(
            self.spec(*logical)))


# ---------------------------------------------------------------- param rules
# Param-name suffix -> logical axes for its trailing dims. When a param is
# scan-stacked it has a leading layer dim, padded with None automatically.
PARAM_RULES: dict[str, tuple] = {
    "embed": ("tp", "fsdp"),          # (V, d)
    "unembed": ("fsdp", "tp"),        # (d, V)
    "pos_embed": (None, "fsdp"),      # (T, d)
    "in_proj_frontend": (None, "fsdp"),
    "wq": ("fsdp", "tp", None),       # (d, H, hd)
    "wk": ("fsdp", "tp", None),       # (d, KvH, hd)
    "wv": ("fsdp", "tp", None),
    "wo": ("tp", None, "fsdp"),       # (H, hd, d)
    "bq": ("tp", None),               # (H, hd)
    "bk": ("tp", None),
    "bv": ("tp", None),
    "w_gate": ("fsdp", "tp"),         # (d, ff)
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),         # (ff, d)
    "router": ("fsdp", "tp"),         # (d, E)
    "we_gate": ("tp", "fsdp", None),  # (E, d, ff) — experts over 'model'
    "we_up": ("tp", "fsdp", None),
    "we_down": ("tp", None, "fsdp"),  # (E, ff, d)
    "scale": (None,),                 # norms
    "scale2": (None,),
    "scale3": (None,),
    "scale4": (None,),
    # ssm (mamba2)
    "ssm_in": ("fsdp", "tp"),         # (d, 2*din + 2*n + heads)
    "ssm_out": ("tp", "fsdp"),        # (din, d)
    "conv_w": (None, "tp"),           # (width, din + 2n)
    "conv_b": ("tp",),
    "A_log": ("tp",),                 # (heads,)
    "D": ("tp",),
    "dt_bias": ("tp",),
    "ssm_norm": ("tp",),
    # rg-lru (recurrentgemma)
    "rg_in": ("fsdp", "tp"),          # (d, 2w)
    "rg_out": ("tp", "fsdp"),         # (w, d)
    "rg_conv_w": (None, "tp"),
    "rg_conv_b": ("tp",),
    "rg_a_param": ("tp",),            # (w,)
    "rg_gate_in": ("fsdp", "tp"),     # (d, 2w) input+recurrence gates... (w,2)
    "rg_wa": ("tp",),                 # (w,) gates
    "rg_wx": ("tp",),
}


def fix_spec(spec, shape, mesh, reassign: bool = True) -> P:
    """Make a PartitionSpec legal for ``shape``: every dim's sharded size
    must divide the dim. Axes that don't fit are moved to the rightmost
    other dim where they do (e.g. vocab 49155 can't split 16-way, so the
    'model' axis moves to the d_model dim), else dropped (replicated)."""
    sizes = mesh_sizes(mesh)
    entries: list[tuple] = []
    for e in tuple(spec) + (None,) * (len(shape) - len(tuple(spec))):
        if e is None:
            entries.append(())
        elif isinstance(e, (tuple, list)):
            entries.append(tuple(e))
        else:
            entries.append((e,))

    def factor(axes):
        f = 1
        for a in axes:
            f *= sizes[a]
        return f

    # only dims the rule already shards may receive reassigned axes: never
    # spill onto a scan/layer dim or head_dim
    candidates = [i for i, e in enumerate(entries) if e] if reassign else []
    dropped: list[str] = []
    for i, dim in enumerate(shape):
        keep: list[str] = []
        for a in entries[i]:
            if dim % (factor(keep) * sizes[a]) == 0:
                keep.append(a)
            else:
                dropped.append(a)
        entries[i] = tuple(keep)
    for a in dropped:
        # left-to-right: prefer moving a misfit axis onto a leading (d_model
        # / row) dim — row-parallel layouts keep downstream reshapes shardable.
        for i in candidates:
            if a in entries[i]:
                continue
            if shape[i] % (factor(entries[i]) * sizes[a]) == 0:
                entries[i] = entries[i] + (a,)
                break
        # unplaced axes are simply dropped (replicated)
    out = tuple(
        None if not e else (e[0] if len(e) == 1 else e) for e in entries
    )
    return P(*out)


def leaf_name(path: tuple) -> str | None:
    """The last string key of a tree path (the reference's leaf name)."""
    for key in reversed(path):
        if isinstance(key, str) and not key.isdigit():
            return key
    return None


def param_specs(params, rules: Rules):
    """A PartitionSpec tree matching ``params`` (a model or its
    ``param_tree``) by leaf name; a :class:`~repro_torch.tree.Stack` gets
    the stacked leaf's spec."""
    if hasattr(params, "param_tree"):
        params = params.param_tree()
    paths = {id(leaf): path for path, leaf in T.flatten(params)}

    def leaf_spec(leaf):
        path = paths[id(leaf)]
        name = leaf_name(path)
        if name not in PARAM_RULES:
            raise KeyError(f"no sharding rule for param '{name}' ({path})")
        logical = PARAM_RULES[name]
        shape = tuple(leaf.shape)
        ndim = len(shape)
        pad = ndim - len(logical)
        assert pad >= 0, f"{name}: rule longer than rank {ndim}"
        spec = rules.spec(*((None,) * pad + tuple(logical)))
        return fix_spec(spec, shape, rules.mesh,
                        reassign=name not in rules.no_reassign)

    return T.map(leaf_spec, params)


def layer_spec(spec, stacked: bool) -> P:
    """The spec of one layer's tensor of a stacked leaf (its leading
    layer entry, always None, dropped)."""
    if not stacked:
        return spec
    assert spec[0] is None, spec
    return P(*spec[1:])


# ---------------------------------------------------------------- placements
def placements(spec, device_mesh) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(i)`` on
    each mesh dim that spec entry ``i`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, e in enumerate(tuple(spec)):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            j = names.index(a)
            if not isinstance(out[j], Replicate):
                raise ValueError(f"mesh axis {a!r} used twice in {spec}")
            out[j] = Shard(i)
    return tuple(out)


def shard_range(size: int, device_mesh, placements_, dim: int) -> tuple:
    """(start, length) of this rank's block of a tensor dim of ``size``
    sharded as ``placements_`` (each mesh dim that shards ``dim`` splits
    the block before it as ``torch.chunk`` splits, as DTensor does)."""
    from torch.distributed.tensor import Shard

    coord = device_mesh.get_coordinate()
    start, length = 0, size
    for j, pl in enumerate(placements_):
        if isinstance(pl, Shard) and pl.dim == dim:
            step = -(-length // device_mesh.size(j))
            offset = min(coord[j] * step, length)
            start, length = start + offset, min(step, length - offset)
    return start, length


def local_chunk(t: torch.Tensor, device_mesh, placements_) -> torch.Tensor:
    """This rank's shard of the global tensor ``t`` (a view)."""
    from torch.distributed.tensor import Shard

    for dim in sorted({p.dim for p in placements_ if isinstance(p, Shard)}):
        start, length = shard_range(t.shape[dim], device_mesh, placements_,
                                    dim)
        t = t.narrow(dim, start, length)
    return t


@contextlib.contextmanager
def implicit_replication():
    """While active, a plain tensor met beside a DTensor counts as
    replicated (DTensor's ``experimental.implicit_replication``, but
    re-entrant: leaving restores the setting it found, so a nested use
    does not switch it off for the enclosing one)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= n
    return tuple(reversed(out))


def to_layout(x, device_mesh, placements_):
    """``x`` as a DTensor with ``placements_``: a DTensor is redistributed,
    a plain tensor (the same global value on every rank) cut locally, with
    no communication."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        if tuple(x.placements) == tuple(placements_):
            return x
        return x.redistribute(device_mesh, placements_)
    local = local_chunk(x, device_mesh, placements_)
    if local.numel() < x.numel():   # do not keep the whole alive
        local = local.contiguous() if not local.is_contiguous() else \
            local.clone()
    return DTensor.from_local(local, device_mesh, placements_,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def on_local(fn, mesh, args, out_placements):
    """``fn`` run on each device's own blocks (what GSPMD does for an op
    that is independent along its sharded dims). ``args``: a
    ``(dtensor, placements, grad_placements)`` triple (the input laid out
    as ``placements``, its local gradient read as ``grad_placements``) or
    a plain value passed as it is. Each output of ``fn`` (a tensor or a
    tuple) becomes a DTensor with its ``out_placements`` entry (evenly
    sharded); a partial output's gradient comes back replicated."""
    from torch.distributed.tensor import DTensor, Shard

    local = []
    for a in args:
        if isinstance(a, tuple) and len(a) == 3 and isinstance(a[0], DTensor):
            t, pl, gpl = a
            if tuple(t.placements) != tuple(pl):
                t = t.redistribute(mesh, tuple(pl))
            local.append(t.to_local(grad_placements=tuple(gpl)))
        else:
            local.append(a)
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    res = []
    for o, pl in zip((outs,) if single else outs, out_placements):
        shape = list(o.shape)
        for j, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(j)
        res.append(DTensor.from_local(
            o.contiguous(), mesh, tuple(pl), run_check=False,
            shape=torch.Size(shape), stride=contiguous_stride(shape)))
    return res[0] if single else tuple(res)


def split_layout(x, size: int):
    """(batch mesh dims, channel mesh dims) of DTensor ``x``: the mesh
    dims that shard its dim 0, and the others, in mesh order, as long as
    their sizes still divide ``size`` (the channels an op is independent
    along)."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    batch = [j for j, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == 0]
    chan, f = [], 1
    for j in range(mesh.ndim):
        if j not in batch and size % (f * mesh.size(j)) == 0:
            chan.append(j)
            f *= mesh.size(j)
    return batch, chan


def layout_of(ndim_mesh: int, dims: dict, partial=()) -> tuple:
    """Placements with ``Shard(dims[j])`` on mesh dim ``j``, ``Partial``
    on the mesh dims in ``partial``, ``Replicate`` elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple(Shard(dims[j]) if j in dims else
                 Partial() if j in partial else Replicate()
                 for j in range(ndim_mesh))


def param_shardings(params, rules: Rules):
    """The placements tree of ``params`` on ``rules.device_mesh``: a
    :class:`~repro_torch.tree.Stack` leaf gets one layer's placements."""
    if hasattr(params, "param_tree"):
        params = params.param_tree()
    it = iter(spec for _, spec in spec_leaves(param_specs(params, rules)))
    return T.map(lambda leaf: rules.placements(
        layer_spec(next(it), isinstance(leaf, T.Stack))), params)


def spec_leaves(specs, prefix: tuple = ()) -> list:
    """(path, spec) pairs of a spec tree (dicts, NamedTuples) in the order
    ``repro_torch.tree.flatten`` gives the tree it describes; a spec is one
    leaf."""
    if specs is None:
        return []
    if isinstance(specs, PartitionSpec):
        return [(prefix, specs)]
    if isinstance(specs, dict):
        out = []
        for k in sorted(specs):
            out += spec_leaves(specs[k], prefix + (str(k),))
        return out
    if hasattr(specs, "_fields"):
        out = []
        for f in specs._fields:
            out += spec_leaves(getattr(specs, f), prefix + (f,))
        return out
    raise TypeError(f"not a spec tree: {type(specs)}")
