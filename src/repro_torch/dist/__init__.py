"""Data-sharded scale-out: one collection's vectors partitioned over shards.

Port of ``repro.dist``. :mod:`repro_torch.core.distributed` holds the
device-level machinery (a shard on each mesh position, the gathered merge);
this package wraps it in the index lifecycle contract, so a sharded
collection plugs into ``BatchingEngine`` / ``VectorService`` / ``persist``
like a single :class:`~repro_torch.core.index.PageANNIndex`: build, search,
save as ``shard-<i>/`` artifacts under one ``kind="sharded"`` manifest,
reload through ``load_index``.
"""
from repro_torch.dist.sharded import ShardedPageStore, shard_params_for

__all__ = ["ShardedPageStore", "shard_params_for"]
