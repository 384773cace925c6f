"""PageANN core, ported to PyTorch: the counterpart of ``repro.core``."""
from repro_torch.core.config import (
    AdaptiveParams,
    DeltaParams,
    FilterParams,
    MemoryBudget,
    MemoryMode,
    PageANNConfig,
    SearchParams,
)
from repro_torch.core.baselines import (
    DiskANNIndex,
    StarlingIndex,
    load_baseline,
)
from repro_torch.core.delta import DeltaTier, MutableIndex
from repro_torch.core.filter import FilterExpr, MetadataSchema, Num, Tag
from repro_torch.core.index import BuildStats, PageANNIndex, recall_at_k
from repro_torch.core.persist import (
    IndexFormatError,
    index_from_arrays,
    load_database,
    load_index,
    load_pageann,
    save_database,
)
from repro_torch.core.protocol import MutableVectorIndex, VectorIndex
from repro_torch.core.search import HopProfile, profile_search
from repro_torch.core.stream import PageFetcher

__all__ = [
    "AdaptiveParams",
    "BuildStats",
    "DeltaParams",
    "DeltaTier",
    "DiskANNIndex",
    "FilterExpr",
    "FilterParams",
    "HopProfile",
    "IndexFormatError",
    "MemoryBudget",
    "MemoryMode",
    "MetadataSchema",
    "MutableIndex",
    "MutableVectorIndex",
    "Num",
    "PageANNConfig",
    "PageANNIndex",
    "PageFetcher",
    "SearchParams",
    "StarlingIndex",
    "Tag",
    "VectorIndex",
    "index_from_arrays",
    "load_baseline",
    "load_database",
    "load_index",
    "load_pageann",
    "profile_search",
    "recall_at_k",
    "save_database",
]
