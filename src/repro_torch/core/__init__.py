"""PageANN core, ported to PyTorch: the counterpart of ``repro.core``."""
from repro_torch.core.config import (
    FilterParams,
    MemoryBudget,
    MemoryMode,
    PageANNConfig,
    SearchParams,
)
from repro_torch.core.filter import FilterExpr, MetadataSchema, Num, Tag
from repro_torch.core.index import BuildStats, PageANNIndex, recall_at_k
from repro_torch.core.persist import IndexFormatError, index_from_arrays, load_pageann
from repro_torch.core.stream import PageFetcher

__all__ = [
    "BuildStats",
    "FilterExpr",
    "FilterParams",
    "IndexFormatError",
    "MemoryBudget",
    "MemoryMode",
    "MetadataSchema",
    "Num",
    "PageANNConfig",
    "PageANNIndex",
    "PageFetcher",
    "SearchParams",
    "Tag",
    "index_from_arrays",
    "load_pageann",
    "recall_at_k",
]
