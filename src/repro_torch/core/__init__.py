"""PageANN core, ported to PyTorch: the counterpart of ``repro.core``."""
from repro_torch.core.config import (
    MemoryMode,
    PageANNConfig,
    SearchParams,
)
from repro_torch.core.index import BuildStats, PageANNIndex, recall_at_k
from repro_torch.core.persist import IndexFormatError, index_from_arrays, load_pageann

__all__ = [
    "BuildStats",
    "IndexFormatError",
    "MemoryMode",
    "PageANNConfig",
    "PageANNIndex",
    "SearchParams",
    "index_from_arrays",
    "load_pageann",
    "recall_at_k",
]
