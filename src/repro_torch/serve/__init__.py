"""Serving, ported to PyTorch: the counterpart of ``repro.serve``.

A request-batching engine in front of any of the port's indexes (PageANN,
DiskANN, Starling, ``MutableIndex``), a multi-collection service with
database persistence and an optional semantic cache, and a stdlib HTTP
frontend with admission control. Host-side Python over the indexes'
searches, which run on the card.
"""
from repro_torch.serve.compile_cache import CompileCache, CompileCacheStats
from repro_torch.serve.engine import (
    DEFAULT_COLLECTION,
    BatchingEngine,
    EngineMetrics,
    RequestResult,
)
from repro_torch.serve.http import HttpFrontend, TokenBucket
from repro_torch.serve.semantic_cache import CacheStats, SemanticCache
from repro_torch.serve.service import CollectionHandle, VectorService

__all__ = [
    "BatchingEngine",
    "CacheStats",
    "CollectionHandle",
    "CompileCache",
    "CompileCacheStats",
    "DEFAULT_COLLECTION",
    "EngineMetrics",
    "HttpFrontend",
    "RequestResult",
    "SemanticCache",
    "TokenBucket",
    "VectorService",
]
