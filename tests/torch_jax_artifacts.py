"""JAX-built artifacts shared by the port's stream and filter tests.

One index per MemoryMode, built by the JAX package with a metadata schema
(one tag field of three values, one uniform numeric field, as
``test_filter.py`` has them), warmed on the queries so ``page_order``
carries real access counts (what a memory-budgeted load pins by), and
saved. Building is the expensive part of those tests, so each mode is
built once per process and shared; callers must not modify the directory.
"""
from __future__ import annotations

import functools
import tempfile

import numpy as np

from repro.core import MemoryMode as JMode
from repro.core import MetadataSchema as JSchema
from repro.core import PageANNConfig as JConfig
from repro.core import PageANNIndex as JIndex
from repro.core import SearchParams as JParams
from repro.data.pipeline import clustered_vectors, query_vectors

N, D, Q = 1200, 32, 8
TAGS = ("lang",)
NUMERICS = ("score",)


def cfg_kwargs(mode_value: str) -> dict:
    return dict(dim=D, graph_degree=12, build_beam=24, pq_subspaces=8,
                lsh_sample=256, lsh_entries=8, beam_width=48, max_hops=48,
                memory_mode=mode_value)


@functools.cache
def dataset():
    """(x, q, metadata columns), all from fixed seeds."""
    x = clustered_vectors(N, D, num_clusters=16, seed=0)
    q = query_vectors(x, Q, seed=1)
    rng = np.random.default_rng(7)
    meta = {
        "lang": rng.choice(["en", "de", "fr"], N).tolist(),
        "score": rng.uniform(0.0, 1.0, N).tolist(),
    }
    return x, q, meta


_DIRS: list = []   # kept alive so the directories last as long as the cache


@functools.cache
def metadata_artifact(mode_value: str):
    """(JAX index, its saved directory) for one MemoryMode."""
    x, q, meta = dataset()
    kw = cfg_kwargs(mode_value)
    kw["memory_mode"] = JMode(mode_value)
    cfg = JConfig(**kw)
    index = JIndex.build(x, cfg, schema=JSchema(tags=TAGS, numerics=NUMERICS),
                         metadata=meta)
    index.warm_cache(np.asarray(q), params=JParams.from_config(cfg))
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_artifact_")
    _DIRS.append(tmp)
    directory = f"{tmp.name}/idx.{mode_value}"
    index.save(directory)
    return index, directory


# ------------------------------------------------------------ mutable index
# the size of tests/test_delta.py: a base of the first N_BASE of N_DELTA
# vectors, the rest inserted through the mutable index
N_DELTA, N_BASE = 1000, 800
DELTA_LANGS = ("en", "de", "fr")   # the base's tag values; inserts add "es"


@functools.cache
def delta_dataset():
    """(x, q, metadata columns) of the mutable-index tests. ``q`` is ten
    queries near data points plus three inserted vectors themselves (exact
    self-matches in the delta tier). Every fourth inserted row carries the
    tag value "es", which the base has never seen."""
    x = clustered_vectors(N_DELTA, D, num_clusters=16, seed=0)
    q = np.concatenate([query_vectors(x, 10, seed=1), x[[805, 930, 990]]])
    rng = np.random.default_rng(11)
    lang = rng.choice(DELTA_LANGS, N_DELTA).tolist()
    for i in range(N_BASE, N_DELTA, 4):
        lang[i] = "es"
    meta = {"lang": lang, "score": rng.uniform(0.0, 1.0, N_DELTA).tolist()}
    return x, q, meta


@functools.cache
def delta_base_artifact(mode_value: str):
    """(JAX base index over the first N_BASE vectors, its saved directory)
    for one MemoryMode, built with the metadata schema."""
    x, _, meta = delta_dataset()
    kw = cfg_kwargs(mode_value)
    kw["memory_mode"] = JMode(mode_value)
    index = JIndex.build(
        x[:N_BASE], JConfig(**kw),
        schema=JSchema(tags=TAGS, numerics=NUMERICS),
        metadata={f: col[:N_BASE] for f, col in meta.items()})
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_delta_")
    _DIRS.append(tmp)
    directory = f"{tmp.name}/base.{mode_value}"
    index.save(directory)
    return index, directory


# ------------------------------------------------------------------ serving
# the size of tests/test_serve_service.py: two same-geometry HYBRID indexes
# over two corpora of N_SERVE vectors
N_SERVE = 600


def serve_cfg_kwargs() -> dict:
    return dict(cfg_kwargs("hybrid"), memory_mode=JMode.HYBRID)


@functools.cache
def serve_artifacts():
    """(corpora (x_a, x_b), JAX indexes (a, b), their saved directories):
    the reference's serving fixtures, built once per process."""
    xs = (clustered_vectors(N_SERVE, D, num_clusters=16, seed=0),
          clustered_vectors(N_SERVE, D, num_clusters=16, seed=42))
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_serve_")
    _DIRS.append(tmp)
    indexes, dirs = [], []
    for name, x in zip("ab", xs):
        index = JIndex.build(x, JConfig(**serve_cfg_kwargs()))
        directory = f"{tmp.name}/idx.{name}"
        index.save(directory)
        indexes.append(index)
        dirs.append(directory)
    return xs, tuple(indexes), tuple(dirs)
