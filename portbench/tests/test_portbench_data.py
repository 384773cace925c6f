"""The generators draw the same inputs from the same seeds, and a mix's
file gives every seed the same amount of work."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import data
from portbench.tests import cells


def test_batch_seed_is_stable_distinct_and_takes_large_seeds():
    big = 2**31 + 12345
    assert data.batch_seed(big, 3) == data.batch_seed(big, 3)
    seeds = {data.batch_seed(s, i) for s in (0, 1, big) for i in range(50)}
    assert len(seeds) == 150
    assert all(0 <= s < 2**63 for s in seeds)


def model(seed=7):
    return data.Mixture(8, clusters=4, rank=2, scale=0.25, noise=0.05,
                        seed=seed, device="cpu")


def test_collection_and_queries_come_back_from_their_seeds():
    x = model().collection(500)
    assert x.shape == (500, 8) and x.dtype == torch.float32
    assert torch.equal(x, model().collection(500))
    assert not torch.equal(x, model(8).collection(500))
    s = data.batch_seed(2**31 + 1, 5)
    q = model().queries(64, s)
    assert torch.equal(q, model().queries(64, s))
    assert not torch.equal(q, model().queries(64, data.batch_seed(2**31 + 1,
                                                                  6)))
    # chunked draws give the same rows as one draw would
    big = model().queries(data.CHUNK + 10, s)
    assert torch.equal(big, model().queries(data.CHUNK + 10, s))


def test_each_cluster_spreads_over_its_own_low_rank_subspace():
    m = data.Mixture(16, clusters=1, rank=3, scale=0.5, noise=0.0, seed=3,
                     device="cpu")
    x = m.collection(400) - m.centres[0]
    sv = torch.linalg.svdvals(x)
    assert sv[2] > 1.0 and sv[3] < 1e-3 * sv[0]
    noisy = data.Mixture(16, clusters=1, rank=3, scale=0.5, noise=0.05,
                         seed=3, device="cpu")
    sv = torch.linalg.svdvals(noisy.collection(400) - noisy.centres[0])
    assert sv[3] > 0.01 * sv[0] and sv[3] < 0.2 * sv[0]


@pytest.mark.parametrize("mix", sorted(
    (cells.REPO / "portbench" / "traffic").glob("*.json")),
    ids=lambda p: p.stem)
def test_every_mix_names_a_loop_and_gives_each_seed_the_same_work(mix):
    spec = json.loads(mix.read_text())
    a = data.Traffic(spec, seed=1)
    b = data.Traffic(spec, seed=2**31 + 9)
    assert (cells.REPO / "portbench" / "loops" / f"{a.loop}.py").is_file()
    assert (a.loop, a.batch, a.k, a.trace_batches) == \
        (b.loop, b.batch, b.k, b.trace_batches)
    assert a.seed != b.seed
