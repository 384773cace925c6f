"""The port's adaptive search against the JAX package's: query-sensitive
entry selection, per-query early termination, autotune and tuned artifacts.

A JAX index built with a metadata schema in each MemoryMode
(``torch_jax_artifacts``) is saved and loaded by the port, and both search
the same 32 seeded queries with the same ``AdaptiveParams``. ids, ios, hops
and cache hits must be equal and distances within rtol = atol = 1e-5,
except for a query whose LSH code differs between the frameworks (a
projection within rounding of zero flips a sign bit and changes the entry
set): such queries are reported by index and exempt. Within the port, the
reference's invariants hold bit for bit: an all-default ``AdaptiveParams()``
is the plain search, and a streamed adaptive search equals the resident one.
Autotune's latency side is measured, so only its recall side is compared.
"""
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MutableIndex as JMutable
from repro.core import Num as JNum
from repro.core import SearchParams as JParams
from repro.core import load_index as jax_load_index
from repro.core import lsh as jlsh
from repro.data.pipeline import query_vectors
from repro_torch.core import (
    AdaptiveParams,
    MemoryMode,
    MutableIndex,
    Num,
    SearchParams,
    load_index,
    load_pageann,
    persist,
    recall_at_k,
)
from repro_torch.core import lsh as tlsh
from repro_torch.core.vamana import brute_force_knn
from torch_jax_artifacts import (
    N_BASE,
    dataset,
    delta_base_artifact,
    delta_dataset,
    metadata_artifact,
)

# six test workers share the host's cores; the port's small searches gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

K = 10
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("ids", "dists", "ios", "hops", "cache_hits")
MODES = [m.value for m in MemoryMode]
EPS = 0.05      # about 3% of the fixture's worst top-10 distance

# AdaptiveParams knobs: early termination (patience, epsilon), entry
# selection (entry_slack_bits, min_entries), and both together
CASES = {
    "p1": dict(patience=1),
    "p2": dict(patience=2),
    "p4": dict(patience=4),
    "p1-eps": dict(patience=1, epsilon=EPS),
    "p2-eps": dict(patience=2, epsilon=EPS),
    "p4-eps": dict(patience=4, epsilon=EPS),
    "slack0-min1": dict(entry_slack_bits=0, min_entries=1),
    "slack0-min4": dict(entry_slack_bits=0, min_entries=4),
    "slack2-min1": dict(entry_slack_bits=2, min_entries=1),
    "slack2-min4": dict(entry_slack_bits=2, min_entries=4),
    "p2-slack2-min4": dict(patience=2, entry_slack_bits=2, min_entries=4),
}


@functools.cache
def queries() -> np.ndarray:
    return query_vectors(dataset()[0], 32, seed=3)


@pytest.fixture(scope="module", params=MODES)
def loaded(request):
    """(JAX index, its directory, the port's load of it)."""
    jindex, directory = metadata_artifact(request.param)
    return jindex, directory, load_pageann(directory, device="cpu")


def _params(index, **adaptive):
    """The same operating point for both packages: (JAX, port) params."""
    base = SearchParams.from_config(index.cfg)
    if adaptive:
        base = base.replace(adaptive=AdaptiveParams(**adaptive))
    return JParams.from_json(base.to_json()), base


def _flips(jindex, q) -> np.ndarray:
    """Queries whose packed LSH code differs between the two packages."""
    planes = np.array(jindex.lsh.planes)
    want = np.asarray(jlsh.hash_codes(jnp.asarray(q), jnp.asarray(planes)))
    got = tlsh.hash_codes(torch.as_tensor(q), torch.as_tensor(planes)).numpy()
    return np.nonzero((got.view(np.uint32) != want).any(1))[0]


def _assert_matches(rt, rj, exempt=()) -> None:
    keep = np.setdiff1d(np.arange(len(rt.ids)), exempt)
    for field in ("ids", "ios", "hops", "cache_hits"):
        np.testing.assert_array_equal(
            np.asarray(getattr(rt, field))[keep],
            np.asarray(getattr(rj, field))[keep], err_msg=field)
    np.testing.assert_allclose(np.asarray(rt.dists)[keep],
                               np.asarray(rj.dists)[keep], **TOL)


def _assert_equal(got, want, context="") -> None:
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                      err_msg=f"{context}{field}")


def _score_le(sel: float) -> float:
    return float(np.quantile(np.asarray(dataset()[2]["score"]), sel))


# ------------------------------------------------------- disabled == plain
@pytest.mark.parametrize("residency", ["resident", "streamed"])
def test_default_adaptive_params_are_the_plain_search(loaded, residency):
    """``AdaptiveParams()`` (and any value with patience and entry slack
    off) runs exactly the non-adaptive loop: every field equal bit for bit,
    resident and under a memory budget."""
    _, directory, tindex = loaded
    if residency == "streamed":
        tindex = load_pageann(directory, device="cpu", memory_budget=0.25)
        assert tindex.fetcher is not None
    q = queries()
    base = SearchParams.from_config(tindex.cfg)
    want = tindex.search(q, params=base)
    for off in (AdaptiveParams(), AdaptiveParams(epsilon=0.3, min_entries=4)):
        assert not off.enabled
        _assert_equal(tindex.search(q, params=base.replace(adaptive=off)), want,
                      f"{off}: ")


# ------------------------------------------------------ parity, resident
@pytest.mark.parametrize("case", list(CASES))
def test_adaptive_search_matches_the_reference(loaded, case, record_property):
    jindex, _, tindex = loaded
    q = queries()
    flips = _flips(jindex, q)
    record_property("sign_flip_queries", flips.tolist())
    assert len(flips) <= 1
    pj, pt = _params(tindex, **CASES[case])
    rt = tindex.search(q, params=pt)
    _assert_matches(rt, jindex.search(q, params=pj), flips)
    plain = tindex.search(q, params=_params(tindex)[1])
    if "patience" in CASES[case] and "entry_slack_bits" not in CASES[case]:
        # the same start, and the loop condition only gained a conjunct: a
        # lane exits earlier
        assert (rt.hops <= plain.hops).all() and (rt.ios <= plain.ios).all()
        if CASES[case]["patience"] == 1:
            assert (rt.hops < plain.hops).any()


def test_entry_selection_drops_entries_before_deduplication(loaded):
    """With zero slack and one forced entry, queries seed fewer entries
    than the top-T, and hop on from a narrower start: the searches differ
    from the plain one for some query, and still match the reference."""
    jindex, _, tindex = loaded
    q = queries()
    pj, pt = _params(tindex, entry_slack_bits=0, min_entries=1)
    rt = tindex.search(q, params=pt)
    plain = tindex.search(q, params=_params(tindex)[1])
    assert (rt.ios != plain.ios).any() or (rt.hops != plain.hops).any()
    _assert_matches(rt, jindex.search(q, params=pj), _flips(jindex, q))


def test_filtered_adaptive_search_matches_the_reference(loaded):
    """Selectivity 0.1: the widened beam with early termination and entry
    selection on."""
    jindex, _, tindex = loaded
    q = queries()
    pj, pt = _params(tindex, patience=2, entry_slack_bits=2, min_entries=4)
    le = _score_le(0.1)
    rt = tindex.search(q, K, params=pt, filter=Num("score").le(le))
    rj = jindex.search(q, K, params=pj, filter=JNum("score").le(le))
    _assert_matches(rt, rj, _flips(jindex, q))
    assert (rt.ids[:, 0] >= 0).all()


# ------------------------------------------------------ parity, streamed
@pytest.mark.parametrize("case", ["p2", "p2-slack2-min4"])
def test_streamed_adaptive_search_equals_resident(loaded, case):
    """Under a 0.25 memory budget the adaptive search equals the resident
    one bit for bit, filtered or not, and so the reference's."""
    jindex, directory, tindex = loaded
    streamed = load_pageann(directory, device="cpu", memory_budget=0.25)
    q = queries()
    pj, pt = _params(tindex, **CASES[case])
    want = tindex.search(q, params=pt)
    _assert_equal(streamed.search(q, params=pt), want, "streamed: ")
    _assert_matches(want, jindex.search(q, params=pj), _flips(jindex, q))
    expr = Num("score").le(_score_le(0.1))
    _assert_equal(streamed.search(q, K, params=pt, filter=expr),
                  tindex.search(q, K, params=pt, filter=expr), "filtered: ")


# ------------------------------------------------------- mutable index
@pytest.mark.parametrize("mode", [MemoryMode.HYBRID.value, MemoryMode.MEM_ALL.value])
def test_mutable_adaptive_search_matches_the_reference(mode):
    """A mutable index over a JAX-built base, the same writes to both
    packages, then an adaptive unified search: the base's adaptive search
    and the exact delta scan, merged."""
    jindex, directory = delta_base_artifact(mode)
    x, q, meta = delta_dataset()
    pair = (JMutable(jindex, auto_compact=False),
            MutableIndex(load_pageann(directory, device="cpu"),
                         auto_compact=False))
    rows = range(N_BASE, 900)
    for m in pair:
        m.insert(x[N_BASE:900], ids=np.arange(N_BASE, 900),
                 metadata={f: [col[i] for i in rows] for f, col in meta.items()})
        m.delete(np.arange(0, 20))
    pj, pt = _params(pair[1].base, patience=2, entry_slack_bits=2,
                     min_entries=4)
    rj, rt = pair[0].search(q, K, params=pj), pair[1].search(q, K, params=pt)
    for field in ("ids", "ios", "hops", "cache_hits"):
        np.testing.assert_array_equal(getattr(rt, field),
                                      np.asarray(getattr(rj, field)),
                                      err_msg=field)
    # the delta tier's expanded-norm L2 (ROADMAP C1): atol by the norms
    atol = 1e-6 * float((q * q).sum(-1).max() + (x * x).sum(-1).max())
    np.testing.assert_allclose(rt.dists, np.asarray(rj.dists), rtol=1e-5,
                               atol=atol)
    assert not np.isin(rt.ids, np.arange(0, 20)).any()


# ------------------------------------------------------------ autotune
def _truth(q) -> np.ndarray:
    return brute_force_knn(dataset()[0], q, K)


def _recorded(index) -> list:
    """Record every operating point ``autotune`` measures on ``index``."""
    probes = []
    measure = index._measure

    def recording(q, params, truth):
        m = measure(q, params, truth)
        probes.append(m)
        return m

    index._measure = recording
    return probes


def _tunable(q):
    """Fresh loads of the HYBRID artifact (autotune stores its winner on
    the index; the shared artifact must stay untouched) and the queries
    whose LSH codes agree in both packages (autotune scores the batch)."""
    jindex, directory = metadata_artifact(MemoryMode.HYBRID.value)
    keep = np.setdiff1d(np.arange(len(q)), _flips(jindex, q))
    return (jax_load_index(directory), load_pageann(directory, device="cpu"),
            q[keep])


@pytest.mark.parametrize("target", ["recall", "p99"])
def test_autotune_probes_the_reference_points_at_its_recall(target):
    """Each probed point: the same params, recall, mean hops and mean ios
    as the reference's. In p99 mode under a budget every point meets, the
    winner is the first point of highest recall, so it is the same too."""
    jindex, tindex, q = _tunable(queries())
    truth = _truth(q)
    kw = (dict(recall_target=0.9, beam_grid=(16, 32, 64),
               io_batch_grid=(3,), entries_grid=(4,))
          if target == "recall" else
          dict(p99_target_us=1e12, beam_grid=(16, 32), patience_grid=(None, 2)))
    probes_j, probes_t = _recorded(jindex), _recorded(tindex)
    win_j = jindex.autotune(q, truth=truth, **kw)
    win_t = tindex.autotune(q, truth=truth, **kw)
    assert len(probes_t) == len(probes_j) >= 4
    for mt, mj in zip(probes_t, probes_j):
        assert mt["params"].to_json() == mj["params"].to_json()
        for key in ("recall", "mean_hops", "mean_ios"):
            assert mt[key] == mj[key], (key, mt["params"])
    if target == "recall":
        assert win_t["recall"] >= 0.9 and win_j["recall"] >= 0.9
        assert win_t["params"] in [m["params"] for m in probes_t]
    else:
        assert win_t["params"].to_json() == win_j["params"].to_json()
    assert tindex.default_params == win_t["params"]
    assert tindex.tuned[-1]["target"] == win_t["target"]


def test_tuned_artifacts_load_in_both_packages(tmp_path):
    """A reference-autotuned artifact loads in the port with the same
    default params and points, and searches with them; a port-autotuned one
    loads in the reference; a mutable index carries its base's."""
    jindex, tindex, q = _tunable(queries())
    truth = _truth(q)
    jindex.autotune(q, recall_target=0.9, truth=truth, beam_grid=(16, 32, 64))
    jindex.save(str(tmp_path / "j"))
    got = load_pageann(str(tmp_path / "j"), device="cpu")
    assert got.default_params.to_json() == jindex.tuned_default.to_json()
    assert [m["recall"] for m in got.tuned] == [m["recall"] for m in jindex.tuned]
    assert (got.params_for_target(recall_target=0.9).to_json()
            == jindex.params_for_target(recall_target=0.9).to_json())
    _assert_matches(got.search(q), jindex.search(q), _flips(jindex, q))

    win = tindex.autotune(q, recall_target=0.9, truth=truth,
                          beam_grid=(16, 32, 64))
    assert recall_at_k(tindex.search(q, k=K).ids, truth) == win["recall"]
    tindex.save(str(tmp_path / "t"))
    back = jax_load_index(str(tmp_path / "t"))
    assert back.tuned_default.to_json() == win["params"].to_json()
    assert [m["qps"] for m in back.tuned] == [m["qps"] for m in tindex.tuned]
    again = load_pageann(str(tmp_path / "t"), device="cpu")
    assert again.default_params == win["params"]
    assert again.tuned == tindex.tuned

    mutable = MutableIndex(again, auto_compact=False)
    mutable.save(str(tmp_path / "m"))
    assert load_index(str(tmp_path / "m"), device="cpu").default_params == win["params"]
    assert (jax_load_index(str(tmp_path / "m")).default_params.to_json()
            == win["params"].to_json())


def test_params_for_target_and_its_errors():
    """The same stored points resolve the same params in both packages,
    and an unmet target raises the reference's ``LookupError``."""
    jindex, tindex, q = _tunable(queries())
    truth = _truth(q)
    for index in (jindex, tindex):
        index.autotune(q, p99_target_us=1e12, truth=truth, beam_grid=(16, 32),
                       patience_grid=(None,))
    assert (tindex.params_for_target(recall_target=0.5).to_json()
            == jindex.params_for_target(recall_target=0.5).to_json())
    assert tindex.params_for_target(p99_target_us=1e12) == tindex.default_params
    for kw in (dict(recall_target=1.01), dict(p99_target_us=1e-9)):
        with pytest.raises(LookupError) as et:
            tindex.params_for_target(**kw)
        with pytest.raises(LookupError) as ej:
            jindex.params_for_target(**kw)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="exactly one of"):
        tindex.params_for_target()
    with pytest.raises(ValueError, match="exactly one of"):
        tindex.autotune(q, recall_target=0.9, p99_target_us=1.0)


def test_a_tuned_manifest_sets_the_default_params(tmp_path, loaded):
    """An artifact whose manifest names a tuned default loads with it as
    ``default_params``, and searches with no params run it."""
    jindex, directory, tindex = loaded
    tuned = SearchParams.from_config(tindex.cfg).replace(
        beam_width=32, adaptive=AdaptiveParams(patience=2))
    copy = str(tmp_path / "tuned")
    tindex.save(copy)
    doc = json.load(open(os.path.join(copy, persist.MANIFEST)))
    doc["tuned"] = {"default": tuned.to_json(), "points": []}
    json.dump(doc, open(os.path.join(copy, persist.MANIFEST), "w"))
    got = load_pageann(copy, device="cpu")
    assert got.default_params == tuned and got.tuned == []
    q = queries()
    _assert_equal(got.search(q), tindex.search(q, params=tuned))
    assert jax_load_index(copy).default_params.to_json() == tuned.to_json()


# ------------------------------------------------ validation and behaviour
def test_pageann_path_reports_cross_field_violations_together(loaded):
    _, _, tindex = loaded
    p = SearchParams(beam_width=4, lsh_entries=8,
                     adaptive=AdaptiveParams(entry_slack_bits=2, min_entries=9))
    with pytest.raises(ValueError) as e:
        tindex.search(queries()[:1], params=p)
    assert "beam_width >= lsh_entries" in str(e.value)
    assert "min_entries <= lsh_entries" in str(e.value)


def test_early_termination_keeps_recall_and_easy_queries_exit(loaded):
    """Recall within 0.02 of the plain search at patience 2; base vectors
    as queries find themselves and exit before ``max_hops`` at patience 1."""
    _, _, tindex = loaded
    x = dataset()[0]
    q = queries()
    truth = _truth(q)
    base = SearchParams.from_config(tindex.cfg)
    off = tindex.search(q, params=base)
    on = tindex.search(q, params=base.replace(adaptive=AdaptiveParams(patience=2)))
    assert recall_at_k(on.ids, truth) >= recall_at_k(off.ids, truth) - 0.02
    easy = x[np.random.default_rng(7).choice(len(x), 16, replace=False)]
    plain = tindex.search(easy, params=base)
    fast = tindex.search(easy, params=base.replace(adaptive=AdaptiveParams(patience=1)))
    assert (fast.hops < tindex.cfg.max_hops).all()
    assert fast.hops.mean() < plain.hops.mean()
    np.testing.assert_allclose(fast.dists[:, 0], 0.0, atol=1e-4)
