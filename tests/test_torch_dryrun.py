"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline``,
``dryrun_pageann``) on the CPU.

Each test that opens a process group closes it: ``dryrun.fake_world``
destroys the fake group of 256 ranks it opens.

* ``dryrun_cell`` reaches ``ok`` on granite-3-2b's ``train_4k`` cell with
  its widths cut so that every dim divides the 16 x 16 mesh, and its
  per-device flops equal a hand count of the step's matrix products (the
  weight products, attention's two batched products over every chunk
  pair, the unembedding; backward twice forward, no remat) over 256
  devices within 2%. ``FlopCounterMode`` counts a DTensor product at its
  global size; the port counts each device's local products.
* Pure FSDP (a (256, 1) mesh): the all-gathers move each sharded
  parameter's bytes once, the reduce-scatters a 256th of that, the
  all-reduces the replicated parameters' gradients and a few scalars.
* The unit extrapolation equals the full trace: flops and collective bytes
  exactly, bytes within 0.1% (a single microbatch skips the accumulator's
  final scaling, so the bytes are not quite linear in microbatches).
* An MoE step on the CPU's fake group records no all-to-all: the expert
  layout's exchange is an all-gather over 'data' (experts over 'model',
  the rest replicated, as the reference lays it out), and the CPU group
  would turn an all-to-all into an all-gather anyway.
* ``main`` writes one record per cell; the production mesh refuses a
  world of another size; ``dryrun_pageann`` tiles a small index into a
  shard whose neighbour and entry ids stay in their tiles and searches it.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun, dryrun_pageann
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import init_params

torch.set_num_threads(1)

# granite-3-2b at widths that divide the 16 x 16 mesh; one attention chunk
SMALL = dict(num_layers=2, d_model=256, num_heads=16, num_kv_heads=16,
             head_dim=16, d_ff=512, vocab_size=4096, remat="none",
             q_chunk=4096, kv_chunk=4096)


def _small(**kw):
    return dataclasses.replace(get_arch("granite-3-2b"), **{**SMALL, **kw})


def test_dryrun_cell_ok_and_flops_match_hand_count():
    rec = dryrun.dryrun_cell("granite-3-2b", "train_4k", False,
                             verbose=False, arch_overrides=SMALL)
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["mesh"] == "pod16x16" and "trace_s" in rec
    d, h, hd, ff, v, n_layers = 256, 16, 16, 512, 4096, 2
    t, b = 4096, 256
    per_token = (2 * (3 * d * h * hd + h * hd * d) + 2 * 3 * d * ff
                 + 2 * 2 * t * h * hd)             # QK^T and PV, all pairs
    forward = b * t * (n_layers * per_token + 2 * d * v)
    want = 3 * forward / 256
    assert abs(rec["hlo_flops"] - want) <= 0.02 * want
    assert rec["fits_hbm"] and rec["peak_gib_per_device"] > 0
    for key in ("compute_s", "memory_s", "collective_s", "bottleneck",
                "model_flops_per_device", "useful_flops_ratio",
                "raw_loop_body_terms", "collective_breakdown",
                "collective_counts"):
        assert key in rec


def test_pure_fsdp_collectives_match_hand_count():
    from torch.distributed.device_mesh import init_device_mesh

    arch = _small()
    shape = ShapeConfig("t", 512, 256, "train", num_microbatches=1)
    with dryrun.fake_world(256):
        mesh = init_device_mesh("cpu", (256, 1),
                                mesh_dim_names=("data", "model"))
        coll = dryrun.trace_train(arch, shape, mesh)["counter"]\
            .collective_bytes()
    params = list(init_params(arch, torch.Generator(),
                              device="meta").parameters())
    sharded = sum(p.numel() * 4 for p in params if p.ndim > 1)
    replicated = sum(p.numel() * 4 for p in params if p.ndim == 1)
    assert coll["all-gather"] == sharded
    assert coll["reduce-scatter"] == sharded // 256
    assert replicated <= coll["all-reduce"] <= replicated + 64
    assert coll["all-to-all"] == 0


def test_calibration_equals_full_trace():
    arch = _small(num_layers=3, q_chunk=256, kv_chunk=512)
    shape = ShapeConfig("t", 512, 64, "train", num_microbatches=4)
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        full = dryrun._trace_cell(arch, shape, mesh)["counter"].counters()
        cal = dryrun.calibrated_counters(arch, shape, mesh)
    assert cal["hlo_flops"] == full["hlo_flops"]
    assert cal["collective_bytes"] == full["collective_bytes"]
    assert abs(cal["hlo_bytes"] - full["hlo_bytes"]) <= 1e-3 * full["hlo_bytes"]


def test_moe_step_exchanges_by_all_gather_on_the_cpu_group():
    arch = dataclasses.replace(
        get_arch("arctic-480b"), num_layers=1, d_model=256, num_heads=16,
        num_kv_heads=16, head_dim=16, d_ff=128, num_experts=16,
        vocab_size=4096, remat="none", q_chunk=512, kv_chunk=512)
    shape = ShapeConfig("t", 512, 32, "train", num_microbatches=1)
    with dryrun.fake_world(256):
        tr = dryrun.trace_train(arch, shape, make_production_mesh())
    coll = tr["counter"].collective_bytes()
    assert coll["counts"]["all-to-all"] == 0
    assert coll["counts"]["all-gather"] > 0
    assert tr["counter"].flops > 0


def test_main_writes_each_cell(tmp_path):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "mamba2-370m_long_500k_single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["hlo_flops"] > 0
    skip = dryrun.dryrun_cell("granite-3-2b", "long_500k", False,
                              verbose=False)
    assert skip["status"] == "skip" and skip["skip_reason"]


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="none is initialized"):
        make_production_mesh()
    with dryrun.fake_world(16):
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            make_production_mesh()


def test_kernel_counts_are_the_smoke_formulas():
    # one page scan: 64 queries x 5 pages of 6 members at d = 128, ADC
    # over 16 code rows of 48 neighbours with 256-entry tables
    b, ops_ = rf.page_scan_counts(64, 5, records=320, cap=6, dim=128, rp=48,
                                  m=16, k=256, adc=True)
    assert b == (320 * (6 * 128 + 16 * 48) * 4 + 320 * 4 + 64 * 128 * 4
                 + 64 * 16 * 256 * 4 + 320 * (6 + 48) * 4)
    assert ops_ == 320 * (6 * 128 * 3 + 48 * 16)
    bound = rf.kernel_bound(b, ops_)
    assert bound["bound_by"] == "bytes" and bound["bound_ms"] > 0


def test_pageann_tiled_shard_searches():
    base, cap, q = dryrun_pageann.build_base(300, device="cpu")
    p0 = base.member_count.shape[0]
    pages = 4 * p0 + 3
    data = dryrun_pageann.tiled_shard(base, cap, pages, 4096)
    n0 = p0 * cap
    tiles = torch.arange(pages) // p0
    nbr = data.nbr_ids.long()
    ok = nbr < 0
    assert bool(((nbr // n0 == tiles[:, None]) | ok).all())
    # entries first from the last full tile
    assert int(data.lsh_ids[0]) // n0 == 3
    assert data.page_recs.shape[0] == pages
    rec = dryrun_pageann.run(base, cap, q, n_vectors=16 * cap * 4 * p0,
                             sample=16)
    assert rec["status"] == "ok" and rec["pages_per_shard"] == 4 * p0
    assert rec["ids_agree_share"] == 1.0
    assert rec["hlo_flops"] > 0 and rec["collective_bytes"] > 0
