"""The port's configs (``repro_torch.configs``) against the reference's
(``repro.configs``): every arch's ``CONFIG`` and ``SMOKE`` field for
field, the derived counts, the shape set and its applicability matrix, the
registry's lookups and errors."""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base
from repro_torch.configs import registry as reg


def test_arch_ids_equal():
    assert reg.ARCH_IDS == jreg.ARCH_IDS
    assert len(reg.ARCH_IDS) == 10


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch_id", jreg.ARCH_IDS)
def test_arch_config_equals_reference(arch_id, smoke):
    got, want = reg.get_arch(arch_id, smoke), jreg.get_arch(arch_id, smoke)
    assert type(got).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.padded_vocab == want.padded_vocab
    assert got.d_inner == want.d_inner
    assert got.ssm_heads == want.ssm_heads
    assert got.attention_free == want.attention_free
    assert got.sub_quadratic == want.sub_quadratic
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_granite_full_width_counts():
    cfg = reg.get_arch("granite-3-2b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff) == (40, 2048, 32, 8, 8192)
    assert (cfg.vocab_size, cfg.padded_vocab) == (49155, 49408)
    # the parameters the port allocates: the padded vocab in both tables
    pad = 2 * (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    assert cfg.param_count() + pad + norms == 2_635_237_376


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for name in base.SHAPES:
        assert dataclasses.asdict(reg.get_shape(name)) == \
            dataclasses.asdict(jreg.get_shape(name))


def test_shape_applicable_matrix_equals_reference():
    got = list(reg.iter_cells())
    want = list(jreg.iter_cells())
    assert got == want
    assert sum(ok for _, _, ok, _ in got) == 31
    assert ("hubert-xlarge", "decode_32k", False,
            "encoder-only arch has no decode step") in got


def test_registry_unknown_id_raises():
    with pytest.raises(KeyError, match="unknown arch 'gpt-5'"):
        reg.get_arch("gpt-5")
    with pytest.raises(KeyError):
        reg.get_shape("train_1m")
