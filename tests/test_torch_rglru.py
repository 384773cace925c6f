"""The port's RG-LRU recurrent block (``repro_torch.models.rglru``) against
the reference's (``repro.models.rglru``) on the CPU.

Parameters come from the reference's own ``init_rglru``, inputs from numpy
seeds; everything is held at rtol = atol = 1e-5. ``rglru_scan``: torch has
no ``lax.associative_scan``, so the port follows that function's recursion
in torch ops (combine adjacent pairs, scan the half-length sequence, fill
in the even positions) with the reference's ``combine``. That is log depth
(a prefill costs a few launches a level, not one a token, which matters on
the card where every launch costs host time) and groups the products in
the reference's tree; a sequential loop would group them otherwise and
launch T times. The gates' sigmoid, exp and softplus differ from XLA's in
the last bits, so the scan agrees to rounding, not bit for bit. The cases
of the reference's ``tests/test_rglru.py`` run over the port at their own
tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import rglru as jrg
from repro_torch.configs.registry import get_arch
from repro_torch.models import rglru as trg
from repro_torch.models.transformer import to_tensor

# six test workers share the host's cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _params(seed=0):
    cfg = get_arch("recurrentgemma-9b", smoke=True)
    jcfg = jget_arch("recurrentgemma-9b", smoke=True)
    jp = jrg.init_rglru(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return cfg, jcfg, {k: to_tensor(np.asarray(v)) for k, v in jp.items()}, jp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_gates_equal_reference():
    _, _, tp, jp = _params(0)
    x = _x((2, 5, 64), 0)
    for g, w in zip(trg._gates(tp, torch.from_numpy(x)),
                    jrg._gates(jp, jnp.asarray(x))):
        _close(g, w)


@pytest.mark.parametrize("T", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
def test_rglru_scan_equals_reference(T, with_h0):
    _, _, tp, jp = _params(1)
    x = _x((2, T, 64), T)
    h0 = _x((2, 64), T + 1) if with_h0 else None
    y, hT = trg.rglru_scan(tp, torch.from_numpy(x),
                           None if h0 is None else torch.from_numpy(h0))
    jy, jhT = jrg.rglru_scan(jp, jnp.asarray(x),
                             None if h0 is None else jnp.asarray(h0))
    _close(y, jy)
    _close(hT, jhT)
    assert hT.dtype == torch.float32


def test_rglru_step_equals_reference():
    _, _, tp, jp = _params(2)
    h, jh = torch.zeros((2, 64)), jnp.zeros((2, 64))
    for t in range(5):
        x1 = _x((2, 64), 10 + t)
        y, h = trg.rglru_step(tp, torch.from_numpy(x1), h)
        jy, jh = jrg.rglru_step(jp, jnp.asarray(x1), jh)
        _close(y, jy)
        _close(h, jh)


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
def test_recurrent_block_equals_reference(with_state):
    cfg, jcfg, tp, jp = _params(3)
    u = _x((2, 11, cfg.d_model), 3)
    state = None
    if with_state:
        state = {"conv": _x((2, cfg.conv_width - 1, 64), 4),
                 "h": _x((2, 64), 5)}
    out, st = trg.recurrent_block(
        tp, torch.from_numpy(u), cfg,
        None if state is None else {k: torch.from_numpy(v)
                                    for k, v in state.items()})
    jout, jst = jrg.recurrent_block(
        jp, jnp.asarray(u), jcfg,
        None if state is None else {k: jnp.asarray(v)
                                    for k, v in state.items()})
    _close(out, jout)
    for k in ("conv", "h"):
        _close(st[k], jst[k])


def test_recurrent_block_step_equals_reference():
    cfg, jcfg, tp, jp = _params(4)
    state = {"conv": _x((2, cfg.conv_width - 1, 64), 6), "h": _x((2, 64), 7)}
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    for t in range(5):
        u1 = _x((2, cfg.d_model), 20 + t)
        out, ts = trg.recurrent_block_step(tp, torch.from_numpy(u1), cfg, ts)
        jout, js = jrg.recurrent_block_step(jp, jnp.asarray(u1), jcfg, js)
        _close(out, jout)
        for k in ("conv", "h"):
            _close(ts[k], js[k])


def test_bf16_gelu_rounds_each_op_as_the_reference():
    """Below float32 the port's gelu is the reference's formula op by op,
    each rounded to bfloat16: equal bit for bit to ``jax.nn.gelu``."""
    x = torch.from_numpy(_x((4096,), 8)).to(torch.bfloat16)
    want = jax.nn.gelu(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    got = trg._gelu(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# -------------------------------- tests/test_rglru.py's cases, ported --
def test_scan_matches_stepwise():
    cfg, _, tp, _ = _params(0)
    B, T, w = 2, 9, cfg.rnn_width
    x = torch.from_numpy(_x((B, T, w), 0))
    y_scan, hT = trg.rglru_scan(tp, x)
    h = torch.zeros((B, w))
    ys = []
    for t in range(T):
        y1, h = trg.rglru_step(tp, x[:, t], h)
        ys.append(y1)
    np.testing.assert_allclose(y_scan.numpy(), torch.stack(ys, 1).numpy(),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(hT.numpy(), h.numpy(), atol=1e-5, rtol=1e-4)


def test_scan_with_initial_state():
    cfg, _, tp, _ = _params(1)
    B, T, w = 1, 8, cfg.rnn_width
    x = torch.from_numpy(_x((B, T, w), 1))
    y_full, h_full = trg.rglru_scan(tp, x)
    y1, h1 = trg.rglru_scan(tp, x[:, :T // 2])
    y2, h2 = trg.rglru_scan(tp, x[:, T // 2:], h0=h1)
    np.testing.assert_allclose(y_full.numpy(), torch.cat([y1, y2], 1).numpy(),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(h_full.numpy(), h2.numpy(), atol=1e-5,
                               rtol=1e-4)


def test_recurrent_block_step_matches_scan():
    cfg, _, tp, _ = _params(2)
    B, T = 2, 7
    u = torch.from_numpy(_x((B, T, cfg.d_model), 2))
    full, _ = trg.recurrent_block(tp, u, cfg)
    w = cfg.rnn_width or cfg.d_model
    state = {"conv": torch.zeros((B, cfg.conv_width - 1, w)),
             "h": torch.zeros((B, w))}
    outs = []
    for t in range(T):
        o, state = trg.recurrent_block_step(tp, u[:, t], cfg, state)
        outs.append(o)
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(),
                               atol=1e-4, rtol=1e-3)
