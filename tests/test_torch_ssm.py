"""The port's Mamba-2 SSD layer (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the CPU.

Parameters come from the reference's own ``init_ssm``, inputs from numpy
seeds. Everything is held at rtol = atol = 1e-5, ``ssd_chunked`` and the
whole mixer included: the reference's ``jnp.cumsum`` runs as an
associative scan and its three-operand einsums contract in another order
than the port's, but at these sizes that stays inside 1e-5. The cases of
the reference's ``tests/test_ssm.py`` run over the port (its hypothesis
sweep as a fixed grid of the same values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import ssm as jssm
from repro_torch.configs.registry import get_arch
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import to_tensor

# six test workers share the host's cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _params(seed=0):
    cfg = get_arch("mamba2-370m", smoke=True)
    jcfg = jget_arch("mamba2-370m", smoke=True)
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return cfg, jcfg, {k: to_tensor(np.asarray(v)) for k, v in jp.items()}, jp


def _ssd_inputs(b, T, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, T, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, (b, T, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((b, T, n)).astype(np.float32),
            rng.standard_normal((b, T, n)).astype(np.float32))


@pytest.mark.parametrize("T,chunk", [(7, 4), (16, 8), (33, 8), (64, 32)])
def test_ssd_chunked_equals_reference(T, chunk):
    args = _ssd_inputs(2, T, 3, 4, 8, seed=T)
    y, state = tssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    jy, jstate = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    assert tuple(y.shape) == jy.shape and tuple(state.shape) == jstate.shape
    _close(y, jy)
    _close(state, jstate)


def test_projection_and_conv_equal_reference():
    cfg, jcfg, tp, jp = _params(1)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    for g, w in zip(tssm._split_proj(tp, torch.from_numpy(u), cfg),
                    jssm._split_proj(jp, jnp.asarray(u), jcfg)):
        _close(g, w)
    xbc = rng.standard_normal((2, 9, cfg.d_inner + 2 * cfg.ssm_state)
                              ).astype(np.float32)
    state = rng.standard_normal((2, cfg.conv_width - 1, xbc.shape[-1])
                                ).astype(np.float32)
    for st in (None, state):
        got = tssm._causal_conv(tp, torch.from_numpy(xbc),
                                None if st is None else torch.from_numpy(st))
        want = jssm._causal_conv(jp, jnp.asarray(xbc),
                                 None if st is None else jnp.asarray(st))
        _close(got[0], want[0])
        _close(got[1], want[1])


def test_ssm_forward_equals_reference():
    cfg, jcfg, tp, jp = _params(2)
    u = np.random.default_rng(2).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)      # two chunks of 32
    out, st = tssm.ssm_forward(tp, torch.from_numpy(u), cfg)
    jout, jst = jssm.ssm_forward(jp, jnp.asarray(u), jcfg)
    _close(out, jout)
    _close(st["conv"], jst["conv"])
    _close(st["ssd"], jst["ssd"])


def test_ssm_decode_step_equals_reference():
    cfg, jcfg, tp, jp = _params(3)
    rng = np.random.default_rng(3)
    B = 2
    state = {"conv": rng.standard_normal(
                 (B, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)
             ).astype(np.float32),
             "ssd": rng.standard_normal(
                 (B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
             ).astype(np.float32)}
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    for t in range(6):
        u1 = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
        out, tstate = tssm.ssm_decode_step(tp, torch.from_numpy(u1), cfg,
                                           tstate)
        jout, jstate = jssm.ssm_decode_step(jp, jnp.asarray(u1), jcfg, jstate)
        _close(out, jout)
        _close(tstate["conv"], jstate["conv"])
        _close(tstate["ssd"], jstate["ssd"])


# ---------------------------------- tests/test_ssm.py's cases, ported --
def naive_ssd(x, dt, A, B, C):
    """Sequential reference: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t."""
    b, T, h, p = x.shape
    n = B.shape[-1]
    state = np.zeros((b, h, p, n), np.float64)
    ys = np.zeros(x.shape, dtype=np.float64)
    for t in range(T):
        decay = np.exp(dt[:, t] * A[None, :])           # (b, h)
        contrib = np.einsum("bh,bn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
        state = state * decay[:, :, None, None] + contrib
        ys[:, t] = np.einsum("bn,bhpn->bhp", C[:, t], state)
    return ys, state


@pytest.mark.parametrize("T", [7, 16, 33])
@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("h", [1, 2])
def test_ssd_chunked_matches_sequential(T, chunk, h):
    rng = np.random.default_rng(T * 10 + chunk)
    b, p, n = 2, 4, 8
    x = rng.standard_normal((b, T, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, T, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    B = rng.standard_normal((b, T, n)).astype(np.float32)
    C = rng.standard_normal((b, T, n)).astype(np.float32)
    y, state = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)),
                                chunk)
    y_ref, state_ref = naive_ssd(x, dt, A, B, C)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(state.numpy(), state_ref, atol=1e-3, rtol=1e-3)


def test_ssm_decode_matches_forward():
    """Prefill T tokens via chunked scan == T single decode steps."""
    cfg, _, tp, _ = _params(0)
    rng = np.random.default_rng(0)
    B, T = 2, 12
    u = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model)
                                             ).astype(np.float32))
    full, _ = tssm.ssm_forward(tp, u, cfg)
    state = {
        "conv": torch.zeros((B, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.ssm_state)),
        "ssd": torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state)),
    }
    outs = []
    for t in range(T):
        o, state = tssm.ssm_decode_step(tp, u[:, t], cfg, state)
        outs.append(o)
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(),
                               atol=2e-3, rtol=2e-3)
