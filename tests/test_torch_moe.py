"""The port's MoE (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the CPU.

Parameters come from the reference's own ``init_moe`` (carried across bit
for bit), inputs from numpy seeds. Outputs are held at rtol = atol = 1e-5
(the frameworks sum the expert products in different orders), with
capacity drops (capacity factors down to 0.25) and with ties in the router's
probabilities (``lax.top_k`` takes the lower expert). In bfloat16 (the
kimi-k2 decode's regime: bf16 activations and experts, float32 router)
the port rounds each op as the reference does, so the layer is held to
one bfloat16 step (2^-8 relative). The cases of the reference's
``tests/test_moe.py`` run over the port (not ``test_moe_grad_finite``:
gradients come with ROADMAP A13c).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import moe as jm
from repro_torch.configs.registry import get_arch
from repro_torch.models import moe as tm
from repro_torch.models.transformer import to_tensor

# six test workers share the host's cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _params(arch, seed, dtype=jnp.float32, **replace):
    jcfg = dataclasses.replace(jget_arch(arch, smoke=True), **replace)
    cfg = dataclasses.replace(get_arch(arch, smoke=True), **replace)
    jp = jm.init_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    tp = {k: to_tensor(np.asarray(v)) for k, v in jp.items()}
    return cfg, jcfg, tp, jp


def _x(cfg, B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def _assignments_over_capacity(probs, cfg, n):
    """How many top-k assignments the capacity drops (numpy, stable)."""
    top = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.experts_per_token]
    counts = np.bincount(top.ravel(), minlength=cfg.num_experts)
    return int(np.maximum(counts - tm.moe_capacity(n, cfg), 0).sum())


@pytest.mark.parametrize("arch,B,T,factor,drops", [
    ("arctic-480b", 2, 32, 1.25, False),    # the smoke config
    ("arctic-480b", 2, 32, 0.25, True),     # capacity 8: 16 an expert on average
    ("arctic-480b", 2, 16, 8.0, False),
    ("kimi-k2-1t-a32b", 1, 24, 1.25, False),    # top-4 of 8
    ("kimi-k2-1t-a32b", 4, 24, 0.5, True),
])
def test_moe_layer_equals_reference(arch, B, T, factor, drops):
    cfg, jcfg, tp, jp = _params(arch, 0, moe_capacity_factor=factor)
    x = _x(cfg, B, T, seed=1)
    got = tm.moe_layer(tp, torch.from_numpy(x), cfg)
    want = jm.moe_layer(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    logits = x.reshape(-1, cfg.d_model) @ np.asarray(jp["router"])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    dropped = _assignments_over_capacity(probs, cfg, B * T)
    assert (dropped > 0) == drops


@pytest.mark.parametrize("router", ["zero", "duplicate-columns"])
def test_moe_router_ties_go_to_the_lower_expert(router):
    """Equal probabilities: ``lax.top_k`` keeps the lower expert, and so
    must the port. A zero router ties all eight experts (every token picks
    experts 0 and 1, most of them dropped); duplicated router columns tie
    expert pairs (3, 5) and (2, 6) for every token."""
    cfg, jcfg, tp, jp = _params("arctic-480b", 2)
    r = np.asarray(jp["router"]).copy()
    if router == "zero":
        r[:] = 0.0
    else:
        r[:, 5] = r[:, 3]
        r[:, 6] = r[:, 2] * 1.0
    tp = dict(tp, router=torch.from_numpy(r))
    jp = dict(jp, router=jnp.asarray(r))
    x = _x(cfg, 2, 16, seed=3)
    got = tm.moe_layer(tp, torch.from_numpy(x), cfg)
    want = jm.moe_layer(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, cfg.d_model) @ r), -1)
    _, top = tm._top_k(probs, cfg.experts_per_token)
    _, jtop = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.experts_per_token)
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    if router == "zero":
        assert (top.numpy() == [0, 1]).all()


def test_moe_layer_bf16_equals_reference():
    """The decode's regime for kimi-k2: bf16 activations and experts, the
    router float32. XLA rounds each bf16 op and so does the port; the
    layer output is held to one bfloat16 step."""
    cfg, jcfg, tp, jp = _params("kimi-k2-1t-a32b", 4, dtype=jnp.bfloat16)
    assert tp["we_gate"].dtype == torch.bfloat16
    assert tp["router"].dtype == torch.float32
    x = _x(cfg, 2, 1, seed=5)
    got = tm.moe_layer(tp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    want = jm.moe_layer(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2.0 ** -8, atol=2.0 ** -8)


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("tokens", [1, 8, 64, 1000, 4096])
def test_moe_capacity_equals_reference(arch, tokens):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert tm.moe_capacity(tokens, cfg) == jm.moe_capacity(tokens, jcfg)


@pytest.mark.parametrize("B,T", [(2, 16), (1, 64)])
def test_moe_aux_loss_equals_reference(B, T):
    cfg, jcfg, tp, jp = _params("arctic-480b", 6)
    x = _x(cfg, B, T, seed=7)
    np.testing.assert_allclose(
        float(tm.moe_aux_loss(tp, torch.from_numpy(x), cfg)),
        float(jm.moe_aux_loss(jp, jnp.asarray(x), jcfg)), **TOL)


# ---------------------------------- tests/test_moe.py's cases, ported --
def dense_moe_reference(params, x, cfg):
    """No-capacity reference: every token reaches its top-k experts."""
    b, t, d = x.shape
    xt = np.asarray(x.reshape(b * t, d), np.float64)
    logits = xt @ np.asarray(params["router"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    k = cfg.experts_per_token
    out = np.zeros_like(xt)
    for i in range(len(xt)):
        top = np.argsort(-probs[i])[:k]
        w = probs[i, top]
        w = w / w.sum()
        for e, we in zip(top, w):
            wg = np.asarray(params["we_gate"][e], np.float64)
            wu = np.asarray(params["we_up"][e], np.float64)
            wd = np.asarray(params["we_down"][e], np.float64)
            hpre = xt[i] @ wg
            h = hpre / (1 + np.exp(-hpre)) * (xt[i] @ wu)
            out[i] += we * (h @ wd)
    return out.reshape(b, t, d)


def test_moe_matches_dense_reference_when_no_drops():
    cfg, _, tp, _ = _params("arctic-480b", 0, moe_capacity_factor=8.0)
    x = _x(cfg, 2, 16, seed=0)
    out = tm.moe_layer(tp, torch.from_numpy(x), cfg)
    want = dense_moe_reference({k: v.numpy() for k, v in tp.items()}, x, cfg)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-3, rtol=1e-2)


def test_moe_capacity_drops_are_bounded():
    cfg, _, tp, _ = _params("arctic-480b", 1)   # capacity factor 1.25
    x = _x(cfg, 2, 32, seed=1)
    out = tm.moe_layer(tp, torch.from_numpy(x), cfg).numpy()
    assert np.isfinite(out).all()
    # dropped tokens produce zero output rows, never NaNs; most match
    want = dense_moe_reference({k: v.numpy() for k, v in tp.items()}, x, cfg)
    close = np.isclose(out, want, atol=1e-3, rtol=1e-2).all(-1)
    assert close.mean() > 0.5


def test_aux_loss_uniform_router_is_one():
    cfg, _, tp, _ = _params("arctic-480b", 3, moe_capacity_factor=8.0)
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(cfg, 1, 64, seed=3)
    aux = float(tm.moe_aux_loss(tp, torch.from_numpy(x), cfg))
    # uniform probs: E * sum(f_i * 1/E) = 1 regardless of argmax distribution
    assert 0.9 < aux < 1.6
