"""The port's models (``repro_torch.models``, ``repro_torch.train.step``)
against the reference's (``repro.models``, ``repro.train.step``) on the
CPU, for every architecture in the registry.

Inputs come from numpy seeds and go through both packages. Each layer
function is held to the reference's at rtol = atol = 1e-5 (the frameworks
reduce in different orders). Every model runs on the reference's own
``init_params(SMOKE, PRNGKey(0))``, carried across by ``params_from_jax``
(bit for bit both ways, bfloat16 included): ``forward_train`` logits,
``loss_fn`` and ``prefill`` at 1e-5 (kimi-k2's bf16 weights are cast
exactly to its float32 activations), 16 ``decode_step``s with greedy
tokens equal. The decode's logits are held at 1e-5 while the two bf16 KV
caches agree bit for bit; where an element of k or v straddles a bf16
rounding boundary (the frameworks' float32 k and v differ by ~1e-7) the
cached value lands one bf16 step (2^-8 relative) apart, which moves the
logits by up to ~1e-3 here (6.6e-4 on qwen1.5-32b), so after such a flip
that step is held at 2e-3. kimi-k2's decode runs in bfloat16 activations,
as the reference's (its ``decode_step`` casts nothing): there the port
rounds each op as XLA does and the logits are held to two bf16 steps
(2^-7). The cases of ``tests/test_models.py`` and
``tests/test_train_step.py``'s serve step run over the port with its own
seeded init.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.train.step import make_serve_step as jmake_serve_step
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tf
from repro_torch.train.step import make_prefill, make_serve_step

# six test workers share the host's cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
FLIP_TOL = dict(rtol=2e-3, atol=2e-3)      # after a bf16 cache flip
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)   # kimi-k2's bf16 decode
DENSE = [a for a in ARCH_IDS if get_arch(a).family == "dense"]
DECODERS = [a for a in ARCH_IDS if get_arch(a).is_decoder]
# the families granite-3-2b's own tests below do not cover
OTHERS = [a for a in ARCH_IDS if a != "granite-3-2b"]
OTHER_DECODERS = [a for a in OTHERS if get_arch(a).is_decoder]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@functools.cache
def _ref_tree(cfg):
    """The reference's ``init_params(cfg, PRNGKey(0))`` as numpy arrays, made
    once a config (read-only: every consumer copies)."""
    tree = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(0)))
    for a in jax.tree.leaves(tree):
        a.flags.writeable = False
    return tree


def _both(arch_id: str):
    """(port cfg, reference cfg, reference params as numpy, port model)."""
    cfg, jcfg = get_arch(arch_id, smoke=True), jget_arch(arch_id, smoke=True)
    tree = _ref_tree(jcfg)
    return cfg, jcfg, tree, tf.params_from_jax(tree, cfg, "cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------ layers --
def test_rms_norm_equals_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_equals_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    _close(tl.rope_freqs(16, theta), jl.rope_freqs(16, theta))
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


ATTN_CASES = {
    # name: (Tq, Tk, H, KvH, causal, window, q_chunk, kv_chunk, fwd_only)
    "causal": (16, 16, 4, 4, True, 0, 8, 8, False),
    "gqa": (16, 16, 8, 2, True, 0, 8, 4, False),
    "window": (24, 24, 4, 2, True, 5, 8, 8, False),
    "padded-T33": (33, 33, 4, 2, True, 0, 8, 16, False),
    "fwd-only": (33, 33, 4, 2, True, 0, 8, 8, True),
    "fwd-only-window": (32, 32, 4, 2, True, 6, 8, 8, True),
    "bidirectional": (12, 20, 4, 1, False, 0, 8, 8, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blockwise_attention_equals_reference(case):
    Tq, Tk, H, KvH, causal, window, qc, kc, fwd_only = ATTN_CASES[case]
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, Tq, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, Tk, KvH, 16)).astype(np.float32)
    v = rng.standard_normal((2, Tk, KvH, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc,
              fwd_only=fwd_only)
    got = tl.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = jl.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert tuple(got.shape) == (2, Tq, H, 16)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
def test_decode_attention_equals_reference(window, per_row):
    rng = np.random.default_rng(3)
    q1 = rng.standard_normal((3, 8, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    clen = np.array([4, 7, 10], np.int32) if per_row else 6
    # the serving cache is bfloat16: both upcast it inside the products
    got = tl.decode_attention(
        torch.from_numpy(q1), torch.from_numpy(kc).to(torch.bfloat16),
        torch.from_numpy(vc).to(torch.bfloat16),
        torch.as_tensor(clen), window=window)
    want = jl.decode_attention(
        jnp.asarray(q1), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.asarray(clen), window=window)
    _close(got, want)


def test_gated_mlp_equals_reference():
    rng = np.random.default_rng(4)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.1 for n, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    _close(tl.gated_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x)),
           jl.gated_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)))


# ---------------------------------------------------- params carried across
# parameter names each family's model must carry (beside final.scale)
FAMILY_NAMES = {
    "dense": {"embed", "unembed", "layers.0.scale", "layers.0.attn.wq",
              "layers.0.attn.wk", "layers.0.attn.wv", "layers.0.attn.wo",
              "layers.0.scale2", "layers.0.mlp.w_gate", "layers.0.mlp.w_up",
              "layers.0.mlp.w_down"},
    "moe": {"embed", "unembed", "layers.1.attn.wq", "layers.1.moe.router",
            "layers.1.moe.we_gate", "layers.1.moe.we_up",
            "layers.1.moe.we_down"},
    "ssm": {"embed", "layers.1.scale", "layers.1.ssm.ssm_in",
            "layers.1.ssm.A_log", "layers.1.ssm.conv_w"},
    "hybrid": {"embed", "unembed", "blocks.pos0_rec.0.rec.rg_in",
               "blocks.pos1_rec.0.rec.rg_a_param",
               "blocks.pos2_attn.0.attn.wq", "blocks.pos2_attn.0.mlp.w_up",
               "tail.tail0_rec.rec.rg_out", "tail.tail1_rec.mlp.w_down"},
    "audio": {"in_proj_frontend", "unembed", "layers.0.attn.wq"},
    "vlm": {"embed", "unembed", "layers.0.attn.bq", "layers.0.attn.bk"},
}


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_params_round_trip_bit_for_bit(arch_id):
    cfg, _, tree, model = _both(arch_id)
    back = tf.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    names = {n for n, _ in model.named_parameters()}
    assert FAMILY_NAMES[cfg.family] | {"final.scale"} <= names
    if cfg.tie_embeddings:
        assert "unembed" not in names
    if cfg.dense_residual:
        assert "layers.0.mlp.w_gate" in names
    assert tf.param_bytes(model) == sum(a.nbytes for a in jax.tree.leaves(tree))
    # the parameters keep the reference's dtypes (kimi-k2: bf16, router f32)
    if cfg.param_dtype == "bfloat16":
        assert model.layers[0].moe["we_up"].dtype == torch.bfloat16
        assert model.layers[0].moe["router"].dtype == torch.float32


def test_params_from_jax_rejects_wrong_depth():
    cfg, _, tree, _ = _both("granite-3-2b")
    with pytest.raises(ValueError, match="layers"):
        tf.params_from_jax(tree, dataclasses.replace(cfg, num_layers=3), "cpu")
    cfg, _, tree, _ = _both("recurrentgemma-9b")
    with pytest.raises(ValueError, match="blocks"):
        tf.params_from_jax(tree, dataclasses.replace(cfg, num_layers=8), "cpu")


def test_init_params_shapes_dtypes_and_scales():
    cfg = get_arch("granite-3-2b", smoke=True)
    model = tf.init_params(cfg, _gen(0), device="cpu")
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype),
                          tf.params_to_numpy(model))
    want = jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype)),
                        jax.eval_shape(lambda: jtf.init_params(
                            jget_arch("granite-3-2b", smoke=True),
                            jax.random.PRNGKey(0))))
    assert shapes == want
    # same seed, same weights; another seed, others
    again = tf.params_to_numpy(tf.init_params(cfg, _gen(0), device="cpu"))
    other = tf.params_to_numpy(tf.init_params(cfg, _gen(1), device="cpu"))
    assert np.array_equal(again["embed"], tf.params_to_numpy(model)["embed"])
    assert not np.array_equal(other["embed"], again["embed"])
    # fan-in scaling; wo and w_down scaled by (2 L) ** -0.5
    L, d = cfg.num_layers, cfg.d_model
    assert abs(again["embed"].std() - d ** -0.5) < 0.1 * d ** -0.5
    wo = again["layers"]["attn"]["wo"]
    fan = cfg.num_heads
    assert abs(wo.std() - fan ** -0.5 / (2 * L) ** 0.5) < 0.1 * wo.std()
    assert (again["layers"]["scale"] == 1).all()


@pytest.mark.parametrize("arch_id", OTHERS)
def test_init_params_shapes_and_dtypes_every_family(arch_id):
    cfg = get_arch(arch_id, smoke=True)
    got = jax.tree.map(lambda a: (a.shape, a.dtype), tf.params_to_numpy(
        tf.init_params(cfg, _gen(0), device="cpu")))
    want = jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype)),
                        jax.eval_shape(lambda: jtf.init_params(
                            jget_arch(arch_id, smoke=True),
                            jax.random.PRNGKey(0))))
    assert got == want


# -------------------------------------------------- the model vs reference --
def _batch(cfg, B, T, seed):
    """Token ids (frame embeddings for the audio encoder), next-token
    labels, and for M-RoPE three position streams, from one seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    batch = {"labels": np.roll(toks, -1, axis=1)}
    if cfg.embed_inputs:
        batch["tokens"] = toks
    else:
        batch["embeds"] = rng.standard_normal(
            (B, T, tf.FRONTEND_DIM)).astype(np.float32)
    if cfg.mrope:
        batch["positions3"] = rng.integers(0, 2 * T, (3, B, T)).astype(np.int32)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_forward_train_and_loss_equal_reference(arch_id):
    cfg, jcfg, tree, model = _both(arch_id)
    batch = _batch(cfg, 2, 33, seed=5)
    logits, aux = tf.forward_train(model, batch, cfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jbatch = _jbatch(batch)
    jlogits, jaux = jtf.forward_train(jparams, jbatch, jcfg)
    assert tuple(logits.shape) == (2, 33, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    _close(logits[..., :cfg.vocab_size], jlogits[..., :cfg.vocab_size])
    _close(aux, jaux)
    assert (float(aux) > 0) == (cfg.family == "moe")
    loss, (nll, _) = tf.loss_fn(model, batch, cfg)
    jloss, (jnll, _) = jtf.loss_fn(jparams, jbatch, jcfg)
    _close(loss, jloss)
    _close(nll, jnll)


def test_decode_steps_equal_reference():
    """16 teacher-forced steps: logits at 1e-5 every step. The bf16 caches
    agree but for rounding flips: k and v differ by ~1e-7 in float32 between
    the frameworks, and where that straddles a bf16 rounding boundary the
    cached value moves by one bf16 step (2^-8 relative). So the caches are
    held to that one step, in at most 0.1% of their elements (1 of 2,560
    here)."""
    cfg, jcfg, tree, model = _both("granite-3-2b")
    toks = _batch(cfg, 2, 16, seed=6)["tokens"]
    jparams = jax.tree.map(jnp.asarray, tree)
    cache = tf.init_cache(cfg, 2, 20, device="cpu")
    jcache = jtf.init_cache(jcfg, 2, 20)
    assert cache["layers"]["k"].dtype == torch.bfloat16
    assert tuple(cache["layers"]["k"].shape) == jcache["layers"]["k"].shape
    for t in range(16):
        logits, cache = tf.decode_step(model, cache, torch.from_numpy(toks[:, t]),
                                       t, cfg)
        jlogits, jcache = jtf.decode_step(jparams, jcache,
                                          jnp.asarray(toks[:, t]),
                                          jnp.int32(t), jcfg)
        assert tuple(logits.shape) == (2, cfg.padded_vocab)
        _close(logits[:, :cfg.vocab_size], jlogits[:, :cfg.vocab_size])
    for name in ("k", "v"):
        got = cache["layers"][name].to(torch.float32).numpy()
        want = np.asarray(jcache["layers"][name].astype(jnp.float32))
        flips = got != want
        assert flips.mean() <= 1e-3
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


def test_prefill_equals_reference():
    cfg, jcfg, tree, model = _both("granite-3-2b")
    batch = _batch(cfg, 2, 12, seed=7)
    last, cache = tf.prefill(model, batch, cfg, max_len=16)
    jlast, jcache = jtf.prefill(jax.tree.map(jnp.asarray, tree),
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jcfg, 16)
    _close(last[:, :cfg.vocab_size], jlast[:, :cfg.vocab_size])
    assert tuple(cache["layers"]["v"].shape) == jcache["layers"]["v"].shape
    assert not cache["layers"]["v"].any()
    logits = make_prefill(cfg)(model, batch)
    _close(logits[:, -1], last)


def test_serve_step_greedy_tokens_equal_reference():
    """``test_train_step.py::test_serve_step_greedy_decode_runs`` over the
    port, with the reference's params: the same 4 greedy tokens."""
    cfg, jcfg, tree, model = _both("granite-3-2b")
    serve = make_serve_step(cfg)
    jserve = jax.jit(jmake_serve_step(jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    jcache = jtf.init_cache(jcfg, 2, 16)
    tok = torch.zeros((2,), dtype=torch.int32)
    jtok = jnp.zeros((2,), jnp.int32)
    for t in range(4):
        logits, cache = serve(model, cache, tok, t)
        jlogits, jcache = jserve(jparams, jcache, jtok, jnp.int32(t))
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1).to(torch.int32)
        jtok = jnp.argmax(jlogits[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert tuple(tok.shape) == (2,)


# ------------------------------- tests/test_models.py's dense cases, ported --
def test_smoke_forward_and_shapes():
    cfg = get_arch("granite-3-2b", smoke=True)
    model = tf.init_params(cfg, _gen(0), device="cpu")
    batch = _batch(cfg, 2, 32, seed=0)
    logits, aux = tf.forward_train(model, batch, cfg)
    assert tuple(logits.shape) == (2, 32, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    loss, (nll, _) = tf.loss_fn(model, batch, cfg)
    assert np.isfinite(float(loss))
    # random init -> loss near ln(V)
    assert abs(float(nll) - np.log(cfg.vocab_size)) < 1.5


def test_smoke_decode_step():
    cfg = get_arch("granite-3-2b", smoke=True)
    model = tf.init_params(cfg, _gen(0), device="cpu")
    cache = tf.init_cache(cfg, 2, 64, device="cpu")
    logits, new_cache = tf.decode_step(
        model, cache, torch.zeros((2,), dtype=torch.int32), 3, cfg)
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()
    assert new_cache.keys() == cache.keys()
    assert new_cache["layers"].keys() == {"k", "v"}
    with pytest.raises(ValueError, match="outside the cache"):
        tf.decode_step(model, cache, torch.zeros((2,), dtype=torch.int32),
                       64, cfg)


def test_prefill_decode_consistency():
    """Teacher-forced decode reproduces the training-forward logits (the
    reference test's 2e-2: the decode path's k and v pass through bf16)."""
    cfg = dataclasses.replace(get_arch("granite-3-2b", smoke=True),
                              q_chunk=8, kv_chunk=8)
    model = tf.init_params(cfg, _gen(0), device="cpu")
    B, T = 1, 16
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, T))
    batch = {"tokens": toks, "labels": toks,
             "positions": np.tile(np.arange(T)[None], (B, 1))}
    full, _ = tf.forward_train(model, batch, cfg)
    cache = tf.init_cache(cfg, B, T, device="cpu")
    outs = []
    for t in range(T):
        logits, cache = tf.decode_step(model, cache, torch.from_numpy(toks[:, t]),
                                       t, cfg)
        outs.append(logits)
    dec = torch.stack(outs, dim=1)
    _close(full[..., :cfg.vocab_size], dec[..., :cfg.vocab_size],
           atol=2e-2, rtol=2e-2)


def test_vocab_padding_masks_logits():
    cfg = dataclasses.replace(get_arch("granite-3-2b", smoke=True),
                              vocab_size=100)  # padded to 256
    model = tf.init_params(cfg, _gen(0), device="cpu")
    batch = _batch(cfg, 1, 8, seed=1)
    logits, _ = tf.forward_train(model, batch, cfg)
    assert logits.shape[-1] == 256
    assert (logits[..., 100:] <= -1e29).all()


@pytest.mark.parametrize("arch_id", ["granite-3-2b", "arctic-480b"])
def test_forward_train_with_rules_on_one_device_equals_no_rules(arch_id):
    """``forward_train(rules=)`` on the (1, 1) mesh of a world of one gloo
    rank (the model's parameters DTensors) equals ``rules=None``; the
    world is closed after."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import Rules, release_world
    from repro_torch.train.step import shard_model

    cfg = get_arch(arch_id, smoke=True)
    batch = _batch(cfg, 2, 8, seed=0)
    want, want_aux = tf.forward_train(tf.init_params(cfg, _gen(0),
                                                     device="cpu"), batch, cfg)
    rules = Rules(make_host_mesh("cpu"))
    try:
        model = shard_model(tf.init_params(cfg, _gen(0), device="cpu"), rules)
        assert isinstance(model.final["scale"], DTensor)
        got, aux = tf.forward_train(model, batch, cfg, rules=rules)
        torch.testing.assert_close(got.full_tensor(), want, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(aux.full_tensor() if isinstance(
            aux, DTensor) else aux, want_aux, rtol=1e-6, atol=1e-6)
    finally:
        release_world()
    assert not torch.distributed.is_initialized()


# ------------------------------------------ the other families, on the CPU --
class _DecodeTol:
    """1e-5 until the bf16 KV caches first differ, 2e-3 from then on (a
    flipped element stays in the cache, or, once a ring overwrites it, in
    the recurrent state it fed); kimi-k2's bf16 decode two bf16 steps. See
    the module docstring."""

    def __init__(self, cfg):
        self.cfg, self.flipped = cfg, False

    def __call__(self, cache, jcache) -> dict:
        if self.cfg.param_dtype == "bfloat16":
            return BF16_TOL
        for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(jcache)):
            if a.dtype == torch.bfloat16 and not np.array_equal(
                    a.float().numpy(), np.asarray(b, np.float32)):
                self.flipped = True
        return FLIP_TOL if self.flipped else TOL


def _p3(batch, t):
    p3 = batch.get("positions3")
    return None if p3 is None else p3[:, :, t:t + 1]


@pytest.mark.parametrize("arch_id", OTHER_DECODERS)
def test_family_decode_steps_equal_reference(arch_id):
    """16 teacher-forced ``decode_step``s against the reference's, M-RoPE
    positions passed through for qwen2-vl: logits every step (tolerance as
    in the module docstring), greedy tokens equal, and the SSM and RG-LRU
    states (float32) at 1e-5."""
    cfg, jcfg, tree, model = _both(arch_id)
    batch = _batch(cfg, 2, 16, seed=6)
    toks = batch["tokens"]
    jparams = jax.tree.map(jnp.asarray, tree)
    cache = tf.init_cache(cfg, 2, 20, device="cpu")
    jcache = jtf.init_cache(jcfg, 2, 20)
    tol = _DecodeTol(cfg)
    for t in range(16):
        p3 = _p3(batch, t)
        logits, cache = tf.decode_step(model, cache,
                                       torch.from_numpy(toks[:, t]), t, cfg,
                                       p3)
        jlogits, jcache = jtf.decode_step(
            jparams, jcache, jnp.asarray(toks[:, t]), jnp.int32(t), jcfg,
            None if p3 is None else jnp.asarray(p3))
        got = logits[:, :cfg.vocab_size].float().numpy()
        want = np.asarray(jlogits[:, :cfg.vocab_size], np.float32)
        assert tuple(logits.shape) == (2, cfg.padded_vocab)
        _close(got, want, **tol(cache, jcache))
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(jcache)):
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.float32:
            _close(a, b)


@pytest.mark.parametrize("arch_id", OTHERS)
def test_family_prefill_equals_reference(arch_id):
    cfg, jcfg, tree, model = _both(arch_id)
    batch = _batch(cfg, 2, 12, seed=7)
    last, cache = tf.prefill(model, batch, cfg, max_len=16)
    jlast, jcache = jtf.prefill(jax.tree.map(jnp.asarray, tree),
                                _jbatch(batch), jcfg, 16)
    _close(last[:, :cfg.vocab_size], jlast[:, :cfg.vocab_size])
    got, want = jax.tree.leaves(cache), jax.tree.leaves(jcache)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, cache)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jcache))
    assert [tuple(a.shape) for a in got] == [b.shape for b in want]
    assert not any(a.any() for a in got)
    _close(make_prefill(cfg)(model, batch)[:, -1], last)


@pytest.mark.parametrize("arch_id", OTHER_DECODERS)
def test_family_serve_step_greedy_tokens_equal_reference(arch_id):
    """``make_serve_step`` (positions3 passed through) against the
    reference's jitted serve step: the same 4 greedy tokens."""
    cfg, jcfg, tree, model = _both(arch_id)
    serve = make_serve_step(cfg)
    jserve = jax.jit(jmake_serve_step(jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    jcache = jtf.init_cache(jcfg, 2, 16)
    tok = torch.zeros((2,), dtype=torch.int32)
    jtok = jnp.zeros((2,), jnp.int32)
    for t in range(4):
        p3 = np.full((3, 2, 1), t, np.int32) if cfg.mrope else None
        logits, cache = serve(model, cache, tok, t, p3)
        jlogits, jcache = jserve(jparams, jcache, jtok, jnp.int32(t),
                                 None if p3 is None else jnp.asarray(p3))
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1).to(torch.int32)
        jtok = jnp.argmax(jlogits[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch_id", OTHERS)
def test_smoke_forward_and_shapes_every_family(arch_id):
    """``tests/test_models.py::test_smoke_forward_and_shapes`` over the
    port's own seeded init, every family."""
    cfg = get_arch(arch_id, smoke=True)
    model = tf.init_params(cfg, _gen(0), device="cpu")
    batch = _batch(cfg, 2, 32, seed=0)
    logits, aux = tf.forward_train(model, batch, cfg)
    assert tuple(logits.shape) == (2, 32, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    loss, (nll, _) = tf.loss_fn(model, batch, cfg)
    assert np.isfinite(float(loss))
    # random init -> loss near ln(V)
    assert abs(float(nll) - np.log(cfg.vocab_size)) < 1.5


@pytest.mark.parametrize("arch_id", OTHER_DECODERS)
def test_smoke_decode_step_every_family(arch_id):
    """``tests/test_models.py::test_smoke_decode_step`` over the port."""
    cfg = get_arch(arch_id, smoke=True)
    model = tf.init_params(cfg, _gen(0), device="cpu")
    cache = tf.init_cache(cfg, 2, 64, device="cpu")
    p3 = torch.zeros((3, 2, 1), dtype=torch.int32) if cfg.mrope else None
    logits, new_cache = tf.decode_step(
        model, cache, torch.zeros((2,), dtype=torch.int32), 3, cfg, p3)
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    assert torch.isfinite(logits[:, :cfg.vocab_size].float()).all()
    assert new_cache is cache
    assert jax.tree.structure(jax.tree.map(lambda a: 0, new_cache)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jtf.init_cache(
            jget_arch(arch_id, smoke=True), 2, 64)))


@pytest.mark.parametrize("arch_id", ["mamba2-370m", "recurrentgemma-9b"])
def test_prefill_decode_consistency_recurrent(arch_id):
    """``tests/test_models.py::test_prefill_decode_consistency`` for the
    SSM and the hybrid: teacher-forced decode (the chunked SSD scan and the
    RG-LRU scan against their one-token steps) reproduces the training
    forward's logits within the reference test's 2e-2."""
    cfg = dataclasses.replace(get_arch(arch_id, smoke=True),
                              q_chunk=8, kv_chunk=8)
    model = tf.init_params(cfg, _gen(0), device="cpu")
    B, T = 1, 16
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, T))
    batch = {"tokens": toks, "labels": toks,
             "positions": np.tile(np.arange(T)[None], (B, 1))}
    full, _ = tf.forward_train(model, batch, cfg)
    cache = tf.init_cache(cfg, B, T, device="cpu")
    outs = []
    for t in range(T):
        logits, cache = tf.decode_step(model, cache,
                                       torch.from_numpy(toks[:, t]), t, cfg)
        outs.append(logits)
    dec = torch.stack(outs, dim=1)
    _close(full[..., :cfg.vocab_size], dec[..., :cfg.vocab_size],
           atol=2e-2, rtol=2e-2)


def test_hybrid_decode_past_the_window_equals_reference():
    """recurrentgemma's local attention decodes through a ring of
    ``min(max_len, window)`` = 16 slots, written at ``pos % 16`` and read
    over ``min(pos + 1, 16)`` of them: 24 steps overwrite half of it.
    Every step's logits equal the reference's, and the ring decode equals
    the windowed training forward (2e-2, the reference test's bound)."""
    cfg, jcfg, tree, model = _both("recurrentgemma-9b")
    assert cfg.window == 16
    B, T = 2, 24
    toks = _batch(cfg, B, T, seed=8)["tokens"]
    jparams = jax.tree.map(jnp.asarray, tree)
    cache = tf.init_cache(cfg, B, 32, device="cpu")
    jcache = jtf.init_cache(jcfg, B, 32)
    assert cache["blocks"]["pos2_attn"]["k"].shape[2] == 16
    tol = _DecodeTol(cfg)
    outs = []
    for t in range(T):
        logits, cache = tf.decode_step(model, cache,
                                       torch.from_numpy(toks[:, t]), t, cfg)
        jlogits, jcache = jtf.decode_step(jparams, jcache,
                                          jnp.asarray(toks[:, t]),
                                          jnp.int32(t), jcfg)
        _close(logits[:, :cfg.vocab_size], jlogits[:, :cfg.vocab_size],
               **tol(cache, jcache))
        outs.append(logits)
    full, _ = tf.forward_train(model, {"tokens": toks}, cfg)
    _close(full[..., :cfg.vocab_size],
           torch.stack(outs, 1)[..., :cfg.vocab_size], atol=2e-2, rtol=2e-2)


F32_ARCHS = [a for a in ARCH_IDS if get_arch(a).param_dtype == "float32"]


@pytest.mark.parametrize("arch_id", F32_ARCHS)
def test_bf16_activations_equal_reference(arch_id):
    """``activation_dtype="bfloat16"`` on float32 parameters: each layer
    reads its weights in bf16 (the router stays float32), against the
    reference's forward at a bf16 tolerance. The port rounds each op to
    bf16 as the reference's ops do one by one (``layers.silu``,
    ``rglru._gelu``); the reference's compiled forward (a ``lax.scan``)
    fuses elementwise ops and keeps some intermediates in float32, one bf16
    step off its own op-by-op result in ~40% of a layer's elements, and
    float32 sums that differ in the last bit flip other roundings. Measured
    over three seeds: at most 0.035 apart at |logit| < 4.1 (a bf16 step
    there is 2^-6 to 2^-5), 0.005 on average; so logits are held at 2^-4
    and their mean difference at 2^-7. recurrentgemma at 2^-3 and 2^-5: its
    gates' sigmoid, exp and softplus differ from XLA's in the last bits and
    the bf16 scan output rounds them apart, 0.11 at most (0.014 on
    average). The MoE's aux loss at 2^-6 (its router reads the bf16
    activations: 0.6% apart)."""
    cfg, jcfg = (dataclasses.replace(c, activation_dtype="bfloat16")
                 for c in (get_arch(arch_id, smoke=True),
                           jget_arch(arch_id, smoke=True)))
    tree = _ref_tree(jcfg)
    model = tf.params_from_jax(tree, cfg, "cpu")
    batch = _batch(cfg, 2, 20, seed=9)
    logits, aux = tf.forward_train(model, batch, cfg)
    jlogits, jaux = jtf.forward_train(jax.tree.map(jnp.asarray, tree),
                                      _jbatch(batch), jcfg)
    assert logits.dtype == torch.float32    # the float32 unembed promotes
    got = logits[..., :cfg.vocab_size].numpy()
    want = np.asarray(jlogits[..., :cfg.vocab_size])
    tol, mean = (2.0 ** -3, 2.0 ** -5) if arch_id == "recurrentgemma-9b" \
        else (2.0 ** -4, 2.0 ** -7)
    _close(got, want, rtol=tol, atol=tol)
    assert np.abs(got - want).mean() <= mean
    _close(aux, jaux, rtol=2.0 ** -6, atol=1e-6)


def test_bf16_silu_rounds_each_op_as_the_reference():
    """Below float32 the port's silu is the reference's ``x * (1 / (1 +
    exp(-x)))`` op by op, each rounded to bf16: equal bit for bit to
    ``jax.nn.silu`` (torch's fused silu rounds once and differs in a
    quarter of the elements)."""
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(4096)
                         .astype(np.float32)).to(torch.bfloat16)
    want = np.asarray(jax.nn.silu(jnp.asarray(x.float().numpy(),
                                              jnp.bfloat16)), np.float32)
    assert (torch.nn.functional.silu(x).float().numpy() != want).mean() > 0.1
    got = tl.silu(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
