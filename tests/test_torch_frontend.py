"""The port's input specs (``repro_torch.models.frontend``) against the
reference's (``repro.models.frontend``): for every arch x shape the same
inputs with the same shapes and dtypes, and ``cache_specs`` the same
pytree as the reference's ``jax.eval_shape(init_cache)``. The port's
stand-ins are tensors on the ``meta`` device (no storage), so the
full-size shapes (a 32k-token cache at batch 128) cost nothing here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import get_arch as jget_arch
from repro.models import frontend as jfe
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.models import frontend as fe
from repro_torch.models import transformer as tf

# six test workers share the host's cores
torch.set_num_threads(1)


def _sig(tree):
    """{path: (shape, dtype name)} of a pytree of tensors or arrays."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return tuple(a.shape), str(a.dtype).removeprefix("torch.")
        return tuple(a.shape), np.dtype(a.dtype).name
    return {jax.tree_util.keystr(p): one(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_input_specs_equal_reference(arch_id, shape):
    arch, jarch = get_arch(arch_id), jget_arch(arch_id)
    got = fe.train_input_specs(arch, SHAPES[shape])
    assert all(t.device.type == "meta" for t in got.values())
    assert _sig(got) == _sig(jfe.train_input_specs(jarch, JSHAPES[shape]))
    assert _sig(fe.decode_input_specs(arch, SHAPES[shape])) == _sig(
        jfe.decode_input_specs(jarch, JSHAPES[shape]))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_cache_specs_equal_reference(arch_id, shape):
    arch, jarch = get_arch(arch_id), jget_arch(arch_id)
    s = SHAPES[shape]
    got = fe.cache_specs(arch, s.global_batch, s.seq_len)
    want = jfe.cache_specs(jarch, s.global_batch, s.seq_len)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(got))
    assert _sig(got) == _sig(want)
    # the port's init_cache is that tree, with storage
    if arch.is_decoder:
        small = tf.init_cache(get_arch(arch_id, smoke=True), 2, 20,
                              device="cpu")
        jsmall = jax.eval_shape(lambda: jfe.cache_specs(
            jget_arch(arch_id, smoke=True), 2, 20))
        assert _sig(small) == _sig(jsmall)
        assert not any(t.any() for t in jax.tree.leaves(small))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_make_train_batch_matches_reference_specs(arch_id):
    arch = get_arch(arch_id, smoke=True)
    jarch = jget_arch(arch_id, smoke=True)
    batch = fe.make_train_batch(arch, 2, 8, torch.Generator().manual_seed(0))
    want = jfe.make_train_batch(jarch, 2, 8, jax.random.PRNGKey(0))
    assert _sig(batch) == _sig(want)
    again = fe.make_train_batch(arch, 2, 8, torch.Generator().manual_seed(0))
    for k in batch:
        assert torch.equal(batch[k], again[k])
    if arch.embed_inputs:
        assert ((batch["tokens"] >= 0)
                & (batch["tokens"] < arch.vocab_size)).all()
    # the model takes it as it comes
    model = tf.init_params(arch, torch.Generator().manual_seed(1),
                           device="cpu")
    logits, _ = tf.forward_train(model, batch, arch)
    assert tuple(logits.shape) == (2, 8, arch.padded_vocab)
    assert jnp.isfinite(jnp.asarray(logits[..., :arch.vocab_size].numpy())).all()
