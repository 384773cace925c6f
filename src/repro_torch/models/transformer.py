"""Composable LM assembled from an ArchConfig: ``repro.models.transformer``
in PyTorch, for the whole zoo:

  dense / moe (+ dense_residual)  : pre-norm attention + (MLP | MoE)
  ssm                             : mamba2 mixer blocks (attention-free)
  hybrid                          : Griffin pattern (rec, rec, attn) blocks
  audio                           : encoder-only, inputs are frame embeddings
  vlm                             : dense + M-RoPE (+ stubbed patch embeds)

A model is a :class:`Transformer` module: ``embed`` (or
``in_proj_frontend`` where the inputs are frame embeddings), ``unembed``
unless the embeddings are tied, ``final.scale``, and either ``layers`` (one
layer module each) or, for the hybrid, ``blocks`` (one list of layers per
position of the block pattern, named ``pos{i}_{kind}``) and ``tail``
(``tail{i}_{kind}``). Each layer's parameters carry the reference's leaf
names (``scale``, ``attn.wq``, ``moe.router``, ``ssm.A_log``,
``rec.rg_in``, ``mlp.w_gate``, ...). The reference stacks layers along a
leading axis for ``lax.scan``; the port keeps one module a layer and loops
over them, and ``params_from_jax`` / ``params_to_numpy`` convert between
the two.

Three entry points, as in the reference: ``forward_train`` (logits + aux),
``prefill`` (logits at the last position + a cache) and ``decode_step``
(one token). ``decode_step`` writes the new token's state into the cache in
place (the reference returns a new cache; the port saves the copy) and
returns the same cache object. The attention cache is bfloat16, as the
reference's: k and v are rounded on write and upcast in the attention
products; the SSM and RG-LRU states are float32.

Where ``activation_dtype`` differs from ``param_dtype``, the forward reads
each layer's weights in the activation dtype (the router stays float32),
as the reference's ``_cast_layer_params`` does; the port casts each weight
as a product reads it, never a whole layer at once (one full-width
kimi-k2 layer's experts are 33.8 GB in bfloat16). ``decode_step`` casts
nothing, as the reference's. ``forward_train(rules=)`` runs on a model
whose parameters are DTensors (``train.step.shard_train_state``): the
activations are held to batch-over-dp at the embedding output and at every
layer boundary, as the reference constrains them.

``forward_train`` is differentiable: a training model's parameters carry
``requires_grad`` (``repro_torch.train.step.init_train_state``), a serving
model's do not, so serving builds no graph. While a graph is built each
layer (the hybrid: each block) runs under the config's ``remat`` policy, as
the reference's ``_remat``: ``"full"`` recomputes the layer in the backward
pass, ``"dots"`` keeps the weight products' outputs (``aten.mm``: a 3-D by
2-D ``@`` folds to it) and recomputes the rest, the batched attention
products (``aten.bmm``) included, as ``checkpoint_dots_with_no_batch_dims``
does. ``Transformer.param_tree`` gives a model's parameters in the
reference's tree, each layer-stacked leaf a :class:`repro_torch.tree.Stack`.
"""
from __future__ import annotations

import functools
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.context import act_shard, current_rules, use_rules
from repro_torch.models.layers import (
    attention_out,
    attention_qkv,
    blockwise_attention,
    decode_attention,
    dense,
    dense_init,
    gated_mlp,
    init_attention,
    init_mlp,
    pairscan_attention,
    rms_norm,
)
from repro_torch.models.sharding import contiguous_stride
from repro_torch.tree import Stack

FRONTEND_DIM = 512  # stubbed modality frontends emit this width

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def to_tensor(a, device=None) -> torch.Tensor:
    """A numpy array (``ml_dtypes.bfloat16`` included, as
    ``np.asarray`` of a JAX array gives it) or tensor as a torch tensor on
    ``device``, bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.to(device) if device is not None else a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device) if device is not None else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The inverse of ``to_tensor``: bfloat16 comes back as
    ``ml_dtypes.bfloat16``; a DTensor as its full value."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# ------------------------------------------------------------------ params --
class _Layer(nn.Module):
    """One layer's parameters under the reference's names: its norm scales
    as parameters, each group (``attn``, ``mlp``, ``moe``, ``ssm``,
    ``rec``) as a ``ParameterDict``."""

    def __init__(self, tensors: dict):
        super().__init__()
        self._names = tuple(tensors)
        for name, v in tensors.items():
            if isinstance(v, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: nn.Parameter(t, requires_grad=False)
                     for k, t in v.items()}))
            else:
                setattr(self, name, nn.Parameter(v, requires_grad=False))

    def params(self) -> dict:
        """The layer's tensors as the reference's nested dict."""
        out = {}
        for name in self._names:
            v = getattr(self, name)
            out[name] = dict(v) if isinstance(v, nn.ParameterDict) else v
        return out


class DenseLayer(_Layer):
    """Pre-norm attention + gated MLP: ``scale``, ``attn.*``, ``scale2``,
    ``mlp.*`` (the dense, audio and VLM families, the hybrid's ``attn``)."""


class MoELayer(_Layer):
    """Pre-norm attention + MoE: ``scale``, ``attn.*``, ``scale2``,
    ``moe.router`` (float32) / ``we_gate`` / ``we_up`` / ``we_down``, plus
    ``mlp.*`` when the config has a dense residual (arctic)."""


class SSMLayer(_Layer):
    """Pre-norm mamba2 mixer: ``scale``, ``ssm.*``."""


class RecLayer(_Layer):
    """Pre-norm Griffin recurrent block + gated MLP: ``scale``, ``rec.*``,
    ``scale2``, ``mlp.*``."""


def _layer_class(cfg: ArchConfig, kind: str) -> type:
    if kind == "ssm":
        return SSMLayer
    if kind == "rec":
        return RecLayer
    return MoELayer if cfg.family == "moe" else DenseLayer


def hybrid_layout(cfg: ArchConfig) -> tuple[int, tuple[str, ...], tuple[str, ...]]:
    """(#full blocks, block pattern, tail pattern) covering num_layers."""
    pat = cfg.block_pattern
    nb = (cfg.num_layers - len(cfg.tail_pattern)) // len(pat)
    used = nb * len(pat) + len(cfg.tail_pattern)
    assert used == cfg.num_layers, (used, cfg.num_layers)
    return nb, pat, cfg.tail_pattern


def _layer_kind(cfg: ArchConfig) -> str:
    """The kind of every layer of a non-hybrid config."""
    return "ssm" if cfg.family == "ssm" else "dense"


class Transformer(nn.Module):
    """A model's parameters; see the module docstring for the layout."""

    def __init__(self, cfg: ArchConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg

        def param(name):
            t = tensors.get(name)
            return None if t is None else nn.Parameter(t, requires_grad=False)

        self.embed = param("embed")
        self.in_proj_frontend = param("in_proj_frontend")
        self.unembed = param("unembed")
        self.final = nn.ParameterDict(
            {"scale": nn.Parameter(tensors["final"]["scale"],
                                   requires_grad=False)})
        self.layers = self.blocks = self.tail = None
        if cfg.family == "hybrid":
            self.blocks = nn.ModuleDict({
                name: nn.ModuleList(_layer_class(cfg, name.split("_")[-1])(t)
                                    for t in stack)
                for name, stack in tensors["blocks"].items()})
            self.tail = nn.ModuleDict({
                name: _layer_class(cfg, name.split("_")[-1])(t)
                for name, t in tensors["tail"].items()})
        else:
            cls = _layer_class(cfg, _layer_kind(cfg))
            self.layers = nn.ModuleList(cls(t) for t in tensors["layers"])

    @property
    def device(self) -> torch.device:
        return self.final["scale"].device

    def param_tree(self) -> dict:
        """The parameters (the tensors themselves) in the reference's tree:
        nested dicts under the reference's names, each leaf that the
        reference stacks over layers (or the hybrid's blocks) a
        :class:`~repro_torch.tree.Stack` of the port's per-layer tensors."""
        out = {"final": {"scale": self.final["scale"]}}
        for name in ("embed", "in_proj_frontend", "unembed"):
            p = getattr(self, name)
            if p is not None:
                out[name] = p
        if self.layers is not None:
            out["layers"] = _stack_params([layer.params()
                                           for layer in self.layers])
        else:
            out["blocks"] = {name: _stack_params([layer.params()
                                                  for layer in stack])
                             for name, stack in self.blocks.items()}
            out["tail"] = {name: layer.params()
                           for name, layer in self.tail.items()}
        return out


def _init_dense_layer(generator, cfg, dtype, device) -> dict:
    p = {
        "scale": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attention(generator, cfg, dtype, device),
        "scale2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(generator, cfg, dtype, device)
        if cfg.dense_residual:
            p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                                cfg.num_layers, device)
    else:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                            cfg.num_layers, device)
    return p


def _init_ssm_layer(generator, cfg, dtype, device) -> dict:
    return {
        "scale": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ssm": ssm_mod.init_ssm(generator, cfg, dtype, device),
    }


def _init_rec_layer(generator, cfg, dtype, device) -> dict:
    return {
        "scale": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "rec": rg_mod.init_rglru(generator, cfg, dtype, device),
        "scale2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                        cfg.num_layers, device),
    }


_INIT = {"dense": _init_dense_layer, "attn": _init_dense_layer,
         "ssm": _init_ssm_layer, "rec": _init_rec_layer}


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device: str | torch.device = "cuda") -> Transformer:
    """A randomly initialised model on ``device``, drawn from ``generator``
    (on its own device; a CPU generator gives the same weights on any
    device). The reference's shapes, scales and dtypes; not its bits, which
    come from ``jax.random`` (``params_from_jax`` carries those across)."""
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    vpad = cfg.padded_vocab
    tensors: dict = {"final": {"scale": torch.ones(
        (cfg.d_model,), dtype=dtype, device=device)}}
    if cfg.embed_inputs:
        tensors["embed"] = dense_init(generator, (vpad, cfg.d_model), 1,
                                      dtype, device)
    else:
        tensors["in_proj_frontend"] = dense_init(
            generator, (FRONTEND_DIM, cfg.d_model), 0, dtype, device)
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        tensors["unembed"] = dense_init(generator, (cfg.d_model, vpad), 0,
                                        dtype, device)
    if cfg.family == "hybrid":
        nb, pat, tail = hybrid_layout(cfg)
        tensors["blocks"] = {
            f"pos{i}_{kind}": [_INIT[kind](generator, cfg, dtype, device)
                               for _ in range(nb)]
            for i, kind in enumerate(pat)}
        tensors["tail"] = {
            f"tail{i}_{kind}": _INIT[kind](generator, cfg, dtype, device)
            for i, kind in enumerate(tail)}
    else:
        kind = _layer_kind(cfg)
        tensors["layers"] = [_INIT[kind](generator, cfg, dtype, device)
                             for _ in range(cfg.num_layers)]
    return Transformer(cfg, tensors)


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, n: int, what: str) -> list:
    """A pytree stacked along a leading axis of ``n`` as ``n`` pytrees."""
    got = int(np.shape(next(iter(_leaves(tree))))[0])
    if got != n:
        raise ValueError(f"tree has {got} {what}, config {n}")
    return [_map(lambda a, i=i: a[i], tree) for i in range(n)]


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def params_from_jax(tree: dict, cfg: ArchConfig, device="cuda") -> Transformer:
    """The port's model from the reference's ``init_params(cfg, key)``
    pytree given as numpy arrays (``jax.tree.map(np.asarray, params)``):
    the stacked leading axis of ``layers`` (and, for the hybrid, of each
    ``blocks`` entry) is split into one layer module each. Every value is
    copied bit for bit, bfloat16 included."""
    from repro_torch.device import resolve_device

    device = resolve_device(device)

    def t(a):
        return to_tensor(a, device)

    tensors = {"final": {"scale": t(tree["final"]["scale"])}}
    for name in ("embed", "in_proj_frontend", "unembed"):
        if name in tree:
            tensors[name] = t(tree[name])
    if cfg.family == "hybrid":
        nb, _, _ = hybrid_layout(cfg)
        tensors["blocks"] = {
            name: [_map(t, p) for p in _unstack(stack, nb, "blocks")]
            for name, stack in tree["blocks"].items()}
        tensors["tail"] = {name: _map(t, p)
                           for name, p in tree["tail"].items()}
    else:
        tensors["layers"] = [_map(t, p) for p in _unstack(
            tree["layers"], cfg.num_layers, "layers")]
    return Transformer(cfg, tensors)


def params_to_numpy(model: Transformer) -> dict:
    """The inverse of ``params_from_jax``: the reference's pytree (nested
    dicts, layers stacked along a leading axis) of numpy arrays."""
    out = {"final": {"scale": to_numpy(model.final["scale"])}}
    for name in ("embed", "in_proj_frontend", "unembed"):
        p = getattr(model, name)
        if p is not None:
            out[name] = to_numpy(p)
    if model.layers is not None:
        out["layers"] = _stack([_map(to_numpy, layer.params())
                                for layer in model.layers])
    else:
        out["blocks"] = {
            name: _stack([_map(to_numpy, layer.params()) for layer in stack])
            for name, stack in model.blocks.items()}
        out["tail"] = {name: _map(to_numpy, layer.params())
                       for name, layer in model.tail.items()}
    return out


def _stack_params(layers) -> dict:
    first = layers[0]
    if isinstance(first, Mapping):
        return {k: _stack_params([p[k] for p in layers]) for k in first}
    return Stack(layers)


def param_bytes(model: Transformer) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


# ------------------------------------------------------------- layer fns ----
class _Cast(Mapping):
    """A layer's parameters read in the compute dtype: each floating weight
    but the router is cast when it is read, so a product's weight lives in
    the activation dtype only while that product runs."""

    def __init__(self, p: Mapping, dtype: torch.dtype):
        self._p, self._dtype = p, dtype

    def __getitem__(self, key):
        v = self._p[key]
        if isinstance(v, Mapping):
            return _Cast(v, self._dtype)
        if key == "router" or not v.is_floating_point():
            return v
        return v.to(self._dtype)

    def __contains__(self, key):
        return key in self._p

    def __iter__(self):
        return iter(self._p)

    def __len__(self):
        return len(self._p)


def _cast_layer_params(p, cfg):
    """Compute-dtype view (the reference's bf16-activation lever): the
    router stays float32 for routing numerics; everything else follows
    ``activation_dtype``."""
    act = _dtype(cfg.activation_dtype)
    if act == _dtype(cfg.param_dtype):
        return p
    return _Cast(p, act)


def _zero(x) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_layer_fwd(p, x, cfg, positions, positions3):
    p = _cast_layer_params(p, cfg)
    xn = rms_norm(x, p["scale"], cfg.norm_eps)
    q, k, v = attention_qkv(p["attn"], xn, cfg, positions, positions3)
    window = cfg.window if cfg.family == "hybrid" else 0
    if cfg.attn_pairs and cfg.causal:
        attn = pairscan_attention(
            q, k, v, causal=True, window=window,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    else:
        attn = blockwise_attention(
            q, k, v, causal=cfg.causal, window=window,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            fwd_only=cfg.attn_fwd_only)
    x = x + _batch_layout(attention_out(p["attn"], attn))
    xn2 = rms_norm(x, p["scale2"], cfg.norm_eps)
    if cfg.family == "moe" and "moe" in p:
        ff = _batch_layout(moe_mod.moe_layer(p["moe"], xn2, cfg))
        aux = moe_mod.moe_aux_loss(p["moe"], xn2, cfg)
        if cfg.dense_residual:
            ff = ff + _batch_layout(gated_mlp(p["mlp"], xn2))
    else:
        ff = _batch_layout(gated_mlp(p["mlp"], xn2))
        aux = _zero(x)
    return x + ff, aux


def _ssm_layer_fwd(p, x, cfg):
    p = _cast_layer_params(p, cfg)
    xn = rms_norm(x, p["scale"], cfg.norm_eps)
    out, _ = ssm_mod.ssm_forward(p["ssm"], xn, cfg)
    return x + _batch_layout(out), _zero(x)


def _rec_layer_fwd(p, x, cfg):
    p = _cast_layer_params(p, cfg)
    xn = rms_norm(x, p["scale"], cfg.norm_eps)
    out, _ = rg_mod.recurrent_block(p["rec"], xn, cfg)
    x = x + _batch_layout(out)
    xn2 = rms_norm(x, p["scale2"], cfg.norm_eps)
    return x + _batch_layout(gated_mlp(p["mlp"], xn2)), _zero(x)


def _batch_layout(y):
    """A sub-block's output, under rules, in the residual stream's layout
    (batch over dp, the rest whole) before it is added: a row-parallel
    product's partial sums are all-reduced there rather than scattered over
    the sequence."""
    return act_shard(y, "dp", None, None)


def _layer_fwd(kind, layer, x, cfg, positions, positions3):
    p = layer.params()
    if kind == "ssm":
        return _ssm_layer_fwd(p, x, cfg)
    if kind == "rec":
        return _rec_layer_fwd(p, x, cfg)
    return _dense_layer_fwd(p, x, cfg, positions, positions3)


def _save_weight_products(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``fn`` under ``cfg.remat`` (see the module docstring)."""
    if cfg.remat == "none":
        return fn
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: 'none', 'dots' or 'full'")

    def run(*args):
        # the backward pass recomputes outside forward_train's context:
        # the recomputation runs under the rules the forward ran under
        rules = current_rules()

        def body(*a):
            with use_rules(rules):
                return fn(*a)

        return checkpoint(body, *args, use_reentrant=False, **kw)

    return run


def _matmul(x, w):
    """``x @ w`` in the promoted dtype, as ``jnp.matmul`` promotes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return dense(x.to(dt), w.to(dt))


# ------------------------------------------------------------ forward (train)
def embed_inputs(model: Transformer, batch: dict, cfg: ArchConfig):
    if cfg.embed_inputs:
        tokens = torch.as_tensor(batch["tokens"], device=model.device).long()
        x = _lookup(model.embed, tokens)
    else:
        w = model.in_proj_frontend
        x = dense(to_tensor(batch["embeds"], model.device).to(w.dtype), w)
    return x.to(_dtype(cfg.activation_dtype))


def _lookup(embed, tokens):
    """``embed[tokens]``. For a DTensor table each device looks up its own
    block, as a vocab-parallel embedding does: the table is gathered over
    the mesh dims that shard the tokens (FSDP's all-gather) and kept
    vocab-sharded over the others, where each device contributes the rows
    its block holds (zeros elsewhere) and the partial sums add."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(embed, DTensor):
        return embed[tokens]
    mesh = embed.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    tp = tuple(tokens.placements)
    batch = {j for j, p in enumerate(tp) if isinstance(p, Shard)}
    w_pl = tuple(Shard(0) if j not in batch and isinstance(p, Shard)
                 and p.dim == 0 else Replicate()
                 for j, p in enumerate(embed.placements))
    vocab = {j for j, p in enumerate(w_pl) if isinstance(p, Shard)}
    w = embed if w_pl == tuple(embed.placements) else \
        embed.redistribute(mesh, w_pl)
    w_l = w.to_local(grad_placements=tuple(
        Partial() if j in batch else p for j, p in enumerate(w_pl)))
    ids = tokens.to_local()
    if vocab:
        from repro_torch.models.sharding import shard_range

        lo, n = shard_range(embed.shape[0], mesh, w_pl, 0)
        hit = (ids >= lo) & (ids < lo + n)
        out = torch.where(hit[..., None],
                          w_l[(ids - lo).clamp(0, max(n - 1, 0))], 0.0)
    else:
        out = w_l[ids]
    pl = tuple(tp[j] if j in batch else Partial() if j in vocab
               else Replicate() for j in range(mesh.ndim))
    shape = torch.Size((*tokens.shape, embed.shape[1]))
    return DTensor.from_local(
        out, mesh, pl, run_check=False, shape=shape,
        stride=contiguous_stride(shape))


def unembed(model: Transformer, x, cfg: ArchConfig):
    logits = _matmul(x, model.unembed if model.unembed is not None
                     else model.embed.T)
    if cfg.padded_vocab != cfg.vocab_size:
        cols = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(cols < cfg.vocab_size, logits, -1e30)
    return logits


def forward_train(model: Transformer, batch: dict, cfg: ArchConfig,
                  rules=None):
    """batch: tokens (B,T) [or embeds (B,T,F)], optional positions (B,T),
    optional positions3 (3,B,T). Returns (logits (B, T, V_pad), aux_loss):
    aux is the MoE load-balancing loss summed over layers, 0 elsewhere.

    ``rules`` (``models.sharding.Rules``) pins activation layouts: batch
    over 'dp' at the embed output and at every layer boundary."""
    constrain = ((lambda t: rules.shard(t, "dp", None, None))
                 if rules is not None else (lambda t: t))
    with use_rules(rules):
        x = constrain(embed_inputs(model, batch, cfg))
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None]
            positions = positions.expand(x.shape[0], x.shape[1])
        else:
            positions = torch.as_tensor(positions, device=x.device)
        positions3 = batch.get("positions3")
        if positions3 is not None:
            positions3 = torch.as_tensor(positions3, device=x.device)

        def fwd(kind, layer, x):
            return _layer_fwd(kind, layer, x, cfg, positions, positions3)

        # remat only where a graph is built: a serving model's parameters
        # carry no gradient
        training = torch.is_grad_enabled() and model.final["scale"].requires_grad
        remat = (lambda fn: _remat(fn, cfg)) if training else (lambda fn: fn)
        aux = _zero(x)
        if cfg.family == "hybrid":
            nb, pat, _ = hybrid_layout(cfg)

            def block_fwd(x, j):
                aux = _zero(x)
                for i, kind in enumerate(pat):
                    x, a = fwd(kind, model.blocks[f"pos{i}_{kind}"][j], x)
                    aux = aux + a
                return x, aux

            block = remat(block_fwd)
            for j in range(nb):
                x, a = block(x, j)
                x = constrain(x)
                aux = aux + a
            for name, layer in model.tail.items():
                x, a = fwd(name.split("_")[-1], layer, x)
                aux = aux + a
        else:
            kind = _layer_kind(cfg)
            body = remat(lambda x, layer: fwd(kind, layer, x))
            for layer in model.layers:
                x, a = body(x, layer)
                x = constrain(x)
                aux = aux + a
        x = rms_norm(x, model.final["scale"], cfg.norm_eps)
        logits = unembed(model, x, cfg)
    return logits, aux


def loss_fn(model: Transformer, batch: dict, cfg: ArchConfig,
            aux_weight: float = 0.01, rules=None):
    with use_rules(rules):
        return _loss(model, batch, cfg, aux_weight, rules)


def _loss(model, batch, cfg, aux_weight, rules):
    logits, aux = forward_train(model, batch, cfg, rules=rules)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    if rules is None:
        gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    else:
        gold = _gold_sharded(logits, labels)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    else:
        mask = torch.as_tensor(mask, device=logits.device).to(torch.float32)
    nll = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll + aux_weight * aux, (nll, aux)


def _gold_sharded(logits, labels):
    """``take_along_dim(logits, labels)`` for DTensor logits whose vocab
    may be sharded: each device picks the labels that fall in its own
    vocab block (a masked row sum: one term, so exact) and the blocks'
    partial sums add over the vocab's mesh dims; the logits are never
    gathered."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models.sharding import shard_range, to_layout

    mesh, last = logits.device_mesh, logits.ndim - 1
    if any(isinstance(p, Partial) for p in logits.placements):
        logits = logits.redistribute(mesh, tuple(
            Replicate() if isinstance(p, Partial) else p
            for p in logits.placements))
    lp = tuple(logits.placements)
    rows = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                 else p for p in lp)
    labels = to_layout(labels, mesh, rows).to_local()
    lo, n = shard_range(logits.shape[-1], mesh, lp, last)
    hit = labels[..., None] == torch.arange(lo, lo + n, device=labels.device)
    gold = torch.where(hit, logits.to_local(), 0.0).sum(-1)
    out_pl = tuple(Partial() if isinstance(p, Shard) and p.dim == last else p
                   for p in lp)
    shape = logits.shape[:-1]
    return DTensor.from_local(
        gold, mesh, out_pl, run_check=False, shape=shape,
        stride=contiguous_stride(shape))


# --------------------------------------------------------------- serving ----
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> dict:
    """An empty cache, the reference's pytree: ``{"layers": ...}`` stacked
    over the layers, or for the hybrid ``{"blocks": {name: stacked over
    the blocks}, "tail": {name: ...}}``. An attention layer holds
    ``{"k", "v"}`` (B, S, KvH, hd) bfloat16, S = ``max_len``, or for the
    hybrid's local attention a ring of ``min(max_len, window)`` slots; an
    SSM layer ``{"conv", "ssd"}`` and a recurrent layer ``{"conv", "h"}``,
    float32."""
    hybrid = cfg.family == "hybrid"
    cache_len = min(max_len, cfg.window) if hybrid and cfg.window else max_len

    def zeros(lead, *shape, dtype=torch.float32):
        return torch.zeros((*lead, batch, *shape), dtype=dtype, device=device)

    def attn_c(lead):
        hd = cfg.resolved_head_dim
        S = cache_len if hybrid else max_len
        return {n: zeros(lead, S, cfg.num_kv_heads, hd, dtype=torch.bfloat16)
                for n in ("k", "v")}

    def ssm_c(lead):
        din, n = cfg.d_inner, cfg.ssm_state
        return {"conv": zeros(lead, cfg.conv_width - 1, din + 2 * n),
                "ssd": zeros(lead, cfg.ssm_heads, cfg.ssm_head_dim, n)}

    def rec_c(lead):
        w = cfg.rnn_width or cfg.d_model
        return {"conv": zeros(lead, cfg.conv_width - 1, w),
                "h": zeros(lead, w)}

    def make(kind, lead=()):
        return {"rec": rec_c, "ssm": ssm_c}.get(kind, attn_c)(lead)

    if hybrid:
        nb, pat, tail = hybrid_layout(cfg)
        return {"blocks": {f"pos{i}_{kind}": make(kind, (nb,))
                           for i, kind in enumerate(pat)},
                "tail": {f"tail{i}_{kind}": make(kind)
                         for i, kind in enumerate(tail)}}
    return {"layers": make(_layer_kind(cfg), (cfg.num_layers,))}


def _attn_decode(p, x1, cache, pos: int, cfg, positions3=None):
    """x1: (B, d); cache {'k', 'v'}: this layer's (B, S, KvH, hd), written
    in place at ``pos`` (at ``pos % S`` in the hybrid's ring)."""
    xn = rms_norm(x1[:, None, :], p["scale"], cfg.norm_eps)
    posb = torch.full((x1.shape[0], 1), pos, dtype=torch.int32,
                      device=x1.device)
    q, k, v = attention_qkv(p["attn"], xn, cfg, posb, positions3)
    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    ring = cfg.family == "hybrid" and cfg.window
    write = pos % S if ring else pos
    _write_slot(kc, write, k[:, 0])
    _write_slot(vc, write, v[:, 0])
    # the ring buffer already bounds the window
    clen = min(pos + 1, S) if ring else pos + 1
    attn = decode_attention(q[:, 0], kc, vc, clen)
    x1 = x1 + attention_out(p["attn"], attn[:, None])[:, 0]
    xn2 = rms_norm(x1[:, None, :], p["scale2"], cfg.norm_eps)[:, 0]
    if cfg.family == "moe" and "moe" in p:
        ff = moe_mod.moe_layer(p["moe"], xn2[:, None, :], cfg)[:, 0]
        if cfg.dense_residual:
            ff = ff + gated_mlp(p["mlp"], xn2)
    else:
        ff = gated_mlp(p["mlp"], xn2)
    return x1 + ff


def _write_slot(cache, pos: int, value) -> None:
    """``cache[:, pos] = value`` in the cache's dtype. For a DTensor cache
    (its sequence split over 'model', split-KV) the device that holds slot
    ``pos`` writes it into its own block, from the value summed and laid
    out as the cache's batch and heads first (a partial sum rounded to
    bfloat16 piece by piece would not be the sum's rounding)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(cache, DTensor):
        cache[:, pos] = value.to(cache.dtype)
        return
    from repro_torch.models.sharding import shard_range

    mesh = cache.device_mesh
    seq = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 1
                else Replicate() for p in cache.placements)
    rest = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
                 if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in cache.placements)
    value = value.redistribute(mesh, rest).to_local()
    start, length = shard_range(cache.shape[1], mesh, seq, 0)
    if start <= pos < start + length:
        cache.to_local()[:, pos - start] = value.to(cache.dtype)


def _store(cache: dict, new: dict) -> None:
    for name, t in new.items():
        cache[name].copy_(t)


def _ssm_decode(p, x1, cache, cfg):
    xn = rms_norm(x1[:, None, :], p["scale"], cfg.norm_eps)[:, 0]
    out, new = ssm_mod.ssm_decode_step(p["ssm"], xn, cfg, cache)
    _store(cache, new)
    return x1 + out


def _rec_decode(p, x1, cache, cfg):
    xn = rms_norm(x1[:, None, :], p["scale"], cfg.norm_eps)[:, 0]
    out, new = rg_mod.recurrent_block_step(p["rec"], xn, cfg, cache)
    _store(cache, new)
    x1 = x1 + out
    xn2 = rms_norm(x1[:, None, :], p["scale2"], cfg.norm_eps)[:, 0]
    return x1 + gated_mlp(p["mlp"], xn2)


def _layer_decode(kind, layer, x1, cache, pos, cfg, positions3):
    p = layer.params()
    if kind == "ssm":
        return _ssm_decode(p, x1, cache, cfg)
    if kind == "rec":
        return _rec_decode(p, x1, cache, cfg)
    return _attn_decode(p, x1, cache, pos, cfg, positions3)


def _slot(cache: dict, i: int) -> dict:
    """Layer ``i``'s views into a stacked cache."""
    return {name: t[i] for name, t in cache.items()}


def decode_step(model: Transformer, cache: dict, token, pos: int,
                cfg: ArchConfig, positions3=None):
    """One serving step: token (B,) int at position ``pos``; positions3
    (3, B, 1) for M-RoPE.

    Returns (logits (B, V_pad), cache): the cache is updated in place."""
    pos = int(pos)
    if cfg.family != "hybrid" and cfg.family != "ssm":
        S = cache["layers"]["k"].shape[2]
        if not 0 <= pos < S:
            raise ValueError(f"position {pos} outside the cache's "
                             f"{S} slots")
    with torch.no_grad():
        dev = model.device
        if positions3 is not None:
            positions3 = torch.as_tensor(positions3, device=dev)
        if cfg.embed_inputs:
            x1 = _lookup(model.embed, torch.as_tensor(token, device=dev).long())
        else:
            x1 = to_tensor(token, dev)
        if cfg.family == "hybrid":
            nb, pat, _ = hybrid_layout(cfg)
            for j in range(nb):
                for i, kind in enumerate(pat):
                    key = f"pos{i}_{kind}"
                    x1 = _layer_decode(kind, model.blocks[key][j], x1,
                                       _slot(cache["blocks"][key], j), pos,
                                       cfg, positions3)
            for name, layer in model.tail.items():
                x1 = _layer_decode(name.split("_")[-1], layer, x1,
                                   cache["tail"][name], pos, cfg, positions3)
        else:
            kind = _layer_kind(cfg)
            for i, layer in enumerate(model.layers):
                x1 = _layer_decode(kind, layer, x1,
                                   _slot(cache["layers"], i), pos, cfg,
                                   positions3)
        x1 = rms_norm(x1, model.final["scale"], cfg.norm_eps)
        logits = unembed(model, x1, cfg)
    return logits, cache


def prefill(model: Transformer, batch: dict, cfg: ArchConfig, max_len: int):
    """Run the full prompt, build a cache, return last-position logits.

    As in the reference, the cache comes back empty: a fused implementation
    would write it during the layer pass."""
    inputs = batch["tokens"] if cfg.embed_inputs else batch["embeds"]
    B = inputs.shape[0]
    logits, _ = forward_train(model, batch, cfg)
    cache = init_cache(cfg, B, max_len, device=model.device)
    return logits[:, -1], cache
