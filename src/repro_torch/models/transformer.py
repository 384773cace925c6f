"""The dense decoder assembled from an ArchConfig: the dense path of
``repro.models.transformer``, in PyTorch.

A model is a :class:`Transformer` module: ``embed``, ``unembed``,
``final.scale`` and ``layers``, a list of :class:`DenseLayer`s whose
parameters carry the reference's leaf names (``scale``,
``attn.wq``/``wk``/``wv``/``wo``, ``scale2``, ``mlp.w_gate``/``w_up``/
``w_down``). The reference stacks its layers along a leading axis for
``lax.scan``; the port keeps one module a layer and loops over them, and
``params_from_jax`` / ``params_to_numpy`` convert between the two.

Three entry points, as in the reference: ``forward_train`` (logits + aux),
``prefill`` (logits at the last position + a cache) and ``decode_step``
(one token). ``decode_step`` writes the new token's k and v into the cache
in place (the reference returns a new cache; the port saves the copy) and
returns the same cache object. The cache is bfloat16, as the reference's:
k and v are rounded on write and upcast in the attention products.

Only ``family="dense"`` runs here. The MoE, SSM, hybrid, audio and VLM
families (and ``attn_pairs``, M-RoPE) raise ``NotImplementedError``: they
come with ROADMAP A13b. Sharding rules come with A13d, and gradient
checkpointing (``remat``) with training, A13c.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    attention_out,
    attention_qkv,
    blockwise_attention,
    decode_attention,
    dense_init,
    gated_mlp,
    init_attention,
    init_mlp,
    rms_norm,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            "A13b: the MoE, SSM, hybrid, audio and VLM families); the port "
            "runs family='dense'")
    if cfg.attn_pairs or cfg.mrope or not cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: attn_pairs, mrope and frontend inputs are not "
            "ported yet (ROADMAP A13b)")
    if cfg.activation_dtype != cfg.param_dtype:
        raise NotImplementedError(
            f"{cfg.name}: activations in another dtype than the parameters "
            "(the reference's bf16-activation lever) are not ported yet "
            "(ROADMAP A13c)")


# ------------------------------------------------------------------ params --
class DenseLayer(nn.Module):
    """Pre-norm attention + gated MLP; the reference's dense layer params."""

    def __init__(self, tensors: dict):
        super().__init__()
        self.scale = nn.Parameter(tensors["scale"], requires_grad=False)
        self.attn = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in tensors["attn"].items()})
        self.scale2 = nn.Parameter(tensors["scale2"], requires_grad=False)
        self.mlp = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in tensors["mlp"].items()})


class Transformer(nn.Module):
    """The dense decoder's parameters: ``embed`` (V_pad, d), ``unembed``
    (d, V_pad) unless the embeddings are tied, ``final.scale`` and one
    :class:`DenseLayer` per layer."""

    def __init__(self, cfg: ArchConfig, tensors: dict):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(tensors["embed"], requires_grad=False)
        if "unembed" in tensors:
            self.unembed = nn.Parameter(tensors["unembed"],
                                        requires_grad=False)
        else:
            self.unembed = None
        self.final = nn.ParameterDict(
            {"scale": nn.Parameter(tensors["final"]["scale"],
                                   requires_grad=False)})
        self.layers = nn.ModuleList(DenseLayer(t) for t in tensors["layers"])

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _init_dense_layer(generator, cfg, dtype, device) -> dict:
    return {
        "scale": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attention(generator, cfg, dtype, device),
        "scale2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                        cfg.num_layers, device),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device: str | torch.device = "cuda") -> Transformer:
    """A randomly initialised model on ``device``, drawn from ``generator``
    (on its own device; a CPU generator gives the same weights on any
    device). The reference's shapes, scales and dtypes; not its bits, which
    come from ``jax.random`` (``params_from_jax`` carries those across)."""
    from repro_torch.device import resolve_device

    _require_dense(cfg)
    device = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    vpad = cfg.padded_vocab
    tensors: dict = {
        "final": {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                      device=device)},
        "embed": dense_init(generator, (vpad, cfg.d_model), 1, dtype, device),
    }
    if not cfg.tie_embeddings:
        tensors["unembed"] = dense_init(generator, (cfg.d_model, vpad), 0,
                                        dtype, device)
    tensors["layers"] = [_init_dense_layer(generator, cfg, dtype, device)
                         for _ in range(cfg.num_layers)]
    return Transformer(cfg, tensors)


def _layer_dict(layer: DenseLayer) -> dict:
    return {"scale": layer.scale, "attn": dict(layer.attn),
            "scale2": layer.scale2, "mlp": dict(layer.mlp)}


def params_from_jax(tree: dict, cfg: ArchConfig, device="cuda") -> Transformer:
    """The port's model from the reference's ``init_params(cfg, key)``
    pytree given as numpy arrays (``jax.tree.map(np.asarray, params)``):
    the stacked leading ``(L, ...)`` axis of ``params["layers"]`` is split
    into one :class:`DenseLayer` each. Every value is copied bit for bit."""
    from repro_torch.device import resolve_device

    _require_dense(cfg)
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    stacked = tree["layers"]
    n = int(np.shape(stacked["scale"])[0])
    if n != cfg.num_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.num_layers}")
    layers = [{
        "scale": t(stacked["scale"][i]),
        "attn": {k: t(v[i]) for k, v in stacked["attn"].items()},
        "scale2": t(stacked["scale2"][i]),
        "mlp": {k: t(v[i]) for k, v in stacked["mlp"].items()},
    } for i in range(n)]
    tensors = {"final": {"scale": t(tree["final"]["scale"])},
               "embed": t(tree["embed"]), "layers": layers}
    if "unembed" in tree:
        tensors["unembed"] = t(tree["unembed"])
    return Transformer(cfg, tensors)


def params_to_numpy(model: Transformer) -> dict:
    """The inverse of ``params_from_jax``: the reference's pytree (nested
    dicts, layers stacked along a leading axis) of numpy arrays."""
    def a(x):
        return x.detach().cpu().numpy()

    layers = [_layer_dict(layer) for layer in model.layers]
    out = {
        "final": {"scale": a(model.final["scale"])},
        "embed": a(model.embed),
        "layers": {
            "scale": np.stack([a(p["scale"]) for p in layers]),
            "attn": {k: np.stack([a(p["attn"][k]) for p in layers])
                     for k in layers[0]["attn"]},
            "scale2": np.stack([a(p["scale2"]) for p in layers]),
            "mlp": {k: np.stack([a(p["mlp"][k]) for p in layers])
                    for k in layers[0]["mlp"]},
        },
    }
    if model.unembed is not None:
        out["unembed"] = a(model.unembed)
    return out


def param_bytes(model: Transformer) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


# ------------------------------------------------------------- layer fns ----
def _dense_layer_fwd(p, x, cfg, positions):
    xn = rms_norm(x, p["scale"], cfg.norm_eps)
    q, k, v = attention_qkv(p["attn"], xn, cfg, positions)
    attn = blockwise_attention(
        q, k, v, causal=cfg.causal, window=0,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        fwd_only=cfg.attn_fwd_only,
    )
    x = x + attention_out(p["attn"], attn)
    xn2 = rms_norm(x, p["scale2"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], xn2)


# ------------------------------------------------------------ forward (train)
def embed_inputs(model: Transformer, batch: dict, cfg: ArchConfig):
    tokens = torch.as_tensor(batch["tokens"], device=model.device).long()
    x = model.embed[tokens]
    return x.to(_dtype(cfg.activation_dtype))


def unembed(model: Transformer, x, cfg: ArchConfig):
    logits = x @ (model.unembed if model.unembed is not None
                  else model.embed.T)
    if cfg.padded_vocab != cfg.vocab_size:
        cols = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(cols < cfg.vocab_size, logits, -1e30)
    return logits


def forward_train(model: Transformer, batch: dict, cfg: ArchConfig,
                  rules=None):
    """batch: tokens (B,T), optional positions (B,T). Returns (logits
    (B, T, V_pad), aux_loss), aux 0 for the dense family."""
    if rules is not None:
        raise NotImplementedError(
            "sharding rules are not ported yet (ROADMAP A13d)")
    _require_dense(cfg)
    with torch.no_grad():
        x = embed_inputs(model, batch, cfg)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None]
            positions = positions.expand(x.shape[0], x.shape[1])
        else:
            positions = torch.as_tensor(positions, device=x.device)
        for layer in model.layers:
            x = _dense_layer_fwd(_layer_dict(layer), x, cfg, positions)
        x = rms_norm(x, model.final["scale"], cfg.norm_eps)
        logits = unembed(model, x, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(model: Transformer, batch: dict, cfg: ArchConfig,
            aux_weight: float = 0.01, rules=None):
    logits, aux = forward_train(model, batch, cfg, rules=rules)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    else:
        mask = torch.as_tensor(mask, device=logits.device).to(torch.float32)
    nll = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll + aux_weight * aux, (nll, aux)


# --------------------------------------------------------------- serving ----
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> dict:
    """An empty KV cache: ``{"layers": {"k", "v"}}``, each (L, B, max_len,
    KvH, hd) bfloat16, as the reference's stacked cache."""
    _require_dense(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"layers": {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }}


def _attn_decode(p, x1, kc, vc, pos: int, cfg):
    """x1: (B, d); kc, vc: this layer's (B, S, KvH, hd) cache, written in
    place at ``pos``."""
    xn = rms_norm(x1[:, None, :], p["scale"], cfg.norm_eps)
    posb = torch.full((x1.shape[0], 1), pos, dtype=torch.int32,
                      device=x1.device)
    q, k, v = attention_qkv(p["attn"], xn, cfg, posb)
    kc[:, pos] = k[:, 0].to(kc.dtype)
    vc[:, pos] = v[:, 0].to(vc.dtype)
    attn = decode_attention(q[:, 0], kc, vc, pos + 1)
    x1 = x1 + attention_out(p["attn"], attn[:, None])[:, 0]
    xn2 = rms_norm(x1[:, None, :], p["scale2"], cfg.norm_eps)[:, 0]
    return x1 + gated_mlp(p["mlp"], xn2)


def decode_step(model: Transformer, cache: dict, token, pos: int,
                cfg: ArchConfig):
    """One serving step: token (B,) int at position ``pos``.

    Returns (logits (B, V_pad), cache): the cache is updated in place."""
    _require_dense(cfg)
    pos = int(pos)
    kcs, vcs = cache["layers"]["k"], cache["layers"]["v"]
    if not 0 <= pos < kcs.shape[2]:
        raise ValueError(f"position {pos} outside the cache's "
                         f"{kcs.shape[2]} slots")
    with torch.no_grad():
        x1 = model.embed[torch.as_tensor(token, device=model.device).long()]
        for i, layer in enumerate(model.layers):
            x1 = _attn_decode(_layer_dict(layer), x1, kcs[i], vcs[i], pos,
                              cfg)
        x1 = rms_norm(x1, model.final["scale"], cfg.norm_eps)
        logits = unembed(model, x1, cfg)
    return logits, cache


def prefill(model: Transformer, batch: dict, cfg: ArchConfig, max_len: int):
    """Run the full prompt, build a cache, return last-position logits.

    As in the reference, the cache comes back empty: a fused implementation
    would write it during the layer pass."""
    tokens = torch.as_tensor(batch["tokens"])
    B = tokens.shape[0]
    logits, _ = forward_train(model, batch, cfg)
    cache = init_cache(cfg, B, max_len, device=model.device)
    return logits[:, -1], cache
