"""The few pytree operations the port needs in place of ``jax.tree``.

A tree is nested ``Mapping``s, ``NamedTuple``s, lists and tuples over
leaves (tensors, numpy arrays, scalars); ``None`` holds no leaf, and a
model (``repro_torch.models.transformer.Transformer``) flattens as its
``param_tree()``. Mappings
flatten in sorted key order, as ``jax.tree`` flattens dicts, so the port's
leaves come out in the reference's order and under its names.

:class:`Stack` is the one addition: a leaf of the reference's tree that is
stacked along a leading layer axis (``layers/attn/wq`` of shape
``(L, d, H, hd)``), held as the port's ``L`` per-layer tensors. It counts
as one leaf, of the stacked shape, wherever a tree is flattened.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

SEP = "::"   # the reference checkpoint's separator of path parts


class Stack(tuple):
    """One leaf of the reference's tree stacked along a leading layer axis,
    held as the port's per-layer tensors (``self[i]`` is layer ``i``)."""

    @property
    def shape(self) -> tuple:
        return (len(self), *self[0].shape)

    @property
    def ndim(self) -> int:
        return self[0].ndim + 1

    @property
    def dtype(self):
        return self[0].dtype

    @property
    def device(self):
        return self[0].device

    def stacked(self) -> torch.Tensor:
        """The leaf as one tensor of the stacked shape (a copy, or a view
        of the one layer's tensor)."""
        if len(self) == 1:
            return self[0].unsqueeze(0)
        return torch.stack(tuple(self))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """(path, leaf) pairs in the reference's order; a path holds dict keys,
    NamedTuple field names and sequence indices, as strings."""
    if tree is None:
        return []
    if isinstance(tree, Stack):
        return [(prefix, tree)]
    if hasattr(tree, "param_tree"):   # a model: its parameters' tree
        return flatten(tree.param_tree(), prefix)
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], prefix + (str(k),))
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += flatten(getattr(tree, name), prefix + (name,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def name(path: tuple) -> str:
    """A path as the reference checkpoint names its leaf."""
    return SEP.join(path)


def map(fn, tree):  # noqa: A001  (the jax.tree.map of this module)
    """``fn`` applied to every leaf (a :class:`Stack` is one leaf) in
    ``flatten``'s order, the structure kept."""
    if tree is None:
        return None
    if isinstance(tree, Stack):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: map(fn, tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v) for v in tree)
    return fn(tree)


def unflatten(like, leaves_):
    """``leaves_`` (in ``flatten``'s order) in the structure of ``like``."""
    it = iter(leaves_)
    return map(lambda _: next(it), like)


def zip_leaves(*trees):
    """The leaves of trees of one structure, side by side: a tuple a path
    (a :class:`Stack` is one leaf); a path that differs raises."""
    flat = [flatten(t) for t in trees]
    for items in zip(*flat, strict=True):
        path = items[0][0]
        for other, _ in items[1:]:
            if other != path:
                raise ValueError(f"tree mismatch: {name(path)!r} against "
                                 f"{name(other)!r}")
        yield tuple(leaf for _, leaf in items)


def layer_leaves(tree) -> list:
    """Every tensor of the tree, each :class:`Stack` given layer by layer."""
    out = []
    for leaf in leaves(tree):
        out.extend(leaf if isinstance(leaf, Stack) else (leaf,))
    return out
