"""Pytrees of tensors (nested dicts, lists and tuples) walked as
``jax.tree`` walks them: dict keys in sorted order, sequences in order.
The reference numbers a tree's leaves this way (its checkpoints'
``leaf_<i>.npy``, its optimizer's zip of params and grads, its tree
all-reduce's buffer layout), so the port does too; ``torch.utils.
_pytree`` keeps a dict's insertion order instead."""
from __future__ import annotations

from typing import Callable, Iterable

__all__ = ["leaves", "unflatten", "map_leaves"]


def leaves(tree) -> list:
    """A tree's leaves in the reference's order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in leaves(t)]
    return [tree]


def unflatten(tree, new_leaves: Iterable):
    """``tree``'s structure (its dicts in their own key order) with its
    leaves taken in the reference's order from ``new_leaves``."""
    return _fill(tree, iter(new_leaves))


def _fill(tree, it):
    if isinstance(tree, dict):
        out = {k: _fill(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(t, it) for t in tree)
    return next(it)


def map_leaves(fn: Callable, tree, *rest):
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` and of the
    trees of the same structure in ``rest``."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(*args) for args in
                            zip(leaves(tree), *others)])
