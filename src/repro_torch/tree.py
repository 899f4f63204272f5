"""Nested containers of tensors ("trees": dicts, lists, tuples), the
port's stand-in for JAX pytrees. Leaves are visited in JAX's order: dict
keys sorted, lists and tuples in order."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves of `tree`, in JAX's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """`fn` applied leaf by leaf to `tree` and the trees of the same
    structure in `rest`, in `leaves` order; the result has `tree`'s
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten(tree, flat):
    """`flat` (in `leaves(tree)` order) laid out in `tree`'s structure."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)
