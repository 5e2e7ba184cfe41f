"""Trees of tensors (nested dicts, lists, tuples and NamedTuples) in
``jax.tree_util``'s leaf order, by ``quant.prepare.tree_manifest``'s walk
(dict keys sorted, ``None`` holds no leaf).

The optimizer pairs the leaves of several trees (parameters, gradients,
moments) by position. Sorted keys make that pairing independent of the
order each tree's dicts were built in: a model's init builds them in
code order, a restored checkpoint sorted."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from repro_torch.quant.prepare import tree_from_manifest, tree_manifest


def flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """``(leaves, unflatten)``: ``unflatten(new_leaves)`` rebuilds the
    tree's containers, NamedTuples included, around new leaves."""
    spec, leaves = tree_manifest(tree)
    return leaves, lambda new: tree_from_manifest(spec, list(new), tree)


def tree_leaves(tree) -> List[Any]:
    return tree_manifest(tree)[1]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of the
    same structure."""
    leaves, unflatten = flatten(tree)
    others = [tree_leaves(t) for t in rest]
    return unflatten([fn(*xs) for xs in zip(leaves, *others)])
