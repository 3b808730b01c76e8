"""Pytrees of tensors, walked in the order JAX walks them.

The optimiser and the checkpoint manager take parameter and optimiser-state
trees: dicts (keys in sorted order), tuples and lists (by index) and
NamedTuples (by field), with tensors or other values at the leaves and
``None`` as an empty subtree.  The order and the path names are those of
``jax.tree_util.tree_flatten_with_path`` as the reference's checkpoint
manager prints them, so a leaf's key is the reference's: ``"0/embed"``,
``"0/segments/0/wq"``, ``"1/.step"``, ``"1/.mu/embed"``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


class P(tuple):
    """A sharding spec, the reference's ``jax.sharding.PartitionSpec``: one
    entry per tensor dim, ``None`` (replicated), a mesh axis name, or a
    tuple of names; a one-name tuple is that name, as JAX canonicalizes
    it.  A leaf of every tree walk here, so spec trees are congruent with
    the tensor trees they lay out."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(path name, child) pairs of a node, or None for a leaf."""
    if tree is None:
        return []
    if isinstance(tree, P):
        return None
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def leaves_with_paths(tree) -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` with keys like ``"1/.mu/embed"``."""
    out = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append(("/".join(path), node))
            return
        for name, child in kids:
            walk(child, path + (name,))

    walk(tree, ())
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(tree_like, new_leaves) -> Any:
    """A tree of ``tree_like``'s structure holding ``new_leaves`` in
    :func:`leaves` order (dicts keep their own key order)."""
    it: Iterator = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, P):
            return next(it)
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of congruent trees, keeping ``tree``'s
    structure."""
    flat = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
