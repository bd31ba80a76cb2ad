"""Arithmetic over parameter trees (``repro/utils/tree.py``).

A tree is the port's parameter layout: nested dicts whose leaves are
tensors (lists and tuples are walked too).  Every function returns a new
tree of the same structure; none updates a leaf in place.
"""
from __future__ import annotations

import torch


def leaves(tree) -> list:
    """The leaves of a tree in key order of each dict, as JAX flattens a
    dict (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_count(tree) -> int:
    """Total number of scalar parameters."""
    return sum(int(x.numel()) for x in leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes, by each leaf's dtype."""
    return sum(int(x.numel()) * x.element_size() for x in leaves(tree))


def tree_global_norm(tree) -> torch.Tensor:
    """Global L2 norm across all leaves, summed in float32."""
    xs = leaves(tree)
    if not xs:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(x.float())) for x in xs)
    return torch.sqrt(sq)


def tree_cast(tree, dtype):
    """Every floating leaf cast to ``dtype``; integer leaves untouched."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype,
                                          device=x.device), tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)
