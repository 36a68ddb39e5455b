"""Parameter-tree utilities, the port of ``repro.core.util``: path-predicate
partitioning for selective training (STE refinement tunes latents and
scales, Phase 3 only scales) and stacking of per-layer trees.

Trees are nested dicts of tensors. A leaf's path is its keys joined by
``/`` (``"attn/wq/s1"``), as the JAX package's path strings read, so the
pipeline's predicates key on the same names.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def _map(tree, fn, path=""):
    """fn(path, leaf) over every leaf, dict keys in sorted order (JAX's
    flattening order)."""
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn, f"{path}/{k}" if path else str(k))
                for k in sorted(tree)}
    return fn(path, tree)


def leaves_with_path(tree, path=""):
    """(path, leaf) of the non-None leaves in JAX's flattening order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in leaves_with_path(
            tree[k], f"{path}/{k}" if path else str(k))]
    return [] if tree is None else [(path, tree)]


def leaves(tree):
    """The non-None leaves of `tree` in JAX's flattening order."""
    return [l for _, l in leaves_with_path(tree)]


def partition(tree, pred: Callable[[str], bool]) -> Tuple[dict, dict]:
    """Split a tree into (selected, rest) by leaf-path predicate; both
    keep the full structure with None placeholders."""
    sel = _map(tree, lambda p, l: l if pred(p) else None)
    rest = _map(tree, lambda p, l: None if pred(p) else l)
    return sel, rest


def combine(sel, rest):
    """Inverse of :func:`partition`."""
    if isinstance(sel, dict):
        return {k: combine(sel[k], rest[k]) for k in sel}
    return sel if sel is not None else rest


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the matching leaves of `rest`);
    None placeholders stay None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return None if tree is None else fn(tree, *rest)


def tree_stack(trees):
    """Stack same-structure trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def tree_index(tree, i):
    """Element i along the leading axis of every leaf."""
    return tree_map(lambda l: l[i], tree)
