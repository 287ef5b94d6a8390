"""Param trees: nested dicts (and lists) of tensors, walked without JAX's
pytrees.

The port keeps the reference's param layout — a nested ``dict`` keyed by
the reference's layer names, leaves ``torch.Tensor`` (or an int8
``QuantizedTensor``) — so converted checkpoints, the int8 tree transform
and the precision policy all address leaves by the same paths.  Lists are
nodes too, walked in order with their indices in the path: ``zero1``'s
optimizer state is the reference's list of flat buckets (``{"velocity":
[buf, ...]}``).
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf (and the leaves at the same paths of
    ``rest``, trees of the same structure); dicts are rebuilt in
    ``tree``'s order, lists in theirs."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _children(tree: Any):
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def tree_leaves_with_path(tree: Any, prefix: tuple = ()) -> list:
    """-> ``[(path tuple of keys and list indices, leaf), ...]`` in
    insertion order."""
    if isinstance(tree, (dict, list)):
        out = []
        for k, v in _children(tree):
            out.extend(tree_leaves_with_path(v, prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable, tree: Any, prefix: tuple = ()) -> Any:
    """``tree_map`` whose ``fn(path, leaf)`` also sees the key path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, prefix + (i,))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_to(tree: Any, device=None, dtype=None) -> Any:
    """Move every tensor leaf (and ``QuantizedTensor``) to ``device``;
    ``dtype`` casts floating tensors only."""
    import torch

    def move(x):
        if isinstance(x, torch.Tensor):
            if dtype is not None and x.is_floating_point():
                return x.to(device=device, dtype=dtype)
            return x.to(device=device)
        if hasattr(x, "to") and device is not None:
            return x.to(device)
        return x

    return tree_map(move, tree)
