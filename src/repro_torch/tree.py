"""Nested-dict trees, the port's stand-in for ``jax.tree``.

The port's params, gradients and optimizer state are nested dicts of
tensors.  Leaves are visited in ``jax.tree_util``'s flatten order (sorted
dict keys at every level), so a sum over leaves adds in the reference's
order and a checkpoint lists its leaves as the reference's does.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` (and the matching leaves of `rest`),
    in a new tree of the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves, the keys on the path joined by
    ``/``, in a new tree of the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def flatten(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) in flatten order, the keys on the path joined by ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like: Any, values: Iterator[Any]) -> Any:
    """A tree nested as `like` whose leaves are taken from `values` in flatten
    order (dict keys keep `like`'s order)."""
    if isinstance(like, dict):
        out = {k: unflatten(like[k], values) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(values)
