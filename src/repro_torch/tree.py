"""Nested containers of tensors, walked as the reference's pytrees are.

A tree is a dict (walked in sorted key order, as jax flattens dicts), a
tuple or list (a NamedTuple's fields by name, other sequences by index),
``None`` (no leaf) or a leaf. A leaf's path is the tuple of its keys,
field names and indices as strings; ``"/".join(path)`` is the key the
reference's checkpointer gives it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

__all__ = ["leaves", "leaves_with_path", "tree_map", "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, is_leaf: Optional[Callable[[Any], bool]] = None,
                     path: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in the reference's flattening order."""
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], is_leaf, path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, is_leaf, path + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, is_leaf, path + (str(i),))
    elif tree is not None:
        yield path, tree


def leaves(tree, is_leaf=None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]


def unflatten(template, new_leaves, is_leaf=None):
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if is_leaf is not None and is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            out = {k: None for k in t}          # keep the caller's key order
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if _is_namedtuple(t):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree, is_leaf=None):
    return unflatten(tree, [fn(x) for x in leaves(tree, is_leaf)], is_leaf)
