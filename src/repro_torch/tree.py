"""Trees of tensors: nested dicts and lists, as the port's parameters are.

The reference walks its parameters with ``jax.tree_util``; the port's
trees are plain dicts and lists with tensors (or numpy arrays) at the
leaves, and these helpers walk them in the same order: a dict's keys
sorted, a list's items in order. Leaf order matters wherever leaves are
summed, as :func:`repro_torch.optim.global_norm` sums them.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

Tree = Any


def _children(tree: Tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_path(tree: Tree, prefix: tuple = ()
                     ) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs; a path holds dict keys and list indices."""
    children = _children(tree)
    if children is None:
        yield prefix, tree
        return
    for key, sub in children:
        yield from leaves_with_path(sub, prefix + (key,))


def leaves(tree: Tree) -> list:
    """The leaves of a tree, in ``jax.tree_util`` order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s
    structure, dict keys in their original order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Tree, prefix: tuple = ()) -> Tree:
    """``fn(path, leaf)`` over the leaves, in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
