"""Pytrees of tensors: a leaf, or dicts, lists and tuples of pytrees.

``None`` is an empty subtree, as in a jax pytree.  Paths are tuples of
dict keys (as strings) and sequence indices, dict keys visited in sorted
order: the order ``jax.tree_util`` flattens in.
"""

from __future__ import annotations

__all__ = ["leaves_with_paths", "tree_leaves", "tree_map",
           "tree_map_with_path"]


def tree_map_with_path(fn, tree, *rest, _prefix=()):
    """Apply ``fn(path, leaf, *matching leaves of rest)`` to every leaf of
    ``tree``, keeping its dict / list / tuple structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      _prefix=(*_prefix, str(k)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             _prefix=(*_prefix, str(i)))
                          for i, v in enumerate(tree))
    return fn(_prefix, tree, *rest)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def leaves_with_paths(tree, _prefix=()) -> list:
    """``[(path, leaf)]`` in flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_paths(tree[k], (*_prefix, str(k)))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in leaves_with_paths(v, (*_prefix, str(i)))]
    return [(_prefix, tree)]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in flattening order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]
