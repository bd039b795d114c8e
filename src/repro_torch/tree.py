"""Trees of tensors: the port's counterpart of ``jax.tree``.

A tree is a NamedTuple (fields in order), a list or tuple (items in
order), a dict (keys in sorted order, as JAX flattens them) or a leaf;
``None`` is an empty subtree with no leaves, as in JAX.  The model
parameters (:class:`~repro_torch.models.transformer.Decoder`: lists of
per-layer dicts), the optimizer and training states and the checkpoint
trees are all such trees.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: Any, prefix: tuple = ()) -> Iterator:
    """(path, leaf) pairs in tree order; a path is a tuple of field names
    and dict keys (strings) and list indices (ints)."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for name in tree._fields:
            yield from flatten_with_path(getattr(tree, name),
                                         prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from flatten_with_path(x, prefix + (i,))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from flatten_with_path(tree[key], prefix + (str(key),))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    """The leaves in tree order."""
    return [x for _, x in flatten_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the structure is kept (dicts rebuilt in sorted
    key order)."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map(fn, getattr(tree, n), *(getattr(r, n) for r in rest))
            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def unflatten(tree: Any, new_leaves) -> Any:
    """``tree``'s structure with ``new_leaves`` (in tree order) as its
    leaves."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree has")
    return out
