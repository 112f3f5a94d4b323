"""Trees of tensors: nested dicts, tuples and NamedTuples (an optimizer
state), with the few operations of ``jax.tree`` the port needs. Dicts keep
their insertion order, so two trees built by the same code flatten alike."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_node(tree: Any) -> bool:
    return isinstance(tree, (dict, tuple, list))


def _children(tree: Any) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return list(tree.items())
    fields = getattr(tree, "_fields", None) or [str(i) for i in range(len(tree))]
    return list(zip(fields, tree))


def _rebuild(tree: Any, values: List[Any]) -> Any:
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def leaves_with_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``a/b/c`` path, leaf) for every leaf, depth first."""
    if not _is_node(tree):
        yield prefix, tree
        return
    for key, val in _children(tree):
        yield from leaves_with_paths(val, f"{prefix}/{key}" if prefix else str(key))


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees of the same structure in ``rest``."""
    if not _is_node(tree):
        return fn(tree, *rest)
    kids = [_children(t) for t in (tree, *rest)]
    return _rebuild(tree, [tree_map(fn, *(k[i][1] for k in kids)) for i in range(len(kids[0]))])


def unflatten(tree: Any, values: List[Any]) -> Any:
    """A tree of the structure of ``tree`` with ``values`` as its leaves, in order."""
    values = list(values)
    if len(values) != len(leaves(tree)):
        raise ValueError(f"{len(values)} values for {len(leaves(tree))} leaves")
    it = iter(values)
    return tree_map(lambda _: next(it), tree)
