"""Nested dict/list trees of tensors (the port's params and train state).

The reference walks its pytrees with ``jax.tree``; the port's trees are
plain dicts and lists, walked here in a fixed order: dict keys as stored,
list items by index. A leaf's path is the tuple of keys and indices that
reaches it; ``key(path)`` joins it with ``/`` as the reference's
checkpointer names its leaves.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def leaves_with_paths(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    """The leaves in ``leaves_with_paths`` order, without building paths
    (a paged decode step walks its params and pools with it every call)."""
    out: List[Any] = []
    _collect(tree, out)
    return out


def _collect(tree, out: List[Any]) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _collect(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, out)
    else:
        out.append(tree)


def key(path: Path) -> str:
    return "/".join(str(p) for p in path)


def get(tree, path: Path):
    for p in path:
        tree = tree[p]
    return tree


def map_tree(fn: Callable, tree, path: Path = ()):
    """``fn(path, leaf)`` at every leaf, in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def unflatten(template, values) -> Any:
    """A tree shaped like ``template`` whose leaves are ``values`` in
    ``leaves_with_paths`` order."""
    it = iter(values)
    out = map_tree(lambda _, __: next(it), template)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more values than the template has leaves")
    return out
