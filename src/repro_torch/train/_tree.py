"""Leaves of the port's parameter and state trees: nested dicts, lists and
tuples whose leaves are tensors.

Dict keys are visited in sorted order, as ``jax.tree`` visits them, so a
tree's flat order does not depend on how its dicts were built. A leaf's
path is its keys and indices joined by ``/`` (``0/layers/3/core/wq``);
the checkpoint manifest records the paths in place of a treedef.
"""

from __future__ import annotations

from typing import Any, Callable


def _children(tree: Any) -> list | None:
    """(key, child) pairs of an inner node, None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


# Module-level recursion, not nested closures: a recursive closure is a
# reference cycle that would keep every leaf it saw alive until the
# garbage collector runs (gigabytes of gradients on the card).
def _walk(node: Any, prefix: str, paths: list, out: list) -> None:
    kids = _children(node)
    if kids is None:
        paths.append(prefix)
        out.append(node)
        return
    for k, child in kids:
        _walk(child, f"{prefix}/{k}" if prefix else str(k), paths, out)


def flatten(tree: Any) -> tuple[list[str], list]:
    """(paths, leaves) in the tree's flat order."""
    paths, out = [], []
    _walk(tree, "", paths, out)
    return paths, out


def leaves(tree: Any) -> list:
    return flatten(tree)[1]


def _build(node: Any, it) -> Any:
    kids = _children(node)
    if kids is None:
        return next(it)
    built = {k: _build(child, it) for k, child in kids}
    if isinstance(node, dict):
        return {k: built[k] for k in node}
    return type(node)([built[i] for i in range(len(node))])


def unflatten(like: Any, new_leaves: list) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` in flat order
    (dicts keep ``like``'s key order)."""
    n = len(leaves(like))
    if len(new_leaves) != n:
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {n}")
    return _build(like, iter(new_leaves))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    return unflatten(tree, [fn(*ls) for ls in zip(
        leaves(tree), *(leaves(r) for r in rest), strict=True)])
