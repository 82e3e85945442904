"""Parameter and optimizer trees: nested dicts of tensors (the port's
counterpart of JAX pytrees).

Leaves are visited in sorted-key order, as ``jax.tree_util`` flattens a
dict, and named by their ``/``-joined key path (``core/uniq.py:path_str``),
the names the reference's checkpoints and freeze masks use.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def is_node(x) -> bool:
    return isinstance(x, dict)


def leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) for every leaf, in sorted-key order."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if is_node(val):
            yield from leaves_with_paths(val, path)
        else:
            yield path, val


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_with_path(fn: Callable[..., Any], tree, *rest,
                  prefix: str = "") -> Dict[str, Any]:
    """New tree of ``fn(path, leaf, *leaves of rest at that path)``; every
    tree in ``rest`` has the structure of ``tree``."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        others = [r[key] for r in rest]
        if is_node(tree[key]):
            out[key] = map_with_path(fn, tree[key], *others, prefix=path)
        else:
            out[key] = fn(path, tree[key], *others)
    return out


def map_tree(fn: Callable[..., Any], tree, *rest) -> Dict[str, Any]:
    """New tree of ``fn(leaf, *leaves of rest at that path)``."""
    return map_with_path(lambda _p, *xs: fn(*xs), tree, *rest)
