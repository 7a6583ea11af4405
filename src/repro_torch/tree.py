"""Trees as the port keeps params and optimiser state: nested dicts,
lists, tuples and NamedTuples (``AdamWState``) whose leaves are tensors
or arrays; ``None`` is an empty subtree.

The counterpart of the ``jax.tree`` functions the JAX package uses.
Dicts are walked in their own key order; a second tree is walked in
the first one's structure, key by key, so two trees with the same keys
in another order (a converted JAX tree has its keys sorted) line up.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest at the same place)`` over ``tree``'s
    leaves, in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return type(tree)(*kids) if _is_namedtuple(tree) else type(tree)(kids)
    if tree is None:
        return None
    return fn(tree, *rest)


def leaves(tree: Any, like: Any = None) -> List[Any]:
    """The leaves of ``tree``, in ``like``'s order (its own by default)."""
    out: List[Any] = []
    if like is None:
        map_tree(out.append, tree)
    else:
        map_tree(lambda _, x: out.append(x), like, tree)
    return out


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)
    return map_tree(lambda _: next(it), like)


def paths(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``("a/0/w", leaf)`` pairs: dict keys, list and tuple indices and
    NamedTuple field names joined by ``/``, the key layout of the JAX
    package's checkpoints (``jax.tree_util.tree_flatten_with_path``)."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [("/".join(prefix), tree)]
    return [p for k, v in items for p in paths(v, prefix + (k,))]
