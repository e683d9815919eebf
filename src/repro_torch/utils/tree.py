"""Small helpers on parameter trees (port of ``repro/utils/tree.py``).

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, numpy arrays or scalars, as the port's params, optimizer state
and train states are. Leaves are visited in the order ``jax.tree.leaves``
visits them: dict keys sorted, sequences in order."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping, Tuple

import numpy as np
import torch


def _leaves_with_path(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    if tree is None:
        return
    if hasattr(tree, "_asdict"):                     # fields in order
        for k, v in tree._asdict().items():
            yield from _leaves_with_path(v, path + (k,))
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_size(tree: Any) -> int:
    """Total number of elements in all leaves."""
    return sum(int(np.prod(tuple(x.shape))) if hasattr(x, "shape") else 1
               for _, x in _leaves_with_path(tree))


def tree_bytes(tree: Any) -> int:
    """Total bytes across leaves with a shape and a dtype."""
    return sum(int(np.prod(tuple(x.shape))) * _itemsize(x.dtype)
               for _, x in _leaves_with_path(tree)
               if hasattr(x, "shape") and hasattr(x, "dtype"))


def tree_map_with_path_str(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """``fn(key, leaf)`` over every leaf, the key '/'-joined from dict keys
    and sequence indices (``blocks/0/attn/w``), a NamedTuple field spelt
    ``.name`` as JAX spells an attribute key; the structure is kept."""
    def rec(node, path):
        if node is None:
            return None
        if hasattr(node, "_asdict"):
            return type(node)(**{k: rec(v, path + (f".{k}",))
                                 for k, v in node._asdict().items()})
        if isinstance(node, Mapping):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, path + (i,)) for i, v in enumerate(node))
        return fn("/".join(str(p) for p in path), node)
    return rec(tree, ())


def flatten_dict(tree: Mapping[str, Any], sep: str = "/", prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_dict(v, sep=sep, prefix=key))
        else:
            out[key] = v
    return out


def unflatten_dict(flat: Mapping[str, Any], sep: str = "/") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(sep)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out
