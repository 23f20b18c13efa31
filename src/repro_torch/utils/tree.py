"""Path-keyed tree walks (counterpart of ``repro.utils.tree``).

A leaf's random streams are keyed by the sha256 of its tree path, so the
path strings must be exactly JAX's ``keystr`` form: ``['blocks']['wq']`` for
dict keys (the key's ``repr``, hence ``["['blocks']['wq']"]`` for a key that
itself holds single quotes) and ``.name`` for a dataclass field.  Dict keys
are walked in sorted order, as JAX flattens them; dataclass fields in
declaration order, a ``None`` field being an empty subtree and a field
marked ``metadata={"static": True}`` no subtree at all (JAX's meta fields).
Tensors, numpy arrays and Python scalars are leaves.

Atomic leaves.  Some dataclasses are logically one leaf though they carry
several tensors (``core.quant.QuantLeaf``: packed codes, codebook, scale
and factor state).  The path-keyed machinery (the factor table, the noise
keys, dispatch) addresses such a node by the path of the dense leaf it
replaced: :func:`map_with_path` and ``flatten_with_path(..., atomic=True)``
hand it over whole.  Storage walks (checkpoints, state comparisons) descend
into its tensor fields, as JAX's own flattening does.  Types register here
(:func:`register_atomic_leaf`), so this module imports none of them.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

from repro_torch.utils import jax_random


_ATOMIC_LEAF_TYPES: tuple[type, ...] = ()


def register_atomic_leaf(cls: type) -> None:
    """Mark ``cls`` so path-keyed walks treat its instances as one leaf."""
    global _ATOMIC_LEAF_TYPES
    if cls not in _ATOMIC_LEAF_TYPES:
        _ATOMIC_LEAF_TYPES = _ATOMIC_LEAF_TYPES + (cls,)


def is_atomic_leaf(x: Any) -> bool:
    return isinstance(x, _ATOMIC_LEAF_TYPES)


def dict_key(key: str) -> str:
    return f"[{key!r}]"


def attr_key(name: str) -> str:
    return f".{name}"


def flatten_with_path(tree: Any, prefix: str = "", atomic: bool = False
                      ) -> list[tuple[str, Any]]:
    """[(path, leaf)] in JAX's flattening order; ``atomic`` keeps atomic
    leaves whole instead of descending into their tensor fields."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_path(tree[k], prefix + dict_key(k), atomic))
        return out
    if atomic and is_atomic_leaf(tree):
        return [(prefix, tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            child = getattr(tree, f.name)
            if child is not None and not f.metadata.get("static"):
                out.extend(flatten_with_path(child, prefix + attr_key(f.name), atomic))
        return out
    return [(prefix, tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """Like ``tree_map`` over nested dicts, ``fn`` receiving the leaf's path
    string first; leaves are visited in sorted-key order.  Anything that is
    not a dict, an atomic leaf included, is a leaf."""

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(node[k], prefix + dict_key(k)) for k in sorted(node)}
        return fn(prefix, node)

    return walk(tree, "")


def _path_hash(path: str) -> int:
    """Deterministic 31-bit hash of a path string (the reference's)."""
    digest = hashlib.sha256(path.encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def fold_in_path(key, path: str) -> tuple[int, int]:
    """Derive a per-leaf key from a base key and the leaf's tree path."""
    return jax_random.fold_in(key, _path_hash(path))


def _tensor_leaves(tree: Any) -> list:
    return [x for _, x in flatten_with_path(tree) if hasattr(x, "numel")]


def tree_size_bytes(tree: Any) -> int:
    """Total bytes across the tree's tensor leaves (a QuantLeaf counts its
    tensor fields), as the reference's ``tree_size_bytes``."""
    return sum(x.numel() * x.element_size() for x in _tensor_leaves(tree))


def tree_num_params(tree: Any) -> int:
    """Total elements across the tree's tensor leaves."""
    return sum(x.numel() for x in _tensor_leaves(tree))
