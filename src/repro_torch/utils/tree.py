"""Path-keyed tree walks (counterpart of ``repro.utils.tree``).

A leaf's random streams are keyed by the sha256 of its tree path, so the
path strings must be exactly JAX's ``keystr`` form: ``['blocks']['wq']`` for
dict keys (the key's ``repr``, hence ``["['blocks']['wq']"]`` for a key that
itself holds single quotes) and ``.name`` for a dataclass field.  Dict keys
are walked in sorted order, as JAX flattens them; dataclass fields in
declaration order, a ``None`` field being an empty subtree.  Tensors, numpy
arrays and Python scalars are leaves.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

from repro_torch.utils import jax_random


def dict_key(key: str) -> str:
    return f"[{key!r}]"


def attr_key(name: str) -> str:
    return f".{name}"


def flatten_with_path(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in JAX's flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_path(tree[k], prefix + dict_key(k)))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            child = getattr(tree, f.name)
            if child is not None:
                out.extend(flatten_with_path(child, prefix + attr_key(f.name)))
        return out
    return [(prefix, tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """Like ``tree_map`` over nested dicts, ``fn`` receiving the leaf's path
    string first; leaves are visited in sorted-key order."""

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
