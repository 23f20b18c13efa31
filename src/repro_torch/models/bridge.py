"""Parameter bridge from the reference's numpy parameter trees.

``params_from_numpy`` turns the reference's parameter pytree, given as
numpy arrays, into the port's parameter dict: the same nested keys and the
same stacked ``[L, ...]`` layout.  bf16 leaves cross as their uint16 bit
patterns, so the bridge is exact and needs neither JAX nor ``ml_dtypes``.
A reference ``QuantLeaf`` (its fields as numpy arrays, e.g. after
``jax.device_get``, plus its meta fields) crosses as the port's
``core.quant.QuantLeaf``, recognised by its fields, not its type.

``load_reference_checkpoint`` reads the reference checkpointer's on-disk
layout (``arrays.npz`` keyed by leaf path plus ``manifest.json``) with numpy
alone.  Leaf paths are JAX ``keystr`` strings: dict keys (``['blocks']``,
or ``["['blocks']['wq']"]`` for a key holding quotes) and dataclass
attributes (``.params``), parsed by :func:`parse_path`.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

_PATH_KEY = re.compile(
    r"""\.(?P<attr>[A-Za-z_][A-Za-z0-9_]*)"""
    r"""|\[(?P<key>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")\]"""
)


def parse_path(path: str) -> list[str]:
    """A ``keystr`` path as its key names, in order: ``.mstate['tau_m']
    ["['blocks']['wq']"]`` → ``['mstate', 'tau_m', "['blocks']['wq']"]``.
    Raises on anything else (integer or flattened keys)."""
    names, pos = [], 0
    for m in _PATH_KEY.finditer(path):
        if m.start() != pos:
            break
        names.append(m["attr"] if m["attr"] is not None else ast.literal_eval(m["key"]))
        pos = m.end()
    if pos != len(path) or not names:
        raise ValueError(f"unsupported leaf path {path!r}")
    return names


def tensor_from_numpy(
    arr: np.ndarray, device: torch.device | str = "cpu", bf16: bool = False
) -> torch.Tensor:
    """One leaf.  ``bf16`` marks a 2-byte array holding bfloat16 bits (an
    ``ml_dtypes`` bfloat16 array is recognised by its dtype name)."""
    arr = np.ascontiguousarray(arr)
    if bf16 or arr.dtype.name == "bfloat16":
        bits = arr.view(np.uint16).astype(np.int16, copy=False)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def quant_leaf_from_numpy(leaf: Any, device: torch.device | str = "cpu"):
    """A reference QuantLeaf (any object with its fields) -> the port's."""
    from repro_torch.core.quant import TENSOR_FIELDS, QuantLeaf

    fields = {f: getattr(leaf, f) for f in TENSOR_FIELDS}
    fields = {f: None if a is None else tensor_from_numpy(np.asarray(a), device)
              for f, a in fields.items()}
    return QuantLeaf(**fields, bits=int(leaf.bits), k_dim=int(leaf.k_dim),
                     dtype_name=str(leaf.dtype_name), qmethod=str(leaf.qmethod))


def params_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    """Nested dict of numpy arrays (reference QuantLeafs among them) ->
    nested dict of tensors and QuantLeafs (same keys)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "codes") and hasattr(tree, "qmethod"):
        return quant_leaf_from_numpy(tree, device)
    return tensor_from_numpy(np.asarray(tree), device)


def load_reference_checkpoint(
    step_dir: str | Path, device: torch.device | str = "cpu"
) -> dict:
    """Read one ``step_NNNNNNNN`` directory of the reference checkpointer
    into a nested dict of tensors keyed as the saved pytree was (a
    dataclass field becomes a dict key of its name)."""
    step_dir = Path(step_dir)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    out: dict = {}
    with np.load(step_dir / "arrays.npz") as arrays:
        for path, (shape, dtype) in manifest["paths"].items():
            keys = parse_path(path)
            arr = arrays[path].reshape(shape)
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = tensor_from_numpy(arr, device, bf16=dtype == "bfloat16")
    return out
