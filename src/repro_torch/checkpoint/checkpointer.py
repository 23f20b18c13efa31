"""Checkpoints of a ZO training state in the reference's on-disk layout
(counterpart of ``repro.checkpoint.checkpointer``).

One ``step_NNNNNNNN/`` directory per save: ``arrays.npz`` keyed by each
leaf's JAX ``keystr`` path (``.params['blocks']['wq']``,
``.mstate['tau_m']["['blocks']['wq']"]``, ``.step``, ``.base_key``; a
factor's per-layer rank mask as ``.mstate['factors']["['blocks']['wq']"].rank_mask``,
the key JAX's flattening of the reference's ``CPDFactor`` gives it) and a
``manifest.json`` of shapes, dtype names and the caller's ``extra``.  bf16
leaves are stored as 2-byte void records with dtype name ``bfloat16``, as
the reference writes them, so either package reads the other's
checkpoints.  A quantized leaf (``core.quant.QuantLeaf``) is stored field
by field under the keys JAX's own flattening gives its tensors
(``.params['blocks']['wq'].codes``, ``.codebook``, ... ``.nacc`` when
present; the codes as uint32); its meta fields (bits, K, dtype, scheme)
come from the template on restore.  (The reference's checkpointer walks a
QuantLeaf as one leaf and pickles it whole under the dense path, which its
own restore cannot load.)  Writes are atomic (a ``.tmp`` directory renamed into place),
``save_async`` copies to the host before it returns and writes on a
background thread, and only the newest ``keep`` checkpoints stay.

Sharded states.  A sharded run (``distributed.sharding``) gathers its state
whole onto the host and rank 0 writes it: the layout is the unsharded one.
``restore(template, shardings=specs, mesh=mesh)`` gives each rank its shard
of every leaf of the whole checkpoint, cut by the spec tree: a checkpoint
restores onto any mesh (the reference's elastic restore).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils import shard_ctx
from repro_torch.utils.tree import attr_key, dict_key, flatten_with_path

_MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d{8})$")


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy().copy()
    if isinstance(leaf, int):  # the state's step: the reference's int32 scalar
        return np.asarray(leaf, dtype=np.int32)
    return np.array(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str, like: Any, cut=None, device=None) -> Any:
    """One leaf like ``like`` (on ``device`` if given); ``cut`` takes this
    rank's shard on the host first, so no whole leaf reaches the device."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if cut is not None:
        t = cut(t)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device if device is None else device, dtype=like.dtype)
    if isinstance(like, int):
        return int(t)
    if isinstance(like, np.ndarray):
        return t.numpy().astype(like.dtype)
    raise TypeError(f"cannot restore into a leaf of type {type(like).__name__}")


def _flatten_numpy(tree: Any) -> dict[str, np.ndarray]:
    return {path: _to_numpy(leaf) for path, leaf in flatten_with_path(tree)}


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def _steps(self) -> list[int]:
        if not self.dir.exists():
            return []
        return sorted(int(m.group(1)) for p in self.dir.iterdir()
                      if p.is_dir() and (m := _STEP_RE.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, extra: dict | None = None) -> Path:
        """Synchronous atomic save of any tree of tensors (a ZOTrainState,
        a dict of params)."""
        self.wait()
        return self._write(step, _flatten_numpy(state), extra or {})

    def save_async(self, step: int, state: Any, extra: dict | None = None) -> None:
        """Copy to the host now, write on a background thread."""
        self.wait()
        flat = _flatten_numpy(state)
        self._thread = threading.Thread(target=self._write, args=(step, flat, extra or {}),
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict[str, np.ndarray], extra: dict) -> Path:
        final = self._step_dir(step)
        tmp = final.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {
            "step": step,
            "paths": {k: [list(v.shape), _dtype_name(v)] for k, v in flat.items()},
            "extra": extra,
        }
        (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for s in self._steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        return final

    def restore(self, template: Any, step: Optional[int] = None, shardings: Any = None,
                mesh: Any = None, device: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` (a whole state, or its
        meta stand-in, whose leaves give each restored leaf's shape, device
        and dtype; ``device`` overrides the device).  With ``shardings``
        (the spec tree of ``sharding.zo_state_specs``, for ``mesh``, which
        need not be the mesh the checkpoint came from) each leaf is this
        rank's shard.  Returns (state, extra)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / _MANIFEST).read_text())
        with np.load(d / "arrays.npz") as arrays:

            def place(node: Any, prefix: str, spec: Any) -> Any:
                if isinstance(node, dict):
                    return {k: place(v, prefix + dict_key(k), None if spec is None else spec[k])
                            for k, v in node.items()}
                if dataclasses.is_dataclass(node) and not isinstance(node, type):
                    return dataclasses.replace(node, **{
                        f.name: place(getattr(node, f.name), prefix + attr_key(f.name),
                                      None if spec is None else getattr(spec, f.name))
                        for f in dataclasses.fields(node)
                        if getattr(node, f.name) is not None and not f.metadata.get("static")
                    })
                if prefix not in arrays:
                    raise KeyError(f"checkpoint {d} missing leaf {prefix}")
                arr = arrays[prefix]
                want = tuple(getattr(node, "shape", ()))
                if tuple(arr.shape) != want:
                    raise ValueError(f"{prefix}: checkpoint {arr.shape} != {want}")
                return _from_numpy(arr, manifest["paths"][prefix][1], node,
                                   None if spec is None else
                                   lambda t: shard_ctx.cut(t, spec, mesh), device)

            state = place(template, "", shardings)
        return state, manifest["extra"]
