"""The registered shard context of a sharded run, and the cutting and
gathering of shards: what the code that takes a leaf reads while a
sharded state is placed (``core.cpd``, ``core.dispatch``,
``core.estimator``, ``core.zo_step`` and the model families).  It imports
nothing of ``repro_torch.distributed``; ``distributed.sharding`` holds the
spec tables that build a :class:`ShardCtx` and re-exports these names.

A spec is one mesh-axis name (``"data"``, ``"model"``) or None per dim of
a leaf.  A mesh is a ``launch.mesh.HostMesh`` (``data``, ``model``,
``world``, ``coords``, ``all_gather``) or, for the spec rules alone,
anything with ``axis_names`` and ``devices.shape``.

While a :class:`ShardCtx` is registered (:func:`placed`):

* the forward gathers each layer's leaves just in time where every family
  takes a layer (``TransformerLM._layer``, xLSTM's per-layer loop) and the
  embedding, final norm and head where they are used (:func:`layer`,
  :func:`subtree`, :func:`whole`);
* the noise kernels draw a shard's part of a leaf from the shard's global
  offsets (:func:`leaf_offsets`, the reference's ``_global_offsets``);
* everything small is drawn whole on every rank and cut (:func:`lead`,
  :func:`rows`, :func:`cols`, :func:`like`): the factors u and v, τ, LOZO's
  U and V, SubZO's Σ, U and V, and the ``jax.random`` z of the leaves the
  noise kernels do not cover.  So each rank's slice equals the unsharded
  draw's, element for element, and the low-rank kernels get their shard
  and the matching factor rows.

The gathers and the sums over ranks go through the mesh's ``all_gather``
and are added in rank order, so a run repeats bit for bit.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.utils.tree import flatten_with_path

_MESH = None


def set_current_mesh(mesh: Optional[object]) -> None:
    """The launcher's mesh, for code that needs it without a parameter
    (``distributed.context`` re-exports it; the expert-parallel MoE reads
    it)."""
    global _MESH
    _MESH = mesh


def current_mesh() -> Optional[object]:
    return _MESH


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis: size}: a ``HostMesh`` (``data``, ``model``), or anything with
    ``axis_names`` and ``devices.shape`` as a jax mesh has."""
    devices = getattr(mesh, "devices", None)
    if devices is not None:
        return dict(zip(mesh.axis_names, devices.shape))
    return {"data": mesh.data, "model": mesh.model}


def batch_spec(mesh, shape: tuple) -> tuple:
    """A batch array's spec: the leading dim over the data axis when it
    divides (else replicated, as a global batch of 1 is), the rest
    replicated."""
    if len(shape) == 0:
        return ()
    d = mesh_axis_sizes(mesh)["data"]
    return ("data" if shape[0] % d == 0 else None,) + (None,) * (len(shape) - 1)


# --------------------------------------------------------------------------
# cutting and gathering
# --------------------------------------------------------------------------


def _slices(spec: tuple, shape: tuple, mesh, coords: dict) -> tuple:
    sizes = mesh_axis_sizes(mesh)
    out = []
    for d, dim in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is None:
            out.append(slice(None))
        else:
            n = dim // sizes[ax]
            out.append(slice(coords[ax] * n, (coords[ax] + 1) * n))
    return tuple(out)


def splits(spec: tuple, mesh) -> bool:
    """Does ``spec`` split anything on ``mesh`` (an axis of size > 1)?"""
    sizes = mesh_axis_sizes(mesh)
    return any(ax is not None and sizes[ax] > 1 for ax in spec)


def local_slices(spec: tuple, shape: tuple, mesh) -> tuple:
    """This rank's slice of each dim of a whole leaf of ``shape``."""
    return _slices(spec, shape, mesh, mesh.coords())


def cut(t: Any, spec: tuple, mesh) -> Any:
    """This rank's shard of the whole tensor ``t`` (a contiguous copy), or
    ``t`` itself where the spec splits nothing."""
    if not isinstance(t, torch.Tensor) or not splits(spec, mesh):
        return t
    return t[_slices(spec, tuple(t.shape), mesh, mesh.coords())].clone(
        memory_format=torch.contiguous_format)  # its own storage, not a view of t's


def offsets(spec: tuple, local_shape: tuple, mesh) -> tuple:
    """The global coordinates of this rank's shard origin, one per dim: the
    shard's index on its axis times the local dim (the reference's
    ``_global_offsets``)."""
    coords = mesh.coords()
    return tuple(0 if (d >= len(spec) or spec[d] is None) else coords[spec[d]] * n
                 for d, n in enumerate(local_shape))


def _whole_shape(spec: tuple, local_shape: tuple, sizes: dict, keep: frozenset) -> tuple:
    return tuple(n * sizes[spec[d]] if (d < len(spec) and spec[d] is not None
                                       and spec[d] not in keep) else n
                 for d, n in enumerate(local_shape))


def gather_many(mesh, items: list) -> list:
    """Whole tensors from this rank's shards, in one all-gather: ``items``
    are ``(local, spec, keep)``; a mesh axis in ``keep`` stays split (the
    result is this rank's part along it).  Replicated dims come from any
    rank; every shard has its leaf's one local shape (the specs shard only
    dims that divide)."""
    if not items:
        return []
    chunks, starts, off = [], [], 0
    for t, _, _ in items:  # each leaf's bytes from a 16-byte boundary
        b = t.contiguous().view(-1).view(torch.uint8)
        pad = -b.numel() % 16
        chunks += [b, b.new_zeros(pad)] if pad else [b]
        starts.append(off)
        off += b.numel() + pad
    parts = mesh.all_gather(torch.cat(chunks))  # [world, bytes]
    sizes, me = mesh_axis_sizes(mesh), mesh.coords()
    outs = []
    for (t, spec, keep), off in zip(items, starts):
        keep = frozenset(keep)
        nbytes = t.numel() * t.element_size()
        out = torch.empty(_whole_shape(spec, tuple(t.shape), sizes, keep), dtype=t.dtype,
                          device=t.device)
        for r in range(mesh.world):
            c = mesh.coords(r)
            if any(c[ax] != me[ax] for ax in keep):
                continue
            where = tuple(
                slice(None) if (d >= len(spec) or spec[d] is None or spec[d] in keep)
                else slice(c[spec[d]] * n, (c[spec[d]] + 1) * n)
                for d, n in enumerate(t.shape))
            out[where] = parts[r, off:off + nbytes].view(t.dtype).view(t.shape)
        outs.append(out)
    return outs


def gather(t: torch.Tensor, spec: tuple, mesh, keep=()) -> torch.Tensor:
    return gather_many(mesh, [(t, spec, keep)])[0]


# --------------------------------------------------------------------------
# the registered context
# --------------------------------------------------------------------------


@dataclass
class ShardCtx:
    """The sharded run's mesh and each param leaf's spec and whole shape,
    keyed by the leaf's path (``utils.tree`` keystr); the spec tree of the
    whole ZO state and the whole state's meta stand-in (a checkpoint's
    restore template)."""

    mesh: Any
    specs: dict
    shapes: dict
    state_specs: Any = None
    whole_state: Any = None

    @property
    def mstate_specs(self) -> dict:
        return self.state_specs.mstate

    @classmethod
    def of(cls, mesh, state_specs: Any, whole_state: Any) -> "ShardCtx":
        """From a state's spec tree and the whole state (or its meta
        stand-in), whose params give each leaf's whole shape."""
        return cls(mesh, dict(flatten_with_path(state_specs.params)),
                   {p: tuple(w.shape) for p, w in flatten_with_path(whole_state.params,
                                                                    atomic=True)},
                   state_specs, whole_state)

    def spec(self, path: str) -> tuple:
        return self.specs[path]

    def sharded(self, path: str) -> bool:
        return path in self.specs and splits(self.spec(path), self.mesh)

    def slices(self, path: str, shape: tuple) -> tuple:
        """This rank's slice of each dim of leaf ``path`` of whole ``shape``."""
        return local_slices(self.spec(path), shape, self.mesh)

    def global_view(self, path: str, w):
        """A meta tensor of the leaf's whole shape and ``w``'s dtype (what
        shape rules and host draws read), or ``w`` itself if unsharded."""
        if not self.sharded(path):
            return w
        return torch.empty(self.shapes[path], dtype=w.dtype, device="meta")

    def offsets(self, path: str, w) -> Optional[tuple]:
        """The global origin of this rank's shard of leaf ``path`` (None
        when the leaf is whole here)."""
        if not self.sharded(path):
            return None
        return offsets(self.spec(path), tuple(w.shape), self.mesh)

    def _cut(self, path: str, t, spec: tuple):
        return cut(t, spec, self.mesh) if self.sharded(path) else t

    def like(self, path: str, t):
        """``t`` of the leaf's whole shape, cut as the leaf is."""
        return self._cut(path, t, self.spec(path))

    def lead(self, path: str, t):
        """``t`` whose leading dims are the leaf's batch dims (τ [..., r],
        Σ [..., r, r]), cut on them."""
        return self._cut(path, t, self.spec(path)[:-2])

    def rows(self, path: str, t):
        """A row factor [..., m, r], cut as u is (batch and row spec)."""
        s = self.spec(path)
        return self._cut(path, t, s[:-2] + (s[-2], None))

    def cols(self, path: str, t):
        """A column factor [..., n, r], cut as v is (batch and column spec)."""
        s = self.spec(path)
        return self._cut(path, t, s[:-2] + (s[-1], None))


_CTX: Optional[ShardCtx] = None


def current() -> Optional[ShardCtx]:
    return _CTX


@contextmanager
def placed(ctx: Optional[ShardCtx]):
    """Register ``ctx`` for the body, its mesh as the current mesh too (the
    expert-parallel MoE reads it there); None is a no-op (the
    single-process path).  Restores both on the way out."""
    global _CTX
    if ctx is None:
        yield ctx
        return
    prev, prev_mesh = _CTX, current_mesh()
    _CTX = ctx
    set_current_mesh(ctx.mesh)
    try:
        yield ctx
    finally:
        _CTX = prev
        set_current_mesh(prev_mesh)


def view(path: str, w):
    """The leaf's global view (:meth:`ShardCtx.global_view`), or ``w``."""
    return w if _CTX is None else _CTX.global_view(path, w)


def like(path: str, t):
    return t if _CTX is None else _CTX.like(path, t)


def lead(path: str, t):
    return t if _CTX is None else _CTX.lead(path, t)


def rows(path: str, t):
    return t if _CTX is None else _CTX.rows(path, t)


def cols(path: str, t):
    return t if _CTX is None else _CTX.cols(path, t)


def leaf_offsets(path: str, w) -> Optional[tuple]:
    return None if _CTX is None else _CTX.offsets(path, w)


def whole_shape(path: str, default: tuple) -> tuple:
    """The whole shape of param leaf ``path`` when it is sharded, else
    ``default``."""
    if _CTX is None or not _CTX.sharded(path):
        return tuple(default)
    return _CTX.shapes[path]


def mstate_whole(key: str, entries: dict) -> dict:
    """``{path: tensor}`` entries of method-state dict ``key``, gathered
    whole (one all-gather); as they are without a context."""
    if _CTX is None:
        return entries
    specs = _CTX.mstate_specs[key]
    names = [p for p in entries if splits(specs[p], _CTX.mesh)]
    out = dict(entries)
    for p, w in zip(names, gather_many(_CTX.mesh, [(entries[p], specs[p], ())
                                                   for p in names])):
        out[p] = w
    return out


def mstate_cut(key: str, entries: dict) -> dict:
    """Whole ``{path: tensor}`` entries of method-state dict ``key`` cut to
    this rank's shards."""
    if _CTX is None:
        return entries
    specs = _CTX.mstate_specs[key]
    return {p: cut(t, specs[p], _CTX.mesh) for p, t in entries.items()}


# --------------------------------------------------------------------------
# the forward on shards
# --------------------------------------------------------------------------


def whole(params: dict, name: str):
    """Top-level leaf ``params[name]`` whole: gathered under a context."""
    w = params[name]
    path = f"[{name!r}]"
    if _CTX is None or not _CTX.sharded(path):
        return w
    return gather(w, _CTX.spec(path), _CTX.mesh)


def layer(params: dict, i: int, keep: Optional[dict] = None) -> dict:
    """Layer ``i`` of every stacked block leaf (``params['blocks']``); under
    a context the layer's shards are gathered in one all-gather.  ``keep``
    {leaf name: mesh axes} leaves those axes split (the expert-parallel
    MoE's local experts)."""
    blocks = params["blocks"]
    if _CTX is None:
        return {name: w[i] for name, w in blocks.items()}
    return _gather_named({name: (f"['blocks'][{name!r}]", w[i], 1)
                          for name, w in blocks.items()}, keep or {})


def subtree(tree: dict, prefix: str) -> dict:
    """A dict of unstacked leaves under ``prefix`` (xLSTM's per-layer
    blocks), gathered in one all-gather under a context."""
    if _CTX is None:
        return tree
    return _gather_named({name: (f"{prefix}[{name!r}]", w, 0) for name, w in tree.items()},
                         {})


def _gather_named(named: dict, keep: dict) -> dict:
    out, items, names = {}, [], []
    sizes = mesh_axis_sizes(_CTX.mesh)
    for name, (path, w, skip) in named.items():
        spec, kept = _CTX.spec(path)[skip:], keep.get(name, ())
        if not any(ax is not None and ax not in kept and sizes[ax] > 1 for ax in spec):
            out[name] = w  # whole here, or split only on kept axes
            continue
        items.append((w, spec, kept))
        names.append(name)
    for name, w in zip(names, gather_many(_CTX.mesh, items)):
        out[name] = w
    return out


def data_share(batch: dict) -> dict:
    """This rank's data-axis share of a whole batch (its leading dim split
    over the data axis when it divides)."""
    mesh = _CTX.mesh
    return {k: cut(v, batch_spec(mesh, tuple(v.shape)), mesh) for k, v in batch.items()}


def sum_in_rank_order(vals: torch.Tensor, mesh, over: str = "data") -> torch.Tensor:
    """The sum over the ``over`` axis of every rank's ``vals``, in rank
    order: rank 0's, then rank 1's, ..., taking one rank per index of
    ``over`` (the ranks of the other axis at this rank's index hold
    copies).  ``over="model"``: the sum over this rank's model row."""
    parts = mesh.all_gather(vals)
    me = mesh.coords()
    other = "model" if over == "data" else "data"
    picked = [r for r in range(mesh.world)
              if mesh.coords(r)[other] == (0 if over == "data" else me[other])]
    acc = parts[picked[0]]
    for r in picked[1:]:
        acc = acc + parts[r]
    return acc
