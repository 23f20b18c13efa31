"""Sharded parameters and ZO state on a ``data`` x ``model`` host mesh
(counterpart of ``repro.distributed.sharding`` and of the reference's
shard-aware dispatch, ``repro.core.dispatch.shard_context``).

The model declares logical axes per parameter (``models.spec``); one table
maps them onto mesh axes:

    embed    -> "data"   (FSDP: weights sharded on the embed dim)
    heads/ff -> "model"  (the reference's tensor-parallel axes; here they
                          shard storage only)
    experts  -> "model"  (expert parallelism; expert-internal ff unsharded)
    vocab    -> "model"  (embedding and logits)
    layers   -> None     (the stacked-layer axis)

A dim that does not divide stays replicated, and a mesh axis shards at most
one dim of a leaf.  A spec here is plain data: one mesh-axis name or None
per dim of the leaf.  TeZO's ``u`` takes W's row spec and ``v`` its column
spec, τ-space moments are replicated, the dense moments take their leaf's
spec (``mstate_specs``, the reference's ``mstate_shardings``); the batch is
split on the data axis and replicated on the model axis.

Each rank keeps only its shard of every param and state leaf, drawn so
(:func:`init_state`) or cut from the whole (:func:`shard_tree`).  Under
the state's :class:`~repro_torch.utils.shard_ctx.ShardCtx` the code that
takes a leaf works on shards (``utils.shard_ctx``): every layer is
gathered whole just in time for the forward, so each rank computes every
layer (only the expert-parallel MoE, ``TransformerLM._moe_ep``, splits
compute over the model axis); the training loss runs on the rank's data
share of the batch and reduces the global token mean
(:func:`sharded_loss`); the leaf ops run on the shards.  Quantized leaves
on a mesh are ROADMAP.md item 13c.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.cpd import CPDFactor
from repro_torch.utils.shard_ctx import (ShardCtx, batch_spec, current, cut,  # noqa: F401
                                         data_share, gather, mesh_axis_sizes, placed,
                                         splits, sum_in_rank_order)
from repro_torch.utils.tree import flatten_with_path, is_atomic_leaf, map_with_path

LOGICAL_RULES: dict[Optional[str], Optional[str]] = {
    "layers": None,
    "embed": "data",
    "heads": "model",
    "kv_heads": None,
    "ff": "model",
    "ff_expert": None,
    "experts": "model",
    "vocab": "model",
    None: None,
}


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axis_for(logical: Optional[str], dim: int, sizes: dict) -> Optional[str]:
    phys = LOGICAL_RULES.get(logical, None)
    if phys is None:
        return None
    if dim % sizes.get(phys, 1) != 0:
        return None  # non-divisible dims stay replicated (e.g. 25 heads / 16)
    return phys


def spec_for_axes(axes: tuple, shape: tuple, mesh) -> tuple:
    """One mesh axis (or None) per dim of a leaf of ``shape`` with logical
    ``axes``; an axis shards at most one dim, the first that takes it."""
    sizes = mesh_axis_sizes(mesh)
    used, out = set(), []
    for logical, dim in zip(axes, shape):
        phys = _axis_for(logical, dim, sizes)
        if phys in used:
            phys = None
        if phys is not None:
            used.add(phys)
        out.append(phys)
    return tuple(out)


def replicated(ndim: int) -> tuple:
    return (None,) * ndim


def _refuse_quant(tree: Any) -> None:
    for path, leaf in flatten_with_path(tree, atomic=True):
        if is_atomic_leaf(leaf):
            raise NotImplementedError(
                f"quantized leaf {path} on a sharded mesh is not ported yet "
                "(ROADMAP.md Queue A item 13c)")


# --------------------------------------------------------------------------
# the spec tables
# --------------------------------------------------------------------------


def _axes_by_path(axes_tree: Any) -> dict[str, tuple]:
    """{leaf path: logical axes tuple} (a tuple is a leaf of these walks)."""
    return dict(flatten_with_path(axes_tree))


def _ndim(a) -> int:
    return a.dim() if isinstance(a, torch.Tensor) else np.ndim(a)


def param_specs(mesh, axes_tree: Any, params: Any) -> Any:
    """The params' spec tree (same layout as ``params``)."""
    _refuse_quant(params)
    table = _axes_by_path(axes_tree)
    return map_with_path(lambda path, w: spec_for_axes(table[path], tuple(w.shape), mesh),
                         params)


def mstate_specs(mesh, axes_tree: Any, mstate: dict) -> dict:
    """The method state's spec tree, the reference's ``mstate_shardings``
    rule for rule (τ-space moments and anything unlisted replicated), but
    for a factor's rank mask: host 0/1 data that the τ draw reads whole, it
    stays whole (the reference shards it on the leaf's batch dims)."""
    table = _axes_by_path(axes_tree)

    def leaf_spec(path, a):
        axes = table.get(path)
        if axes is None:
            return replicated(_ndim(a))
        return spec_for_axes(axes, tuple(a.shape), mesh)

    def factor_spec(path, f: CPDFactor) -> CPDFactor:
        axes = table.get(path)
        mask = None if f.rank_mask is None else replicated(f.rank_mask.dim())
        if axes is None:
            return CPDFactor(replicated(f.u.dim()), replicated(f.v.dim()), mask)
        batch = axes[:-2]
        return CPDFactor(spec_for_axes(batch + (axes[-2], None), tuple(f.u.shape), mesh),
                         spec_for_axes(batch + (axes[-1], None), tuple(f.v.shape), mesh), mask)

    def stored_factor_spec(path, a, which: int):
        axes = table.get(path)
        if axes is None:
            return replicated(a.dim())
        return spec_for_axes(axes[:-2] + (axes[which], None), tuple(a.shape), mesh)

    out: dict = {}
    for key, sub in mstate.items():
        if key == "factors":
            out[key] = {p: factor_spec(p, f) for p, f in sub.items()}
        elif key in ("dense_m", "dense_v", "m", "v", "v_m"):
            out[key] = {p: leaf_spec(p, a) for p, a in sub.items()}
        elif key in ("U", "V"):  # SubZO's stored factors: row / column like u, v
            out[key] = {p: stored_factor_spec(p, a, {"U": -2, "V": -1}[key])
                        for p, a in sub.items()}
        else:  # tau_m, tau_v, base_key, ...: replicated
            out[key] = map_with_path(lambda _, a: replicated(_ndim(a)), sub)
    return out


def zo_state_specs(mesh, axes_tree: Any, state: Any) -> Any:
    """The spec tree of a whole ``core.zo_step.ZOTrainState``."""
    return dataclasses.replace(
        state, params=param_specs(mesh, axes_tree, state.params),
        mstate=mstate_specs(mesh, axes_tree, state.mstate), step=(), base_key=(None,))


# --------------------------------------------------------------------------
# cutting and gathering
# --------------------------------------------------------------------------


def _zip_map(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over the tensor leaves of ``tree`` and the parallel
    spec tree (dicts, dataclasses such as ``ZOTrainState`` and
    ``CPDFactor``); anything else passes through."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _zip_map(fn, getattr(tree, f.name), getattr(specs, f.name))
            for f in dataclasses.fields(tree)
            if getattr(tree, f.name) is not None and not f.metadata.get("static")})
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    return tree


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's shard of every tensor leaf of the whole ``tree``."""
    return _zip_map(lambda t, s: cut(t, s, mesh), tree, specs)


def gather_tree(tree: Any, specs: Any, mesh, device=None) -> Any:
    """The whole tree from this rank's shards, leaf by leaf (every rank
    takes part and gets the whole), each leaf on ``device`` (default its
    own): the checkpoint gathers onto the host."""
    def one(t, s):
        w = gather(t, s, mesh) if splits(s, mesh) else t
        return w if device is None else w.to(device)

    return _zip_map(one, tree, specs)


def shard_context(mesh, specs: Any, whole_state: Any) -> ShardCtx:
    """The :class:`ShardCtx` of a state with spec tree ``specs`` (from the
    whole state, :func:`zo_state_specs`); ``whole_state`` (its meta
    stand-in will do) gives the leaves' whole shapes.  A factor whose
    stored spec is not the one its leaf's shard takes (u by W's rows, v by
    its columns) is refused."""
    ctx = ShardCtx.of(mesh, specs, whole_state)
    for key, which in (("factors", None), ("U", -2), ("V", -1)):
        for path, fs in specs.mstate.get(key, {}).items():
            w = ctx.spec(path)
            pairs = ([(fs.u, w[:-2] + (w[-2], None)), (fs.v, w[:-2] + (w[-1], None))]
                     if which is None else [(fs, w[:-2] + (w[which], None))])
            for got, want in pairs:
                if tuple(got) != tuple(want):
                    raise NotImplementedError(
                        f"{path}: the {key} spec {got} is not its leaf's {want}")
    return ctx


def init_state(model, cfg, mesh, key=None, params: Any = None, ranks: Optional[dict] = None,
               rank_masks: Optional[dict] = None) -> tuple:
    """(this rank's shard of ``init_zo_state(params, cfg, ranks,
    rank_masks)`` on ``mesh``, the :class:`ShardCtx` its step runs under).

    The specs are read off the whole state's meta stand-in (the same
    ``init_zo_state`` on ``model.abstract_params()``, which draws
    nothing).  Without ``params`` each rank draws its shard of
    ``model.init(key)`` alone; given the whole params (after
    ``--pretrain-steps``, say) it cuts them.  The method state is then
    drawn on the shards under the context: zeros of the shard's shape, and
    the factors drawn whole and cut.  No rank holds the whole model or
    state, and each shard is bitwise the cut of the whole state."""
    from repro_torch.core.zo_step import init_zo_state

    abstract = init_zo_state(model.abstract_params(), cfg, ranks, rank_masks)
    specs = zo_state_specs(mesh, model.logical_axes(), abstract)
    shard = shard_context(mesh, specs, abstract)
    params = (model.init(key, shard) if params is None
              else shard_tree(params, specs.params, mesh))
    with placed(shard):
        state = init_zo_state(params, cfg, ranks, rank_masks)
    return state, shard


def sharded_loss(model):
    """The training loss on shards: each rank's forward on its data share
    of the batch (layers gathered just in time), the global token mean from
    the (NLL sum, token count) of every data lane added in rank order.  On
    one data lane it is the model's own loss, bitwise."""

    def loss_fn(params, batch):
        ctx = current()
        if ctx is None or mesh_axis_sizes(ctx.mesh)["data"] == 1:
            return model.loss_fn(params, batch)
        s, n = model.loss_sums(params, data_share(batch))
        tot = sum_in_rank_order(torch.stack([s, n]).float(), ctx.mesh)
        return tot[0] / torch.clamp_min(tot[1], 1.0)

    return loss_fn
