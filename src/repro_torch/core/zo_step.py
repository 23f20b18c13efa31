"""The ZO training step: Algorithm 1 as a perturbation chain (counterpart
of ``repro.core.zo_step``).

    first_perturb        W ← W + ρZ₀                     (1 pass)
    flip                 W ← W − 2ρZ_i                   (q passes)
    bridge               W ← W + ρZ_i + ρZ_{i+1}         (q − 1 passes)
    restore_into_update  W ← optimizer(W + ρZ_{q−1})     (1 pass)

``2q + 1`` weight passes per step, each chained op replaying the rounding
of the separate passes it merges, so the chained step equals the literal
``3q + 1`` schedule (``restore_mode="unchained"``) bit for bit.
``restore_mode="exact"`` branches the ±ρ copies off the original params
into a second set of buffers (2× weight memory).  Before the step's draws,
``method.begin_step`` applies the lazy refreshes at a window boundary
(LOZO-m's momentum reset, SubZO's new subspace).

The step updates the params in place on the device: the kernels write W
where it lies.  It returns the new state (the same param tensors, the new
optimizer state, step + 1) and device-side metrics; nothing in it reads a
value back to the host, so consecutive steps queue on the device without a
sync.

Probe-parallel schedule (``cfg.probe_parallel``, the chained ``inplace``
mode, on a ``launch.mesh.HostMesh``: one process per rank).  The D data
lanes each evaluate a contiguous block of the q probes
(``distributed.collectives.probe_assignment``).  A rank perturbs the
original params into one scratch set of buffers: a lane that starts at
probe 0 opens with the first perturb, a lane that starts at probe s with
one catch-up chain of 3s + 1 deltas (probes 0 .. s−1's ±ρ triples, then
+ρ of probe s), and its block's bridges and flips follow in place.  Each
rank writes its probes' rows of a [q, 2] loss matrix (a rank off model
index 0 writes zeros) and one all-reduce over the ranks completes it: each
entry has one nonzero writer, so the sum is exact.  κ and the loss sums are
rebuilt in probe order with the sequential step's ops, and one update pass
on the original params replays the whole 3q-delta trajectory before the
update's own delta.  Every delta rounds to the weight dtype as its own pass
would, so the result is the sequential chained step's bit for bit, on
``2·ceil(q/D) + 1`` weight passes per rank.  The all-reduce's copy of the
2q losses to the host is the step's one wait on the device.

Sharded schedule (``shard``, a ``utils.shard_ctx.ShardCtx``, on a
``HostMesh`` without ``probe_parallel``).  Each rank holds its shard of
every param and state leaf, and runs the chained step above on them under
the context: each leaf op on the rank's shard (the noise kernels at the
shard's global offsets, the low-rank kernels with the matching factor
rows), each forward on gathered layers.  ``zo_passes`` stays 2q + 1; the
caller's ``loss_fn`` is ``sharding.sharded_loss(model)``, which reduces the
global token mean over the data lanes in rank order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.estimator import ZOConfig, _device, get_method
from repro_torch.utils import jax_random, shard_ctx
from repro_torch.utils.tree import flatten_with_path

RESTORE_MODES = ("inplace", "unchained", "exact")


def zo_pass_count(q_probes: int, restore_mode: str = "inplace",
                  probe_lanes: int | None = None) -> int:
    """Full-parameter weight passes per ZO step: ``2q + 1`` chained or
    exact, ``3q + 1`` unchained; with ``probe_lanes`` = D (probe-parallel)
    the busiest lane's ``2·ceil(q/D) + 1``."""
    if restore_mode not in RESTORE_MODES:
        raise ValueError(
            f"unknown restore_mode {restore_mode!r}; expected one of {RESTORE_MODES}"
        )
    if probe_lanes is not None:
        if restore_mode != "inplace":
            raise ValueError(
                "probe-parallel pass counting requires restore_mode='inplace' "
                f"(got {restore_mode!r})"
            )
        if probe_lanes < 1:
            raise ValueError(f"probe_lanes must be >= 1, got {probe_lanes}")
        return 2 * -(-q_probes // probe_lanes) + 1
    if restore_mode == "unchained":
        return 3 * q_probes + 1
    return 2 * q_probes + 1


@dataclass
class ZOTrainState:
    params: Any
    mstate: Any
    step: int  # host int (the reference's int32 scalar)
    base_key: np.ndarray  # uint32[2]


def init_zo_state(params: Any, cfg: ZOConfig, ranks: dict | None = None,
                  rank_masks: dict | None = None) -> ZOTrainState:
    """The reference's key chain: PRNGKey(seed) → fold_in 0xF0 for the
    method's factors, fold_in 0x5EED for the step keys.  ``ranks`` and
    ``rank_masks`` are ``core.rank.select_ranks``'s per-path overrides.
    With ``weight_quant`` the eligible block leaves are quantized first,
    their qu/qv drawn from the key TeZO's ``init_factors`` gets (the method
    key folded with 1), so the quantized run's factors are the dense run's."""
    key = jax_random.PRNGKey(cfg.seed)
    if cfg.weight_quant != "none":
        if ranks is not None or rank_masks is not None:
            raise ValueError(
                "weight_quant with per-path ranks/rank_masks is unsupported: "
                "quantized leaves draw their factors at cfg.rank before the "
                "method sees the overrides"
            )
        params = quant.quantize_for_config(
            params, cfg, jax_random.fold_in(jax_random.fold_in(key, 0xF0), 1))
    method = get_method(cfg.method)
    mstate = method.init(params, jax_random.fold_in(key, 0xF0), cfg, ranks, rank_masks)
    return ZOTrainState(params=params, mstate=mstate, step=0,
                        base_key=jax_random.key_data(jax_random.fold_in(key, 0x5EED)))


def branch_buffers(scratch: dict, params) -> dict:
    """One scratch buffer per leaf of ``params`` (a QuantLeaf's for its
    ``nacc``; its ``acc`` is new each pass), made into ``scratch`` at the
    first call and reused after: the second set of weights that a step
    perturbs off the originals writes to."""
    if not scratch:
        for p, w in flatten_with_path(params, atomic=True):
            if isinstance(w, quant.QuantLeaf):
                w = w.nacc
            scratch[p] = None if w is None else torch.empty_like(w)
    return scratch


def build_zo_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor], cfg: ZOConfig, *, mesh=None, shard=None
) -> Callable[[ZOTrainState, Any], tuple[ZOTrainState, dict]]:
    """``loss_fn(params, batch)`` → f32 scalar on the params' device.
    ``mesh`` (a ``launch.mesh.HostMesh``) is what the probe-parallel
    schedule runs on; ``shard`` (the ``ShardCtx`` of a state that
    ``distributed.sharding.init_state`` placed on ``mesh``) makes the
    chained schedule run on shards."""
    method = get_method(cfg.method)
    zo_pass_count(cfg.q_probes, cfg.restore_mode)  # fail fast on unknown schedules
    quant.validate_quant_config(cfg)  # ...and incompatible weight_quant combinations
    if cfg.probe_parallel:
        return _build_probe_parallel_step(loss_fn, cfg, method, mesh)
    if mesh is not None and mesh.world > 1 and shard is None:
        raise ValueError("a step on a multi-rank mesh without probe_parallel runs on a "
                         "sharded state: pass the shard context of sharding.init_state")
    scratch: dict = {}  # the exact mode's copies, reused across steps
    cache: dict = {}  # what the method reuses across steps (LOZO's window of U)

    def step_fn(state: ZOTrainState, batch: Any) -> tuple[ZOTrainState, dict]:
        with torch.inference_mode(), shard_ctx.placed(shard):
            key_t = jax_random.fold_in(state.base_key, state.step)
            mstate = method.begin_step(state.mstate, key_t, state.step, cfg)
            noise = method.draws(state.params, mstate, key_t, cfg, state.step, cache)
            lr = float(cfg.schedule(state.step))
            rho = cfg.rho
            params = state.params
            p = params
            kappas, f_plus_acc, f_minus_acc = [], 0.0, 0.0
            for probe in range(cfg.q_probes):
                if cfg.restore_mode == "exact":
                    out = branch_buffers(scratch, params)
                    p_plus = method.perturb(params, mstate, noise, probe, +rho, cfg, out=out)
                    f_plus = loss_fn(p_plus, batch)
                    p_minus = method.perturb(params, mstate, noise, probe, -rho, cfg, out=out)
                    f_minus = loss_fn(p_minus, batch)
                elif cfg.restore_mode == "unchained":
                    p = method.perturb(params, mstate, noise, probe, +rho, cfg)
                    f_plus = loss_fn(p, batch)
                    p = method.perturb(p, mstate, noise, probe, -2.0 * rho, cfg)
                    f_minus = loss_fn(p, batch)
                    params = method.perturb(p, mstate, noise, probe, +rho, cfg)
                else:  # "inplace": the chained transitions
                    if probe == 0:
                        p = method.perturb(p, mstate, noise, 0, +rho, cfg)
                    else:
                        p = method.perturb_pair(p, mstate, noise, probe - 1, +rho, probe,
                                                +rho, cfg)
                    f_plus = loss_fn(p, batch)
                    p = method.perturb(p, mstate, noise, probe, -2.0 * rho, cfg)
                    f_minus = loss_fn(p, batch)
                kappas.append((f_plus - f_minus) / (2.0 * rho))
                f_plus_acc = f_plus_acc + f_plus
                f_minus_acc = f_minus_acc + f_minus

            kappa_vec = torch.stack(kappas).float()
            if cfg.restore_mode == "inplace":
                params, mstate = method.update(p, mstate, noise, kappa_vec, lr, cfg,
                                               restore_probe=cfg.q_probes - 1,
                                               restore_scale=+rho)
            else:
                params, mstate = method.update(params, mstate, noise, kappa_vec, lr, cfg)

        q = float(cfg.q_probes)
        metrics = {
            "loss": (f_plus_acc + f_minus_acc) / (2.0 * q),
            "kappa_abs": torch.mean(torch.abs(kappa_vec)),
            "kappa_var": torch.var(kappa_vec, unbiased=False),
            "lr": lr,
            "zo_passes": zo_pass_count(cfg.q_probes, cfg.restore_mode),
        }
        new_state = ZOTrainState(params=params, mstate=mstate, step=state.step + 1,
                                 base_key=state.base_key)
        return new_state, metrics

    return step_fn


def _build_probe_parallel_step(loss_fn, cfg: ZOConfig, method, mesh):
    """The probe-parallel schedule on ``mesh`` (see the module docstring):
    this rank runs its data lane's block of probes."""
    if cfg.restore_mode != "inplace":
        raise ValueError(
            "probe_parallel requires restore_mode='inplace' (the chained "
            f"schedule); got restore_mode={cfg.restore_mode!r}"
        )
    if mesh is None or "data" not in mesh.axis_names:
        raise ValueError(
            "probe_parallel requires a mesh with a 'data' axis (got "
            f"{None if mesh is None else mesh.axis_names})"
        )
    from repro_torch.distributed.collectives import probe_assignment

    q, rho = cfg.q_probes, cfg.rho
    starts, counts = probe_assignment(q, mesh.data)
    start, count = starts[mesh.data_index], counts[mesh.data_index]
    writes = mesh.model_index == 0  # the other ranks of a lane add zeros
    passes = zo_pass_count(q, cfg.restore_mode, probe_lanes=mesh.data)
    # the lane's opening chain: probes 0 .. start-1's ±ρ triples, then +ρ of
    # probe `start` (the first perturb when start is 0)
    open_probes = tuple(i for i in range(start) for _ in range(3)) + (start,)
    open_scales = tuple(s for _ in range(start) for s in (+rho, -2.0 * rho, +rho)) + (+rho,)
    # the whole trajectory, which the update replays on the original params
    restore_probes = tuple(i for i in range(q) for _ in range(3))
    restore_scales = tuple(s for _ in range(q) for s in (+rho, -2.0 * rho, +rho))
    scratch: dict = {}
    cache: dict = {}

    def step_fn(state: ZOTrainState, batch: Any) -> tuple[ZOTrainState, dict]:
        with torch.inference_mode():
            key_t = jax_random.fold_in(state.base_key, state.step)
            mstate = method.begin_step(state.mstate, key_t, state.step, cfg)
            noise = method.draws(state.params, mstate, key_t, cfg, state.step, cache)
            lr = float(cfg.schedule(state.step))
            params = state.params
            f_mat = None
            if count:
                p = method.perturb_chain(params, mstate, noise, open_probes, open_scales, cfg,
                                         out=branch_buffers(scratch, params))
                rows = []
                for probe in range(start, start + count):
                    if probe > start:
                        p = method.perturb_pair(p, mstate, noise, probe - 1, +rho, probe,
                                                +rho, cfg)
                    f_plus = loss_fn(p, batch)
                    p = method.perturb(p, mstate, noise, probe, -2.0 * rho, cfg)
                    rows.append(torch.stack([f_plus, loss_fn(p, batch)]).float())
                block = torch.stack(rows)
                f_mat = torch.zeros((q, 2), dtype=torch.float32, device=block.device)
                if writes:
                    f_mat[start:start + count] = block
            f_mat = mesh.all_reduce_losses(f_mat, q, _device(params))

            # κ and the loss sums in probe order, the sequential step's ops
            kappas, f_plus_acc, f_minus_acc = [], 0.0, 0.0
            for i in range(q):
                f_plus, f_minus = f_mat[i, 0], f_mat[i, 1]
                kappas.append((f_plus - f_minus) / (2.0 * rho))
                f_plus_acc = f_plus_acc + f_plus
                f_minus_acc = f_minus_acc + f_minus
            kappa_vec = torch.stack(kappas).float()
            params, mstate = method.update(params, mstate, noise, kappa_vec, lr, cfg,
                                           restore_probe=restore_probes,
                                           restore_scale=restore_scales)

        metrics = {
            "loss": (f_plus_acc + f_minus_acc) / (2.0 * float(q)),
            "kappa_abs": torch.mean(torch.abs(kappa_vec)),
            "kappa_var": torch.var(kappa_vec, unbiased=False),
            "lr": lr,
            # the busiest lane's weight passes, not the sequential 2q + 1
            "zo_passes": passes,
        }
        new_state = ZOTrainState(params=params, mstate=mstate, step=state.step + 1,
                                 base_key=state.base_key)
        return new_state, metrics

    return step_fn

