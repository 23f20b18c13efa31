"""Distributed ZO steps: the probe-parallel lanes' assignment, the
distinct-seed ensemble and straggler-tolerant κ aggregation (counterpart
of ``repro.distributed.collectives``).

Distinct-seed ensemble: member i draws its own probe i (τ⁽ⁱ⁾, or the
method's noise) and evaluates ±ρZ⁽ⁱ⁾ on its slice i of the batch.  The
combined update is every method's multi-probe update over the [n] κ
vector: for TeZO, ``G = (u · diag((1/n) Σᵢ κᵢ τ⁽ⁱ⁾)) vᵀ``, r floats a leaf
to exchange where a gradient all-reduce would move the weights.  A late
member is dropped by zeroing its κ weight and renormalizing
(:func:`apply_kappa_weights`); it contributes nothing else, so no state can
diverge.

The reference vmaps over the members with the ensemble axis sharded over
pods; the port runs them on one device in turn.  Each member perturbs ±ρ
off the original params into one scratch set of buffers (as the ``exact``
restore mode does), so the step makes 2n + 1 weight passes beside one extra
copy of the weights.  On a sharded state (``shard``, a
``utils.shard_ctx.ShardCtx``) the members run on the shards, each member's loss on
its batch slice over the data lanes (``sharding.sharded_loss``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.estimator import ZOConfig, _device, get_method
from repro_torch.core.zo_step import ZOTrainState, branch_buffers
from repro_torch.distributed import sharding
from repro_torch.utils import jax_random


def probe_assignment(q_probes: int, lanes: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Lane d of the probe-parallel schedule evaluates probes [starts[d],
    starts[d] + counts[d]): contiguous blocks, the first ``q_probes %
    lanes`` lanes one probe longer, surplus lanes none."""
    if q_probes < 1 or lanes < 1:
        raise ValueError((q_probes, lanes))
    base, extra = divmod(q_probes, lanes)
    counts = tuple(base + (1 if d < extra else 0) for d in range(lanes))
    starts = tuple(sum(counts[:d]) for d in range(lanes))
    return starts, counts


def apply_kappa_weights(kappas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Masked-mean reweighting: scaled so that the update's (1/n)Σ over the
    members equals Σ wᵢκᵢ / Σ wᵢ.  ``weights`` on κ's device."""
    n = kappas.shape[0]
    denom = torch.clamp(torch.sum(weights), min=1.0)
    return kappas * weights * (n / denom)


def build_ensemble_zo_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    cfg: ZOConfig,
    n_ensemble: int,
    straggler_mask_fn: Optional[Callable[[int], torch.Tensor]] = None,
    shard=None,
) -> Callable[[ZOTrainState, Any], tuple[ZOTrainState, dict]]:
    """The distinct-seed ensemble step.  The global batch must divide into
    ``n_ensemble`` contiguous slices; member i sees slice i and probe i.
    ``straggler_mask_fn(step)`` gives [n] host 0/1 weights (simulated
    faults, ``fault.StragglerSim``) that drop members.  ``shard``: the
    shard context of a sharded state (``sharding.init_state``)."""
    method = get_method(cfg.method)
    draws_cfg = dataclasses.replace(cfg, q_probes=n_ensemble)  # probes 0 .. n-1
    scratch: dict = {}
    cache: dict = {}

    def split_batch(batch: dict) -> list:
        lead = {k: v.shape[0] for k, v in batch.items()}
        if any(b % n_ensemble for b in lead.values()):
            raise ValueError(f"a batch of {lead} does not split into {n_ensemble} members")
        return [{k: v[i * (v.shape[0] // n_ensemble):(i + 1) * (v.shape[0] // n_ensemble)]
                 for k, v in batch.items()} for i in range(n_ensemble)]

    def step_fn(state: ZOTrainState, batch: Any) -> tuple[ZOTrainState, dict]:
        with torch.inference_mode(), sharding.placed(shard):
            key_t = jax_random.fold_in(state.base_key, state.step)
            mstate = method.begin_step(state.mstate, key_t, state.step, cfg)
            noise = method.draws(state.params, mstate, key_t, draws_cfg, state.step, cache)
            lr = float(cfg.schedule(state.step))
            params = state.params
            out = branch_buffers(scratch, params)
            f_plus, f_minus = [], []
            for i, member_batch in enumerate(split_batch(batch)):
                p = method.perturb(params, mstate, noise, i, +cfg.rho, cfg, out=out)
                f_plus.append(loss_fn(p, member_batch))
                p = method.perturb(params, mstate, noise, i, -cfg.rho, cfg, out=out)
                f_minus.append(loss_fn(p, member_batch))
            f_plus, f_minus = torch.stack(f_plus).float(), torch.stack(f_minus).float()
            kappas = (f_plus - f_minus) / (2.0 * cfg.rho)
            if straggler_mask_fn is not None:
                weights = jax_random.to_device(straggler_mask_fn(state.step).numpy(),
                                               _device(params))
                kappas = apply_kappa_weights(kappas, weights)
            params, mstate = method.update(params, mstate, noise, kappas, lr, cfg)

        new_state = ZOTrainState(params=params, mstate=mstate, step=state.step + 1,
                                 base_key=state.base_key)
        metrics = {
            "loss": torch.mean((f_plus + f_minus) / 2.0),
            "kappa_abs": torch.mean(torch.abs(kappas)),
            "lr": lr,
        }
        return new_state, metrics

    return step_fn


def kappa_allreduce_bytes(mstate: dict, n_ensemble: int) -> int:
    """The bytes of the distinct-seed κτ aggregation: one f32 r-vector per
    matrix of every factor leaf (what replaces a gradient all-reduce)."""
    total = 0
    for f in mstate.get("factors", {}).values():
        batch = 1
        for d in f.batch:
            batch *= d
        total += batch * f.rank * 4
    return total
