"""Fault tolerance: straggler masks, failure reports, elastic restart
(counterpart of ``repro.distributed.fault``).

1. Straggler drop, per step: a member that misses the step's deadline is
   left out by zeroing its κ weight (``collectives.apply_kappa_weights``).
   A member contributes only its scalar κ, so dropping one never makes
   the members' states diverge.  :class:`StragglerSim` gives the
   reference's deterministic drop masks bit for bit.
2. Hard failure, elastic restart: checkpoints do not depend on the mesh,
   and :func:`elastic_restart_plan` maps a failure report to the largest
   healthy mesh to restore onto.
3. Seed-ahead: a step's perturbation is a pure function of (base key,
   step), so a member can derive the next step's draws before the κ of
   this one arrives.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.utils import jax_random


@dataclass(frozen=True)
class StragglerSim:
    """A deterministic straggler process: each member misses a step with
    probability ``drop_prob``, a Bernoulli draw on the counter stream of
    ``fold_in(PRNGKey(seed), step)``."""

    n_members: int
    drop_prob: float = 0.0
    seed: int = 1234

    def mask_fn(self) -> Callable[[int], torch.Tensor]:
        """``step -> [n_members]`` f32 0/1 weights on the host, the
        reference's masks bit for bit (``jax.random.bernoulli`` replayed);
        when every member drops, member 0 is kept."""
        key = jax_random.PRNGKey(self.seed)

        def fn(step: int) -> torch.Tensor:
            k = jax_random.fold_in(key, int(step))
            drops = jax_random.bernoulli(k, self.drop_prob, (self.n_members,))
            mask = 1.0 - drops.float()
            if not bool(mask.any()):  # never drop everyone: keep member 0
                mask[0] = 1.0
            return mask

        return fn


@dataclass(frozen=True)
class FailureReport:
    """What the control plane knows after a health sweep."""

    failed_pods: tuple = ()
    n_pods: int = 2
    pod_shape: tuple = (16, 16)


def elastic_restart_plan(report: FailureReport) -> dict:
    """Map a failure report to the next mesh and restore instructions:
    drop the failed pods and restart on the healthy ones, on the single-pod
    mesh if one remains.  A failed chip fails its pod (slices are
    scheduled whole)."""
    healthy = report.n_pods - len(report.failed_pods)
    if healthy <= 0:
        return {"action": "halt", "reason": "no healthy pods"}
    multi = healthy >= 2
    return {
        "action": "restart",
        "multi_pod": multi,
        "mesh_shape": ((healthy,) if multi else ()) + tuple(report.pod_shape),
        "mesh_axes": (("pod",) if multi else ()) + ("data", "model"),
        "notes": (
            "restore with checkpoint.restore(..., shardings=<new mesh>); "
            "global batch is preserved (per-pod batch grows), so the token "
            "stream and loss trajectory are unchanged"
        ),
    }


class Heartbeat:
    """Host-side liveness bookkeeping; ``clock`` may be injected (tests)."""

    def __init__(self, n_members: int, timeout_s: float, clock=None):
        self.n = n_members
        self.timeout = timeout_s
        self.clock = clock or time.monotonic
        self.last_seen = {i: self.clock() for i in range(n_members)}

    def beat(self, member: int) -> None:
        self.last_seen[member] = self.clock()

    def healthy(self) -> list[int]:
        now = self.clock()
        return [i for i in range(self.n) if now - self.last_seen[i] <= self.timeout]

    def report(self, n_pods: int, pod_shape=(16, 16)) -> FailureReport:
        healthy = set(self.healthy())
        failed = tuple(i for i in range(self.n) if i not in healthy)
        return FailureReport(failed_pods=failed, n_pods=n_pods, pod_shape=pod_shape)
