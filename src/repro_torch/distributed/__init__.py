"""Distributed training (counterpart of ``repro.distributed``): the
probe-parallel lanes' assignment, the distinct-seed ensemble, straggler
masks and fault plans, and sharded parameters and ZO state
(``distributed.sharding``)."""

from repro_torch.distributed.collectives import (
    apply_kappa_weights,
    build_ensemble_zo_train_step,
    kappa_allreduce_bytes,
    probe_assignment,
)
from repro_torch.distributed.fault import (
    FailureReport,
    Heartbeat,
    StragglerSim,
    elastic_restart_plan,
)
