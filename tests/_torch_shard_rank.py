"""One rank of the sharded-training parity job (tests/test_torch_sharding.py,
tests/test_torch_cuda.py).  It imports the port alone, no JAX, so a rank
starts in seconds.

    python tests/_torch_shard_rank.py OUT_DIR [--device cpu|cuda] [--cases all|card]

The first process is rank 0 of a 4-rank gloo job and spawns the other
three (``repro_torch.launch.mesh.host_ranks``).  Every case starts from the
seed's params of a smoke config and runs its steps on a sharded state
(``distributed.sharding``) on the ranks of its mesh, then gathers the state
whole; each rank of the mesh also runs the single-process step from the
same params for comparison.  Rank 0 writes one JSON line per case to
OUT_DIR/shard.jsonl:

* ``step``: two chained steps at q = 2 and lr 1e-2 of opt-125m-smoke:
  every method on a 1 x 2 mesh (ranks 0-1) in bf16 (and TeZO-Adam on the
  smoke configs of dbrx-132b, hymba-1.5b and xlstm-350m), and TeZO-Adam
  and MeZO-Adam on 2 x 1 and 2 x 2 in f32 (the reference's sharded test's
  bars are f32 bars), each of the latter twice (whether the two runs are
  bitwise); whether the gathered params, the method state, ``loss`` and
  ``kappa_abs`` are bitwise the single-process run's, and else the largest
  param difference and the relative differences of the loss and of
  ``kappa_abs``; the share of the single-process run's params that moved
  from init by more than ten times the params bar; ``zo_passes``; the
  ranks' resident param + state bytes against the single-process run's;
* ``ensemble``: the distinct-seed ensemble of 2 members on 1 x 2 (bf16)
  and 2 x 2 (f32), with and without stragglers, against the
  single-process ensemble, with the same records;
* ``moe_ep``: dbrx-132b-smoke's loss with ``moe_impl="ep"`` at capacity
  factor 8 on 1 x 2 and 2 x 2 against the single-device path;
* ``restore``: a checkpoint saved whole by one process, restored onto 1 x 2
  and 2 x 2 with the state's specs, against the cut of the whole state;
* ``granite``: one TeZO-Adam step of granite-8b-smoke (rank 4, lr 1e-2) on
  2 x 2 from numpy params of seed 0 (the test's ``numpy_params``) on a
  ``make_inputs`` batch, its gathered params written to
  OUT_DIR/granite.npz for the test to hold against the reference's
  unsharded step, with its ``loss`` and ``kappa_abs``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.distributed import build_ensemble_zo_train_step, sharding
from repro_torch.distributed.fault import StragglerSim
from repro_torch.launch.mesh import HostMesh, host_ranks
from repro_torch.launch.train import to_device
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.spec import PSpec
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path, tree_size_bytes

WORLD = 4
METHODS = ("tezo", "tezo_m", "tezo_adam", "mezo", "mezo_m", "mezo_adam", "lozo", "lozo_m",
           "subzo")
DATA = DataConfig(seq_len=16, global_batch=4, vocab_size=256, seed=0)
STEPS, Q = 2, 2
# ten times the reference's params bar (tests/test_sharding_multidevice.py:
# 55-58): a step compared at that bar must move the params further
MOVED_BAR = 10 * 2e-4
# the lr of the steps compared on data lanes, whose losses are summed in
# another order than the single process's (a relative 1e-7 apart): TeZO-Adam
# moves each element by about 3 lr a step, MeZO-Adam by lr (its first step
# is lr times a sign), which at 1e-2 also moves by 2e-4 when one of its
# losses changes by 1e-7 relative
DATA_LANE_LR = {"tezo_adam": 1e-2, "mezo_adam": 2.5e-3}
GRANITE_LR = 1e-2  # tests/test_torch_sharding.py runs the reference's step at it
# the other families' layer hooks: the MoE's stacked experts, Hymba's reuse
# of the transformer's layer, xLSTM's per-layer blocks
FAMILY_ARCHS = ("dbrx-132b", "hymba-1.5b", "xlstm-350m")


def digests(tree) -> dict:
    return {p: hashlib.sha256(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                              .tobytes()).hexdigest()
            for p, v in flatten_with_path(tree) if isinstance(v, torch.Tensor)}


def max_diff(a, b) -> float:
    la, lb = dict(flatten_with_path(a)), dict(flatten_with_path(b))
    return max(float((la[p].float() - lb[p].float()).abs().max()) for p in la)


def opt_model(device, dtype="bfloat16", arch="opt-125m"):
    return build_model(get_smoke_config(arch).reduced(dtype=dtype), device)


def zo_cfg(method: str, lr: float = 1e-2) -> ZOConfig:
    return ZOConfig(method=method, rank=8, lr=lr, q_probes=Q, lazy_interval=1)


def run(model, cfg, mesh, batches, ensemble=0, stragglers=False):
    """(final state, whole; metrics, resident bytes) of the steps on
    ``batches``: sharded on ``mesh``, or single-process when it is None."""
    shard, loss = None, model.loss_fn
    if mesh is None:
        state = init_zo_state(model.init(PRNGKey(0)), cfg)
    else:  # each rank draws its shards alone
        state, shard = sharding.init_state(model, cfg, mesh, PRNGKey(0))
        loss = sharding.sharded_loss(model)
    if ensemble:
        sim = StragglerSim(ensemble, 0.5, seed=99)
        step = build_ensemble_zo_train_step(loss, cfg, ensemble, shard=shard,
                                            straggler_mask_fn=sim.mask_fn() if stragglers
                                            else None)
    else:
        step = build_zo_train_step(loss, cfg, mesh=mesh, shard=shard)
    resident = tree_size_bytes(state.params) + tree_size_bytes(state.mstate)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({"loss": float(m["loss"]), "kappa_abs": float(m["kappa_abs"]),
                        "zo_passes": m.get("zo_passes")})
    if shard is not None:
        state = sharding.gather_tree(state, shard.state_specs, mesh)
    return state, metrics, resident


def moved_share(params, init, bar: float) -> float:
    """The share of the param elements that moved from ``init`` by more
    than ``bar``."""
    la, lb = dict(flatten_with_path(params)), dict(flatten_with_path(init))
    n = sum(int(((la[p].float() - lb[p].float()).abs() > bar).sum()) for p in la)
    return n / sum(x.numel() for x in la.values())


def kappa_rel(gm, wm) -> float:
    """The largest relative difference of ``kappa_abs`` over the steps."""
    return max(abs(a["kappa_abs"] - b["kappa_abs"]) / abs(b["kappa_abs"]) for a, b in zip(gm, wm))


def compare(got, want, extra: dict, init=None) -> dict:
    """One case's record from (state, metrics, resident) of the sharded and
    the single-process runs; with the ``init`` params, the share of the
    single-process run's params that moved by more than ten times the
    params bar (``MOVED_BAR``)."""
    (gs, gm, gres), (ws, wm, wres) = got, want
    dg, dw = digests(gs), digests(ws)
    if init is not None:
        extra = {**extra, "moved": moved_share(ws.params, init, MOVED_BAR)}
    return {**extra,
            "bitwise": dg == dw and [m["loss"] for m in gm] == [m["loss"] for m in wm]
            and [m["kappa_abs"] for m in gm] == [m["kappa_abs"] for m in wm],
            "differ": sorted(p for p in dw if dg.get(p) != dw[p])[:8],
            "param_diff": max_diff(gs.params, ws.params),
            "loss_rel": max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(gm, wm)),
            "kappa_rel": kappa_rel(gm, wm),
            "zo_passes": [m["zo_passes"] for m in gm],
            "resident": gres, "resident_whole": wres, "digest": dg}


def step_cases(which: str) -> list:
    """(arch, method, D, M) of the step cases."""
    if which == "card":
        return [("opt-125m", "tezo_adam", 1, 2), ("opt-125m", "mezo_adam", 1, 2),
                ("opt-125m", "tezo_adam", 2, 1)]
    return ([("opt-125m", m, 1, 2) for m in METHODS]
            + [(a, "tezo_adam", 1, 2) for a in FAMILY_ARCHS]
            + [("opt-125m", m, d, mm) for m in ("tezo_adam", "mezo_adam")
               for d, mm in ((2, 1), (2, 2))])


def numpy_params(cfg, seed: int) -> dict:
    """tests/_torch_ref.py's numpy params (normal * spec.scale; norm
    scales * 0.1), without its JAX import."""
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, PSpec):
            scale = node.scale if node.init == "normal" else 0.1
            return (rng.standard_normal(node.shape) * scale).astype(np.float32)
        return {k: make(v) for k, v in node.items()}

    return make(build_model(cfg, "cpu").impl.param_specs())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", type=Path)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--cases", default="all", choices=["all", "card"])
    args = ap.parse_args()
    torch.set_num_threads(1)
    dev = torch.device(args.device)
    with host_ranks(WORLD, [sys.executable, __file__, *sys.argv[1:]]) as rank:
        groups = {2: dist.new_group([0, 1], backend="gloo"), WORLD: dist.group.WORLD}
        if dev.type == "cuda":  # the ranks share the card: rank 0 builds the kernels
            from repro_torch.kernels import _build
            if rank == 0:
                _build.load()
            dist.barrier()

        def mesh_of(d, m):
            return HostMesh(d, m, rank, groups[d * m]) if rank < d * m else None

        lines = []
        model, model32 = opt_model(dev), opt_model(dev, "float32")
        batches = [to_device(batch_at_step(DATA, s), dev) for s in range(STEPS)]

        def setting(d, arch="opt-125m", method="tezo_adam"):
            """(model, lr): bf16 on one data lane (bitwise), f32 on two (the
            reference's sharded test compares in f32); an lr at which a step
            moves the params past ten times the params bar (``DATA_LANE_LR``)."""
            if arch != "opt-125m":
                return opt_model(dev, arch=arch), 1e-2
            return (model, 1e-2) if d == 1 else (model32, DATA_LANE_LR[method])

        for arch, method, d, m in step_cases(args.cases):
            mesh = mesh_of(d, m)
            if mesh is None:
                continue
            model_c, lr = setting(d, arch, method)
            cfg = zo_cfg(method, lr)
            data = dataclasses.replace(DATA, vocab_size=min(DATA.vocab_size,
                                                            model_c.cfg.vocab_size))
            bs = [to_device(batch_at_step(data, s), dev) for s in range(STEPS)]
            got = run(model_c, cfg, mesh, bs)
            rec = compare(got, run(model_c, cfg, None, bs),
                          {"case": "step", "arch": arch, "method": method, "data": d,
                           "model": m}, init=model_c.init(PRNGKey(0)))
            if d > 1:  # the reduction over the data lanes repeats bit for bit
                rec["repeat_bitwise"] = (digests(run(model_c, cfg, mesh, bs)[0])
                                         == rec["digest"])
            lines.append(rec)
        if args.cases == "all":
            for (d, m), stragglers in [((1, 2), False), ((1, 2), True), ((2, 2), True)]:
                mesh = mesh_of(d, m)
                if mesh is None:
                    continue
                model_c, lr = setting(d)
                cfg = zo_cfg("tezo_adam", lr)
                got = run(model_c, cfg, mesh, batches, ensemble=2, stragglers=stragglers)
                lines.append(compare(got, run(model_c, cfg, None, batches, 2, stragglers),
                                     {"case": "ensemble", "data": d, "model": m,
                                      "stragglers": stragglers},
                                     init=model_c.init(PRNGKey(0))))
            base = get_smoke_config("dbrx-132b").reduced(moe_capacity_factor=8.0)
            moe = build_model(base, dev)
            ep = build_model(base.reduced(moe_impl="ep"), dev)
            p = moe.init(PRNGKey(0))
            batch = moe.make_inputs(PRNGKey(1), ShapeConfig("t", 32, 4, "train"))
            want = float(moe.loss_fn(p, batch))
            for d, m in ((1, 2), (2, 2)):
                mesh = mesh_of(d, m)
                if mesh is None:
                    continue
                state, shard = sharding.init_state(ep, ZOConfig(method="tezo_adam", rank=4),
                                                   mesh, params=p)
                with sharding.placed(shard):
                    got = float(sharding.sharded_loss(ep)(state.params, batch))
                lines.append({"case": "moe_ep", "data": d, "model": m, "loss": got,
                              "loss_single": want})
            whole = init_zo_state(model.init(PRNGKey(0)), zo_cfg("mezo_adam"))
            ckdir = [tempfile.mkdtemp(prefix="shard_ck_")] if rank == 0 else [None]
            dist.broadcast_object_list(ckdir, src=0)
            if rank == 0:
                Checkpointer(ckdir[0]).save(3, whole, extra={"step": 3})
            dist.barrier()
            for d, m in ((1, 2), (2, 2)):
                mesh = mesh_of(d, m)
                if mesh is None:
                    continue
                specs = sharding.zo_state_specs(mesh, model.logical_axes(), whole)
                restored, extra = Checkpointer(ckdir[0]).restore(whole, shardings=specs,
                                                                 mesh=mesh)
                lines.append({"case": "restore", "data": d, "model": m,
                              "bitwise": digests(restored)
                              == digests(sharding.shard_tree(whole, specs, mesh)),
                              "sharded": sum(any(s) for _, s in flatten_with_path(specs)
                                             if isinstance(s, tuple)),
                              "step": extra["step"]})
            gcfg = get_smoke_config("granite-8b")
            gmodel = build_model(gcfg, dev)
            gparams = params_from_numpy(numpy_params(gcfg, 0), dev)
            gbatch = gmodel.make_inputs(PRNGKey(1), ShapeConfig("t", 32, 4, "train"))
            gz = ZOConfig(method="tezo_adam", rank=4, lr=GRANITE_LR)
            mesh = mesh_of(2, 2)
            state, shard = sharding.init_state(gmodel, gz, mesh, params=gparams)
            step = build_zo_train_step(sharding.sharded_loss(gmodel), gz, mesh=mesh,
                                       shard=shard)
            state, mets = step(state, gbatch)
            state = sharding.gather_tree(state, shard.state_specs, mesh, device="cpu")
            if rank == 0:
                np.savez(args.out / "granite.npz",
                         **{p: v.float().numpy() for p, v in flatten_with_path(state.params)})
            lines.append({"case": "granite", "loss": float(mets["loss"]),
                          "kappa_abs": float(mets["kappa_abs"])})
        if rank == 0:  # every case's mesh holds rank 0
            (args.out / "shard.jsonl").write_text(
                "".join(json.dumps({k: v for k, v in r.items() if k != "digest"}) + "\n"
                        for r in lines))


if __name__ == "__main__":
    main()
