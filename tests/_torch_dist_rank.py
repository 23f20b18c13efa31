"""One rank of the probe-parallel parity job (tests/test_torch_distributed.py,
tests/test_torch_cuda.py).  It imports the port alone, no JAX, so a rank
starts in seconds.

    python tests/_torch_dist_rank.py OUT.jsonl [--device cpu|cuda] [--cases all|card]

The first process is rank 0 of a 4-rank gloo job and spawns the other
three (``repro_torch.launch.mesh.host_ranks``).  Each case runs two
probe-parallel steps of opt-125m-smoke in bf16 on its mesh's ranks, from
the seed's params: D = 2 (ranks 0-1) for every method at q in {2, 3, 4},
TeZO-Adam at q = 4 on D = 3 (ranks 0-2) and on a 2 x 2 mesh (all four).
A rank outside the case's mesh (rank 1 for the 2 x 2 mesh, after its
lane) runs the same two steps on the sequential chained schedule
meanwhile.  Rank 0 gathers every rank's sha256 digests of each param and
state leaf and writes one JSON line per case to OUT: whether params, method
state and the metrics ``loss`` and ``kappa_abs`` are bitwise equal, whether
every rank of the case ended with the same state, and the ``zo_passes``
metric.  Last, ranks 0-1 run the trainer with ``--adaptive-q`` on
probe-parallel while rank 2 runs it sequentially; their q histories,
losses and final evaluations go to OUT as one more line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch.mesh import HostMesh, host_ranks
from repro_torch.launch.train import to_device, train
from repro_torch.models import build_model
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path

WORLD = 4
METHODS = ("tezo", "tezo_m", "tezo_adam", "mezo", "mezo_m", "mezo_adam", "lozo", "lozo_m",
           "subzo")
DATA = DataConfig(seq_len=16, global_batch=4, vocab_size=256, seed=0)
STEPS = 2


def cases(which: str) -> list:
    """(method, q, D, M) of each case; ``card`` is the short list the cuda
    test runs."""
    if which == "card":
        return [("tezo_adam", 3, 2, 1), ("mezo_adam", 3, 2, 1), ("lozo", 4, 2, 1)]
    return ([(m, q, 2, 1) for m in METHODS for q in (2, 3, 4)]
            + [("tezo_adam", 4, 3, 1), ("tezo_adam", 4, 2, 2)])


def run(method: str, q: int, device: str, mesh: HostMesh | None):
    model = build_model(get_smoke_config("opt-125m").reduced(dtype="bfloat16"), device)
    cfg = ZOConfig(method=method, rank=8, lr=1e-2, q_probes=q, lazy_interval=1,
                   probe_parallel=mesh is not None)
    state = init_zo_state(model.init(PRNGKey(0)), cfg)
    step = build_zo_train_step(model.loss_fn, cfg, mesh=mesh)
    metrics = []
    for s in range(STEPS):
        state, m = step(state, to_device(batch_at_step(DATA, s), model.device))
        metrics.append({k: m[k] for k in ("loss", "kappa_abs")} | {"zo_passes": m["zo_passes"]})
    return state, metrics


# LOZO from q = 3, one log a step: the κ dispersion grows q to its cap of 4
# at step 2 (tests/test_torch_lowrank.py's adaptive-q run), so the step is
# rebuilt at q = 4 on every rank
ADAPTIVE = dict(smoke=True, method="lozo", steps=3, q_probes=3, q_max=4, adaptive_q=True,
                log_every=1, eval_every=1000, verbose=False, seq_len=32, global_batch=4)


def adaptive_record(res: dict) -> dict:
    return {"q_history": [(h["step"], h["q_probes"]) for h in res["history"]
                          if "q_probes" in h],
            "loss": [h["loss"] for h in res["history"]], "q_probes": res["q_probes"],
            "final_eval_loss": res["final_eval_loss"], "zo_passes": res["zo_passes"]}


def leaf_digests(state) -> dict:
    """{path: sha256 of the tensor's bytes} over params and method state."""
    return {p: hashlib.sha256(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                              .tobytes()).hexdigest()
            for p, v in flatten_with_path(state) if isinstance(v, torch.Tensor)}


def record(state, metrics) -> dict:
    return {"leaves": leaf_digests(state),
            "loss": [float(m["loss"]) for m in metrics],
            "kappa_abs": [float(m["kappa_abs"]) for m in metrics],
            "zo_passes": [m["zo_passes"] for m in metrics],
            "wq": hashlib.sha256(state.params["blocks"]["wq"].float().cpu().numpy()
                                 .tobytes()).hexdigest()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", type=Path)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--cases", default="all", choices=["all", "card"])
    args = ap.parse_args()
    torch.set_num_threads(1)
    with host_ranks(WORLD, [sys.executable, __file__, *sys.argv[1:]]) as rank:
        groups = {n: dist.new_group(list(range(n)), backend="gloo") for n in (2, 3)}
        groups[WORLD] = dist.group.WORLD
        todo = cases(args.cases)
        mine = {}  # (case, "pp" or "seq") -> record
        for i, (method, q, d, m) in enumerate(todo):
            n = d * m
            if rank < n:
                mesh = HostMesh(d, m, rank, groups[n])
                mine[i, "pp", rank] = record(*run(method, q, args.device, mesh))
            # a rank outside the case's mesh runs the sequential reference
            # meanwhile (ranks 2 and 3 in turn beside a 2-lane mesh)
            if rank == (n + i % (WORLD - n) if n < WORLD else 1):
                mine[i, "seq", rank] = record(*run(method, q, args.device, None))
        if args.cases == "all":  # adaptive-q rebuilds the probe-parallel step
            if rank < 2:
                mine["adaptive", "pp", rank] = adaptive_record(train(
                    mesh=HostMesh(2, 1, rank, groups[2]), probe_parallel=True,
                    device=args.device, **ADAPTIVE))
            elif rank == 2:
                mine["adaptive", "seq", rank] = adaptive_record(train(device=args.device,
                                                                      **ADAPTIVE))
        everything = [None] * WORLD
        dist.all_gather_object(everything, mine)
        if rank == 0:
            merged = {k: v for part in everything for k, v in part.items()}
            init = hashlib.sha256(init_wq(args.device).float().cpu().numpy()
                                  .tobytes()).hexdigest()
            lines = []
            for i, (method, q, d, m) in enumerate(todo):
                seq = next(v for (j, kind, _), v in merged.items() if j == i and kind == "seq")
                pps = [v for (j, kind, _), v in merged.items() if j == i and kind == "pp"]
                got = pps[0]
                differ = sorted(p for p in seq["leaves"]
                                if got["leaves"].get(p) != seq["leaves"][p])
                lines.append(json.dumps({
                    "method": method, "q": q, "data": d, "model": m,
                    "bitwise": (not differ and set(got["leaves"]) == set(seq["leaves"])
                                and got["loss"] == seq["loss"]
                                and got["kappa_abs"] == seq["kappa_abs"]),
                    "differ": differ[:8],
                    "ranks_agree": len(pps) == d * m and all(
                        v["leaves"] == got["leaves"] for v in pps),
                    "zo_passes": got["zo_passes"], "loss": got["loss"],
                    "loss_sequential": seq["loss"], "moved": got["wq"] != init,
                }))
            if args.cases == "all":
                pps = [merged["adaptive", "pp", r] for r in (0, 1)]
                lines.append(json.dumps({"method": "adaptive", "pp": pps,
                                         "seq": merged["adaptive", "seq", 2]}))
            args.out.write_text("\n".join(lines) + "\n")


def init_wq(device: str) -> torch.Tensor:
    model = build_model(get_smoke_config("opt-125m").reduced(dtype="bfloat16"), device)
    return model.init(PRNGKey(0))["blocks"]["wq"]


if __name__ == "__main__":
    main()
