"""End-to-end ZO fine-tuning entry point (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch opt-125m --method tezo_adam --steps 300        # on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch opt-125m --method mezo_adam                    # the MeZO baseline
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch opt-125m --method subzo --adaptive-q           # a low-rank baseline
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch opt-125m --weight-quant lut4                   # quantized block leaves
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch opt-125m --pretrain-steps 20 --rank-mode spectral   # the paper's recipe
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen2.5-14b --method tezo_adam --steps 3       # 14.8 B params, bf16
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch dbrx-132b --layers 2 --steps 3                 # MoE, full width, 2 layers
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch xlstm-350m --method tezo_adam --steps 3        # xLSTM, no kernel in the forward
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --mesh host:2,1 --probe-parallel --q-probes 4         # 2 ranks, 2 probes each
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --ensemble 4 --straggler-prob 0.25                    # distinct-seed ensemble
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --mesh host:1,2 --method tezo_adam                    # sharded over 2 ranks
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --smoke --device cpu --steps 10                       # plain versions

Build the model (``--layers N`` cuts the registered config's depth) and
draw the reference's initial params from ``--seed``, or take the caller's
``init_params`` (which the run then updates in place).
``--pretrain-steps N`` first trains them with N AdamW steps by backprop
(``optim.fo``, lr 3e-3, batches ``batch_at_step(data, 10_000_000 + s)``, the
plain attention and scan under autograd; every family); ``--rank-mode
spectral`` then picks each low-rank leaf's rank from the (pretrained)
weights by the paper's Eq. 7
(``core.rank.select_ranks``, numpy on the host).  Then draw the ZO state
and loop: prefetched batch → pinned non-blocking copy → one ZO
step (the weight passes on the ``tezo_perturb`` / ``tezo_adam_update``
kernels for the TeZO family, on ``noise_perturb`` / ``noise_update`` for
the MeZO family, on ``tezo_perturb`` for LOZO and on ``subzo_perturb`` for
SubZO, the forwards on the flash-attention kernel, and Hymba's on the
selective scan too; xLSTM's forward runs no kernel), with the losses left
on the device and read once per log boundary.  ``--weight-quant nf4|lut3|lut4``
stores the transformer block matmul weights as packed LUT-quantized leaves
(``core.quant``): their forwards run on the ``quant_matmul`` kernel, the
TeZO family perturbs and updates their r-vector ``acc`` and the MeZO family
their dense ``nacc`` buffer; a tree without such leaves (xLSTM's) raises,
as the reference's ``quantize_params`` does.  On the card, every step after
the first runs under ``torch.cuda.set_sync_debug_mode("error")``: a step
that waited on the device would raise.  ``--adaptive-q`` grows q at a log
boundary (``core.adaptive``), outside that guard, and rebuilds the step.
Prints the reference's JSON result (``final_eval_loss``, the final
``q_probes``, ``probe_lanes`` and the rest) without the history.

``--mesh host:D,M --probe-parallel`` runs the probe-parallel schedule
(``core.zo_step``) on D·M ranks of one machine: ``main`` starts them
(``launch.mesh.host_ranks``: this process is rank 0 and spawns the others,
unless a launcher such as torchrun already started it), each rank on the
same device (the one card, or the CPU with ``--device cpu``), reading the
same batches; rank 0 alone prints, writes checkpoints and the log file.
It composes with ``--adaptive-q`` (the step is rebuilt at a log boundary,
on every rank alike: they all see the same κ).  ``--ensemble N`` runs the
distinct-seed ensemble (``distributed.collectives``), with
``--straggler-prob p`` dropping members by ``distributed.fault.
StragglerSim(N, p, seed + 99)``.

``--mesh host:D,M`` without ``--probe-parallel`` trains sharded
(``distributed.sharding``): each rank draws its shard of every param and
state leaf alone, or, after ``--pretrain-steps`` or ``--rank-mode
spectral`` (on every rank, on the whole params), cuts the params; the step
runs the leaf ops on the shards,
gathers each layer just in time for the forward, and reduces the loss over
the D data lanes, each of which reads its share of the batch.  It composes
with ``--ensemble``.  ``final_eval_loss`` is the whole state's (layers
gathered, the whole eval batch on every rank) and a checkpoint is the
gathered, whole state, written by rank 0; a restore cuts it onto the run's
mesh.  The result names the ``collective_backend`` (gloo, or NCCL where
every rank has a card of its own) and each rank's resident param + state
bytes.  ``--weight-quant`` on a sharded mesh is ROADMAP.md item 13c and
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.adaptive import AdaptiveQ
from repro_torch.core.estimator import ZOConfig, get_method
from repro_torch.core.rank import select_ranks
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state, zo_pass_count
from repro_torch.data import DataConfig, Prefetcher, batch_at_step
from repro_torch.distributed import StragglerSim, build_ensemble_zo_train_step, sharding
from repro_torch.kernels import _build
from repro_torch.launch.mesh import (HostMesh, host_ranks, make_host_mesh, parse_mesh,
                                     rank_device)
from repro_torch.models import build_model
from repro_torch.optim import adamw, build_fo_train_step, init_fo_state
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import tree_size_bytes


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue A item {item})")


def _check_options(*, mesh, probe_parallel, ensemble, adaptive_q, method,
                   weight_quant="none") -> None:
    """Refuse what does not compose, the reference's refusals first."""
    if mesh is not None and not probe_parallel and weight_quant != "none":
        raise _not_ported("--weight-quant with a sharded --mesh (quantized leaves on a mesh)",
                          "13c")
    if probe_parallel and mesh is None:
        raise ValueError(
            "--probe-parallel requires --mesh with a data axis (the q probes "
            "shard over the mesh's data-axis replicas)"
        )
    if ensemble > 1:
        if probe_parallel:
            raise ValueError("--probe-parallel does not compose with --ensemble")
        if adaptive_q:
            raise ValueError("--adaptive-q does not compose with --ensemble")
    get_method(method)  # KeyError for an unknown method


def to_device(host_batch: dict, device: torch.device) -> dict:
    """A numpy batch on ``device``: one pinned, non-blocking copy per array
    on the card (a pageable copy would wait on the stream)."""
    out = {}
    for k, v in host_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


@contextmanager
def no_host_sync(device: torch.device, enabled: bool):
    """Raise on any call that waits for the card (the counterpart of the
    reference's ``jax.transfer_guard_device_to_host("disallow")``).  One
    wait is allowed, on the probe-parallel path only: its step copies the
    2q losses to the host for the all-reduce over the ranks, and lifts the
    guard for that copy alone (``HostMesh.all_reduce_losses``)."""
    if not (enabled and device.type == "cuda"):
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def train(
    arch: str = "opt-125m",
    smoke: bool = False,
    method: str = "tezo_adam",
    steps: int = 300,
    seq_len: int = 128,
    global_batch: int = 8,
    lr: float = 1e-6,
    rho: float = 1e-3,
    rank: int = 24,
    rank_mode: str = "const",
    weight_quant: str = "none",
    q_probes: int = 1,
    restore_mode: str = "inplace",
    probe_parallel: bool = False,
    adaptive_q: bool = False,
    q_max: int = 16,
    seed: int = 0,
    ckpt_dir: str | None = None,
    ckpt_every: int = 100,
    eval_every: int = 50,
    log_every: int = 10,
    mesh: HostMesh | str | None = None,
    ensemble: int = 0,
    straggler_prob: float = 0.0,
    pretrain_steps: int = 0,
    pretrain_lr: float = 3e-3,
    data_cfg: DataConfig | None = None,
    log_file: str | None = None,
    verbose: bool = True,
    device: str | torch.device = "cuda",
    model_cfg: ModelConfig | None = None,
    init_params: dict | None = None,
    return_state: bool = False,
) -> dict:
    """Run ``pretrain_steps`` first-order steps, then ``steps`` ZO steps;
    returns the reference's result dict (plus, with ``return_state``, the
    final ``state`` and the ``setup``: the pretraining's losses and the
    selected ranks).  ``model_cfg`` replaces the registered config (a
    depth-cut model, say).  ``init_params`` (the model's params on its
    device) replace the seed's draw: a caller that already holds them (a
    serving engine's, say) saves the draw, and the ZO steps write them in
    place.  ``mesh`` is this rank's ``HostMesh`` or ``"host:D,M"`` (one
    rank: :func:`main` starts several)."""
    _check_options(mesh=mesh, probe_parallel=probe_parallel, ensemble=ensemble,
                   adaptive_q=adaptive_q, method=method, weight_quant=weight_quant)
    if isinstance(mesh, str):
        mesh = make_host_mesh(*parse_mesh(mesh), device=device)
    main_rank = mesh is None or mesh.is_main
    verbose = verbose and main_rank
    probe_lanes = mesh.data if probe_parallel else None
    sharded = mesh is not None and not probe_parallel and mesh.world > 1
    cfg = model_cfg or (get_smoke_config(arch) if smoke else get_config(arch))
    model = build_model(cfg, rank_device(mesh, device))
    dev = model.device
    if mesh is not None and mesh.world > 1 and dev.type == "cuda":
        if main_rank:  # one build for the ranks that share the card
            _build.load()
        mesh.barrier()
    data = data_cfg or DataConfig(
        seq_len=seq_len, global_batch=global_batch,
        vocab_size=min(cfg.vocab_size, 512), seed=seed,
    )
    zo_cfg = ZOConfig(
        method=method, lr=lr, rho=rho, rank=rank, rank_mode=rank_mode,
        weight_quant=weight_quant, q_probes=q_probes, restore_mode=restore_mode,
        probe_parallel=probe_parallel, adaptive_q=adaptive_q, q_max=q_max, seed=seed,
        total_steps=steps,
    )
    # a sharded run draws each rank's shards alone (sharding.init_state),
    # unless the pretraining or the spectral ranks need the whole params
    whole = not sharded or pretrain_steps > 0 or rank_mode == "spectral"
    params = init_params if init_params is not None else (
        model.init(PRNGKey(seed)) if whole else None)
    setup: dict = {}
    if pretrain_steps > 0:
        t0 = time.perf_counter()
        opt = adamw(lr=pretrain_lr)
        fo_state = init_fo_state(params, opt)
        fo_step = build_fo_train_step(model.fo_loss_fn, opt)
        fo_losses = []
        for s in range(pretrain_steps):
            fo_state, m = fo_step(fo_state, to_device(batch_at_step(data, 10_000_000 + s), dev))
            fo_losses.append(m["loss"])
        params = fo_state.params
        del fo_state
        fo_losses = torch.stack(fo_losses).cpu().tolist()  # waits for the last step
        setup.update(pretrain_steps=pretrain_steps, pretrain_first_loss=fo_losses[0],
                     pretrain_last_loss=fo_losses[-1], pretrain_s=time.perf_counter() - t0)
        if verbose:
            print(f"[train] {json.dumps(setup)}", flush=True)

    ranks = masks = None
    if zo_cfg.rank_mode == "spectral":
        t0 = time.perf_counter()
        ranks, masks = select_ranks(params, threshold=zo_cfg.rank_threshold, r_max=zo_cfg.r_max)
        sel = {"rank_mode": "spectral", "rank_set": sorted(set(ranks.values())),
               "rank_masks": len(masks), "select_s": time.perf_counter() - t0}
        setup.update(sel)
        if verbose:
            print(f"[train] {json.dumps(sel)}", flush=True)
    shard, loss_fn = None, model.loss_fn
    if sharded:  # each rank keeps its shards
        state, shard = sharding.init_state(model, zo_cfg, mesh, PRNGKey(seed), params,
                                           ranks, masks)
        loss_fn = sharding.sharded_loss(model)
    else:
        state = init_zo_state(params, zo_cfg, ranks, masks)
    del params

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        if shard is None:
            state, extra = ckpt.restore(state)
        else:  # each rank reads its shards onto its device
            state, extra = ckpt.restore(shard.whole_state, shardings=shard.state_specs,
                                        mesh=mesh, device=dev)
        start_step = int(extra.get("step", state.step))
        if main_rank:
            print(f"[train] restored step {start_step} from {ckpt.dir}")
    if shard is not None and dev.type == "cuda":
        torch.cuda.empty_cache()  # the whole params' blocks where they were cut
    resident = tree_size_bytes(state.params) + tree_size_bytes(state.mstate)

    def build_step(cfg_b):
        if ensemble > 1:
            sim = StragglerSim(ensemble, straggler_prob, seed=seed + 99)
            return build_ensemble_zo_train_step(
                loss_fn, cfg_b, ensemble,
                straggler_mask_fn=sim.mask_fn() if straggler_prob > 0 else None, shard=shard)
        return build_zo_train_step(loss_fn, cfg_b, mesh=mesh, shard=shard)

    step_fn = build_step(zo_cfg)

    eval_batch = to_device(batch_at_step(data, 999_999_999), dev)
    controller = AdaptiveQ(q=zo_cfg.q_probes, q_max=zo_cfg.q_max) if adaptive_q else None
    prefetch = Prefetcher(data, start_step=start_step)
    history: list[dict] = []
    # the window holds the losses still on the device: they are read in one
    # copy at the log boundary, never once per step
    losses_window: list[torch.Tensor] = []
    t_start = time.time()
    t_steady, steady_steps = None, 0
    try:
        for step_idx, host_batch in prefetch:
            if step_idx >= steps:
                break
            batch = to_device(host_batch, dev)
            with no_host_sync(dev, enabled=step_idx > start_step):
                state, metrics = step_fn(state, batch)
                losses_window.append(metrics["loss"])
            if t_steady is None:  # the first step builds the kernels
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t_steady = time.perf_counter()
            else:
                steady_steps += 1
            if (step_idx + 1) % log_every == 0:
                window = torch.stack(losses_window).cpu().numpy().astype(np.float32)
                rec = {
                    "step": step_idx + 1,
                    "loss": float(np.mean(window)),
                    "kappa_abs": float(metrics["kappa_abs"]),
                    "wall_s": round(time.time() - t_start, 1),
                }
                losses_window.clear()
                if controller is not None:
                    new_q = controller.observe(float(metrics["kappa_var"]), rec["kappa_abs"])
                    if new_q is not None:  # the step is built for one q: rebuild it
                        zo_cfg = dataclasses.replace(zo_cfg, q_probes=new_q)
                        step_fn = build_step(zo_cfg)
                        rec["q_probes"] = new_q
                if (step_idx + 1) % eval_every == 0:
                    with sharding.placed(shard):
                        rec["eval_loss"] = float(model.loss_fn(state.params, eval_batch))
                history.append(rec)
                if verbose:
                    print(f"[train] {json.dumps(rec)}", flush=True)
            if ckpt and (step_idx + 1) % ckpt_every == 0:
                save = state if shard is None else sharding.gather_tree(
                    state, shard.state_specs, mesh, device="cpu")  # every rank takes part
                if main_rank:
                    ckpt.save_async(step_idx + 1, save, extra={"step": step_idx + 1})
    finally:
        prefetch.close()
        if ckpt:
            ckpt.wait()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    steady_s = 0.0 if t_steady is None else time.perf_counter() - t_steady

    with sharding.placed(shard):  # the whole state's loss: layers gathered, whole batch
        final_eval = float(model.loss_fn(state.params, eval_batch))
    result = {
        "arch": cfg.name,
        "method": method,
        "device": dev.type,
        "steps": steps,
        "q_probes": zo_cfg.q_probes,  # the final q (adaptive-q may grow it)
        "restore_mode": restore_mode,
        "weight_quant": weight_quant,
        "probe_parallel": probe_parallel,
        "probe_lanes": probe_lanes,
        "sharded": sharded,
        "mesh": None if mesh is None else f"{mesh.data},{mesh.model}",
        "collective_backend": None if mesh is None or mesh.world == 1 else mesh.backend,
        # this rank's params + method state after placement (its shards)
        "resident_bytes": resident,
        # per step: the busiest lane's with probe-parallel; the ensemble's
        # 2n + 1 (n members off the original params, then the update)
        "zo_passes": (zo_pass_count(ensemble, "exact") if ensemble > 1 else
                      zo_pass_count(zo_cfg.q_probes, restore_mode, probe_lanes=probe_lanes)),
        "final_eval_loss": final_eval,
        "history": history,
        "wall_s": round(time.time() - t_start, 1),
        # the steps after the first (which builds the kernels), timed from
        # its end to the end of the last with the device drained
        "steady_steps": steady_steps,
        "steady_step_ms": 1e3 * steady_s / steady_steps if steady_steps else None,
    }
    if log_file and main_rank:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        Path(log_file).write_text(json.dumps(result, indent=1))
    if return_state:
        result["state"] = state
        result["setup"] = setup
        result["shard"] = shard  # sharding.gather_tree(state, shard.state_specs, mesh)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers (0: as registered)")
    ap.add_argument("--method", default="tezo_adam",
                    help="tezo, tezo_m, tezo_adam, mezo, mezo_m, mezo_adam, lozo, lozo_m "
                    "or subzo")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-6)
    ap.add_argument("--rho", type=float, default=1e-3)
    ap.add_argument("--rank", type=int, default=24)
    ap.add_argument("--rank-mode", default="const", choices=["const", "spectral"])
    ap.add_argument("--weight-quant", default="none", choices=["none", "nf4", "lut3", "lut4"],
                    help="store transformer block weights as packed LUT-quantized leaves "
                    "(core.quant.QuantLeaf), dequantized in-tile on the forward; TeZO and "
                    "MeZO families only, no weight decay")
    ap.add_argument("--q-probes", type=int, default=1)
    ap.add_argument("--restore-mode", default="inplace",
                    choices=["inplace", "unchained", "exact"],
                    help="inplace = the chained 2q+1-pass step; unchained = literal "
                    "Algorithm 1 (3q+1 passes); exact = branch the ±ρ copies off "
                    "the originals (2× weight memory)")
    ap.add_argument("--probe-parallel", action="store_true")
    ap.add_argument("--adaptive-q", action="store_true",
                    help="AdaZeta-style probe growth: double q (up to --q-max) when the "
                    "κ-variance EMA says the estimator is noise-dominated")
    ap.add_argument("--q-max", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--pretrain-steps", type=int, default=0)
    ap.add_argument("--ensemble", type=int, default=0)
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--mesh", default=None, metavar="host:D,M",
                    help="run D·M ranks of this command on this machine (rank 0 spawns the "
                    "others unless a launcher started them): with --probe-parallel the q "
                    "probes over the D data lanes, else the params and ZO state stored "
                    "sharded on both axes, FSDP-style: each layer gathered whole just in "
                    "time for the forward, the experts of a config whose moe_impl is ep "
                    "computed expert-parallel over the model axis")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the hand-written kernels) or cpu (their "
                    "plain PyTorch versions)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    kwargs = {k.replace("-", "_"): v for k, v in vars(args).items()}
    if kwargs.pop("layers"):
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        kwargs["model_cfg"] = cfg.reduced(n_layers=args.layers)
    if args.mesh is None:
        result = train(**kwargs)
    else:
        _check_options(mesh=args.mesh, probe_parallel=args.probe_parallel,
                       ensemble=args.ensemble, adaptive_q=args.adaptive_q, method=args.method,
                       weight_quant=args.weight_quant)
        d, m = parse_mesh(args.mesh)
        with host_ranks(d * m, [sys.executable, "-m", "repro_torch.launch.train", *argv]) as rank:
            kwargs["mesh"] = make_host_mesh(d, m, device=args.device)
            result = train(**kwargs)
        if rank != 0:
            return
    print(json.dumps({k: v for k, v in result.items() if k != "history"}, indent=1))


if __name__ == "__main__":
    main()
