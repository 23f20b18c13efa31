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
        --smoke --device cpu --steps 10                       # plain versions

Build the model, draw the reference's initial params and ZO state from
``--seed``, then loop: prefetched batch → pinned non-blocking copy → one ZO
step (the weight passes on the ``tezo_perturb`` / ``tezo_adam_update``
kernels for the TeZO family, on ``noise_perturb`` / ``noise_update`` for
the MeZO family, on ``tezo_perturb`` for LOZO and on ``subzo_perturb`` for
SubZO, the forwards on the flash-attention kernel), with the losses left on
the device and read once per log boundary.  ``--weight-quant nf4|lut3|lut4``
stores the transformer block matmul weights as packed LUT-quantized leaves
(``core.quant``): their forwards run on the ``quant_matmul`` kernel, the
TeZO family perturbs and updates their r-vector ``acc`` and the MeZO family
their dense ``nacc`` buffer.  On the card, every step after
the first runs under ``torch.cuda.set_sync_debug_mode("error")``: a step
that waited on the device would raise.  ``--adaptive-q`` grows q at a log
boundary (``core.adaptive``), outside that guard, and rebuilds the step.
Prints the reference's JSON result (``final_eval_loss``, the final
``q_probes`` and the rest) without the history.

Options whose modules are not ported raise and name their ROADMAP.md item:
``--mesh``, ``--probe-parallel``, ``--ensemble``, ``--rank-mode spectral``
and ``--pretrain-steps``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state, zo_pass_count
from repro_torch.data import DataConfig, Prefetcher, batch_at_step
from repro_torch.models import build_model
from repro_torch.utils.jax_random import PRNGKey


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue A item {item})")


def _check_ported(*, mesh, probe_parallel, ensemble, straggler_prob, rank_mode,
                  pretrain_steps, method) -> None:
    if mesh is not None:
        raise _not_ported("--mesh", "13")
    if probe_parallel:
        raise _not_ported("--probe-parallel", "13")
    if ensemble > 1 or straggler_prob > 0:
        raise _not_ported("--ensemble / --straggler-prob", "13")
    if rank_mode != "const":
        raise _not_ported(f"--rank-mode {rank_mode}", "4")
    if pretrain_steps > 0:
        raise _not_ported("--pretrain-steps (first-order pretraining)", "14")
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
    reference's ``jax.transfer_guard_device_to_host("disallow")``)."""
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
    mesh=None,
    ensemble: int = 0,
    straggler_prob: float = 0.0,
    pretrain_steps: int = 0,
    data_cfg: DataConfig | None = None,
    log_file: str | None = None,
    verbose: bool = True,
    device: str | torch.device = "cuda",
    model_cfg: ModelConfig | None = None,
    return_state: bool = False,
) -> dict:
    """Run ``steps`` ZO steps; returns the reference's result dict (plus the
    final ``state`` with ``return_state``).  ``model_cfg`` replaces the
    registered config (a depth-cut model, say)."""
    _check_ported(mesh=mesh, probe_parallel=probe_parallel, ensemble=ensemble,
                  straggler_prob=straggler_prob, rank_mode=rank_mode,
                  pretrain_steps=pretrain_steps, method=method)
    cfg = model_cfg or (get_smoke_config(arch) if smoke else get_config(arch))
    model = build_model(cfg, device)
    dev = model.device
    data = data_cfg or DataConfig(
        seq_len=seq_len, global_batch=global_batch,
        vocab_size=min(cfg.vocab_size, 512), seed=seed,
    )
    zo_cfg = ZOConfig(
        method=method, lr=lr, rho=rho, rank=rank, weight_quant=weight_quant,
        q_probes=q_probes, restore_mode=restore_mode, probe_parallel=probe_parallel,
        adaptive_q=adaptive_q, q_max=q_max, seed=seed,
        total_steps=steps,
    )
    state = init_zo_state(model.init(PRNGKey(seed)), zo_cfg)
    step_fn = build_zo_train_step(model.loss_fn, zo_cfg)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(state)
        start_step = int(extra.get("step", state.step))
        print(f"[train] restored step {start_step} from {ckpt.dir}")

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
                        step_fn = build_zo_train_step(model.loss_fn, zo_cfg)
                        rec["q_probes"] = new_q
                if (step_idx + 1) % eval_every == 0:
                    rec["eval_loss"] = float(model.loss_fn(state.params, eval_batch))
                history.append(rec)
                if verbose:
                    print(f"[train] {json.dumps(rec)}", flush=True)
            if ckpt and (step_idx + 1) % ckpt_every == 0:
                ckpt.save_async(step_idx + 1, state, extra={"step": step_idx + 1})
    finally:
        prefetch.close()
        if ckpt:
            ckpt.wait()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    steady_s = 0.0 if t_steady is None else time.perf_counter() - t_steady

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
        "probe_lanes": None,
        "zo_passes": zo_pass_count(zo_cfg.q_probes, restore_mode),
        "final_eval_loss": final_eval,
        "history": history,
        "wall_s": round(time.time() - t_start, 1),
        # the steps after the first (which builds the kernels), timed from
        # its end to the end of the last with the device drained
        "steady_steps": steady_steps,
        "steady_step_ms": 1e3 * steady_s / steady_steps if steady_steps else None,
    }
    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        Path(log_file).write_text(json.dumps(result, indent=1))
    if return_state:
        result["state"] = state
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--smoke", action="store_true")
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
    ap.add_argument("--mesh", default=None, metavar="host:D,M")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the hand-written kernels) or cpu (their "
                    "plain PyTorch versions)")
    args = ap.parse_args(argv)
    kwargs = {k.replace("-", "_"): v for k, v in vars(args).items()}
    result = train(**kwargs)
    print(json.dumps({k: v for k, v in result.items() if k != "history"}, indent=1))


if __name__ == "__main__":
    main()
