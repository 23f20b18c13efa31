"""The port's data-parallel distributed training on the CPU (ROADMAP item
13a), against the reference and against its own sequential step.

* probe-parallel over gloo: two steps of every method at q in {2, 3, 4} on
  D = 2 lanes, and of TeZO-Adam at q = 4 on D = 3 and on a 2 x 2 mesh, in
  bf16, bitwise the port's sequential chained step (params, method state,
  ``loss``, ``kappa_abs``) on every rank, with ``zo_passes`` =
  2·ceil(q/D) + 1 (one 4-rank job, ``tests/_torch_dist_rank.py``, which
  imports no JAX);
* the training CLI with ``--mesh host:2,1 --probe-parallel`` prints the
  sequential run's ``final_eval_loss``;
* the distinct-seed ensemble against the reference's
  ``build_ensemble_zo_train_step`` (``kernel_mode="xla"``) on one device,
  from the same numpy params of a small regression model, with and without
  stragglers, three steps: losses within 1e-5 relative and params within
  1e-5 of each leaf's largest entry (ROADMAP fact 10's bar across the
  frameworks); κ within 1e-3 relative and the κ-scaled moments within 1e-3
  of their largest entry, as tests/test_torch_train.py holds them (κ =
  Δloss / 2ρ magnifies the forwards' last-bit difference 500-fold);
* the MeZO family's ensemble on a duplicated batch bitwise the port's
  ``exact``-mode q = n step;
* ``StragglerSim``'s masks bit for bit the reference's, the all-dropped
  fallback included; ``probe_assignment``, ``apply_kappa_weights``,
  ``kappa_allreduce_bytes``, ``elastic_restart_plan`` and ``Heartbeat``
  equal to the reference's; the host mesh's layout and the refusals.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ZOConfig as RefZOConfig
from repro.core import init_zo_state as ref_init_state
from repro.distributed import FailureReport as RefFailureReport
from repro.distributed import Heartbeat as RefHeartbeat
from repro.distributed import StragglerSim as RefStragglerSim
from repro.distributed import apply_kappa_weights as ref_apply_kappa_weights
from repro.distributed import build_ensemble_zo_train_step as ref_build_ensemble
from repro.distributed import elastic_restart_plan as ref_elastic_restart_plan
from repro.distributed import kappa_allreduce_bytes as ref_kappa_allreduce_bytes
from repro.distributed.collectives import probe_assignment as ref_probe_assignment
from repro_torch.configs import get_smoke_config
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state, zo_pass_count
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.distributed import (FailureReport, Heartbeat, StragglerSim,
                                     apply_kappa_weights, build_ensemble_zo_train_step,
                                     elastic_restart_plan, kappa_allreduce_bytes,
                                     probe_assignment)
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import HostMesh, make_host_mesh, parse_mesh
from repro_torch.models import build_model
from repro_torch.utils import jax_random
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path

REPO = Path(__file__).resolve().parents[1]
METHODS = ("tezo", "tezo_m", "tezo_adam", "mezo", "mezo_m", "mezo_adam", "lozo", "lozo_m",
           "subzo")


def _env() -> dict:
    """A subprocess's environment: the port on the path, one torch thread
    (the losses' last bits follow the thread count, ROADMAP fact 11)."""
    src = str(REPO / "src")
    return dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------------------------------
# probe-parallel: the port against its own sequential chained step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """{(method, q, D, M): record} of the 4-rank job."""
    out = tmp_path_factory.mktemp("pp") / "pp.jsonl"
    proc = subprocess.run([sys.executable, str(REPO / "tests" / "_torch_dist_rank.py"), str(out)],
                          env=_env(), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    return {(r["method"], r["q"], r["data"], r["model"]) if "q" in r else r["method"]: r
            for r in recs}


def _check_record(rec, q, lanes):
    what = f"{rec['method']} q={q} on {rec['data']} x {rec['model']}"
    assert rec["bitwise"], f"{what}: differs from the sequential step in {rec['differ']}"
    assert rec["ranks_agree"], f"{what}: the ranks ended with different states"
    assert rec["moved"], f"{what}: the params did not move"
    assert rec["zo_passes"] == [2 * math.ceil(q / lanes) + 1] * 2
    assert rec["zo_passes"][0] == zo_pass_count(q, "inplace", probe_lanes=lanes)


@pytest.mark.parametrize("method", METHODS)
def test_probe_parallel_is_the_sequential_step(parity, method):
    """Two steps on 2 lanes at q = 2 (one probe a lane), 3 (lane 1 opens
    with a 4-delta catch-up chain and holds one probe) and 4; the update
    replays 6, 9 and 12 restore deltas."""
    for q in (2, 3, 4):
        _check_record(parity[method, q, 2, 1], q, 2)


@pytest.mark.parametrize("data,model", [(3, 1), (2, 2)])
def test_probe_parallel_on_more_ranks(parity, data, model):
    """TeZO-Adam at q = 4 on 3 lanes (2 + 1 + 1 probes, catch-ups of 7 and
    10 deltas) and on a 2 x 2 mesh (model index 1 writes zeros)."""
    _check_record(parity["tezo_adam", 4, data, model], 4, data)


def test_probe_parallel_with_adaptive_q(parity):
    """``--adaptive-q`` on 2 lanes: LOZO from q = 3 grows to 4 at step 2 and
    the step is rebuilt on both ranks; the q history, per-step losses and
    final evaluation are the sequential run's bit for bit."""
    rec = parity["adaptive"]
    for pp in rec["pp"]:
        assert pp["q_history"] == rec["seq"]["q_history"] == [[2, 4]]
        assert pp["loss"] == rec["seq"]["loss"]
        assert pp["final_eval_loss"] == rec["seq"]["final_eval_loss"]
        assert pp["q_probes"] == 4 and pp["zo_passes"] == 5 and rec["seq"]["zo_passes"] == 9


def test_cli_probe_parallel_matches_sequential():
    args = ["--smoke", "--device", "cpu", "--q-probes", "3", "--steps", "10"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--mesh", "host:2,1",
         "--probe-parallel"], env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = json.loads(proc.stdout[proc.stdout.rindex("\n{"):])
    want = port_train.train(smoke=True, device="cpu", q_probes=3, steps=10, verbose=False)
    assert got["final_eval_loss"] == want["final_eval_loss"]
    assert got["probe_parallel"] is True
    assert got["probe_lanes"] == 2 and got["zo_passes"] == 5 and want["zo_passes"] == 7


def test_probe_parallel_refusals():
    model = build_model(get_smoke_config("opt-125m"), "cpu")
    cfg = ZOConfig(method="tezo", q_probes=2, probe_parallel=True)
    with pytest.raises(ValueError, match="requires a mesh with a 'data' axis"):
        build_zo_train_step(model.loss_fn, cfg)
    with pytest.raises(ValueError, match="restore_mode='inplace'"):
        build_zo_train_step(model.loss_fn, ZOConfig(method="tezo", q_probes=2,
                                                    probe_parallel=True, restore_mode="exact"),
                            mesh=HostMesh(1, 1))
    kw = dict(smoke=True, steps=1, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="--probe-parallel requires --mesh"):
        port_train.train(probe_parallel=True, **kw)
    # a mesh without --probe-parallel trains sharded (tests/test_torch_sharding.py),
    # except quantized leaves (item 13c); a step on it needs the shard context
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 13c"):
        port_train.train(mesh="host:2,1", weight_quant="lut4", **kw)
    with pytest.raises(ValueError, match="runs on a sharded state"):
        build_zo_train_step(model.loss_fn, ZOConfig(method="tezo"), mesh=HostMesh(2, 1))
    with pytest.raises(ValueError, match="does not compose with --ensemble"):
        port_train.train(mesh="host:2,1", probe_parallel=True, ensemble=2, **kw)
    with pytest.raises(ValueError, match="does not compose with --ensemble"):
        port_train.train(ensemble=2, adaptive_q=True, **kw)
    with pytest.raises(ValueError, match="--mesh expects host:D,M"):
        parse_mesh("tpu:2,1")


def test_one_rank_mesh_runs_the_sequential_step():
    """On a 1 x 1 mesh (no process group) the probe-parallel step is the
    sequential one: one lane, the 3q-delta restore on the original params."""
    assert make_host_mesh(1, 1) == HostMesh(1, 1)
    out = {}
    for mesh in (None, make_host_mesh(1, 1)):
        model = build_model(get_smoke_config("opt-125m").reduced(dtype="bfloat16"), "cpu")
        cfg = ZOConfig(method="tezo_adam", rank=8, lr=1e-2, q_probes=3,
                       probe_parallel=mesh is not None)
        state = init_zo_state(model.init(PRNGKey(0)), cfg)
        state, m = build_zo_train_step(model.loss_fn, cfg, mesh=mesh)(
            state, {k: torch.from_numpy(v) for k, v in batch_at_step(
                DataConfig(seq_len=16, global_batch=4, vocab_size=256), 0).items()})
        out[mesh is None] = (dict(flatten_with_path(state)), m)
    (a, ma), (b, mb) = out[True], out[False]
    assert all(torch.equal(a[k], b[k]) for k in a if isinstance(a[k], torch.Tensor))
    assert torch.equal(ma["loss"], mb["loss"]) and mb["zo_passes"] == ma["zo_passes"] == 7


@pytest.mark.parametrize("rank,data,model", [(0, 2, 2), (1, 2, 2), (2, 2, 2), (3, 2, 2),
                                             (2, 3, 1), (5, 2, 3)])
def test_host_mesh_layout(rank, data, model):
    """Rank r at (r // M, r % M), as the reference reshapes its devices to
    (D, M); the lanes' probe blocks as the reference assigns them."""
    mesh = HostMesh(data, model, rank)
    assert (mesh.data_index, mesh.model_index) == divmod(rank, model)
    assert mesh.world == data * model and mesh.axis_names == ("data", "model")
    assert parse_mesh(f"host:{data},{model}") == (data, model)


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5, 16])
def test_probe_assignment_matches_reference(q):
    for lanes in (1, 2, 3, 4, 8):
        assert probe_assignment(q, lanes) == ref_probe_assignment(q, lanes)
    with pytest.raises(ValueError):
        probe_assignment(0, 2)


# --------------------------------------------------------------------------
# the ensemble against the reference
# --------------------------------------------------------------------------

TOY = {"b": (8,), "v": (12, 8), "w": (16, 12)}


def _toy_params(seed=3) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in TOY.items()}


def _toy_batch(n=8, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    y = np.tanh(x[:, :8] * 2.0).astype(np.float32)
    return {"x": x, "y": y}


def _ref_toy_loss(p, batch):
    h = jnp.tanh(batch["x"] @ p["w"])
    return jnp.mean((h @ p["v"] + p["b"] - batch["y"]) ** 2)


def _toy_loss(p, batch):
    h = torch.tanh(batch["x"] @ p["w"])
    return torch.mean((h @ p["v"] + p["b"] - batch["y"]) ** 2)


def _ref_flat(state) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) if v.dtype != np.uint32
            else np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(state)}


def _flat(state) -> dict:
    return {p: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in flatten_with_path(state)}


ENSEMBLE = 4
ENSEMBLE_STEPS = 3


@pytest.mark.parametrize("stragglers", [False, True])
@pytest.mark.parametrize("method", ["tezo", "tezo_adam", "lozo", "subzo"])
def test_ensemble_matches_reference(method, stragglers):
    kw = dict(method=method, rank=4, lr=2e-3, lazy_interval=2)
    params = _toy_params()
    sim_args = (ENSEMBLE, 0.5, 7)
    ref_step = jax.jit(ref_build_ensemble(
        _ref_toy_loss, RefZOConfig(kernel_mode="xla", **kw), ENSEMBLE,
        RefStragglerSim(*sim_args).mask_fn() if stragglers else None))
    ref_state = ref_init_state({k: jnp.asarray(v) for k, v in params.items()},
                               RefZOConfig(kernel_mode="xla", **kw))
    step = build_ensemble_zo_train_step(_toy_loss, ZOConfig(**kw), ENSEMBLE,
                                        StragglerSim(*sim_args).mask_fn() if stragglers
                                        else None)
    state = init_zo_state({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                          ZOConfig(**kw))
    dropped = 0
    for s in range(ENSEMBLE_STEPS):
        batch = _toy_batch(seed=s)
        ref_state, rm = ref_step(ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        # κ = Δloss / 2ρ carries the frameworks' last-bit loss difference
        # times 1/2ρ = 500, so it is held as the κ-scaled moments are
        for name, rtol in (("loss", 1e-5), ("kappa_abs", 1e-3)):
            np.testing.assert_allclose(float(m[name]), float(rm[name]), rtol=rtol, atol=0,
                                       err_msg=f"step {s} {name}")
        if stragglers:
            dropped += int(ENSEMBLE - StragglerSim(*sim_args).mask_fn()(s).sum())
    assert not stragglers or dropped > 0  # the masks dropped someone
    got, want = _flat(state), _ref_flat(ref_state)
    assert set(got) == set(want)
    for path, w in want.items():
        scale = float(np.abs(w).max()) if w.dtype != np.uint32 else 0.0
        tol = 1e-3 if path.startswith((".mstate['tau_", ".mstate['dense_")) else 1e-5
        np.testing.assert_allclose(got[path], w, rtol=0, atol=tol * scale, err_msg=path)
    assert np.abs(got[".params['w']"] - params["w"]).max() > 1e-3  # it trained


@pytest.mark.parametrize("method", ["mezo", "mezo_m", "mezo_adam", "tezo_adam"])
def test_ensemble_on_duplicated_batch_is_exact_mode_step(method):
    """n members on n copies of a batch are the exact mode's q = n probes:
    the same draws off the same params, the same κ, the same update."""
    n = 2
    model = build_model(get_smoke_config("opt-125m").reduced(dtype="bfloat16"), "cpu")
    data = DataConfig(seq_len=16, global_batch=2, vocab_size=256)
    out = []
    for ensemble in (False, True):
        kw = dict(method=method, rank=8, lr=1e-2)
        cfg = ZOConfig(**kw) if ensemble else ZOConfig(q_probes=n, restore_mode="exact", **kw)
        step = (build_ensemble_zo_train_step(model.loss_fn, cfg, n) if ensemble
                else build_zo_train_step(model.loss_fn, cfg))
        state = init_zo_state(model.init(PRNGKey(0)), cfg)
        for s in range(2):
            batch = {k: torch.from_numpy(v) for k, v in batch_at_step(data, s).items()}
            if ensemble:
                batch = {k: torch.cat([v] * n) for k, v in batch.items()}
            state, m = step(state, batch)
        out.append((dict(flatten_with_path(state)), m))
    (a, ma), (b, mb) = out
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(ma["kappa_abs"], mb["kappa_abs"])
    assert not torch.equal(a[".params['blocks']['wq']"], model.init(PRNGKey(0))["blocks"]["wq"])


def test_ensemble_cli_runs_with_stragglers():
    res = port_train.train(smoke=True, device="cpu", steps=4, ensemble=4, straggler_prob=0.25,
                           verbose=False, log_every=2)
    assert np.isfinite(res["final_eval_loss"])
    assert res["zo_passes"] == 9 and res["probe_lanes"] is None
    with pytest.raises(ValueError, match="does not split into 3 members"):
        port_train.train(smoke=True, device="cpu", steps=1, ensemble=3, verbose=False)


# --------------------------------------------------------------------------
# straggler masks and the host-side helpers against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.25, 0.5, 0.95])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_straggler_masks_match_reference(n, p):
    seed = 99 + n
    want = np.asarray(jax.vmap(RefStragglerSim(n, p, seed).mask_fn())(jnp.arange(64)))
    fn = StragglerSim(n, p, seed).mask_fn()
    got = np.stack([fn(s).numpy() for s in range(64)])
    np.testing.assert_array_equal(got, want)
    assert got.sum(axis=1).min() >= 1
    if (n, p) == (2, 0.95):  # the fallback: everyone dropped, member 0 kept
        drops = np.stack([jax_random.bernoulli(jax_random.fold_in(PRNGKey(seed), s), p, (n,))
                          .numpy() for s in range(64)])
        assert drops.all(axis=1).any()


def test_bernoulli_matches_reference():
    key = PRNGKey(5)
    for p in (0.1, 0.5, 0.95):
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(5), p, (1000,)))
        np.testing.assert_array_equal(jax_random.bernoulli(key, p, (1000,)).numpy(), want)


def test_apply_kappa_weights_matches_reference():
    rng = np.random.default_rng(0)
    for weights in ([1.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0]):
        kappas = rng.standard_normal(4).astype(np.float32)
        w = np.asarray(weights, np.float32)
        got = apply_kappa_weights(torch.from_numpy(kappas), torch.from_numpy(w))
        want = ref_apply_kappa_weights(jnp.asarray(kappas), jnp.asarray(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kappa_allreduce_bytes_matches_reference():
    from repro.configs import get_smoke_config as ref_smoke_config
    from repro.models import build_model as ref_build_model

    model = build_model(get_smoke_config("opt-125m"), "cpu")
    state = init_zo_state(model.init(PRNGKey(0)), ZOConfig(method="tezo_adam", rank=24))
    ref_model = ref_build_model(ref_smoke_config("opt-125m"))
    ref_state = jax.eval_shape(lambda: ref_init_state(
        ref_model.init(jax.random.PRNGKey(0)), RefZOConfig(method="tezo_adam", rank=24)))
    got = kappa_allreduce_bytes(state.mstate, 2)
    assert got == ref_kappa_allreduce_bytes(ref_state.mstate, 2) > 0
    assert kappa_allreduce_bytes({}, 2) == 0


@pytest.mark.parametrize("failed,n_pods", [((1,), 2), ((0,), 4), ((0, 1), 2), ((), 3)])
def test_elastic_restart_plan_matches_reference(failed, n_pods):
    assert (elastic_restart_plan(FailureReport(failed_pods=failed, n_pods=n_pods))
            == ref_elastic_restart_plan(RefFailureReport(failed_pods=failed, n_pods=n_pods)))


def test_heartbeat_matches_reference():
    t = [0.0]
    ours, ref = (cls(3, timeout_s=5.0, clock=lambda: t[0]) for cls in (Heartbeat, RefHeartbeat))
    t[0] = 3.0
    for hb in (ours, ref):
        hb.beat(0)
        hb.beat(2)
    t[0] = 7.0
    assert ours.healthy() == ref.healthy() == [0, 2]
    a, b = ours.report(n_pods=3), ref.report(n_pods=3)
    assert (a.failed_pods, a.n_pods, a.pod_shape) == (b.failed_pods, b.n_pods, b.pod_shape)
