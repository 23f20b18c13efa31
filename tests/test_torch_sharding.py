"""The port's sharded parameters and ZO state on the CPU (ROADMAP item
13b), against the reference and against its own single-process step.

* the spec tables: the params' and the ZO state's per-leaf specs equal the
  reference's ``param_shardings`` / ``zo_state_shardings`` for every
  family's smoke config on 2 x 2, 1 x 4 and 4 x 1 meshes (the reference
  runs on a stand-in mesh with ``axis_names`` and ``devices.shape``, its
  ``NamedSharding`` replaced by a holder of the spec);
* the noise streams on shards: the plain ``noise_perturb`` /
  ``noise_update`` with ``offsets`` on uneven row and column cuts and on a
  split leading dim are bitwise the matching slice of the whole leaf's
  launch, their z bitwise the reference's ``ops.noise_perturb(...,
  offsets=)`` under the interpreter, and the updates within the noise
  tests' 1e-6 of ``ops.noise_update_adam(..., offsets=)``;
* one 4-rank gloo job of JAX-free rank processes
  (``tests/_torch_shard_rank.py``): on a 1 x 2 mesh all nine methods at
  q = 2 bitwise the single-process chained step (params, method state,
  ``loss``, ``kappa_abs``) with ``zo_passes`` = 5 and less resident state
  per rank; TeZO-Adam and MeZO-Adam on 2 x 1 and 2 x 2 within the
  reference's own sharded-vs-unsharded bars (loss rtol 2e-4, params atol
  2e-4, tests/test_sharding_multidevice.py:55-58) and bitwise across two
  runs; the ensemble on 1 x 2 (bitwise) and 2 x 2 (the bars), with and
  without stragglers; ``_moe_ep`` within 2e-4 of the single-device MoE at
  capacity factor 8; a checkpoint restored onto 1 x 2 and 2 x 2 bitwise
  the cut of the whole state; and the 2 x 2 step of granite-8b-smoke on a
  ``make_inputs`` batch against the reference's unsharded xla step within
  the same bars;
* the training CLI with ``--mesh host:1,2`` prints the single-process
  run's ``final_eval_loss`` bit for bit (TeZO-Adam, MeZO-Adam) and runs
  ``--ensemble 2`` on the mesh.
"""

import json
import os
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.sharding as ref_sharding
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.core import ZOConfig as RefZOConfig
from repro.core import build_zo_train_step as ref_build_step
from repro.core import init_zo_state as ref_init_state
from repro.kernels import ops
from repro.kernels import zo_noise as rz
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import init_zo_state
from repro_torch.distributed import sharding
from repro_torch.kernels import zo_noise as pz
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path

from _torch_ref import numpy_params, to_jax

REPO = Path(__file__).resolve().parents[1]
METHODS = ("tezo", "tezo_m", "tezo_adam", "mezo", "mezo_m", "mezo_adam", "lozo", "lozo_m",
           "subzo")
ARCHS = ("opt-125m", "granite-8b", "yi-34b", "qwen2.5-14b", "qwen3-32b", "paligemma-3b",
         "musicgen-medium", "dbrx-132b", "kimi-k2-1t-a32b", "hymba-1.5b", "xlstm-350m")
BARS = dict(loss_rtol=2e-4, param_atol=2e-4)  # tests/test_sharding_multidevice.py:55-58
# a step compared at the params bar moves at least half the params by ten
# times it (the rank script's MOVED_BAR), so a step that changed nothing
# could not pass; and kappa_abs per step agrees within 1e-3 relative: the
# data lanes sum the loss in another order (7.9e-8 relative at opt-125m-smoke),
# which moves kappa by 2.9e-5 (TeZO-Adam) and 1.0e-4 (MeZO-Adam) relative,
# the reference's forward against the port's by 5.9e-4 (granite-8b-smoke),
# while a kappa from the wrong losses is off by its own size
MOVED_SHARE, KAPPA_RTOL = 0.5, 1e-3


def _env() -> dict:
    src = str(REPO / "src")
    return dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------------------------------
# the spec tables against the reference's
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class _Mesh:
    """The reference's mesh API that its spec functions read."""

    data: int
    model: int
    axis_names = ("data", "model")

    @property
    def devices(self):
        return np.empty((self.data, self.model))


@dataclass(frozen=True)
class _Held:
    spec: tuple


def _trim(spec) -> tuple:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _ref_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, _Held))
    return {jax.tree_util.keystr(p): _trim(s.spec) for p, s in flat if isinstance(s, _Held)}


def _port_specs(tree) -> dict:
    return {p: _trim(s) for p, s in flatten_with_path(tree) if isinstance(s, tuple)}


SPEC_CASES = ([(a, "tezo_adam") for a in ARCHS]
              + [("opt-125m", m) for m in ("mezo_adam", "lozo_m", "subzo")]
              + [("dbrx-132b", "mezo_adam")])


@pytest.mark.parametrize("arch,method", SPEC_CASES)
def test_spec_tables_match_reference(monkeypatch, arch, method):
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda mesh, spec: _Held(spec))
    ref_model = ref_build_model(ref_smoke_config(arch))
    model = build_model(get_smoke_config(arch), "cpu")
    rcfg = RefZOConfig(method=method, rank=4)
    ref_abs = jax.eval_shape(lambda p: ref_init_state(p, rcfg), ref_model.abstract_params())
    state = init_zo_state(model.init(PRNGKey(0)), ZOConfig(method=method, rank=4))
    for d, m in ((2, 2), (1, 4), (4, 1)):
        want = _ref_specs(ref_sharding.zo_state_shardings(
            _Mesh(d, m), ref_model.logical_axes(), ref_abs))
        got = _port_specs(sharding.zo_state_specs(_Mesh(d, m), model.logical_axes(), state))
        assert got == want, (d, m, {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                                    if got.get(k) != want.get(k)})
        assert any(got.values())  # the mesh shards something
        want_p = _ref_specs(ref_sharding.param_shardings(
            _Mesh(d, m), ref_model.logical_axes(), ref_model.abstract_params()))
        assert _port_specs(sharding.param_specs(_Mesh(d, m), model.logical_axes(),
                                                model.abstract_params())) == want_p


def test_batch_spec_and_axes():
    mesh = _Mesh(2, 2)
    assert sharding.batch_spec(mesh, (4, 16)) == ("data", None)
    assert sharding.batch_spec(mesh, (3, 16)) == (None, None)  # 3 rows do not split
    assert sharding.batch_axes(mesh) == ref_sharding.batch_axes(mesh) == ("data",)
    assert sharding.LOGICAL_RULES == ref_sharding.LOGICAL_RULES
    for axes, shape in [(("heads", "ff"), (8, 8)), (("embed", "embed"), (4, 4)),
                        (("vocab", "embed"), (25, 8)), (("layers", "experts", "embed", None),
                                                        (2, 4, 6, 3))]:
        assert sharding.spec_for_axes(axes, shape, mesh) == tuple(
            ref_sharding.spec_for_axes(axes, shape, mesh)) + (None,) * (
            len(shape) - len(ref_sharding.spec_for_axes(axes, shape, mesh)))


# --------------------------------------------------------------------------
# the noise streams on shards
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def _interpret():
    ops.set_interpret(True)
    yield
    ops.set_interpret(None)


def _seeds(k=11, path="['blocks']['w_up']"):
    key = jax.random.PRNGKey(k)
    port_key = tuple(int(x) for x in np.asarray(jax.random.key_data(key)))
    return rz.leaf_seed(key, path), pz.leaf_seed(port_key, path)


# (whole shape, the shard's slices): uneven rows and columns of a stacked
# leaf; the second leading dim (an expert axis) split
SHARD_CASES = [((3, 40, 70), (slice(1, 3), slice(7, 30), slice(11, 60))),
               ((2, 4, 16, 24), (slice(None), slice(2, 4), slice(None), slice(8, 24)))]


def _offsets(shape, cut) -> list:
    return [s.start or 0 for s in cut]


@pytest.mark.parametrize("shape,cut", SHARD_CASES)
def test_noise_perturb_on_shards(_interpret, shape, cut):
    """A shard with its offsets is bitwise the whole leaf's slice, and its
    z (drawn onto zeros at scale 1) bitwise the reference's."""
    seed_j, seed_p = _seeds()
    w = torch.from_numpy((np.random.default_rng(1).standard_normal(shape) * 0.1)
                         .astype(np.float32)).to(torch.bfloat16)
    off = _offsets(shape, cut)
    for probes, scales in (([0], [1e-3]), ([2, 3], [1e-3, -2e-3])):
        whole = pz.noise_perturb(w.clone(), seed_p, probes, scales)
        part = pz.noise_perturb(w[cut].clone(), seed_p, probes, scales, offsets=off)
        assert torch.equal(part, whole[cut])
    z_shape = tuple(np.zeros(shape)[cut].shape)
    got = pz.noise_perturb(torch.zeros(z_shape), seed_p, [1], [1.0], offsets=off)
    want = ops.noise_perturb(jnp.zeros(z_shape, jnp.float32), seed_j, 1.0, probe=1,
                             offsets=jnp.asarray(off, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.abs().max() > 0


@pytest.mark.parametrize("shape,cut", SHARD_CASES)
def test_noise_update_on_shards(_interpret, shape, cut):
    """The Adam update with a folded restore: a shard is bitwise the whole
    leaf's slice (W and both moments) and within 1e-6 of the reference's
    ``ops.noise_update_adam(..., offsets=)``."""
    seed_j, seed_p = _seeds(5)
    rng = np.random.default_rng(2)
    w0 = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    m0 = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    v0 = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
    kap = np.asarray([0.7, -1.3], np.float32)
    off = _offsets(shape, cut)
    hyp = (1e-2, 0.9, 0.99, 1e-5)
    t = torch.from_numpy
    whole = pz.noise_update(t(w0.copy()), seed_p, t(kap), "adam", *hyp, decay=0.99,
                            m_buf=t(m0.copy()), v_buf=t(v0.copy()), restore_probes=[1],
                            restore_scales=[1e-3])
    part = pz.noise_update(t(w0[cut].copy()), seed_p, t(kap), "adam", *hyp, decay=0.99,
                           m_buf=t(m0[cut].copy()), v_buf=t(v0[cut].copy()),
                           restore_probes=[1], restore_scales=[1e-3], offsets=off)
    for a, b in zip(part, whole):
        assert torch.equal(a, b[cut])
    want = ops.noise_update_adam(jnp.asarray(w0[cut]), jnp.asarray(m0[cut]),
                                 jnp.asarray(v0[cut]), seed_j, jnp.asarray(kap), *hyp,
                                 decay=0.99, restore_probe=1, restore_scale=1e-3,
                                 offsets=jnp.asarray(off, jnp.int32))
    for g, w in zip(part, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_offsets_are_checked():
    w = torch.zeros(4, 8, 8)
    with pytest.raises(ValueError, match="offsets"):
        pz.noise_perturb(w, (1, 2), [0], [1.0], offsets=[0, 0])
    with pytest.raises(ValueError, match="24 bits"):
        pz.noise_perturb(w, (1, 2), [0], [1.0], offsets=[0, (1 << 24) - 8, 0])


# --------------------------------------------------------------------------
# the 4-rank job
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(records by case, the job's output directory)."""
    out = tmp_path_factory.mktemp("shard")
    proc = subprocess.run([sys.executable, str(REPO / "tests" / "_torch_shard_rank.py"),
                           str(out)], env=_env(), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    recs = [json.loads(line) for line in (out / "shard.jsonl").read_text().splitlines()]
    by = {}
    for r in recs:
        key = (r["case"], r.get("method"), r.get("data"), r.get("model"), r.get("stragglers"))
        if r.get("arch", "opt-125m") != "opt-125m":
            key = (r["arch"],) + key
        by[key] = r
    return by, out


@pytest.mark.parametrize("method", METHODS)
def test_one_by_two_is_the_single_process_step(job, method):
    rec = job[0]["step", method, 1, 2, None]
    assert rec["bitwise"], f"{method}: differs in {rec['differ']}"
    assert rec["zo_passes"] == [5, 5]  # 2q + 1, as unsharded
    assert rec["resident"] < rec["resident_whole"]


@pytest.mark.parametrize("arch", ["dbrx-132b", "hymba-1.5b", "xlstm-350m"])
def test_families_on_one_by_two(job, arch):
    """The other families' layer hooks gather their shards: TeZO-Adam on
    1 x 2 bitwise the single-process step."""
    rec = job[0][arch, "step", "tezo_adam", 1, 2, None]
    assert rec["bitwise"], f"{arch}: differs in {rec['differ']}"
    assert rec["resident"] < rec["resident_whole"]


@pytest.mark.parametrize("arch", ["opt-125m", "dbrx-132b", "hymba-1.5b", "xlstm-350m"])
@pytest.mark.parametrize("data,model,rank", [(1, 2, 1), (2, 2, 3), (2, 1, 0)])
def test_init_shard_is_the_whole_draws_slice(arch, data, model, rank):
    """``sharding.init_state`` draws a rank's shard of the params and of
    the ZO state alone (TeZO-Adam, LOZO-m, SubZO, MeZO-Adam), bitwise the
    cut of the whole state (f32 and bf16 leaves; rows longer than a draw
    chunk); its context's whole-state stand-in has the whole shapes."""
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.utils import jax_random

    m = build_model(get_smoke_config(arch).reduced(dtype="bfloat16"), "cpu")
    mesh = HostMesh(data, model, rank)
    for method in ("tezo_adam", "lozo_m", "subzo", "mezo_adam"):
        cfg = ZOConfig(method=method, rank=8, lazy_interval=1)
        whole = init_zo_state(m.init(PRNGKey(3)), cfg)
        chunk = jax_random._CHUNK
        if method == "tezo_adam":  # several chunks and rows past a chunk, at smoke size
            jax_random._CHUNK = 100
        try:
            state, shard = sharding.init_state(m, cfg, mesh, PRNGKey(3))
        finally:
            jax_random._CHUNK = chunk
        want = dict(flatten_with_path(sharding.shard_tree(whole, shard.state_specs, mesh)))
        got = dict(flatten_with_path(state))
        assert got.keys() == want.keys(), method
        for p, w in want.items():
            if isinstance(w, torch.Tensor):
                assert torch.equal(got[p], w), (method, p)
            else:
                assert np.array_equal(np.asarray(got[p]), np.asarray(w)), (method, p)
        stand_in = dict(flatten_with_path(shard.whole_state))
        for p, w in flatten_with_path(whole):
            if isinstance(w, torch.Tensor):
                assert stand_in[p].is_meta and stand_in[p].shape == w.shape, (method, p)
        assert (sum(x.numel() for _, x in flatten_with_path(state.params))
                < sum(x.numel() for _, x in flatten_with_path(whole.params)))


@pytest.mark.parametrize("method", ["tezo_adam", "mezo_adam"])
@pytest.mark.parametrize("data,model", [(2, 1), (2, 2)])
def test_data_lanes_within_reference_bars(job, method, data, model):
    rec = job[0]["step", method, data, model, None]
    assert rec["moved"] >= MOVED_SHARE, f"the step moved {rec['moved']} of the params"
    assert rec["loss_rel"] <= BARS["loss_rtol"], rec
    assert rec["param_diff"] <= BARS["param_atol"], rec
    assert rec["kappa_rel"] <= KAPPA_RTOL, rec
    assert rec["repeat_bitwise"], "two runs of the same sharded step differ"
    assert rec["zo_passes"] == [5, 5]
    assert rec["resident"] < rec["resident_whole"]


@pytest.mark.parametrize("data,model,stragglers", [(1, 2, False), (1, 2, True),
                                                   (2, 2, True)])
def test_ensemble_on_a_mesh(job, data, model, stragglers):
    rec = job[0]["ensemble", None, data, model, stragglers]
    if data == 1:
        assert rec["bitwise"], rec["differ"]
    assert rec["moved"] >= MOVED_SHARE, f"the step moved {rec['moved']} of the params"
    assert rec["loss_rel"] <= BARS["loss_rtol"] and rec["param_diff"] <= BARS["param_atol"]
    assert rec["kappa_rel"] <= KAPPA_RTOL, rec


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_moe_ep_matches_single_device(job, data, model):
    rec = job[0]["moe_ep", None, data, model, None]
    assert abs(rec["loss"] - rec["loss_single"]) <= 2e-4  # the reference's bar
    assert np.isfinite(rec["loss"])


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_elastic_restore(job, data, model):
    rec = job[0]["restore", None, data, model, None]
    assert rec["bitwise"] and rec["step"] == 3 and rec["sharded"] > 0


def test_sharded_step_against_reference(job):
    """The port's 2 x 2 TeZO-Adam step of granite-8b-smoke against the
    reference's unsharded xla step from the same numpy params and the same
    ``make_inputs`` batch (bitwise the port's, tests/test_torch_inputs.py)."""
    recs, out = job
    cfg = ref_smoke_config("granite-8b").reduced(kernel_mode="xla")
    model = ref_build_model(cfg)
    params = to_jax(numpy_params(get_smoke_config("granite-8b"), 0))
    batch = model.make_inputs(jax.random.PRNGKey(1), RefShapeConfig("t", 32, 4, "train"))
    zc = RefZOConfig(method="tezo_adam", rank=4, lr=1e-2)  # the rank script's GRANITE_LR
    state, metrics = jax.jit(ref_build_step(model.loss_fn, zc))(ref_init_state(params, zc),
                                                                batch)
    got = np.load(out / "granite.npz")
    flat, _ = jax.tree_util.tree_flatten_with_path(state.params)
    init = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    moved = sum(int((np.abs(np.asarray(w, np.float32) - np.asarray(init[p], np.float32))
                     > 10 * BARS["param_atol"]).sum()) for p, w in flat)
    assert moved >= MOVED_SHARE * sum(np.size(w) for _, w in flat), moved
    for p, w in flat:
        np.testing.assert_allclose(got[jax.tree_util.keystr(p)], np.asarray(w, np.float32),
                                   rtol=0, atol=BARS["param_atol"])
    rec = recs["granite", None, None, None, None]
    np.testing.assert_allclose(rec["loss"], float(metrics["loss"]), rtol=BARS["loss_rtol"])
    np.testing.assert_allclose(rec["kappa_abs"], float(metrics["kappa_abs"]), rtol=KAPPA_RTOL)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def _cli(*args) -> dict:
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                           "--device", "cpu", "--steps", "3", *args],
                          env=_env(), capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return json.loads(proc.stdout[proc.stdout.index("{"):])


def _single(**kw) -> dict:
    """The same run in this process, unsharded (one torch thread, as the
    CLI's ranks run)."""
    return port_train.train(smoke=True, device="cpu", steps=3, verbose=False, **kw)


@pytest.mark.parametrize("method", ["tezo_adam", "mezo_adam"])
def test_cli_one_by_two_prints_the_single_process_loss(method):
    got = _cli("--method", method, "--mesh", "host:1,2")
    want = _single(method=method)
    assert got["sharded"] and got["collective_backend"] == "gloo" and got["mesh"] == "1,2"
    assert got["final_eval_loss"] == want["final_eval_loss"]
    assert got["zo_passes"] == want["zo_passes"] == 3
    assert got["resident_bytes"] < want["resident_bytes"]


def test_cli_ensemble_on_a_mesh():
    got = _cli("--ensemble", "2", "--straggler-prob", "0.25", "--mesh", "host:1,2")
    want = _single(ensemble=2, straggler_prob=0.25)
    assert got["sharded"] and got["final_eval_loss"] == want["final_eval_loss"]
