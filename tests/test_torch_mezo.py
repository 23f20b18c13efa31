"""The port's MeZO family (``mezo``, ``mezo_m``, ``mezo_adam``) on the CPU,
against the reference's ``kernel_mode="pallas"`` step: the counter stream
the port's noise kernels draw is the one the reference's Pallas kernels
draw, where its ``xla`` lowering draws ``jax.random`` streams instead (by
design, ROADMAP.md Queue C).  The leaf the noise kernels do not cover
(``final_norm``, and the smoke model's [2, 64] norm stacks) keeps the
``jax.random`` stream on both sides.

Tolerances (tests/test_torch_train.py's, for the same reasons): per-step
losses within 1e-5 relative; params within 1e-5; the κ-scaled moments
within 1e-3 of each moment's largest entry (κ = Δloss / 2ρ carries the
frameworks' ~1e-7 relative loss difference times 1/2ρ = 500).  Over the
ten-step run that last bound also admits what the measured per-step κ
differences can move a moment: a loss near 6 is held to about one f32 ulp
(4.8e-7), which is 2.4e-4 of κ, and every element of a dense moment takes
κ·z with |z| up to 5.89 (the stream's largest: u1 >= 2^-25), where a TeZO
moment takes κ·τ once per leaf.  Inside the port: chained == unchained
bit for bit; a checkpoint round trip bit for bit.

Each reference step costs a ~10 s compile of the interpreted noise
kernels, so the cases are chosen to cover each method and each q once:
mezo at q = 1, mezo_m at q = 2, mezo_adam at q = 2, and mezo_adam at q = 1
for ten steps through the smoke CLI's ``train`` call (which also serves
the checkpoint and resume check).  The rules at q = 1 and 3 are held against
the Pallas kernels one by one in tests/test_torch_zo_noise.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import ZOConfig as RefZOConfig
from repro.core import build_zo_train_step as ref_build_step
from repro.core import init_zo_state as ref_init_state
from repro.data import DataConfig as RefDataConfig
from repro.data import batch_at_step as ref_batch_at_step
from repro.kernels import ops
from repro.models import build_model as ref_build_model
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core import dispatch
from repro_torch.core.estimator import ZOConfig, get_method
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path

DATA = dict(seq_len=32, global_batch=4, vocab_size=256, seed=0)
# ``launch/train.py --smoke``'s data and ZO settings
CLI = dict(data=dict(seq_len=128, global_batch=8, vocab_size=256, seed=0), lr=1e-6)
CLI_STEPS = 10
CLI_FINAL_EVAL_LOSS = 6.035619735717773  # the reference CLI, --method mezo_adam
# --kernel-mode pallas --smoke --steps 10, seed 0
Z_MAX = float(np.sqrt(-2.0 * np.log(2.0**-25)))  # the largest |z| the stream draws


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    ops.set_interpret(True)
    yield
    ops.set_interpret(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_state(method, q, restore_mode="inplace", dtype="float32", lr=1e-4):
    model = build_model(get_smoke_config("opt-125m").reduced(dtype=dtype), device="cpu")
    zc = ZOConfig(method=method, q_probes=q, restore_mode=restore_mode, lr=lr)
    return model, zc, init_zo_state(model.init(PRNGKey(0)), zc)


def _port_run(method, q, steps, restore_mode="inplace", dtype="float32", lr=1e-4, data=DATA):
    model, zc, state = _port_state(method, q, restore_mode, dtype, lr)
    step = build_zo_train_step(model.loss_fn, zc)
    losses, kappas = [], []
    for s in range(steps):
        batch = {k: _t(v) for k, v in batch_at_step(DataConfig(**data), s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        kappas.append(float(metrics["kappa_abs"]))
    return state, losses, kappas


def _ref_run(method, q, steps, lr=1e-4, data=DATA, keep=()):
    """The reference's pallas step; returns (states at the steps in
    ``keep`` and the last, losses, mean |κ| per step, model)."""
    model = ref_build_model(ref_smoke_config("opt-125m"))
    zc = RefZOConfig(method=method, kernel_mode="pallas", q_probes=q, lr=lr)
    state = ref_init_state(model.init(jax.random.PRNGKey(0)), zc)
    step = jax.jit(ref_build_step(model.loss_fn, zc))
    losses, kappas, kept = [], [], {}
    for s in range(steps):
        if s in keep:
            kept[s] = state
        batch = {k: jnp.asarray(v) for k, v in ref_batch_at_step(RefDataConfig(**data), s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        kappas.append(float(metrics["kappa_abs"]))
    kept[steps] = state
    return kept, losses, kappas, model


def _flat(state) -> dict:
    return {p: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in flatten_with_path(state)}


def _ref_flat(state) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) if v.dtype != np.uint32
            else np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(state)}


def _kappa_slack(k_port, k_ref, beta1=0.9, beta2=0.99) -> dict:
    """What the per-step differences of a q = 1 run's κ can move each
    moment, for any element: M takes (1−β₁)·κ·z per step, V (1−β₂)·κ²·z²,
    |z| <= Z_MAX.  |κ| comes from the steps' metrics; it gives |Δκ| where
    κ is far from 0, which the run checks."""
    kp, kr = np.asarray(k_port), np.asarray(k_ref)
    dk = np.abs(kp - kr)
    assert kr.min() > 10 * dk.max(), (kr, dk)
    age = np.arange(len(kr))[::-1]
    return {"m": (1 - beta1) * np.sum(beta1**age * dk) * Z_MAX,
            "v": (1 - beta2) * np.sum(beta2**age * (2 * kr + dk) * dk) * Z_MAX**2}


def _assert_state_close(port, jref, slack=None):
    got, want = _flat(port), _ref_flat(jref)
    assert set(got) == set(want)
    for path, w in want.items():
        if path.startswith(".mstate"):
            atol = 1e-3 * float(np.abs(w).max())
            if slack is not None:
                atol += slack[path[len(".mstate['"):][0]]
            np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)
    return got


@pytest.fixture(scope="module")
def ref_cli_run():
    """The reference's mezo_adam run at the smoke CLI's settings: states
    after 9 and 10 steps, per-step losses, final eval loss and its step."""
    kept, losses, kappas, model = _ref_run("mezo_adam", 1, CLI_STEPS, lr=CLI["lr"],
                                           data=CLI["data"], keep=(CLI_STEPS - 1,))
    batch = ref_batch_at_step(RefDataConfig(**CLI["data"]), 999_999_999)
    final = float(jax.jit(model.loss_fn)(kept[CLI_STEPS].params,
                                         {k: jnp.asarray(v) for k, v in batch.items()}))
    return kept, losses, kappas, final


@pytest.mark.parametrize("method,q", [("mezo", 1), ("mezo_m", 2), ("mezo_adam", 2)])
def test_step_matches_reference_pallas(method, q):
    """Two steps from the same seed; every param and moment."""
    port, l_p, _ = _port_run(method, q, 2)
    kept, l_r, _, _ = _ref_run(method, q, 2)
    np.testing.assert_allclose(l_p, l_r, rtol=1e-5, atol=0)
    got = _assert_state_close(port, kept[2])
    init = build_model(get_smoke_config("opt-125m"), device="cpu").init(PRNGKey(0))
    assert np.abs(got[".params['blocks']['wq']"] - init["blocks"]["wq"].numpy()).max() > 1e-6


def test_smoke_cli_matches_reference(ref_cli_run):
    """``python -m repro_torch.launch.train --smoke --device cpu --steps 10
    --method mezo_adam`` (its ``train`` call) against the reference's
    ``--kernel-mode pallas`` run: every step's loss, the state after ten
    steps and the final eval loss (measured: within 1e-7 relative)."""
    kept, l_r, k_r, want = ref_cli_run
    res = port_train.train(smoke=True, device="cpu", steps=CLI_STEPS, method="mezo_adam",
                           log_every=1, verbose=False, return_state=True)
    assert abs(want - CLI_FINAL_EVAL_LOSS) < 1e-6
    assert res["method"] == "mezo_adam" and res["zo_passes"] == 3
    assert abs(res["final_eval_loss"] - want) <= 1e-5 * abs(want)
    np.testing.assert_allclose([h["loss"] for h in res["history"]], l_r, rtol=1e-5, atol=0)
    k_p = [h["kappa_abs"] for h in res["history"]]
    got = _assert_state_close(res["state"], kept[CLI_STEPS], _kappa_slack(k_p, k_r))
    assert int(got[".step"]) == CLI_STEPS


@pytest.mark.parametrize("method,q,dtype", [
    ("mezo", 2, "bfloat16"), ("mezo_m", 2, "bfloat16"), ("mezo_adam", 2, "bfloat16"),
    ("mezo_adam", 1, "float32"),
])
def test_chained_equals_unchained_bitwise(method, q, dtype):
    chained, l_c, _ = _port_run(method, q, 3, "inplace", dtype, lr=1e-2)
    unchained, l_u, _ = _port_run(method, q, 3, "unchained", dtype, lr=1e-2)
    assert l_c == l_u and all(np.isfinite(l_c))
    a, b = flatten_with_path(chained), dict(flatten_with_path(unchained))
    for path, x in a:
        assert (torch.equal(x, b[path]) if isinstance(x, torch.Tensor)
                else np.array_equal(x, b[path])), path


def test_noise_kernel_eligibility_and_state_layout():
    """The reference's rule picks the leaves; MeZO's state has the
    reference's names; only the ineligible leaves draw host z."""
    model, zc, state = _port_state("mezo_adam", 1)
    flat = dict(flatten_with_path(state.params))
    eligible = {p for p, w in flat.items() if dispatch.noise_kernel_eligible(w)}
    assert eligible == {p for p in flat if "norm" not in p and "ln" not in p}
    assert set(state.mstate) == {"m", "v"}
    assert set(state.mstate["m"]) == set(flat)
    noise = get_method(zc.method).draws(state.params, state.mstate, PRNGKey(3), zc)
    assert {p for p, _ in noise._z} == set(flat) - eligible
    assert dispatch.noise_kernel_eligible(torch.empty(12, 768))
    assert not dispatch.noise_kernel_eligible(torch.empty(768))


def test_checkpoint_reference_layout_and_resume(tmp_path, ref_cli_run):
    """A reference mezo_adam checkpoint (after 9 steps) restores into the
    port leaf for leaf, and the port's tenth step from it lands where the
    reference's did; a port checkpoint round-trips bit for bit."""
    kept = ref_cli_run[0]
    RefCheckpointer(tmp_path / "ref").save(CLI_STEPS - 1, kept[CLI_STEPS - 1],
                                           extra={"step": CLI_STEPS - 1})
    model, zc, template = _port_state("mezo_adam", 1, lr=CLI["lr"])
    restored, extra = Checkpointer(tmp_path / "ref").restore(template)
    assert extra == {"step": CLI_STEPS - 1} and restored.step == CLI_STEPS - 1
    want = _ref_flat(kept[CLI_STEPS - 1])
    got = _flat(restored)
    assert set(got) == set(want) and ".mstate['v'][\"['embed']\"]" in got
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    step = build_zo_train_step(model.loss_fn, zc)
    batch = {k: _t(v) for k, v in
             batch_at_step(DataConfig(**CLI["data"]), CLI_STEPS - 1).items()}
    resumed, _ = step(restored, batch)
    _assert_state_close(resumed, kept[CLI_STEPS])

    ck = Checkpointer(tmp_path / "port")
    ck.save(CLI_STEPS, resumed, extra={"step": CLI_STEPS})
    again, _ = ck.restore(template)
    a, b = dict(flatten_with_path(resumed)), dict(flatten_with_path(again))
    assert a.keys() == b.keys()
    for path, x in a.items():
        assert (torch.equal(x, b[path]) if isinstance(x, torch.Tensor)
                else np.array_equal(x, b[path])), path
