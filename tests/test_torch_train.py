"""The port's training slice on the CPU, against the reference.

* the plain versions of the two weight-pass kernels against the reference's
  oracles (``repro/kernels/ref.py``) and its Pallas kernels under the
  interpreter: f32 within 1e-6, bf16 within 1 bf16 ulp;
* ``loss_fn`` from bridged params (1e-5);
* chained == unchained, bitwise, inside the port (3 methods x q in {1, 2} x
  f32 / bf16);
* the ZO step against the reference's ``kernel_mode="xla"`` step from the
  same seed: per-step losses within 1e-5 relative, params and factors
  within 1e-5, the κ-scaled τ-space and dense moments within 1e-3 of each
  moment's largest entry (the two frameworks sum matmuls in other orders,
  and κ = Δloss / 2ρ magnifies that by 1/2ρ);
* the data pipeline, the training CLI, checkpoints, and the options that
  are not ported.

All at the opt-125m-smoke size; the CUDA kernels are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import json

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
from repro.kernels import ops, ref
from repro.models import build_model as ref_build_model
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core import dispatch
from repro_torch.core.estimator import ZOConfig, get_method
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state, zo_pass_count
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.kernels import tezo_adam as tadam
from repro_torch.kernels import tezo_perturb as tpert
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path

from _torch_ref import numpy_params, to_jax

F32_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def force_interpret():
    ops.set_interpret(True)
    yield
    ops.set_interpret(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _within_bf16_ulp(got, want) -> bool:
    got, want = _f32(got), _f32(want)
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    ulp = np.ldexp(1.0, e - 8)  # bf16: 8 significant bits
    return bool(np.all(np.abs(got - want) <= ulp))


def _check(got, want, dtype, what):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=F32_ATOL, err_msg=what)
    else:
        assert _within_bf16_ulp(got, want), what


# --------------------------------------------------------------------------
# the two kernels' plain versions
# --------------------------------------------------------------------------

KERNEL_CASES = [(50, 40, 8), (16, 136, 24), (24, 32, 1)]  # m = 50 is no tile multiple


def _operands(m, n, r, dtype, seed, k=3):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((m, n)) * 0.1).astype(np.float32)
    u = rng.standard_normal((m, r)).astype(np.float32)
    v = rng.standard_normal((n, r)).astype(np.float32)
    taus = rng.standard_normal((k, r)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    w_j = jnp.asarray(w).astype(jdt)
    w_t = _t(w).to(getattr(torch, dtype))
    return w_j, w_t, u, v, taus


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,r", KERNEL_CASES)
def test_tezo_perturb_plain_matches_reference(m, n, r, dtype, force_interpret):
    """k = 1..3 chained deltas with a decay on the last, against the
    composed oracle and the Pallas chain kernel."""
    w_j, w_t, u, v, taus = _operands(m, n, r, dtype, seed=m + n + r)
    scales, decay = [1e-3, -2e-3, 1.5e-3], 0.98
    for k in (1, 2, 3):
        got = tpert.tezo_perturb(w_t.clone(), _t(u), _t(v), _t(taus[:k]), scales[:k],
                                 decay=decay)
        want = ref.tezo_chain_ref(w_j, jnp.asarray(u), jnp.asarray(v),
                                  jnp.asarray(taus[:k]), scales[:k], decay)
        assert got.dtype == w_t.dtype and tuple(got.shape) == (m, n)
        _check(got, want, dtype, f"oracle k={k}")
        if k != 2:  # the interpreter is slow; k = 1 and the 3-chain cover it
            pallas = ops.tezo_perturb(w_j, jnp.asarray(u), jnp.asarray(v),
                                      jnp.asarray(taus[:k]), jnp.asarray(scales[:k]),
                                      decay=decay)
            _check(got, pallas, dtype, f"pallas k={k}")
    one = tpert.tezo_perturb(w_t.clone(), _t(u), _t(v), _t(taus[:1]), [scales[0]])
    _check(one, ref.tezo_perturb_ref(w_j, jnp.asarray(u), jnp.asarray(v),
                                     jnp.asarray(taus[0]), scales[0]), dtype, "single")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,r", KERNEL_CASES)
def test_tezo_adam_plain_matches_reference(m, n, r, dtype, force_interpret):
    """Without and with a folded restore delta."""
    w_j, w_t, u, v, taus = _operands(m, n, r, dtype, seed=7 * m + n + r)
    tau_m, tau_v = taus[0] * 0.3, taus[1] ** 2 * 0.05
    lr, eps, rs = 1e-3, 1e-5, 1e-3
    args_j = (jnp.asarray(u), jnp.asarray(v), jnp.asarray(tau_m), jnp.asarray(tau_v))
    args_t = (_t(u), _t(v), _t(tau_m), _t(tau_v))
    got = tadam.tezo_adam_update(w_t.clone(), *args_t, lr, eps)
    _check(got, ref.tezo_adam_update_ref(w_j, *args_j, lr, eps), dtype, "oracle")
    _check(got, ops.tezo_adam_update(w_j, *args_j, lr, eps), dtype, "pallas")
    got = tadam.tezo_adam_update(w_t.clone(), *args_t, lr, eps, decay=0.99,
                                 tau_r=_t(taus[2:3]), restore_scale=[rs])
    want = ref.tezo_adam_restore_update_ref(w_j, *args_j, lr, eps, 0.99,
                                            tau_r=jnp.asarray(taus[2]), restore_scale=rs)
    pallas = ops.tezo_adam_update(w_j, *args_j, lr, eps, decay=0.99,
                                  tau_r=jnp.asarray(taus[2]), restore_scale=rs)
    _check(got, want, dtype, "restore oracle")
    _check(got, pallas, dtype, "restore pallas")


def test_restore_into_update_is_bitwise_the_two_passes():
    """The plain versions keep the chained contract: restore folded into the
    Adam pass == a separate perturb pass followed by the Adam pass; a
    stacked leaf == its matrices one by one; ``out`` leaves W untouched."""
    rng = np.random.default_rng(1)
    w = _t((rng.standard_normal((3, 20, 12)) * 0.1).astype(np.float32)).to(torch.bfloat16)
    u = _t(rng.standard_normal((3, 20, 4)).astype(np.float32))
    v = _t(rng.standard_normal((3, 12, 4)).astype(np.float32))
    tm, tv, tr = (_t(rng.standard_normal((3, 4)).astype(np.float32) ** p) for p in (1, 2, 1))
    fused = tadam.tezo_adam_update(w.clone(), u, v, tm, tv, 1e-3, 1e-5,
                                   tau_r=tr[:, None], restore_scale=[1e-3])
    two = tadam.tezo_adam_update(tpert.tezo_perturb(w.clone(), u, v, tr[:, None], [1e-3]),
                                 u, v, tm, tv, 1e-3, 1e-5)
    assert torch.equal(fused, two)
    chain = torch.stack([tr, tm], dim=-2)  # a two-delta restore chain
    fused2 = tadam.tezo_adam_update(w.clone(), u, v, tm, tv, 1e-3, 1e-5, tau_r=chain,
                                    restore_scale=[1e-3, -2e-3])
    three = tadam.tezo_adam_update(
        tpert.tezo_perturb(w.clone(), u, v, chain, [1e-3, -2e-3]), u, v, tm, tv, 1e-3, 1e-5)
    assert torch.equal(fused2, three)
    for i in range(3):
        one = tadam.tezo_adam_update(tpert.tezo_perturb(w[i].clone(), u[i], v[i],
                                                        tr[i][None], [1e-3]),
                                     u[i], v[i], tm[i], tv[i], 1e-3, 1e-5)
        assert torch.equal(fused[i], one)
    out = torch.empty_like(w)
    before = w.clone()
    got = tpert.tezo_perturb(w, u, v, tr[:, None], [1e-3], out=out)
    assert got is out and torch.equal(w, before) and not torch.equal(out, before)


# --------------------------------------------------------------------------
# loss_fn
# --------------------------------------------------------------------------


def test_loss_fn_matches_reference():
    cfg = get_smoke_config("opt-125m")
    params = numpy_params(cfg, seed=5)
    batch = batch_at_step(DataConfig(seq_len=48, global_batch=3, vocab_size=256, seed=2), 0)
    want = float(ref_build_model(ref_smoke_config("opt-125m")).loss_fn(
        to_jax(params), {k: jnp.asarray(v) for k, v in batch.items()}))
    got = build_model(cfg, device="cpu").loss_fn(
        params_from_numpy(params), {k: _t(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * abs(want)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

DATA = dict(seq_len=32, global_batch=4, vocab_size=256, seed=0)
# what ``launch/train.py --smoke --steps 10`` runs (its DataConfig and
# ZOConfig defaults), so one reference run serves the step and CLI checks
CLI = dict(data=dict(seq_len=128, global_batch=8, vocab_size=256, seed=0), rank=24, lr=1e-6)


def _port_run(method, q, restore_mode, steps, dtype="float32", lr=1e-3, seed=0, data=DATA,
              rank=8):
    cfg = get_smoke_config("opt-125m").reduced(dtype=dtype)
    model = build_model(cfg, device="cpu")
    zc = ZOConfig(method=method, q_probes=q, restore_mode=restore_mode, rank=rank, lr=lr,
                  seed=seed)
    state = init_zo_state(model.init(PRNGKey(seed)), zc)
    step = build_zo_train_step(model.loss_fn, zc)
    losses = []
    for s in range(steps):
        batch = {k: _t(v) for k, v in batch_at_step(DataConfig(**data), s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


def _ref_run(method, q, restore_mode, steps, lr=1e-3, seed=0, data=DATA, rank=8):
    model = ref_build_model(ref_smoke_config("opt-125m"))
    zc = RefZOConfig(method=method, kernel_mode="xla", q_probes=q, restore_mode=restore_mode,
                     rank=rank, lr=lr, seed=seed)
    state = ref_init_state(model.init(jax.random.PRNGKey(seed)), zc)
    step = jax.jit(ref_build_step(model.loss_fn, zc))
    losses = []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in ref_batch_at_step(RefDataConfig(**data), s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses, model


@pytest.fixture(scope="module")
def ref_cli_run():
    """The reference's ``--smoke --steps 10 --kernel-mode xla`` run: its
    state, per-step losses and final eval loss (train.py's eval batch)."""
    state, losses, model = _ref_run("tezo_adam", 1, "inplace", 10, **CLI)
    batch = ref_batch_at_step(RefDataConfig(**CLI["data"]), 999_999_999)
    final = float(jax.jit(model.loss_fn)(state.params,
                                         {k: jnp.asarray(v) for k, v in batch.items()}))
    return state, losses, final


def _flat_state(state) -> dict:
    return {p: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in flatten_with_path(state)}


def _ref_flat(state) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) if v.dtype != np.uint32
            else np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(state)}


@pytest.mark.parametrize("method", ["tezo", "tezo_m", "tezo_adam"])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_equals_unchained_bitwise(method, q, dtype):
    """The port's copy of tests/test_chain_fusion.py's contract."""
    chained, l_c = _port_run(method, q, "inplace", 3, dtype, lr=1e-2)
    unchained, l_u = _port_run(method, q, "unchained", 3, dtype, lr=1e-2)
    assert l_c == l_u and all(np.isfinite(l_c))
    a, b = flatten_with_path(chained), dict(flatten_with_path(unchained))
    for path, x in a:
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, b[path]), path
        else:
            assert np.array_equal(x, b[path]), path
    init = dict(flatten_with_path(build_model(get_smoke_config("opt-125m").reduced(
        dtype=dtype), device="cpu").init(PRNGKey(0))))
    assert not torch.equal(chained.params["blocks"]["wq"], init["['blocks']['wq']"])


def _assert_state_close(port, jref):
    got, want = _flat_state(port), _ref_flat(jref)
    assert set(got) == set(want)
    for path, w in want.items():
        if path.startswith((".mstate['tau_", ".mstate['dense_")):
            # κ-scaled moments: κ = Δloss / 2ρ carries the frameworks' ~1e-7
            # relative loss difference times 1/2ρ = 500, a relative error of
            # the whole κ, so each moment is held within 1e-3 of its largest
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-3 * scale, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)
    return got


STEP_CASES = [("tezo", 1, 4), ("tezo", 2, 4), ("tezo_adam", 2, 4)]


@pytest.mark.parametrize("method,q,steps", STEP_CASES)
def test_step_matches_reference_xla(method, q, steps):
    port, l_p = _port_run(method, q, "inplace", steps, lr=1e-4)
    jref, l_r, _ = _ref_run(method, q, "inplace", steps, lr=1e-4)
    np.testing.assert_allclose(l_p, l_r, rtol=1e-5, atol=0)
    got = _assert_state_close(port, jref)
    assert int(got[".step"]) == steps
    init = build_model(get_smoke_config("opt-125m"), device="cpu").init(PRNGKey(0))
    assert np.abs(got[".params['blocks']['wq']"] - init["blocks"]["wq"].numpy()).max() > 1e-5


def test_tezo_adam_ten_steps_match_reference_xla(ref_cli_run):
    """TeZO-Adam, q = 1, 10 steps at the smoke CLI's settings."""
    jref, l_r, _ = ref_cli_run
    port, l_p = _port_run("tezo_adam", 1, "inplace", 10, **CLI)
    np.testing.assert_allclose(l_p, l_r, rtol=1e-5, atol=0)
    assert int(_assert_state_close(port, jref)[".step"]) == 10


def test_exact_restore_mode_branches_copies():
    """``exact`` perturbs copies and updates the untouched originals: close
    to the chained step (which restores by arithmetic), not bitwise."""
    exact, l_e = _port_run("tezo_adam", 2, "exact", 3, lr=1e-3)
    chained, l_c = _port_run("tezo_adam", 2, "inplace", 3, lr=1e-3)
    np.testing.assert_allclose(l_e, l_c, rtol=1e-5)
    for name, w in exact.params["blocks"].items():
        np.testing.assert_allclose(w.numpy(), chained.params["blocks"][name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_perturb_chain_is_the_single_perturbs():
    """One k-delta chain pass (dense leaves included) == k perturb passes."""
    model = build_model(get_smoke_config("opt-125m").reduced(dtype="bfloat16"), device="cpu")
    zc = ZOConfig(method="tezo", rank=8, q_probes=2)
    state = init_zo_state(model.init(PRNGKey(0)), zc)
    method = get_method("tezo")
    noise = method.draws(state.params, state.mstate, PRNGKey(5), zc)
    probes, scales = (0, 1, 0), (1e-3, 1e-3, -2e-3)
    copy = {k: ({n: w.clone() for n, w in v.items()} if isinstance(v, dict) else v.clone())
            for k, v in state.params.items()}
    chained = method.perturb_chain(copy, state.mstate, noise, probes, scales, zc)
    single = state.params
    for p, sc in zip(probes, scales):
        single = method.perturb(single, state.mstate, noise, p, sc, zc)
    a, b = dict(flatten_with_path(chained)), dict(flatten_with_path(single))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_pass_count_and_methods():
    assert [zo_pass_count(q, m) for q in (1, 4) for m in ("inplace", "unchained", "exact")] \
        == [3, 4, 3, 9, 13, 9]
    with pytest.raises(ValueError):
        zo_pass_count(1, "lazy")
    names = ("tezo", "tezo_m", "tezo_adam", "mezo", "mezo_m", "mezo_adam", "lozo", "lozo_m",
             "subzo")
    assert [get_method(name).name for name in names] == list(names)
    with pytest.raises(KeyError, match="unknown ZO method"):
        get_method("lazo")


@pytest.mark.parametrize("q", [1, 2, 3])
def test_kappa_fold_matches_reference_fence(q):
    """Bitwise for the q the step tests run; at q = 3 XLA's divide by 3 may
    round differently, so within 1 ulp there."""
    from repro.kernels import fence

    rng = np.random.default_rng(3)
    kap = rng.standard_normal(q).astype(np.float32)
    terms = [rng.standard_normal(17).astype(np.float32) for _ in range(q)]
    for square in (False, True):
        want = np.asarray(fence.kappa_fold(jnp.asarray(kap), [jnp.asarray(t) for t in terms],
                                           square=square))
        got = dispatch.kappa_fold(_t(kap), [_t(t) for t in terms], square=square).numpy()
        if q < 3:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)


# --------------------------------------------------------------------------
# data, CLI, checkpoints, options
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(seq_len=128, global_batch=8, vocab_size=512, seed=3),
                                dict(global_batch=4, host_index=1, host_count=2)])
def test_batches_equal_reference(kw):
    for step in (0, 7, 999_999_999):
        got = batch_at_step(DataConfig(**kw), step)
        want = ref_batch_at_step(RefDataConfig(**kw), step)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_smoke_cli_matches_reference(capsys, ref_cli_run):
    """``python -m repro_torch.launch.train --smoke --device cpu --steps 10``
    against the reference's ``--kernel-mode xla`` run (6.03563 at seed 0)."""
    port_train.main(["--smoke", "--device", "cpu", "--steps", "10"])
    out = capsys.readouterr().out
    result = json.loads(out[out.index("\n{") + 1:])
    want = ref_cli_run[2]
    assert result["device"] == "cpu" and result["zo_passes"] == 3
    assert abs(result["final_eval_loss"] - want) <= 1e-5 * abs(want)
    assert abs(want - 6.03563) < 1e-5


def test_checkpoint_round_trip_and_reference_layout(tmp_path):
    """A port checkpoint restores bitwise (bf16 params included) and has
    the reference's paths; a reference ZO checkpoint restores into the
    port's state with every leaf equal."""
    cfg = get_smoke_config("opt-125m").reduced(dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    zc = ZOConfig(method="tezo_adam", rank=8, lr=1e-2)
    state = init_zo_state(model.init(PRNGKey(0)), zc)
    step = build_zo_train_step(model.loss_fn, zc)
    batch = {k: _t(v) for k, v in batch_at_step(DataConfig(**DATA), 0).items()}
    state, _ = step(state, batch)
    ck = Checkpointer(tmp_path / "port", keep=2)
    for s in (1, 2, 3):
        ck.save(s, state, extra={"step": s})
    assert ck.latest_step() == 3 and len(list((tmp_path / "port").iterdir())) == 2
    template = init_zo_state(model.init(PRNGKey(1)), zc)
    restored, extra = ck.restore(template)
    assert extra == {"step": 3} and restored.step == 1
    a, b = dict(flatten_with_path(state)), dict(flatten_with_path(restored))
    assert a.keys() == b.keys() and ".mstate['tau_m'][\"['blocks']['wq']\"]" in a
    for path, x in a.items():
        if isinstance(x, torch.Tensor):
            assert x.dtype == b[path].dtype and torch.equal(x, b[path]), path
        else:
            assert np.array_equal(x, b[path]), path

    rmodel = ref_build_model(ref_smoke_config("opt-125m"))
    rzc = RefZOConfig(method="tezo_adam", kernel_mode="xla", rank=8, seed=4)
    rstate = ref_init_state(rmodel.init(jax.random.PRNGKey(4)), rzc)
    RefCheckpointer(tmp_path / "ref").save(5, rstate, extra={"step": 5})
    fmodel = build_model(get_smoke_config("opt-125m"), device="cpu")
    template = init_zo_state(fmodel.init(PRNGKey(0)), ZOConfig(method="tezo_adam", rank=8))
    got, extra = Checkpointer(tmp_path / "ref").restore(template)
    assert extra == {"step": 5}
    want = _ref_flat(rstate)
    flat = _flat_state(got)
    assert set(flat) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(flat[path], w, err_msg=path)


def test_resume_from_checkpoint_is_bitwise(tmp_path):
    """Two steps, a checkpoint, a restart to four steps == four straight."""
    kw = dict(smoke=True, device="cpu", verbose=False, log_every=1, lr=1e-3)
    straight = port_train.train(steps=4, **kw)
    port_train.train(steps=2, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    resumed = port_train.train(steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert resumed["final_eval_loss"] == straight["final_eval_loss"]
    assert [h["loss"] for h in resumed["history"]] == [h["loss"] for h in straight["history"][2:]]


@pytest.mark.parametrize("sched", [dict(), dict(lr_schedule="cosine", total_steps=50),
                                   dict(lr_schedule="linear_warmup_cosine", warmup_steps=7,
                                        total_steps=40)])
def test_lr_schedule_matches_reference(sched):
    """The host-side f32 schedule against the reference's jnp one: the same
    f32 arithmetic, but numpy's cos against XLA's, an ulp apart at most,
    which 1 + cos magnifies to ~3e-7 relative near the schedule's end."""
    ours, want = ZOConfig(lr=3e-4, **sched), RefZOConfig(lr=3e-4, **sched)
    for step in (0, 3, 7, 20, 39, 60):
        np.testing.assert_allclose(np.float32(ours.schedule(step)),
                                   np.asarray(want.schedule(jnp.int32(step))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kw", [
    dict(mesh="host:2,1"), dict(probe_parallel=True), dict(ensemble=2),
    dict(straggler_prob=0.1), dict(rank_mode="spectral"), dict(pretrain_steps=5),
])
def test_unported_options_raise(kw):
    with pytest.raises((NotImplementedError, KeyError), match="ROADMAP.md Queue A"):
        port_train.train(smoke=True, steps=1, device="cpu", verbose=False, **kw)
