"""The port's low-rank baselines (LOZO, LOZO-m, SubZO) and adaptive-q on the
CPU, against the reference.

* ``subzo_perturb``'s plain version against the reference's oracles
  (``repro/kernels/ref.py``) and its Pallas kernel under the interpreter,
  and the port's ``lozo_chain_k`` against ``ops.lozo_chain_k`` and the LOZO
  oracle: f32 within 1e-6, bf16 within 1 bf16 ulp;
* LOZO's U and V and SubZO's Σ bit for bit the reference's ``jax.random``
  draws, the vectorized step draws bit for bit the single ones, and
  SubZO's orthonormal U, V within 1e-6 of the reference's (``torch`` and
  ``jnp`` QR of the same Gaussians), with the same column signs;
* chained == unchained, bitwise, inside the port, across a window boundary;
* the ZO step against the reference's ``kernel_mode="xla"`` step from the
  same seed: per-step losses within 1e-5 relative, params within 1e-5, U
  and V within 1e-6, LOZO-m's κ-scaled momentum within 1e-3 of its largest
  entry (as the TeZO step tests hold the τ moments);
* the training CLI, checkpoints in the reference's layout both ways, and
  adaptive-q against the reference's controller and its ``--adaptive-q``
  run.

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
from repro.core import estimator as ref_est
from repro.core import init_zo_state as ref_init_state
from repro.core.adaptive import AdaptiveQ as RefAdaptiveQ
from repro.data import DataConfig as RefDataConfig
from repro.data import batch_at_step as ref_batch_at_step
from repro.kernels import ops, ref
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core import estimator as est
from repro_torch.core.adaptive import AdaptiveQ
from repro_torch.core.estimator import ZOConfig, get_method
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.kernels import subzo_perturb as tsub
from repro_torch.kernels import tezo_perturb as tpert
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.utils import jax_random
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path

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
# the kernels' plain versions
# --------------------------------------------------------------------------

# W shape, r: a ragged matrix (no tile multiple), a stacked leaf, a wide one
KERNEL_CASES = [((50, 40), 8), ((3, 24, 20), 4), ((16, 136), 12)]
SCALES, DECAY = [1e-3, -2e-3], 0.98


def _orthonormal(rng, shape):
    return np.linalg.qr(rng.standard_normal(shape))[0].astype(np.float32)


def _operands(shape, r, dtype, seed):
    rng = np.random.default_rng(seed)
    *batch, m, n = shape
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    u = _orthonormal(rng, (*batch, m, r))
    v = _orthonormal(rng, (*batch, n, r))
    sig = rng.standard_normal((*batch, 2, r, r)).astype(np.float32)
    vs = rng.standard_normal((2, *batch, n, r)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jnp.asarray(w).astype(jdt), _t(w).to(getattr(torch, dtype)), u, v, sig, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,r", KERNEL_CASES)
def test_subzo_perturb_plain_matches_reference(shape, r, dtype, force_interpret):
    """k = 1 and a k = 2 chain with a decay on the last delta, against the
    oracles and the Pallas kernel."""
    w_j, w_t, u, v, sig, _ = _operands(shape, r, dtype, seed=sum(shape) + r)
    uj, vj, sj = jnp.asarray(u), jnp.asarray(v), jnp.asarray(sig)
    lead = len(shape) - 2

    def oracle(k, decay):
        if lead == 0:
            if k == 1:
                return ref.subzo_perturb_ref(w_j, uj, vj, sj[0], SCALES[0], decay)
            return ref.subzo_chain_ref(w_j, uj, vj, sj, SCALES, decay)
        return jnp.stack([ref.subzo_chain_ref(w_j[i], uj[i], vj[i], sj[i, :k], SCALES[:k], decay)
                          for i in range(shape[0])])

    for k, decay in ((1, 1.0), (2, DECAY)):
        got = tsub.subzo_perturb(w_t.clone(), _t(u), _t(v), _t(sig[..., :k, :, :]), SCALES[:k],
                                 decay=None if decay == 1.0 else decay)
        assert got.dtype == w_t.dtype and tuple(got.shape) == shape
        _check(got, oracle(k, decay), dtype, f"oracle k={k}")
        pallas = ops.subzo_perturb(w_j, uj, vj, sj[..., :k, :, :], jnp.asarray(SCALES[:k]),
                                   decay=decay)
        _check(got, pallas, dtype, f"pallas k={k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,r", KERNEL_CASES)
def test_lozo_chain_plain_matches_reference(shape, r, dtype, force_interpret):
    """The port's LOZO chain (k = 1, and k = 2 with a decay) against the
    reference's ``ops.lozo_chain_k`` (the TeZO Pallas kernel over widened
    factors) and the LOZO oracle applied delta by delta."""
    w_j, w_t, _, _, _, vs = _operands(shape, r, dtype, seed=3 * sum(shape) + r)
    *batch, m, n = shape
    u = np.random.default_rng(r).standard_normal((*batch, m, r)).astype(np.float32)
    uj = jnp.asarray(u)
    for k, decay in ((1, None), (2, DECAY)):
        got = tpert.lozo_chain_k(w_t.clone(), _t(u), [_t(x) for x in vs[:k]], SCALES[:k],
                                 decay=decay)
        pallas = ops.lozo_chain_k(w_j, uj, [jnp.asarray(x) for x in vs[:k]],
                                  SCALES[:k], decay=decay)
        want = w_j
        for s in range(k):
            d = decay if (s == k - 1 and decay is not None) else 1.0
            if batch:
                want = jnp.stack([ref.lozo_perturb_ref(want[i], uj[i], jnp.asarray(vs[s][i]),
                                                       SCALES[s], d) for i in range(batch[0])])
            else:
                want = ref.lozo_perturb_ref(want, uj, jnp.asarray(vs[s]), SCALES[s], d)
        _check(got, want, dtype, f"oracle k={k}")
        _check(got, pallas, dtype, f"pallas k={k}")


# --------------------------------------------------------------------------
# draws
# --------------------------------------------------------------------------

LEAVES = {"['blocks']['wq']": (2, 64, 48), "['embed']": (256, 64), "['blocks']['ln1']": (2, 64)}


@pytest.mark.parametrize("path", sorted(LEAVES))
def test_factor_draws_are_the_reference_draws(path):
    """``_lozo_u`` (two windows), ``_lozo_v`` (two probes) and SubZO's
    ``_sigma``, bit for bit."""
    shape = LEAVES[path]
    leaf_j, leaf_t = jnp.zeros(shape), torch.zeros(shape)
    key_t = jax.random.fold_in(jax.random.PRNGKey(3), 17)
    base = jax.random.fold_in(jax.random.PRNGKey(4), 7)
    r = min(8, shape[-2], shape[-1])
    for step in (3, 5):
        want = ref_est._lozo_u(leaf_j, key_t, base, path, step, 4, r)
        got = est._lozo_u(leaf_t, np.asarray(base), path, step, 4, r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for probe in (0, 1):
        np.testing.assert_array_equal(
            est._lozo_v(leaf_t, np.asarray(key_t), path, probe, r).numpy(),
            np.asarray(ref_est._lozo_v(leaf_j, key_t, path, probe, r)))
        np.testing.assert_array_equal(
            est._sigma(np.asarray(key_t), path, probe, r, shape[:-2]).numpy(),
            np.asarray(ref_est.SubZO()._sigma(path, key_t, probe, r, shape[:-2])))


def _smoke_state(method, rank=8, **kw):
    model = build_model(get_smoke_config("opt-125m"), device="cpu")
    zc = ZOConfig(method=method, rank=rank, **kw)
    return model, zc, init_zo_state(model.init(PRNGKey(0)), zc)


def test_step_draws_are_the_single_draws():
    """The step's vectorized draws (LOZO's U per window and V per probe,
    SubZO's Σ per probe, all on the device path) equal the one-leaf draws
    bit for bit; a window's U is drawn once."""
    _, zc, state = _smoke_state("lozo", q_probes=2, lazy_interval=3)
    method, key_t = get_method("lozo"), PRNGKey(9)
    params, base = dict(flatten_with_path(state.params)), state.mstate["base_key"]
    cache = {}  # the step function's, kept across its steps
    noise = method.draws(state.params, state.mstate, key_t, zc, step=4, cache=cache)
    assert noise.u and sorted(noise.u) == [p for p, w in params.items() if w.dim() == 3
                                           or p in ("['embed']", "['lm_head']")]
    for path, u in noise.u.items():
        r = u.shape[-1]
        assert torch.equal(u, est._lozo_u(params[path], base, path, 4, 3, r))
        for p in (0, 1):
            assert torch.equal(noise.v(path, p), est._lozo_v(params[path], key_t, path, p, r))
    same = method.draws(state.params, state.mstate, key_t, zc, step=5, cache=cache)
    assert all(same.u[p] is noise.u[p] for p in noise.u)  # the window's cache
    nxt = method.draws(state.params, state.mstate, key_t, zc, step=6, cache=cache)
    assert not torch.equal(nxt.u["['embed']"], noise.u["['embed']"])

    _, zc, state = _smoke_state("subzo", q_probes=2)
    noise = get_method("subzo").draws(state.params, state.mstate, key_t, zc, step=1)
    for path, u in state.mstate["U"].items():
        for p in (0, 1):
            assert torch.equal(noise.coef(path, p),
                               est._sigma(key_t, path, p, u.shape[-1], u.shape[:-2]))


def test_normal_draws_equal_normal_per_key():
    """The layout-keeping vectorized draw (what LOZO's step runs on the
    device) is the concatenation of single draws, empty segments included,
    on a second call with the same sizes and other keys too."""
    sizes = [5, 0, 1, 300, 17, 4096]
    draws = jax_random.NormalDraws("cpu")
    for seed in (1, 2):
        keys = [jax_random.fold_in(PRNGKey(seed), i) for i in range(len(sizes))]
        want = torch.cat([jax_random.normal(k, (n,)) for k, n in zip(keys, sizes)])
        assert torch.equal(draws(keys, sizes), want)
        assert torch.equal(jax_random.normal_many(keys, sizes), want)
    assert len(draws._layouts) == 1


def test_subzo_init_matches_reference():
    """SubZO's window-0 factors: QR of the same Gaussians in torch and in
    jnp agree within 1e-6, with the same column signs, and are orthonormal."""
    model, zc, state = _smoke_state("subzo")
    rmodel = ref_build_model(ref_smoke_config("opt-125m"))
    rstate = ref_init_state(rmodel.init(jax.random.PRNGKey(0)),
                            RefZOConfig(method="subzo", kernel_mode="xla", rank=8))
    assert sorted(state.mstate["U"]) == sorted(rstate.mstate["U"])
    np.testing.assert_array_equal(state.mstate["base_key"], np.asarray(rstate.mstate["base_key"]))
    for name in ("U", "V"):
        for path, q in state.mstate[name].items():
            want = np.asarray(rstate.mstate[name][path])
            np.testing.assert_allclose(q.numpy(), want, rtol=0, atol=1e-6, err_msg=path)
            assert np.all(np.sum(q.numpy() * want, axis=-2) > 0.99), path  # same signs
            eye = torch.matmul(q.transpose(-1, -2), q)
            assert torch.allclose(eye, torch.eye(q.shape[-1]).expand_as(eye), atol=1e-5)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

DATA = dict(seq_len=32, global_batch=4, vocab_size=256, seed=0)
LOWRANK = ["lozo", "lozo_m", "subzo"]


def _port_run(method, q, restore_mode, steps, dtype="float32", lr=1e-3, lazy_interval=2):
    cfg = get_smoke_config("opt-125m").reduced(dtype=dtype)
    model = build_model(cfg, device="cpu")
    zc = ZOConfig(method=method, q_probes=q, restore_mode=restore_mode, rank=8, lr=lr,
                  lazy_interval=lazy_interval)
    state = init_zo_state(model.init(PRNGKey(0)), zc)
    step = build_zo_train_step(model.loss_fn, zc)
    losses = []
    for s in range(steps):
        batch = {k: _t(v) for k, v in batch_at_step(DataConfig(**DATA), s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


@pytest.mark.parametrize("method", LOWRANK)
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_equals_unchained_bitwise(method, q, dtype):
    """3 steps at ν = 2: the step at 2 opens a new window."""
    chained, l_c = _port_run(method, q, "inplace", 3, dtype, lr=1e-2)
    unchained, l_u = _port_run(method, q, "unchained", 3, dtype, lr=1e-2)
    assert l_c == l_u and all(np.isfinite(l_c))
    a, b = flatten_with_path(chained), dict(flatten_with_path(unchained))
    for path, x in a:
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, b[path]), path
        else:
            assert np.array_equal(x, b[path]), path
    init = build_model(get_smoke_config("opt-125m").reduced(dtype=dtype),
                       device="cpu").init(PRNGKey(0))
    assert not torch.equal(chained.params["blocks"]["wq"], init["blocks"]["wq"])


def _ref_run(method, q, steps, lr, lazy_interval=2):
    model = ref_build_model(ref_smoke_config("opt-125m"))
    zc = RefZOConfig(method=method, kernel_mode="xla", q_probes=q, rank=8, lr=lr,
                     lazy_interval=lazy_interval)
    state = ref_init_state(model.init(jax.random.PRNGKey(0)), zc)
    step = jax.jit(ref_build_step(model.loss_fn, zc))
    losses = []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in ref_batch_at_step(RefDataConfig(**DATA), s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


def _flat_state(state) -> dict:
    return {p: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in flatten_with_path(state)}


def _ref_flat(state) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) if v.dtype != np.uint32
            else np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(state)}


@pytest.mark.parametrize("method,q", [("lozo", 1), ("lozo_m", 2), ("subzo", 2)])
def test_step_matches_reference_xla(method, q):
    """4 steps at ν = 2 (a refresh at step 2) against the reference."""
    port, l_p = _port_run(method, q, "inplace", 4, lr=1e-4)
    jref, l_r = _ref_run(method, q, 4, lr=1e-4)
    np.testing.assert_allclose(l_p, l_r, rtol=1e-5, atol=0)
    got, want = _flat_state(port), _ref_flat(jref)
    assert set(got) == set(want)
    for path, w in want.items():
        if path.startswith(".mstate['v_m']"):
            # κ-scaled: κ = Δloss / 2ρ carries the frameworks' ~1e-7 relative
            # loss difference times 1/2ρ
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-3 * float(np.abs(w).max()),
                                       err_msg=path)
        elif path.startswith((".mstate['U']", ".mstate['V']")):
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-6, err_msg=path)
        elif w.dtype == np.uint32 or path == ".step":
            np.testing.assert_array_equal(got[path], w, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)
    assert int(got[".step"]) == 4
    init = build_model(get_smoke_config("opt-125m"), device="cpu").init(PRNGKey(0))
    assert np.abs(got[".params['blocks']['wq']"] - init["blocks"]["wq"].numpy()).max() > 1e-6


# the reference's ``python -m repro.launch.train --smoke --steps 10 --method M
# --kernel-mode xla`` at seed 0
REF_SMOKE_LOSS = {"lozo": 6.035594463348389, "lozo_m": 6.035606861114502,
                  "subzo": 6.03562068939209}


@pytest.mark.parametrize("method", LOWRANK)
def test_smoke_cli_matches_reference(capsys, method):
    port_train.main(["--smoke", "--device", "cpu", "--steps", "10", "--method", method])
    out = capsys.readouterr().out
    result = json.loads(out[out.index("\n{") + 1:])
    want = REF_SMOKE_LOSS[method]
    assert result["method"] == method and result["zo_passes"] == 3
    assert abs(result["final_eval_loss"] - want) <= 1e-6 * abs(want)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["lozo_m", "subzo"])
def test_checkpoints_cross_both_ways(tmp_path, method):
    """A port checkpoint restores into the reference's state (every leaf
    equal, the reference's paths: ``base_key`` uint32[2], path-keyed U, V,
    v_m) and a reference checkpoint into the port's."""
    model, zc, state = _smoke_state(method, lr=1e-2, lazy_interval=2)
    step = build_zo_train_step(model.loss_fn, zc)
    batch = {k: _t(v) for k, v in batch_at_step(DataConfig(**DATA), 0).items()}
    state, _ = step(state, batch)
    Checkpointer(tmp_path / "port").save(1, state, extra={"step": 1})
    rmodel = ref_build_model(ref_smoke_config("opt-125m"))
    rzc = RefZOConfig(method=method, kernel_mode="xla", rank=8, seed=4)
    rstate = ref_init_state(rmodel.init(jax.random.PRNGKey(4)), rzc)
    got, extra = RefCheckpointer(tmp_path / "port").restore(rstate)
    assert extra == {"step": 1}
    want = _flat_state(state)
    flat = _ref_flat(got)
    assert set(flat) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(flat[path], w, err_msg=path)
    assert flat[".mstate['base_key']"].dtype == np.uint32

    RefCheckpointer(tmp_path / "ref").save(5, rstate, extra={"step": 5})
    restored, extra = Checkpointer(tmp_path / "ref").restore(_smoke_state(method)[2])
    assert extra == {"step": 5}
    flat, want = _flat_state(restored), _ref_flat(rstate)
    assert set(flat) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(flat[path], w, err_msg=path)


@pytest.mark.parametrize("method", ["lozo_m", "subzo"])
def test_resume_from_checkpoint_is_bitwise(tmp_path, method):
    """Three steps, a checkpoint, a restore into a fresh state and a fresh
    step function (LOZO's window cache starts empty), three more == six
    straight, with a window boundary before and after the restart (ν = 2)."""
    def fresh():
        return _smoke_state(method, lr=1e-3, lazy_interval=2)

    def run(state, start, stop):
        model, zc, _ = fresh()
        step, losses = build_zo_train_step(model.loss_fn, zc), []
        for s in range(start, stop):
            batch = {k: _t(v) for k, v in batch_at_step(DataConfig(**DATA), s).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        return state, losses

    straight, l_straight = run(fresh()[2], 0, 6)
    half, l_half = run(fresh()[2], 0, 3)
    Checkpointer(tmp_path).save(3, half, extra={"step": 3})
    restored, extra = Checkpointer(tmp_path).restore(fresh()[2])
    assert extra == {"step": 3} and int(restored.step) == 3
    resumed, l_resumed = run(restored, 3, 6)
    assert l_half + l_resumed == l_straight
    want = dict(flatten_with_path(straight))
    for path, x in flatten_with_path(resumed):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, want[path]), path
        else:
            assert np.array_equal(x, want[path]), path


# --------------------------------------------------------------------------
# adaptive-q
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_q_decides_as_the_reference(seed):
    """The same seeded (kappa_var, kappa_abs) observations give the same q
    decisions and EMA."""
    rng = np.random.default_rng(seed)
    ours, theirs = AdaptiveQ(q=2, q_max=16), RefAdaptiveQ(q=2, q_max=16)
    decisions = []
    for _ in range(60):
        kv, ka = float(rng.exponential(1.2)), float(rng.exponential(1.0))
        decisions.append(ours.observe(kv, ka))
        assert decisions[-1] == theirs.observe(kv, ka)
        assert ours.ema == theirs.ema and ours.hot == theirs.hot and ours.q == theirs.q
    assert any(d is not None for d in decisions)


def test_adaptive_q_run_matches_reference():
    """LOZO from q = 3, one log per step: the κ dispersion grows q to its
    cap of 4 at step 2 in both packages; the q history, the per-step losses
    and the final evaluation agree."""
    kw = dict(smoke=True, method="lozo", steps=3, q_probes=3, q_max=4, adaptive_q=True,
              log_every=1, eval_every=1000, verbose=False, seq_len=32, global_batch=4)
    want = ref_train.train(kernel_mode="xla", **kw)
    got = port_train.train(device="cpu", **kw)
    q_hist = [(h["step"], h["q_probes"]) for h in got["history"] if "q_probes" in h]
    assert q_hist == [(h["step"], h["q_probes"]) for h in want["history"] if "q_probes" in h]
    assert q_hist == [(2, 4)] and got["q_probes"] == want["q_probes"] == 4
    assert got["zo_passes"] == want["zo_passes"] == 9
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]], rtol=1e-5, atol=0)
    assert abs(got["final_eval_loss"] - want["final_eval_loss"]) <= 1e-5 * abs(
        want["final_eval_loss"])
