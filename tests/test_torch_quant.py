"""The port's quantized weight leaves on the CPU (``opt-125m-smoke``),
against the reference.

* ``core.quant``: pack/unpack bitwise; ``quantize_leaf`` bitwise for nf4,
  lut3 and lut4 (codes, codebook, scale, qu, qv) on a leaf wide enough for
  the quantile fit's near-ties to matter; the config rejections with the
  reference's messages; the byte accounting.
* The forward: the ``quant_matmul`` plain version against the port's twin
  (``dispatch._quant_matmul_ref``) and against the reference's Pallas
  kernel under the interpreter, within 1e-5 relative in f32, with a
  nonzero ``acc`` (so a kernel that drops ``xu @ qvᵀ`` fails), ragged M
  and N, and lut3's 640-row padding; ``layers.weight_matmul`` routing.
* The step: a quantized TeZO-Adam step against the reference's
  ``kernel_mode="xla"`` step and a quantized MeZO-Adam step against its
  ``kernel_mode="pallas"`` step (the counter stream on ``nacc``) from the
  same parameters: losses within 1e-7 relative; the frozen fields (codes,
  codebook, scale, qu, qv) bitwise; dense params and ``nacc`` within 1e-5;
  ``acc`` and the moments within 1e-3 of their largest entry (κ = Δloss /
  2ρ carries the frameworks' ~1e-7 relative loss difference times 500, as
  in tests/test_torch_train.py), the MeZO moments plus what the steps'
  measured κ differences can move them (tests/test_torch_mezo.py's
  ``_kappa_slack``).
* Inside the port: chained == unchained bitwise for every quantized
  method; zero weight-sized kernel passes on QuantLeafs for the TeZO
  family (a pass spy, as the reference's test_quant.py has), 2q + 1 for
  the MeZO family (on ``nacc``).
* The smoke CLI against the reference's runs, and checkpoints both ways."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import ZOConfig as RefZOConfig
from repro.core import build_zo_train_step as ref_build_step
from repro.core import dispatch as rdispatch
from repro.core import init_zo_state as ref_init_state
from repro.core import quant as rquant
from repro.data import DataConfig as RefDataConfig
from repro.data import batch_at_step as ref_batch_at_step
from repro.kernels import ops
from repro.models import build_model as ref_build_model
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core import dispatch, quant
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state, zo_pass_count
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.kernels import quant_matmul as tqmm
from repro_torch.launch import train as port_train
from repro_torch.models import build_model, layers
from repro_torch.models.bridge import params_from_numpy, quant_leaf_from_numpy
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path

from _torch_ref import numpy_params, to_jax

DATA = dict(seq_len=32, global_batch=4, vocab_size=256, seed=0)
# the reference CLI's final_eval_loss at seed 0, printed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.train --smoke \
#       --steps 10 --weight-quant lut4 --kernel-mode xla
CLI_LUT4_XLA = 6.032031536102295
# and by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.train --smoke \
#       --steps 10 --method mezo_adam --weight-quant nf4 --kernel-mode pallas
CLI_MEZO_NF4_PALLAS = 6.050392150878906
PATH = "['blocks']['wq']"
Z_MAX = float(np.sqrt(-2.0 * np.log(2.0**-25)))  # the largest |z| the streams draw


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _key():
    return (0x1234, 0x5678)


# --------------------------------------------------------------------------
# core.quant
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("shape", [(1, 5), (2, 37, 9), (130, 3)])
def test_pack_unpack_bitwise(bits, shape):
    rng = np.random.default_rng(sum(shape) + bits)
    codes = rng.integers(0, 1 << bits, size=shape).astype(np.int32)
    got = quant.pack_codes(_t(codes), bits)
    want = np.asarray(rquant.pack_codes(jnp.asarray(codes), bits))
    assert got.dtype == torch.uint32 and got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    back = quant.unpack_codes(got, bits, shape[-2])
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(rquant.unpack_codes(jnp.asarray(want), bits,
                                                                 shape[-2])))


@pytest.mark.parametrize("scheme", ["nf4", "lut3", "lut4"])
def test_quantize_leaf_bitwise(scheme):
    """[2, 768, 384]: K = 768 rows per channel quantile, the fit where
    ``torch.quantile`` would put one codebook entry in eight an ulp off."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((2, 768, 384)) * 0.05).astype(np.float32)
    want = rquant.quantize_leaf(jnp.asarray(w), scheme=scheme, rank=8,
                                key=jnp.asarray(_key(), jnp.uint32), path=PATH,
                                with_nacc=True)
    got = quant.quantize_leaf(_t(w), scheme=scheme, rank=8, key=_key(), path=PATH,
                              with_nacc=True)
    for f in quant.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.bits, got.k_dim, got.dtype_name, got.qmethod) == (
        want.bits, want.k_dim, want.dtype_name, want.qmethod)
    assert got.shape == want.shape and got.rank == 8
    assert quant.stored_weight_bytes(got) == rquant.stored_weight_bytes(want)
    assert quant.dense_weight_bytes(got) == rquant.dense_weight_bytes(want)
    np.testing.assert_array_equal(quant.dequantize(got).numpy(),
                                  np.asarray(rquant.dequantize(want)))


def _rejected(validate, cfg) -> str:
    with pytest.raises(ValueError) as e:
        validate(cfg)
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(method="tezo", weight_quant="int8"),
    dict(method="lozo", weight_quant="lut4"),
    dict(method="subzo", weight_quant="nf4"),
    dict(method="tezo", weight_quant="lut4", weight_decay=0.01),
])
def test_validate_quant_config_rejections(kw):
    """Every rejection the port's ZOConfig can express raises the
    reference's message, from validate, init and the step builder (and
    the trainer, which has no weight-decay option)."""
    msg = _rejected(quant.validate_quant_config, ZOConfig(**kw))
    assert msg == _rejected(rquant.validate_quant_config, RefZOConfig(**kw))
    model = build_model(get_smoke_config("opt-125m"), device="cpu")
    with pytest.raises(ValueError, match="weight_quant"):
        init_zo_state(model.init(PRNGKey(0)), ZOConfig(**kw))
    with pytest.raises(ValueError, match="weight_quant"):
        build_zo_train_step(model.loss_fn, ZOConfig(**kw))
    if "weight_decay" not in kw:
        with pytest.raises(ValueError, match="weight_quant"):
            port_train.train(smoke=True, steps=1, device="cpu", verbose=False, **kw)


@pytest.mark.parametrize("extra", [dict(rank_mode="spectral"), dict(factor_dtype="bfloat16")])
def test_validate_quant_config_fields_the_port_lacks(extra):
    """The reference's rank_mode and factor_dtype rejections, on a config
    that carries those fields, with the same messages."""
    cfg = types.SimpleNamespace(method="tezo", weight_quant="lut4", weight_decay=0.0,
                                rank_mode="const", factor_dtype="float32")
    cfg.__dict__.update(extra)
    assert _rejected(quant.validate_quant_config, cfg) == _rejected(
        rquant.validate_quant_config, cfg)


def test_per_path_ranks_rejected():
    model = build_model(get_smoke_config("opt-125m"), device="cpu")
    with pytest.raises(ValueError, match="per-path ranks"):
        init_zo_state(model.init(PRNGKey(0)), ZOConfig(weight_quant="lut4"), ranks={PATH: 2})


# --------------------------------------------------------------------------
# the forward
# --------------------------------------------------------------------------


def _leaf(scheme, k, n, seed, with_nacc=False):
    """A quantized [k, n] leaf with a nonzero acc (and nacc): the port's and
    the reference's, from the same numpy values."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    ref = rquant.quantize_leaf(jnp.asarray(w), scheme=scheme, rank=4,
                               key=jnp.asarray(_key(), jnp.uint32), path="['w']",
                               with_nacc=with_nacc)
    acc = (rng.standard_normal(4) * 0.05).astype(np.float32)  # xu @ qvᵀ ~ the base product
    ref = ref.replace(acc=jnp.asarray(acc))
    if with_nacc:
        ref = ref.replace(nacc=jnp.asarray((rng.standard_normal((k, n)) * 0.01)
                                           .astype(np.float32)))
    return quant_leaf_from_numpy(jax.device_get(ref)), ref


@pytest.mark.parametrize("scheme", ["nf4", "lut3", "lut4"])
def test_quant_matmul_plain_vs_reference(scheme):
    """M = 19 and N = 80 are ragged for any tile, K = 96 pads to 128
    (lut4, nf4) or 640 (lut3).  The plain version against the port's twin,
    the reference's twin and the reference's Pallas kernel (interpret), all
    within 1e-5 relative; the xu @ qvᵀ term alone moves the output by far
    more than that."""
    leaf, ref = _leaf(scheme, 96, 80, seed=len(scheme), with_nacc=True)
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((19, 96))).astype(np.float32)
    got = dispatch.quant_matmul_fwd(_t(x), leaf).numpy()
    twin = dispatch._quant_matmul_ref(_t(x), leaf).numpy()
    ops.set_interpret(True)
    try:
        kern = np.asarray(rdispatch.quant_matmul_fwd(jnp.asarray(x), ref, mode="pallas"))
    finally:
        ops.set_interpret(None)
    want = np.asarray(rdispatch.quant_matmul_fwd(jnp.asarray(x), ref, mode="xla"))
    scale = np.abs(want).max()
    for other in (twin, kern, want):
        np.testing.assert_allclose(got, other, rtol=0, atol=1e-5 * scale)
    dropped = got - (x @ leaf.qu.numpy() * leaf.acc.numpy()) @ leaf.qv.numpy().T
    assert np.abs(dropped - got).max() > 100 * 1e-5 * scale


def test_quant_matmul_kernel_operands_and_routing():
    """The wrapper's plain version on the kernel's own operands, against the
    effective weight; weight_matmul routes QuantLeafs and dense weights;
    the CPU never counts a launch; the wrapper refuses other devices."""
    leaf, _ = _leaf("lut4", 64, 24, seed=3)
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(0))
    n0 = tqmm.quant_matmul.launches
    xu = x @ (leaf.qu * leaf.acc)
    out = tqmm.quant_matmul(x, leaf.codes, quant.scaled_lut(leaf), xu, leaf.qv, bits=4)
    torch.testing.assert_close(out, x @ quant.effective_weight(leaf), rtol=0, atol=1e-5)
    assert torch.equal(layers.weight_matmul(x, leaf), dispatch.quant_matmul_fwd(x, leaf))
    w = torch.randn(64, 24)
    assert torch.equal(layers.weight_matmul(x, w), x @ w)
    assert tqmm.quant_matmul.launches == n0
    meta = torch.empty((5, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tqmm.quant_matmul(meta, leaf.codes, leaf.codebook, xu, leaf.qv, bits=4)


def _within_2_bf16_ulps(got: torch.Tensor, ref_f32: torch.Tensor) -> bool:
    """The card's bf16 bar: within 2 bf16 ulps (+1e-5) of the f32 plain
    version (tests/test_torch_cuda.py, chip_smoke.py)."""
    _, e = torch.frexp(ref_f32.abs())
    ulp = torch.ldexp(torch.ones_like(ref_f32), e - 8)
    return bool(torch.all((got.float() - ref_f32).abs() <= 2 * ulp + 1e-5))


@pytest.mark.parametrize("scheme", ["nf4", "lut3", "lut4"])
def test_lut_parts_sum_to_the_lut_bitwise(scheme):
    """The bf16 kernel's split of a scaled LUT into hi, mid and lo (each
    rounded to nearest even) sums to the f32 entry exactly, so its three
    products with bf16 x carry no weight error; hi + mid alone does not."""
    w = torch.randn(96, 80, generator=torch.Generator().manual_seed(len(scheme))) * 0.05
    leaf = quant.quantize_leaf(w, scheme=scheme, rank=4, key=(len(scheme), 1), path="['w']")
    lut = quant.scaled_lut(leaf)
    hi, mid, lo = tqmm.lut_parts(lut)
    assert {hi.dtype, mid.dtype, lo.dtype} == {torch.bfloat16}
    assert torch.equal((hi.float() + mid.float()) + lo.float(), lut)
    assert not torch.equal(hi.float() + mid.float(), lut)


def test_one_part_lut_fails_the_bf16_bar():
    """At K = 3072 (the FFN down-projection's depth) a kernel that
    multiplied bf16(W) alone misses the card's bf16 bar against the f32
    plain version, so the bar catches a one-part kernel; the three parts
    reproduce the plain version bitwise."""
    g = torch.Generator().manual_seed(7)
    K, N, M = 3072, 64, 64
    leaf = quant.quantize_leaf(torch.randn(K, N, generator=g) * 0.05, scheme="lut4", rank=4,
                               key=(7, 1), path="['w']")
    lut = quant.scaled_lut(leaf)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16).float()
    xu = torch.zeros(M, 4)
    want = tqmm.quant_matmul_plain(x, leaf.codes, lut, xu, leaf.qv, bits=4)
    hi, mid, lo = tqmm.lut_parts(lut)
    one = tqmm.quant_matmul_plain(x, leaf.codes, hi.float(), xu, leaf.qv, bits=4)
    three = tqmm.quant_matmul_plain(x, leaf.codes, (hi.float() + mid.float()) + lo.float(), xu,
                                    leaf.qv, bits=4)
    assert not _within_2_bf16_ulps(one.to(torch.bfloat16), want)
    assert torch.equal(three, want)


# --------------------------------------------------------------------------
# the step against the reference
# --------------------------------------------------------------------------


def _port_run(method, wq, steps, restore_mode="inplace", q=1, lr=1e-4, dtype="float32",
              np_params=None, data=DATA):
    cfg = get_smoke_config("opt-125m").reduced(dtype=dtype)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(np_params) if np_params is not None else model.init(PRNGKey(0))
    if dtype != "float32":
        params = {k: ({n: w.to(model.dtype) for n, w in v.items()} if isinstance(v, dict)
                      else v.to(model.dtype)) for k, v in params.items()}
    zc = ZOConfig(method=method, q_probes=q, restore_mode=restore_mode, lr=lr, rank=8,
                  weight_quant=wq)
    state = init_zo_state(params, zc)
    step = build_zo_train_step(model.loss_fn, zc)
    losses, kappas = [], []
    for s in range(steps):
        batch = {k: _t(v) for k, v in batch_at_step(DataConfig(**data), s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        kappas.append(float(metrics["kappa_abs"]))
    return state, losses, kappas


def _ref_run(method, wq, mode, steps, np_params, lr=1e-4):
    model = ref_build_model(ref_smoke_config("opt-125m"))
    zc = RefZOConfig(method=method, kernel_mode=mode, lr=lr, rank=8, weight_quant=wq)
    state = ref_init_state(to_jax(np_params), zc)
    step = jax.jit(ref_build_step(model.loss_fn, zc))
    losses, kappas = [], []
    ops.set_interpret(True)
    try:
        for s in range(steps):
            batch = {k: jnp.asarray(v)
                     for k, v in ref_batch_at_step(RefDataConfig(**DATA), s).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            kappas.append(float(metrics["kappa_abs"]))
    finally:
        ops.set_interpret(None)
    return state, losses, kappas


def _kappa_slack(k_port, k_ref, beta1=0.9, beta2=0.99) -> dict:
    """What the steps' κ differences can move a dense moment element (M
    takes (1−β₁)·κ·z per step, V (1−β₂)·κ²·z², |z| <= Z_MAX)."""
    kp, kr = np.asarray(k_port), np.asarray(k_ref)
    dk = np.abs(kp - kr)
    assert kr.min() > 10 * dk.max(), (kr, dk)
    age = np.arange(len(kr))[::-1]
    return {"m": (1 - beta1) * np.sum(beta1**age * dk) * Z_MAX,
            "v": (1 - beta2) * np.sum(beta2**age * (2 * kr + dk) * dk) * Z_MAX**2}


def _flat(state) -> dict:
    return {p: (v.float().numpy() if isinstance(v, torch.Tensor) and v.dtype != torch.uint32
                else np.asarray(v)) for p, v in flatten_with_path(state)}


def _ref_flat(state) -> dict:
    return {jax.tree_util.keystr(p): (np.asarray(v) if v.dtype == np.uint32
                                      else np.asarray(v, np.float32))
            for p, v in jax.tree_util.tree_leaves_with_path(state)}


_FROZEN = (".codes", ".codebook", ".scale", ".qu", ".qv")


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(get_smoke_config("opt-125m"), seed=0)


@pytest.mark.parametrize("method,wq,mode", [("tezo_adam", "lut4", "xla"),
                                            ("mezo_adam", "nf4", "pallas")])
def test_quant_step_matches_reference(np_params, method, wq, mode):
    port, l_p, k_p = _port_run(method, wq, 2, np_params=np_params)
    ref, l_r, k_r = _ref_run(method, wq, mode, 2, np_params)
    np.testing.assert_allclose(l_p, l_r, rtol=1e-7, atol=0)
    slack = _kappa_slack(k_p, k_r)
    got, want = _flat(port), _ref_flat(ref)
    assert set(got) == set(want)
    assert isinstance(port.params["blocks"]["wq"], quant.QuantLeaf)
    for path, w in want.items():
        if path.endswith(_FROZEN):
            np.testing.assert_array_equal(got[path], w, err_msg=path)
        elif path.endswith(".acc") or path.startswith(".mstate"):
            atol = 1e-3 * float(np.abs(w).max())
            if path.startswith((".mstate['m']", ".mstate['v']")):
                atol += slack[path[len(".mstate['"):][0]]
            np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)
    moved = ".params['blocks']['wq'].acc" if method == "tezo_adam" else (
        ".params['blocks']['wq'].nacc")
    assert np.abs(got[moved]).max() > 0.0


@pytest.mark.parametrize("method", quant.QUANT_METHODS)
def test_quant_chained_equals_unchained_bitwise(method):
    """q = 2, 2 steps, lut3, bf16 weights (the TeZO-family τ-space adds and
    the MeZO-family noise passes on bf16 nacc).  The exact mode runs a step
    too (equivalent, not bitwise: it branches each probe off the original
    weights, so its adds associate otherwise)."""
    a, la, _ = _port_run(method, "lut3", 2, "inplace", q=2, lr=1e-2, dtype="bfloat16")
    b, lb, _ = _port_run(method, "lut3", 2, "unchained", q=2, lr=1e-2, dtype="bfloat16")
    _, lc, _ = _port_run(method, "lut3", 1, "exact", q=2, lr=1e-2, dtype="bfloat16")
    assert la == lb and all(np.isfinite(la + lc))
    fa, fb = flatten_with_path(a), dict(flatten_with_path(b))
    assert len(fa) == len(fb)
    for path, x in fa:
        assert (torch.equal(x, fb[path]) if isinstance(x, torch.Tensor)
                else np.array_equal(x, fb[path])), path
    wq = a.params["blocks"]["wq"]
    assert wq.nacc is None if method.startswith("tezo") else wq.nacc.dtype == torch.bfloat16
    moved = wq.acc if method.startswith("tezo") else wq.nacc
    assert moved.abs().max() > 0


@pytest.mark.parametrize("q", [1, 2])
def test_quant_tezo_makes_zero_weight_passes(q, monkeypatch):
    """With every trainable leaf quantized (a one-leaf model), the TeZO
    family makes no weight-sized pass; the MeZO family makes 2q + 1 noise
    passes over ``nacc``, as in the reference's test_quant.py."""
    calls = {"n": 0}

    def spy(real):
        def wrapped(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)
        return wrapped

    from repro_torch.kernels import zo_noise

    monkeypatch.setattr(dispatch, "tezo_perturb", spy(dispatch.tezo_perturb))
    monkeypatch.setattr(dispatch, "tezo_adam_update", spy(dispatch.tezo_adam_update))
    monkeypatch.setattr(zo_noise, "noise_perturb", spy(zo_noise.noise_perturb))
    monkeypatch.setattr(zo_noise, "noise_update", spy(zo_noise.noise_update))
    rng = np.random.default_rng(1)
    x = _t((rng.standard_normal((4, 32))).astype(np.float32))

    def loss_fn(p, batch):
        h = x
        for i in range(2):
            h = torch.tanh(layers.weight_matmul(h, p["blocks"]["wq"][i]))
        return torch.mean((h.sum(-1) - 1.0) ** 2)

    for method, want in (("tezo", 0), ("tezo_adam", 0), ("mezo", zo_pass_count(q))):
        calls["n"] = 0
        params = {"blocks": {"wq": _t((rng.standard_normal((2, 32, 32)) * 0.1)
                                      .astype(np.float32))}}
        zc = ZOConfig(method=method, rank=4, q_probes=q, lr=1e-2, weight_quant="lut4")
        state = init_zo_state(params, zc)
        state, _ = build_zo_train_step(loss_fn, zc)(state, None)
        assert calls["n"] == want, (method, q, calls["n"])


# --------------------------------------------------------------------------
# CLI and checkpoints
# --------------------------------------------------------------------------


def test_smoke_cli_matches_reference(capsys):
    """``--smoke --device cpu --steps 10 --weight-quant lut4`` and ``--method
    mezo_adam --weight-quant nf4`` against the reference's ``--kernel-mode
    xla`` and ``pallas`` runs (measured: bitwise, and 2 f32 ulps apart)."""
    port_train.main(["--smoke", "--device", "cpu", "--steps", "10", "--weight-quant", "lut4"])
    out = capsys.readouterr().out
    res = json.loads(out[out.index("\n{") + 1:])
    assert res["weight_quant"] == "lut4" and res["zo_passes"] == 3
    assert abs(res["final_eval_loss"] - CLI_LUT4_XLA) <= 1e-6 * CLI_LUT4_XLA
    res = port_train.train(smoke=True, device="cpu", steps=10, method="mezo_adam",
                           weight_quant="nf4", verbose=False)
    assert abs(res["final_eval_loss"] - CLI_MEZO_NF4_PALLAS) <= 1e-6 * CLI_MEZO_NF4_PALLAS


def test_checkpoint_round_trip_both_ways(tmp_path, np_params):
    """A quantized state saved by the port restores bitwise, under the keys
    JAX's flattening gives the reference QuantLeaf's fields (codes as
    uint32); a reference quantized state written under those keys by the
    reference's own writer restores into the port's state, every leaf
    equal.  Meta fields ride the template."""
    port, _, _ = _port_run("mezo_adam", "lut3", 1, np_params=np_params)
    ck = Checkpointer(tmp_path / "port")
    ck.save(1, port, extra={"step": 1})
    template, _, _ = _port_run("mezo_adam", "lut3", 0)
    restored, extra = ck.restore(template)
    assert extra == {"step": 1}
    a, b = dict(flatten_with_path(port)), dict(flatten_with_path(restored))
    assert a.keys() == b.keys() and ".params['blocks']['wq'].codes" in a
    for path, x in a.items():
        assert (torch.equal(x, b[path]) if isinstance(x, torch.Tensor)
                else np.array_equal(x, b[path])), path
    assert restored.params["blocks"]["wq"].qmethod == "lut3"

    ref_state, _, _ = _ref_run("mezo_adam", "lut3", "xla", 0, np_params)
    flat = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(ref_state)}
    saved = np.load(ck._step_dir(1) / "arrays.npz")
    port_keys = {k for k in saved.files if k.startswith(".params")}
    assert port_keys == {k for k in flat if k.startswith(".params")}
    assert saved[".params['blocks']['wq'].codes"].dtype == np.uint32
    RefCheckpointer(tmp_path / "ref")._write(3, flat, {"step": 3})
    tmpl, _, _ = _port_run("mezo_adam", "lut3", 0)
    got, extra = Checkpointer(tmp_path / "ref").restore(tmpl)
    assert extra == {"step": 3}
    gflat = _flat(got)
    assert set(gflat) == set(flat)
    for path, w in flat.items():
        np.testing.assert_array_equal(gflat[path], np.asarray(w, gflat[path].dtype),
                                      err_msg=path)
