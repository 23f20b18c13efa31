"""The port's xLSTM family (``repro_torch.models.xlstm``) on the CPU, at the
xlstm-350m-smoke config, against the reference's ``XLSTMLM``.

* the registry copies the reference's config, the ``ssm`` family routes to
  ``XLSTMLM``, and the seed's params are the reference's, bit for bit;
* ``loss_fn`` within 1e-5 relative of the reference's at
  ``kernel_mode="xla"`` (the sequential scan), with and without prefix
  ``embeds``;
* the chunkwise form (``mlstm_chunk`` 4, 8, 16) against the reference's
  chunkwise form and against the port's sequential form, at the
  reference's own bars (``tests/test_perf_features.py``: hidden states and
  carried states within 1e-3, losses within 1e-4);
* prefill plus decode against the teacher-forced forward within 2e-3
  (``tests/test_models.py``), and against the reference's decode logits;
* ``BatchedServer`` tokens equal to the reference's; ``ServeEngine`` and
  ``--weight-quant`` raising as the reference does;
* a TeZO-Adam step against the reference's xla step and a MeZO-Adam step
  against its pallas step (ROADMAP "Reference-side facts" 4) at 4 heads,
  where ``w_if [64, 8]`` is a low-rank leaf (at the smoke config's 2 heads
  it is ``[64, 4]`` and dense): losses within 1e-5 relative, params within
  1e-5, the κ-scaled moments within 1e-3 of each moment's largest entry;
* chained == unchained bitwise inside the port; all nine methods and
  adaptive-q through the trainer;
* Eq. 7's ranks and the factors drawn at them against the reference's on
  the per-layer tree;
* ``tree_size_bytes``, ``tree_num_params`` and
  ``num_sampled_elements_per_step`` against the reference's;
* the train and serve CLIs.

Inputs are made with numpy from seeds and cross to both sides as numpy
arrays; the reference's jitted functions are built once per module."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import ZOConfig as RefZOConfig
from repro.core import build_zo_train_step as ref_build_step
from repro.core import init_zo_state as ref_init_state
from repro.core.cpd import num_sampled_elements_per_step as ref_num_sampled
from repro.data import DataConfig as RefDataConfig
from repro.data import batch_at_step as ref_batch_at_step
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro.utils.tree import tree_num_params as ref_tree_num_params
from repro.utils.tree import tree_size_bytes as ref_tree_size_bytes
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.cpd import num_sampled_elements_per_step
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.launch.serve import BatchedServer, ServeEngine
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.xlstm import XLSTMLM
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path, tree_num_params, tree_size_bytes

from _torch_ref import numpy_params, to_jax

ARCH = "xlstm-350m"
DATA = dict(seq_len=24, global_batch=2, vocab_size=128, seed=0)
# the reference's ``launch.train --arch xlstm-350m --smoke --steps 4
# --seq-len 32 --global-batch 4 --kernel-mode xla`` (seed 0)
CLI_ARGS = ["--steps", "4", "--seq-len", "32", "--global-batch", "4"]
CLI_FINAL_EVAL_LOSS = 5.149966239929199
MAX_LEN = 32


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config(ARCH)


@pytest.fixture(scope="module")
def np_params(cfg):
    return numpy_params(cfg, seed=0)


@pytest.fixture(scope="module")
def params(np_params):
    return params_from_numpy(np_params)


def _ref_cfg(**kw):
    return dataclasses.replace(ref_smoke_config(ARCH), kernel_mode="xla", **kw)


@pytest.fixture(scope="module")
def ref_hidden():
    """The reference's jitted ``hidden_states`` for an ``mlstm_chunk``."""
    fns = {}

    def run(np_params, tokens, chunk=0):
        if chunk not in fns:
            model = ref_build_model(_ref_cfg(mlstm_chunk=chunk))
            fns[chunk] = jax.jit(lambda p, t: model.impl.hidden_states(p, {"tokens": t}))
        return fns[chunk](to_jax(np_params), jnp.asarray(tokens))

    return run


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 128, size=shape).astype(np.int32)


# --------------------------------------------------------------------------
# config, params, loss
# --------------------------------------------------------------------------


def test_config_and_family_routing(cfg):
    for port, ref in ((get_config(ARCH), ref_get_config(ARCH)), (cfg, ref_smoke_config(ARCH))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    full = get_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.n_heads, full.vocab_size,
            full.slstm_layers, full.mlstm_chunk) == ("ssm", 24, 1024, 4, 50304, (7, 15, 23), 0)
    model = build_model(cfg, device="cpu")
    assert isinstance(model.impl, XLSTMLM) and not model.supports_paged_decode
    assert model.impl.dh_m == 32 and build_model(full, device="cpu").impl.dh_m == 512


def test_init_is_bitwise_the_reference(cfg):
    """The seed's draw: the per-layer ``blocks/lNN_m`` / ``lNN_s`` keys fold
    into the reference's streams."""
    ref = {jax.tree_util.keystr(p): np.asarray(v)
           for p, v in jax.tree_util.tree_leaves_with_path(
               ref_build_model(ref_smoke_config(ARCH)).init(jax.random.PRNGKey(1)))}
    got = dict(flatten_with_path(build_model(cfg, device="cpu").init(PRNGKey(1))))
    assert got.keys() == ref.keys() and "['blocks']['l01_s']['r_h']" in got
    for path, want in ref.items():
        np.testing.assert_array_equal(got[path].numpy(), want, err_msg=path)


def test_params_bridge_carries_the_xlstm_tree(np_params, params):
    """``params_from_numpy`` keeps the per-layer nested keys and the values."""
    want = dict(flatten_with_path(np_params))
    got = dict(flatten_with_path(params))
    assert got.keys() == want.keys() and len(got) == 24
    for path, w in want.items():
        assert np.array_equal(got[path].numpy(), w), path


@pytest.mark.parametrize("prefix", [0, 3])
def test_loss_fn_matches_reference(cfg, np_params, params, prefix):
    batch = batch_at_step(DataConfig(**DATA), 0)
    if prefix:
        rng = np.random.default_rng(4)
        batch["embeds"] = rng.standard_normal((2, prefix, cfg.d_model)).astype(np.float32)
    want = float(jax.jit(ref_build_model(_ref_cfg()).loss_fn)(
        to_jax(np_params), {k: jnp.asarray(v) for k, v in batch.items()}))
    got = build_model(cfg, device="cpu").loss_fn(params, {k: _t(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * abs(want)


# --------------------------------------------------------------------------
# the chunkwise form
# --------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunkwise_matches_reference_and_sequential(cfg, np_params, params, ref_hidden, chunk):
    """Hidden states and every carried (C, n, m) state: the port's chunkwise
    form against the reference's at the same chunk and against the port's
    sequential form, within the reference's 1e-3; the losses of the two
    forms within its 1e-4."""
    tokens = _tokens((2, 32), chunk)
    seq = build_model(cfg, device="cpu")
    chk = build_model(cfg.reduced(mlstm_chunk=chunk), device="cpu")
    x_seq, st_seq = seq.impl.hidden_states(params, {"tokens": _t(tokens)})
    x_chk, st_chk = chk.impl.hidden_states(params, {"tokens": _t(tokens)})
    x_ref, st_ref = ref_hidden(np_params, tokens, chunk)
    for other in (x_seq.numpy(), np.asarray(x_ref)):
        np.testing.assert_allclose(x_chk.numpy(), other, rtol=0, atol=1e-3)
    assert st_chk.keys() == st_seq.keys() == set(st_ref) == {"l00_m", "l01_s", "l02_m"}
    for key in st_chk:
        for a, b, r in zip(st_chk[key], st_seq[key], st_ref[key]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-3, err_msg=key)
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0, atol=1e-3,
                                       err_msg=key)
    batch = {"tokens": _t(tokens), "targets": _t(tokens)}
    assert abs(float(chk.loss_fn(params, batch)) - float(seq.loss_fn(params, batch))) < 1e-4


def test_chunk_follows_the_device_and_the_config(cfg):
    """An explicit chunk wins; otherwise the CPU takes the sequential scan
    (the card takes 256, held on the card in tests/test_torch_cuda.py), and
    a chunk that does not divide S, or is not shorter than it, falls back
    to the sequential scan as in the reference."""
    x = torch.zeros(1, 32, cfg.d_model)
    assert build_model(cfg, device="cpu").impl._mlstm_chunk(x) == 0
    assert build_model(cfg.reduced(mlstm_chunk=8), device="cpu").impl._mlstm_chunk(x) == 8
    impl = build_model(cfg.reduced(mlstm_chunk=32), device="cpu").impl
    calls = []
    impl._mlstm_chunk_scan = lambda *a: calls.append(a)
    params = build_model(cfg, device="cpu").init(PRNGKey(0))
    impl.hidden_states(params, {"tokens": torch.zeros(1, 32, dtype=torch.int32)})
    impl.hidden_states(params, {"tokens": torch.zeros(1, 40, dtype=torch.int32)})
    assert calls == []


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 4])
def test_prefill_and_decode_match_teacher_forcing(cfg, np_params, params, chunk):
    """Prefill 8 tokens (chunkwise at ``chunk`` 4), then four decode steps
    on the carried states: within 2e-3 of the full forward's logits at the
    same positions (the reference's bar), and within 1e-4 of the
    reference's own prefill and decode logits."""
    tokens = _tokens((2, 12), 5)
    model = build_model(cfg.reduced(mlstm_chunk=chunk), device="cpu")
    ref = ref_build_model(_ref_cfg(mlstm_chunk=chunk))
    rp = to_jax(np_params)
    x, _ = model.impl.hidden_states(params, {"tokens": _t(tokens)})
    full = (x @ params["lm_head"]).numpy()
    logits, cache = model.prefill(params, {"tokens": _t(tokens[:, :8])}, MAX_LEN)
    r_logits, r_cache = jax.jit(lambda p, b: ref.prefill(p, b, MAX_LEN))(
        rp, {"tokens": jnp.asarray(tokens[:, :8])})
    decode = jax.jit(ref.decode_step)
    for i in range(8, 13):
        np.testing.assert_allclose(logits.numpy(), full[:, i - 1], rtol=0, atol=2e-3)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), rtol=0, atol=1e-4)
        if i == 12:
            break
        logits, cache = model.decode_step(params, cache, _t(tokens[:, i]))
        r_logits, r_cache = decode(rp, r_cache, jnp.asarray(tokens[:, i]))
    assert cache["pos"] == 12 == int(r_cache["pos"])


def test_batched_server_tokens_match_reference(cfg, np_params, params):
    """Greedy and sampled (temperature 0.8) streams of 10 tokens."""
    prompts = _tokens((3, 9), 3)
    ref = ref_serve.BatchedServer(_ref_cfg(), to_jax(np_params), max_len=MAX_LEN)
    server = BatchedServer(cfg, params, max_len=MAX_LEN, device="cpu")
    for temperature in (0.0, 0.8):
        want, _ = ref.generate(prompts, max_new_tokens=10, temperature=temperature, seed=7)
        got, _ = server.generate(prompts, max_new_tokens=10, temperature=temperature, seed=7)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"T={temperature}")


def test_engine_and_weight_quant_raise_as_the_reference(cfg, params):
    """No paged decode path, and no leaf that quantization covers (the
    block weights are 2-D and per layer, not QUANT_FIELDS' stacked [L, K,
    N]): the reference's messages."""
    with pytest.raises(ValueError, match="no paged decode path"):
        ServeEngine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="matched no leaves"):
        port_train.train(arch=ARCH, smoke=True, steps=1, weight_quant="lut4", device="cpu",
                         verbose=False)


def test_serve_cli_on_cpu(capsys):
    port_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "6", "--max-new", "3"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated_shape"] == [2, 3]
    with pytest.raises(ValueError, match="no paged decode path"):
        port_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine"])


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

STEP_CFG = dict(n_layers=2, n_heads=4, n_kv_heads=4)  # w_if [64, 8]: low-rank, r = 8


def _port_run(method, q, restore_mode, steps, lr=1e-3):
    cfg = get_smoke_config(ARCH).reduced(**STEP_CFG)
    model = build_model(cfg, device="cpu")
    zc = ZOConfig(method=method, q_probes=q, restore_mode=restore_mode, rank=8, lr=lr)
    state = init_zo_state(params_from_numpy(numpy_params(cfg, seed=0)), zc)
    step = build_zo_train_step(model.loss_fn, zc)
    losses = []
    for s in range(steps):
        batch = {k: _t(v) for k, v in batch_at_step(DataConfig(**DATA), s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


def _ref_run(method, kernel_mode, steps, lr=1e-3):
    model = ref_build_model(ref_smoke_config(ARCH).reduced(**STEP_CFG))
    zc = RefZOConfig(method=method, kernel_mode=kernel_mode, q_probes=1, rank=8, lr=lr)
    cfg = get_smoke_config(ARCH).reduced(**STEP_CFG)
    # jitted: one compile for the factor draws, bitwise the eager init
    state = jax.jit(lambda p: ref_init_state(p, zc))(to_jax(numpy_params(cfg, seed=0)))
    step = jax.jit(ref_build_step(model.loss_fn, zc))
    losses = []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in ref_batch_at_step(RefDataConfig(**DATA),
                                                                  s).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


@pytest.mark.parametrize("method,kernel_mode", [("tezo_adam", "xla"), ("mezo_adam", "pallas")])
def test_step_matches_reference(method, kernel_mode):
    """Two q = 1 steps from the same params: losses, params, moments; the
    TeZO state factors ``w_if`` at r = 8."""
    port, l_p = _port_run(method, 1, "inplace", 2)
    jref, l_r = _ref_run(method, kernel_mode, 2)
    np.testing.assert_allclose(l_p, l_r, rtol=1e-5, atol=0)
    got = {p: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for p, v in flatten_with_path(port)}
    want = {jax.tree_util.keystr(p): np.asarray(v, np.float32) if v.dtype != np.uint32
            else np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(jref)}
    assert set(got) == set(want)
    w_if = "['blocks']['l00_m']['w_if']"
    if method == "tezo_adam":
        assert port.mstate["factors"][w_if].u.shape == (64, 8)
    for path, w in want.items():
        atol = 1e-3 * float(np.abs(w).max()) if path.startswith(".mstate") else 1e-5
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg=path)
    init = numpy_params(get_smoke_config(ARCH).reduced(**STEP_CFG), seed=0)
    assert np.abs(got[".params" + w_if] - init["blocks"]["l00_m"]["w_if"]).max() > 0


@pytest.mark.parametrize("method", ["tezo_adam", "mezo_adam"])
def test_chained_equals_unchained_bitwise(method):
    a, l_a = _port_run(method, 2, "inplace", 2, lr=1e-2)
    b, l_b = _port_run(method, 2, "unchained", 2, lr=1e-2)
    assert l_a == l_b and all(np.isfinite(l_a))
    other = dict(flatten_with_path(b))
    for path, x in flatten_with_path(a):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, other[path]), path
        else:
            assert np.array_equal(x, other[path]), path


@pytest.mark.parametrize("method", ["tezo", "tezo_m", "tezo_adam", "mezo", "mezo_m",
                                    "mezo_adam", "lozo", "lozo_m", "subzo"])
def test_trainer_runs_every_method(method):
    """Every ZO method trains the smoke model through ``train`` (3 steps, a
    log each step): finite losses, and the params move."""
    res = port_train.train(arch=ARCH, smoke=True, method=method, steps=3, seq_len=16,
                           global_batch=2, device="cpu", verbose=False, log_every=1,
                           return_state=True)
    losses = [h["loss"] for h in res["history"]] + [res["final_eval_loss"]]
    assert len(losses) == 4 and all(np.isfinite(losses))
    init = build_model(get_smoke_config(ARCH), device="cpu").init(PRNGKey(0))
    moved = dict(flatten_with_path(res["state"].params))
    assert any(not torch.equal(moved[p], w) for p, w in flatten_with_path(init))


def test_trainer_adaptive_q_grows_q():
    """``--adaptive-q`` from q = 4: the κ dispersion grows q at a log
    boundary and the step is rebuilt for the new q."""
    res = port_train.train(arch=ARCH, smoke=True, method="tezo_adam", steps=4, seq_len=16,
                           global_batch=2, device="cpu", verbose=False, log_every=1,
                           adaptive_q=True, q_probes=4, q_max=8)
    assert res["q_probes"] == 8 and any(h.get("q_probes") == 8 for h in res["history"])
    assert np.isfinite(res["final_eval_loss"])


@pytest.mark.parametrize("arch", [ARCH, "opt-125m"])
def test_tree_helpers_match_reference(arch):
    """The params' bytes and elements, and Table 2's draws per step (the
    TeZO factors at rank 8, 4 heads for xLSTM), against the reference's on
    the same trees."""
    from repro.core.cpd import init_factors as ref_init_factors
    from repro_torch.core.cpd import init_factors

    cfg = get_smoke_config(arch).reduced(**(STEP_CFG if arch == ARCH else {}))
    npp = numpy_params(cfg, seed=0)
    params, rp = params_from_numpy(npp), to_jax(npp)
    assert tree_size_bytes(params) == ref_tree_size_bytes(rp)
    assert tree_num_params(params) == ref_tree_num_params(rp)
    # the count reads the factors' shapes only: one jitted draw of them
    factors = jax.jit(lambda p: ref_init_factors(p, jax.random.PRNGKey(0), default_rank=8))(rp)
    want = ref_num_sampled(rp, factors)
    got = num_sampled_elements_per_step(params, init_factors(params, PRNGKey(0), default_rank=8))
    assert got == want and got < tree_num_params(params)


def test_spectral_ranks_and_factors_match_reference():
    """Eq. 7 on the per-layer tree, copied and not repaired: no path holds
    ``blocks`` followed by a layer digit (``lNN_m``), so ``_BLOCK_RE`` puts
    every leaf in one block and, with r_h's batch shape beside the 2-D
    leaves, one scalar minimum ranks them all.  The ranks, masks and the
    factors drawn at those ranks equal the reference's."""
    from repro.core import rank as rrank
    from repro.core.cpd import init_factors as ref_init_factors
    from repro_torch.core import rank
    from repro_torch.core.cpd import init_factors

    npp = numpy_params(get_smoke_config(ARCH).reduced(**STEP_CFG), seed=0)
    params, rp = params_from_numpy(npp), to_jax(npp)
    ranks, masks = rank.select_ranks(params)
    want_ranks, want_masks = rrank.select_ranks(npp)
    assert ranks == want_ranks and masks == want_masks == {}
    assert len(set(ranks.values())) == 1 and len(ranks) == 11
    factors = init_factors(params, PRNGKey(3), ranks=ranks)
    # the factors are plain draws: one jitted draw of them is the eager one's bits
    want = jax.jit(lambda p: ref_init_factors(p, jax.random.PRNGKey(3), ranks=ranks))(rp)
    assert factors.keys() == want.keys() == ranks.keys()
    for path, f in factors.items():
        np.testing.assert_array_equal(f.u.numpy(), np.asarray(want[path].u), err_msg=path)
        np.testing.assert_array_equal(f.v.numpy(), np.asarray(want[path].v), err_msg=path)


def test_train_cli_matches_reference(capsys):
    port_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", *CLI_ARGS])
    out = capsys.readouterr().out
    out = json.loads(out[out.index("{\n"):])  # after any [train] lines
    assert out["arch"] == "xlstm-350m-smoke"
    assert abs(out["final_eval_loss"] - CLI_FINAL_EVAL_LOSS) <= 1e-5 * CLI_FINAL_EVAL_LOSS
