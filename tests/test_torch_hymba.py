"""The port's hybrid family (``repro_torch.models.hymba``) on the CPU, at the
hymba-1.5b-smoke config, against the reference's ``HymbaLM``.

* params bridged from the reference's tree (``params_from_numpy``) exactly;
* ``loss_fn`` within 1e-5 relative of the reference's at
  ``kernel_mode="xla"``;
* prefill and decode logits within 1e-4 (the decode attention rounds its
  softmax weights to the bf16 cache in both), past the ring window;
* ``BatchedServer`` greedy and sampled (temperature 0.8) tokens equal to the
  reference's, with prompts longer than the window (the ring and the roll);
* a TeZO-Adam step against the reference at ``kernel_mode="xla"`` and a
  MeZO-Adam step against ``"pallas"`` (the counter stream, ROADMAP
  "Reference-side facts" 4): losses within 1e-5 relative, params within
  1e-5, the κ-scaled moments within 1e-3 of each moment's largest entry
  (κ = Δloss / 2ρ carries the frameworks' ~1e-7 loss difference times
  1/2ρ, as in tests/test_torch_train.py);
* chained == unchained bitwise inside the port, and the CLIs.

The reference's jitted steps and server are built once per module."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import ZOConfig as RefZOConfig
from repro.core import build_zo_train_step as ref_build_step
from repro.core import init_zo_state as ref_init_state
from repro.data import DataConfig as RefDataConfig
from repro.data import batch_at_step as ref_batch_at_step
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.launch.serve import BatchedServer, ServeEngine
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.utils.tree import flatten_with_path

from _torch_ref import numpy_params, to_jax

ARCH = "hymba-1.5b"
DATA = dict(seq_len=24, global_batch=2, vocab_size=128, seed=0)
# the reference's ``launch.train --arch hymba-1.5b --smoke --steps 10
# --kernel-mode xla`` (seed 0)
CLI_FINAL_EVAL_LOSS = 5.263861656188965
MAX_LEN = 40  # the servers' cache length; the ring holds min(40, window 16)


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config(ARCH)


@pytest.fixture(scope="module")
def ref_cfg():
    return dataclasses.replace(ref_smoke_config(ARCH), kernel_mode="xla")


@pytest.fixture(scope="module")
def np_params(cfg):
    return numpy_params(cfg, seed=0)


@pytest.fixture(scope="module")
def params(np_params):
    return params_from_numpy(np_params)


@pytest.fixture(scope="module")
def ref_server(ref_cfg, np_params):
    return ref_serve.BatchedServer(ref_cfg, to_jax(np_params), max_len=MAX_LEN)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _prompts(n, seed=3):
    return np.random.default_rng(seed).integers(2, 128, size=(3, n)).astype(np.int32)


# --------------------------------------------------------------------------
# config, params, loss
# --------------------------------------------------------------------------


def test_config_and_family_routing(cfg):
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.ssm_state, full.ssm_expand, full.conv_width,
            full.window, full.activation) == (32, 1600, 25, 5, 64, 5504, 32001, 16, 2, 4,
                                              1024, "swiglu")
    model = build_model(cfg, device="cpu")
    assert type(model.impl).__name__ == "HymbaLM" and not model.supports_paged_decode
    assert build_model(get_smoke_config("opt-125m"), device="cpu").supports_paged_decode


def test_params_bridge_carries_the_hymba_tree(cfg, ref_cfg, np_params, params):
    """Same nested keys and shapes as the reference's specs, values exact."""
    specs = ref_build_model(ref_cfg).impl.param_specs()

    def walk(spec, arr, got, path):
        if isinstance(spec, dict):
            assert set(spec) == set(arr) == set(got), path
            for k in spec:
                walk(spec[k], arr[k], got[k], f"{path}/{k}")
        else:
            assert tuple(got.shape) == tuple(spec.shape) == arr.shape, path
            assert np.array_equal(got.numpy(), arr), path

    walk(specs, np_params, params, "")


def test_loss_fn_matches_reference(cfg, ref_cfg, np_params, params):
    batch = batch_at_step(DataConfig(**DATA), 0)
    want = float(jax.jit(ref_build_model(ref_cfg).loss_fn)(
        to_jax(np_params), {k: jnp.asarray(v) for k, v in batch.items()}))
    got = build_model(cfg, device="cpu").loss_fn(params, {k: _t(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * abs(want)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


@pytest.mark.parametrize("prompt_len", [9, 21])
def test_prefill_and_decode_logits_match_reference(cfg, params, ref_server, prompt_len):
    """Prompts shorter and longer than the window; four decode steps carry
    the ring slot, the SSM state and the conv tail (S = 1 scans)."""
    prompts = _prompts(prompt_len)
    model = build_model(cfg, device="cpu")
    logits, cache = model.prefill(params, {"tokens": _t(prompts)}, MAX_LEN)
    r_logits, r_cache = ref_server._prefill(ref_server.params, {"tokens": jnp.asarray(prompts)})
    assert cache["k"].shape[2] == 16
    for step in range(5):
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), rtol=0, atol=1e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(r_cache["ssm"]), rtol=0,
                                   atol=1e-5, err_msg=f"ssm state, step {step}")
        toks = np.asarray(jnp.argmax(r_logits, axis=-1)).astype(np.int32)
        logits, cache = model.decode_step(params, cache, _t(toks))
        r_logits, r_cache = ref_server._decode(ref_server.params, r_cache, jnp.asarray(toks))
    assert cache["pos"] == prompt_len + 5 == int(r_cache["pos"])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_batched_server_tokens_match_reference(cfg, params, ref_server, temperature):
    """Greedy and sampled streams, prompts of 21 > window 16 tokens."""
    prompts = _prompts(21)
    want, _ = ref_server.generate(prompts, max_new_tokens=10, temperature=temperature, seed=7)
    got, _ = BatchedServer(cfg, params, max_len=MAX_LEN, device="cpu").generate(
        prompts, max_new_tokens=10, temperature=temperature, seed=7)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_engine_rejects_the_hybrid_family(cfg, params):
    with pytest.raises(ValueError, match="no paged decode path"):
        ServeEngine(cfg, params, device="cpu")


def test_serve_cli_on_cpu(capsys):
    port_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "20", "--max-new", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated_shape"] == [2, 4]
    with pytest.raises(ValueError, match="no paged decode path"):
        port_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine"])


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


# The steps start from numpy params on both sides (the reference's own
# init costs ~8 s of eager compiles; the port's init draws are held to the
# reference's in tests/test_torch_random.py).


def _port_run(method, q, restore_mode, steps, lr=1e-3):
    cfg = get_smoke_config(ARCH)
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
    model = ref_build_model(ref_smoke_config(ARCH))
    zc = RefZOConfig(method=method, kernel_mode=kernel_mode, q_probes=1, rank=8, lr=lr)
    state = ref_init_state(to_jax(numpy_params(get_smoke_config(ARCH), seed=0)), zc)
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
    """Two q = 1 steps from the same params: losses, params, moments."""
    port, l_p = _port_run(method, 1, "inplace", 2)
    jref, l_r = _ref_run(method, kernel_mode, 2)
    np.testing.assert_allclose(l_p, l_r, rtol=1e-5, atol=0)
    got = {p: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for p, v in flatten_with_path(port)}
    want = {jax.tree_util.keystr(p): np.asarray(v, np.float32) if v.dtype != np.uint32
            else np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(jref)}
    assert set(got) == set(want)
    for path, w in want.items():
        if path.startswith(".mstate"):
            atol = 1e-3 * float(np.abs(w).max())
        else:
            atol = 1e-5
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg=path)
    init = numpy_params(get_smoke_config(ARCH), seed=0)
    assert np.abs(got[".params['blocks']['w_in']"] - init["blocks"]["w_in"]).max() > 0


@pytest.mark.parametrize("method", ["tezo_adam", "mezo_adam", "subzo"])
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


def test_train_cli_matches_reference(capsys):
    port_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "10"])
    out = capsys.readouterr().out
    out = json.loads(out[out.index("\n{") + 1:])
    assert out["arch"] == "hymba-1.5b-smoke"
    assert abs(out["final_eval_loss"] - CLI_FINAL_EVAL_LOSS) <= 1e-6 * CLI_FINAL_EVAL_LOSS
