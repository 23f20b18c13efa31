"""The port's dense model against the reference on ``opt-125m-smoke``: the
parameter bridge, the serving forward paths from bridged parameters, the
config registry, and the port's import isolation.

The reference runs as its own tests run it: ``kernel_mode="xla"`` for the
whole model — except ``decode_step_paged``, which is held against the
reference's Pallas decode kernel under the interpreter.  The reference's XLA
twin of that kernel rounds the softmax weights to the cache dtype (bf16)
before the value product, which moves the smoke model's logits by ~4e-3;
the port's plain version and the Pallas kernel keep them in f32, as the
CUDA kernel does.  Tolerance: 1e-4 on logits (f32 model, bf16 cache)."""

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer
from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ops
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.bridge import load_reference_checkpoint, params_from_numpy
from repro_torch.utils.jax_random import PRNGKey

from _torch_ref import numpy_params, to_jax

ATOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="session", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref_model():
    return ref_build_model(ref_smoke_config("opt-125m"))


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(get_smoke_config("opt-125m"), seed=0)


@pytest.fixture(scope="module")
def ref_params(np_params):
    return to_jax(np_params)


@pytest.fixture(scope="module")
def model():
    return build_model(get_smoke_config("opt-125m"), device="cpu")


@pytest.fixture(scope="module")
def params(np_params):
    return params_from_numpy(np_params)


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as unsigned integers (bf16 -> uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view({2: np.uint16, 4: np.uint32}[x.dtype.itemsize])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# --------------------------------------------------------------------------
# bridge
# --------------------------------------------------------------------------


def test_bridge_round_trip_is_bit_exact():
    """Reference params (bf16 and f32 leaves) -> numpy -> the port: same
    keys, shapes, stacked layout and bits."""
    ref = numpy_params(get_smoke_config("opt-125m"), seed=1, dtype=jnp.bfloat16)
    ref["final_norm"] = ref["final_norm"].astype(np.float32)  # one f32 leaf too
    ported = params_from_numpy(ref)
    want, got = dict(_leaves(ref)), dict(_leaves(ported))
    assert want.keys() == got.keys()
    assert got["blocks/wq"].dtype == torch.bfloat16
    assert got["final_norm"].dtype == torch.float32
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(w), err_msg=name)


def test_reference_checkpoint_reads_bit_exact(tmp_path):
    """The reference checkpointer's on-disk layout reads back with numpy
    alone, bf16 leaves included."""
    ref = numpy_params(get_smoke_config("opt-125m"), seed=2, dtype=jnp.bfloat16)
    Checkpointer(tmp_path).save(3, {"params": to_jax(ref), "step": jnp.int32(3)})
    state = load_reference_checkpoint(tmp_path / "step_00000003")
    assert int(state["step"]) == 3
    got = dict(_leaves(state["params"]))
    for name, w in _leaves(ref):
        np.testing.assert_array_equal(_bits(got[name]), _bits(w), err_msg=name)


def test_init_matches_reference_specs(model, ref_model):
    """The port's own init draws the reference's tree: same leaves, shapes
    and dtypes (the values themselves are held against the reference's in
    tests/test_torch_random.py)."""
    ported = model.init(PRNGKey(0))
    want = {k: (v.shape, str(v.dtype)) for k, v in _leaves(ref_model.abstract_params())}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in
           _leaves(ported)}
    assert got == want
    assert torch.all(ported["blocks"]["ln1"] == 0)
    assert 0.1 < float(ported["embed"].std()) < 10.0  # scale 1.0 normal


# --------------------------------------------------------------------------
# forward paths from bridged params
# --------------------------------------------------------------------------


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


def _close_bf16(got: torch.Tensor, want):
    """bf16 cache entries: the f32 values agree to ~1e-6, so a value near a
    rounding boundary may land one bf16 ulp (2**-7 relative) apart."""
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=ATOL
    )


def test_prefill_and_decode_step_match(model, params, ref_model, ref_params):
    """Dense-cache serving: prefill logits and cache, then three decode
    steps, from the same params."""
    tokens = np.random.default_rng(0).integers(2, 256, size=(2, 11)).astype(np.int32)
    ref_prefill = jax.jit(ref_model.prefill, static_argnums=2)
    ref_decode = jax.jit(ref_model.decode_step)
    jl, jc = ref_prefill(ref_params, {"tokens": jnp.asarray(tokens)}, 16)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, 16)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    assert tc["pos"] == int(jc["pos"]) == 11
    for nxt in ([3, 4], [5, 6], [7, 8]):
        nxt = np.asarray(nxt, np.int32)
        jl, jc = ref_decode(ref_params, jc, jnp.asarray(nxt))
        tl, tc = model.decode_step(params, tc, torch.from_numpy(nxt))
        _close(tl, jl)


def test_prefill_paged_and_decode_step_paged_match(model, params, ref_params):
    """Paged serving: bucket-padded prefill, page insertion through a
    shuffled table, then a decode step with a dead slot, a mid-page slot and
    a slot at its page capacity (whose write routes to the null page)."""
    ref = ref_build_model(ref_smoke_config("opt-125m"))
    ref_prefill = jax.jit(ref.prefill_paged)
    ref_insert = jax.jit(ref.insert_pages)
    pallas = ref_build_model(replace(ref_smoke_config("opt-125m"), kernel_mode="pallas"))
    ref_decode = jax.jit(pallas.decode_step_paged)
    rng = np.random.default_rng(1)
    ps, P = 8, 2
    bt = np.asarray([[4, 2], [1, 5], [3, 6], [0, 0]], np.int32)
    jcache = ref.init_paged_cache(7, ps)
    tcache = model.init_paged_cache(7, ps)
    lens = []
    for s, n in enumerate([5, 13, 16]):
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :n] = rng.integers(2, 256, size=n)
        jl, jk, jv = ref_prefill(ref_params, jnp.asarray(prompt), jnp.int32(n))
        jcache = ref_insert(jcache, jk, jv, jnp.asarray(bt[s]))
        tl, tk, tv = model.prefill_paged(params, torch.from_numpy(prompt), n)
        tcache = model.insert_pages(tcache, tk, tv, torch.from_numpy(bt[s].astype(np.int64)))
        _close(tl, jl)
        lens.append(n)
    _close_bf16(tcache["k"], jcache["k"])
    # The decode step starts from one cache on both sides: a prefilled value
    # near a bf16 rounding boundary may have landed one ulp apart above.
    jcache = {n: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for n, t in tcache.items()}
    lens = np.asarray(lens + [0], np.int32)
    tokens = np.asarray([7, 8, 9, 0], np.int32)
    ops.set_interpret(True)
    try:
        jl, jcache = ref_decode(
            ref_params, jcache, jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(tokens)
        )
    finally:
        ops.set_interpret(None)
    assert lens[2] == P * ps  # at capacity: its write must land on page 0
    tl, tcache = model.decode_step_paged(
        params, tcache, torch.from_numpy(bt), torch.from_numpy(lens), torch.from_numpy(tokens)
    )
    _close(tl, jl)
    _close_bf16(tcache["k"][:, 1:], jcache["k"][:, 1:])  # every real page agrees


# --------------------------------------------------------------------------
# configs, devices, import isolation
# --------------------------------------------------------------------------


def test_config_registry():
    assert get_config("opt-125m").d_model == 768
    assert get_smoke_config("opt-125m").n_layers == 2
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        get_config("no-such-arch")
    with pytest.raises(NotImplementedError, match="unknown model family 'no-such-family'"):
        build_model(get_smoke_config("opt-125m").reduced(family="no-such-family"), device="cpu")


def test_entry_points_default_to_cuda():
    """Without a card, asking for the default device raises; the CPU runs
    only when asked for.  The same holds for the training entry point."""
    from repro_torch.launch import train

    if torch.cuda.is_available():
        assert build_model(get_smoke_config("opt-125m")).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_smoke_config("opt-125m"))
    assert build_model(get_smoke_config("opt-125m"), device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train(smoke=True, steps=1, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import json, sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.core.dispatch\n"
        "import repro_torch.models.bridge, repro_torch.kernels._build\n"
        "import repro_torch.launch.train, repro_torch.core.zo_step\n"
        "import repro_torch.core.estimator, repro_torch.core.cpd\n"
        "import repro_torch.kernels.tezo_perturb, repro_torch.kernels.tezo_adam\n"
        "import repro_torch.kernels.zo_noise, repro_torch.core.quant\n"
        "import repro_torch.kernels.quant_matmul, repro_torch.kernels.decode_attention\n"
        "import repro_torch.checkpoint.checkpointer, repro_torch.data.pipeline\n"
        "import repro_torch.utils.jax_random, repro_torch.utils.tree\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        check=True, timeout=120,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
