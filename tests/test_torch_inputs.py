"""The dense family's sliding window and the reference's input helpers in
the port, against the reference on the CPU.

* the window: opt-125m-smoke's loss at ``window`` 0 and 4 against the
  reference's ``kernel_mode="xla"`` loss within 1e-5 relative; the
  ring-buffered dense cache (prefill + 6 decode steps at ``window`` 4, a
  prompt shorter and one longer than the ring) against the reference's
  dense decode within 1e-4 on the logits (f32 model, bf16 cache, as
  tests/test_torch_model.py); the paged entries refuse ``window`` > 0;
* ``utils.jax_random.split`` and ``randint`` bitwise ``jax.random``'s over
  several shapes and spans, opt's 50272 and qwen's 151936 among them;
* ``LM.make_inputs`` bitwise the reference's for every family's smoke
  config (prefix embeds on paligemma and musicgen); ``input_specs``,
  ``decode_input_specs`` (hymba's and xLSTM's caches, a windowed ring),
  ``abstract_params`` and ``logical_axes`` equal to the reference's
  ShapeDtypeStructs and axes; ``SHAPES``, ``assigned_cells`` and
  ``runnable_cells`` equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.base import long_context_capable as ref_long_context_capable
from repro.models import build_model as ref_build_model
import repro_torch.configs as port_configs
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import SHAPES, ShapeConfig, long_context_capable
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.utils import jax_random
from repro_torch.utils.tree import flatten_with_path

from _torch_ref import numpy_params, to_jax

ARCHS = ("opt-125m", "granite-8b", "yi-34b", "qwen2.5-14b", "qwen3-32b", "paligemma-3b",
         "musicgen-medium", "dbrx-132b", "kimi-k2-1t-a32b", "hymba-1.5b", "xlstm-350m")
CELLS = [ShapeConfig("t", 32, 4, "train"), ShapeConfig("d", 48, 2, "decode"),
         ShapeConfig("one", 1, 1, "decode")]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def _ref_shape(s: ShapeConfig):
    return RefShapeConfig(s.name, s.seq_len, s.global_batch, s.kind)


# --------------------------------------------------------------------------
# the dense family's sliding window
# --------------------------------------------------------------------------


def _window_models(window: int):
    cfg = get_smoke_config("opt-125m").reduced(window=window)
    ref = ref_build_model(ref_smoke_config("opt-125m").reduced(window=window, kernel_mode="xla"))
    np_params = numpy_params(cfg, 0)
    return build_model(cfg, "cpu"), params_from_numpy(np_params), ref, to_jax(np_params)


@pytest.mark.parametrize("window", [0, 4])
def test_dense_loss_with_window(window):
    model, params, ref, ref_params = _window_models(window)
    toks = np.random.default_rng(1).integers(0, 256, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    got = float(model.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}))
    want = float(ref.loss_fn(ref_params, {k: jnp.asarray(v) for k, v in batch.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_window_changes_the_loss():
    """Without the fix both windows gave 6.245616 (ROADMAP Queue C item 3)."""
    toks = np.random.default_rng(1).integers(0, 256, (2, 17)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    losses = [float(m.loss_fn(p, batch)) for m, p, _, _ in (_window_models(0),
                                                            _window_models(4))]
    assert losses[0] != losses[1]


@pytest.mark.parametrize("prompt", [3, 8])
def test_ring_cache_decode_with_window(prompt):
    """Prefill then 6 decode steps at window 4 (ring capacity 4 < max_len
    16): a 3-token prompt pads the ring and wraps during decode, an
    8-token one is rolled into it."""
    model, params, ref, ref_params = _window_models(4)
    toks = np.random.default_rng(2).integers(0, 256, (2, prompt + 6)).astype(np.int32)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :prompt])}, 16)
    r_logits, r_cache = jax.jit(lambda p, b: ref.prefill(p, b, 16))(
        ref_params, {"tokens": jnp.asarray(toks[:, :prompt])})
    ref_decode = jax.jit(ref.decode_step)
    assert tuple(cache["k"].shape) == tuple(r_cache["k"].shape)
    assert cache["k"].shape[2] == 4  # the ring holds the window
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=1e-4)
    for t in range(6):
        tok = toks[:, prompt + t]
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        r_logits, r_cache = ref_decode(ref_params, r_cache, jnp.asarray(tok))
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=1e-4,
                                   err_msg=f"decode step {t}")
    assert cache["pos"] == int(r_cache["pos"]) == prompt + 6


@pytest.mark.parametrize("entry", ["prefill_paged", "decode_step_paged", "verify_step_paged"])
def test_paged_entries_refuse_window(entry):
    model, params, _, _ = _window_models(4)
    pool = model.init_paged_cache(4, 4)
    bt = torch.zeros((1, 2), dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    call = {"prefill_paged": lambda: model.prefill_paged(params, prompt, 4),
            "decode_step_paged": lambda: model.decode_step_paged(
                params, pool, bt, lens, torch.zeros(1, dtype=torch.int32)),
            "verify_step_paged": lambda: model.verify_step_paged(
                params, pool, bt, lens, torch.zeros((1, 2), dtype=torch.int32))}[entry]
    with pytest.raises(ValueError, match="window"):
        call()


# --------------------------------------------------------------------------
# jax.random replays
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_split_matches_jax(n):
    for seed in (0, 1, 12345):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
        got = np.asarray(jax_random.split(jax_random.PRNGKey(seed), n), np.uint32)
        np.testing.assert_array_equal(got, want.reshape(n, 2))
    k1, _ = jax_random.split(jax_random.PRNGKey(3))
    assert jax_random.split(k1, 2) == jax_random.split(np.asarray(k1, np.uint32), 2)


RANDINT_CASES = [((4, 17), 0, 50272), ((3, 5, 7), 0, 151936), ((64,), 0, 256),
                 ((100,), -5, 7), ((50,), 0, 65536), ((50,), 0, 65537), ((33,), -100, 32001),
                 ((257,), 0, 2**31 - 1), ((10,), -2**31, 2**31 - 1), ((8,), 3, 3),
                 ((8,), 5, 2)]


@pytest.mark.parametrize("shape,lo,hi", RANDINT_CASES)
def test_randint_matches_jax(shape, lo, hi):
    for seed in (0, 7):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi,
                                             jnp.int32))
        got = jax_random.randint(jax_random.PRNGKey(seed), shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the model's input helpers
# --------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_make_inputs_matches_reference(arch):
    ref, model = ref_build_model(ref_smoke_config(arch)), build_model(get_smoke_config(arch),
                                                                      "cpu")
    for shape in CELLS:
        want = ref.make_inputs(jax.random.PRNGKey(3), _ref_shape(shape))
        got = model.make_inputs(jax_random.PRNGKey(3), shape)
        assert set(got) == set(want)
        for k in want:
            assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k], np.float32
                                                                  if got[k].is_floating_point()
                                                                  else np.int32), err_msg=k)
        if model.cfg.n_prefix_embeds and shape.seq_len > 1:
            assert "embeds" in got


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype)) for p, x in flat}


def _walk(node, prefix=""):
    """(keystr path, tensor) of a tree of dicts and tuples (xLSTM's cache)."""
    if isinstance(node, dict):
        for k in node:
            yield from _walk(node[k], f"{prefix}[{k!r}]")
    elif isinstance(node, tuple):
        for i, x in enumerate(node):
            yield from _walk(x, f"{prefix}[{i}]")
    else:
        yield prefix, node


def _port_leaves(tree) -> dict:
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for p, t in _walk(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    ref, model = ref_build_model(ref_smoke_config(arch)), build_model(get_smoke_config(arch),
                                                                      "cpu")
    for shape in CELLS:
        got = model.input_specs(shape)
        assert all(t.device.type == "meta" for t in got.values())
        assert _port_leaves(got) == _ref_leaves(ref.input_specs(_ref_shape(shape)))
        got = model.decode_input_specs(shape)
        assert all(t.device.type == "meta" for _, t in _walk(got))
        assert _port_leaves(got) == _ref_leaves(ref.decode_input_specs(_ref_shape(shape)))
    assert _port_leaves(model.abstract_params()) == _ref_leaves(ref.abstract_params())
    want_axes = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(
        ref.logical_axes(), is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert dict(flatten_with_path(model.logical_axes())) == want_axes


def test_windowed_decode_specs_are_the_ring():
    cfg = get_smoke_config("opt-125m").reduced(window=4)
    got = build_model(cfg, "cpu").decode_input_specs(ShapeConfig("d", 48, 2, "decode"))
    want = ref_build_model(ref_smoke_config("opt-125m").reduced(window=4)).decode_input_specs(
        RefShapeConfig("d", 48, 2, "decode"))
    assert _port_leaves(got) == _ref_leaves(want)
    assert got["cache"]["k"].shape[2] == 4


def test_shapes_and_cells_match_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in REF_SHAPES.items()}
    assert [s.is_serving for s in SHAPES.values()] == [s.is_serving for s in REF_SHAPES.values()]
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert port_configs.assigned_cells() == ref_configs.assigned_cells()
    assert port_configs.runnable_cells() == ref_configs.runnable_cells()
    assert port_configs.get_shape("decode_32k") == SHAPES["decode_32k"]
    for a in ARCHS:
        assert long_context_capable(port_configs.get_config(a)) == ref_long_context_capable(
            ref_configs.get_config(a))
