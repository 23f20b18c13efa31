"""The port's other transformer-family configs against the reference, on
the CPU: granite-8b, yi-34b, qwen2.5-14b (QKV biases), qwen3-32b (qk-norm),
paligemma-3b (family ``vlm``: GeGLU, prefix embeds), musicgen-medium
(family ``audio``: prefix embeds), dbrx-132b and kimi-k2-1t-a32b (family
``moe``: router and expert leaves), each at its ``*-smoke`` config
(tests/test_torch_moe.py holds the MoE block itself).

* The registry resolves the eight ids with the reference's fields, and
  ``LM`` builds the ``vlm``, ``audio`` and ``moe`` families.
* ``init`` is bitwise the reference's ``init`` for the seed (f32, and bf16
  for qwen2.5-14b-smoke, whose chunked scale-and-cast must stay bitwise).
* ``loss_fn`` from bridged numpy params within 1e-5 relative of the
  reference at ``kernel_mode="xla"``; paligemma and musicgen also with a
  batch of prefix ``embeds [B, P, D]``.  The norm scales, the QKV biases
  and the qk-norm scales are nonzero (``_torch_ref.numpy_params``), so a
  branch that skipped them would show.
* qwen2.5-14b-smoke and qwen3-32b-smoke serving: ``prefill`` /
  ``decode_step`` against the reference at ``kernel_mode="xla"`` and
  ``prefill_paged`` / ``decode_step_paged`` / ``verify_step_paged``
  against its Pallas kernels under the interpreter, logits within 1e-4
  (the reference's XLA twin of the paged kernels rounds the softmax
  weights to the bf16 cache dtype; ROADMAP.md fact 2).
* A reference checkpoint holding the new leaves (the MoE's 4-D expert
  leaves among them) reads back bit-exact."""

from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ops
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.models import build_model
from repro_torch.models.bridge import load_reference_checkpoint, params_from_numpy
from repro_torch.models.transformer import TransformerLM
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path

from _torch_ref import numpy_params, to_jax

ARCHS = ["granite-8b", "yi-34b", "qwen2.5-14b", "qwen3-32b", "paligemma-3b",
         "musicgen-medium", "dbrx-132b", "kimi-k2-1t-a32b"]
SERVED = ["qwen2.5-14b", "qwen3-32b"]
ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_cfg(arch, **kw):
    return replace(ref_smoke_config(arch), **{"kernel_mode": "xla", **kw})


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view({2: np.uint16, 4: np.uint32}[x.dtype.itemsize])


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# --------------------------------------------------------------------------
# registry, families, init
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_copies_the_reference_configs(arch):
    """Every field the port's ModelConfig has equals the reference's, at
    full width and at the smoke size; the family builds."""
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke_config(arch), ref_smoke_config(arch))):
        for f in fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), (arch, f.name)
    model = build_model(get_smoke_config(arch), device="cpu")
    assert isinstance(model.impl, TransformerLM) and model.supports_paged_decode


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("qwen2.5-14b", "bfloat16")])
def test_init_is_bitwise_the_reference(arch, dtype):
    """The port's draw of the seed's params equals the reference's, leaf
    for leaf and bit for bit (the QKV-bias and qk-norm leaves under the
    reference's names, zeros)."""
    ref = _ref_leaves(ref_build_model(_ref_cfg(arch, dtype=dtype)).init(
        jax.random.PRNGKey(1)))
    got = dict(flatten_with_path(build_model(get_smoke_config(arch).reduced(dtype=dtype),
                                             device="cpu").init(PRNGKey(1))))
    assert got.keys() == ref.keys()
    for path, want in ref.items():
        assert str(got[path].dtype).removeprefix("torch.") == str(want.dtype), path
        np.testing.assert_array_equal(_bits(got[path]), _bits(want), err_msg=path)
    c = get_smoke_config(arch)
    new = {"['blocks']['bq']", "['blocks']['bk']", "['blocks']['bv']"} if c.qkv_bias else set()
    new |= {"['blocks']['q_norm']", "['blocks']['k_norm']"} if c.qk_norm else set()
    assert new <= got.keys() and all(not got[p].any() for p in new)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

LOSS_CASES = [(a, False) for a in ARCHS] + [("paligemma-3b", True), ("musicgen-medium", True)]


@pytest.mark.parametrize("arch,embeds", LOSS_CASES)
def test_loss_fn_matches_reference(arch, embeds):
    cfg = get_smoke_config(arch)
    params = numpy_params(cfg, seed=5)
    batch = batch_at_step(DataConfig(seq_len=24, global_batch=3,
                                     vocab_size=min(cfg.vocab_size, 256), seed=2), 0)
    if embeds:
        rng = np.random.default_rng(9)
        batch["embeds"] = rng.standard_normal(
            (3, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    want = float(ref_build_model(_ref_cfg(arch)).loss_fn(
        to_jax(params), {k: jnp.asarray(v) for k, v in batch.items()}))
    got = build_model(cfg, device="cpu").loss_fn(params_from_numpy(params),
                                                 {k: _t(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * abs(want), (float(got), want)
    if embeds:  # the prefix moves the loss: the P rows are really read, then dropped
        plain = float(build_model(cfg, device="cpu").loss_fn(
            params_from_numpy(params),
            {k: _t(v) for k, v in batch.items() if k != "embeds"}))
        assert abs(plain - float(got)) > 1e-4


# --------------------------------------------------------------------------
# serving (qwen2.5: QKV biases; qwen3: qk-norm, H·dh != d_model)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=SERVED)
def served(request):
    arch = request.param
    cfg = get_smoke_config(arch)
    np_params = numpy_params(cfg, seed=3)
    return arch, cfg, params_from_numpy(np_params), to_jax(np_params)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_prefill_and_decode_step_match(served):
    arch, cfg, params, ref_params = served
    ref = ref_build_model(_ref_cfg(arch))
    model = build_model(cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    jl, jc = jax.jit(ref.prefill, static_argnums=2)(ref_params,
                                                     {"tokens": jnp.asarray(tokens)}, 16)
    tl, tc = model.prefill(params, {"tokens": _t(tokens)}, 16)
    _close(tl, jl)
    np.testing.assert_allclose(tc["k"].float().numpy(), np.asarray(jc["k"], np.float32),
                               rtol=2**-7, atol=ATOL)
    decode = jax.jit(ref.decode_step)
    for nxt in ([3, 4], [5, 6]):
        nxt = np.asarray(nxt, np.int32)
        jl, jc = decode(ref_params, jc, jnp.asarray(nxt))
        tl, tc = model.decode_step(params, tc, _t(nxt))
        _close(tl, jl)


def test_paged_prefill_decode_and_verify_match(served):
    """Bucket-padded prefills into a shuffled page table, then one decode
    step (a dead slot, a mid-page slot, a slot at capacity) and one
    3-token verify window, against the reference's Pallas kernels under
    the interpreter; every live page's entries within a bf16 ulp."""
    arch, cfg, params, ref_params = served
    ref = ref_build_model(_ref_cfg(arch))
    pallas = ref_build_model(_ref_cfg(arch, kernel_mode="pallas"))
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(1)
    ps, P = 8, 2
    bt = np.asarray([[4, 2], [1, 5], [3, 6], [0, 0]], np.int32)
    tcache = model.init_paged_cache(7, ps)
    jcache = ref.init_paged_cache(7, ps)
    ref_prefill, ref_insert = jax.jit(ref.prefill_paged), jax.jit(ref.insert_pages)
    for s, n in enumerate([5, 13, 16]):
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :n] = rng.integers(2, cfg.vocab_size, size=n)
        jl, jk, jv = ref_prefill(ref_params, jnp.asarray(prompt), jnp.int32(n))
        jcache = ref_insert(jcache, jk, jv, jnp.asarray(bt[s]))
        tl, tk, tv = model.prefill_paged(params, _t(prompt), n)
        model.insert_pages(tcache, tk, tv, _t(bt[s].astype(np.int64)))
        _close(tl, jl)
    np.testing.assert_allclose(tcache["k"].float().numpy(), np.asarray(jcache["k"], np.float32),
                               rtol=2**-7, atol=ATOL)
    lens = np.asarray([5, 13, 16, 0], np.int32)
    assert lens[2] == P * ps  # at capacity: its write lands on page 0
    tokens = np.asarray([7, 8, 9, 0], np.int32)
    window = rng.integers(2, cfg.vocab_size, size=(4, 3)).astype(np.int32)
    # both sides start each step from the port's cache (a prefilled value
    # near a bf16 rounding boundary may have landed one ulp apart)
    start = {n: t.clone() for n, t in tcache.items()}
    ops.set_interpret(True)
    try:
        jl, _ = jax.jit(pallas.decode_step_paged)(
            ref_params, {n: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                         for n, t in start.items()},
            jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(tokens))
        jv, jvc = jax.jit(pallas.verify_step_paged)(
            ref_params, {n: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                         for n, t in start.items()},
            jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(window))
    finally:
        ops.set_interpret(None)
    tl, _ = model.decode_step_paged(params, {n: t.clone() for n, t in start.items()},
                                    _t(bt), _t(lens), _t(tokens))
    live = lens > 0
    _close(tl[_t(live)], np.asarray(jl)[live])
    tv, tvc = model.verify_step_paged(params, {n: t.clone() for n, t in start.items()},
                                      _t(bt), _t(lens), _t(window))
    assert tv.shape == (4, 3, cfg.vocab_size)
    _close(tv[_t(live)], np.asarray(jv)[live])
    for name in ("k", "v"):  # pages 1..6 (page 0 takes the dead and overhanging writes)
        np.testing.assert_allclose(tvc[name][:, 1:].float().numpy(),
                                   np.asarray(jvc[name][:, 1:], np.float32),
                                   rtol=2.0**-8, atol=1e-6)


# --------------------------------------------------------------------------
# bridge and checkpoint
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SERVED + ["paligemma-3b", "dbrx-132b", "kimi-k2-1t-a32b"])
def test_reference_checkpoint_with_new_leaves_reads_bit_exact(arch, tmp_path):
    """bf16 params holding the QKV-bias or qk-norm leaves (or GeGLU's
    gate, or the MoE's router and [L, E, ...] expert leaves) through the
    bridge and through the reference checkpointer's on-disk layout: same
    keys, shapes and bits."""
    cfg = get_smoke_config(arch)
    ref = numpy_params(cfg, seed=4, dtype=jnp.bfloat16)
    want = {p: w for p, w in flatten_with_path(ref)}
    Checkpointer(tmp_path).save(2, {"params": to_jax(ref), "step": jnp.int32(2)})
    loaded = load_reference_checkpoint(tmp_path / "step_00000002")
    assert int(loaded["step"]) == 2
    for got_tree in (params_from_numpy(ref), loaded["params"]):
        got = dict(flatten_with_path(got_tree))
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert got[path].dtype == torch.bfloat16 and tuple(got[path].shape) == w.shape
            np.testing.assert_array_equal(_bits(got[path]), _bits(w), err_msg=path)
    blocks = ref["blocks"]
    assert ("bq" in blocks) == cfg.qkv_bias and ("q_norm" in blocks) == cfg.qk_norm
    moe = {"router", "we_gate", "we_up", "we_down"}
    if cfg.n_experts:
        assert moe <= blocks.keys() and "w_up" not in blocks
        assert blocks["we_down"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_ff, cfg.d_model)
    else:
        assert not moe & blocks.keys() and ("w_gate" in blocks) == (cfg.activation != "gelu")
