"""The port's MoE block (``TransformerLM._moe`` and ``moe_route``) against the
reference's single-device ``_moe_gspmd``, on the CPU, at the smoke configs
(dbrx-132b-smoke: 4 experts top-2; kimi-k2-smoke: 8 experts top-2), from the
same numpy inputs:

* at the default capacity factor (entries dropped), at 8.0 (none dropped),
  with a router of zeros (every probability ties: the reference's
  ``top_k`` routes every token to experts 0..K-1, and so must the port),
  in bf16, and with ``moe_impl="ep"`` and no mesh (the gspmd path, as in
  the reference).  The reference does not return its routing, so
  :func:`_ref_route` repeats its routing lines in jnp; the port's routing
  must equal it entry for entry and the outputs must agree;
* paged prefill and decode of dbrx-132b-smoke against the reference's
  paged path on its Pallas kernels under the interpreter (the decode
  step's four slots, a dead one among them, route under one capacity);
* ``LM.fo_loss_fn``'s gradients against ``jax.value_and_grad`` of the
  reference's loss, with at least two experts of layer 0 hit;
* ``ServeEngine`` refuses speculative decoding on a ``moe`` config."""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ops
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.utils.tree import flatten_with_path

from _torch_ref import numpy_params, to_jax

ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b"]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_route(router, xt, cfg):
    """The routing lines of the reference's ``_moe_gspmd``
    (repro/models/transformer.py), in jnp: expert ids, positions and the
    in-capacity mask per (token, k) entry, token-major."""
    N = xt.shape[0]
    E, K = cfg.n_experts, cfg.n_experts_per_token
    capacity = max(1, int(math.ceil(N * K / E * cfg.moe_capacity_factor)))
    probs = jax.nn.softmax((xt @ router).astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(probs, K)
    e_flat = eidx.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    return np.asarray(e_flat), np.asarray(pos), np.asarray((pos < capacity) & (pos >= 0))


# (arch, capacity factor, zero router, dtype, moe_impl)
MOE_CASES = [(a, None, False, "float32", "gspmd") for a in ARCHS] + [
    ("dbrx-132b", 8.0, False, "float32", "gspmd"),
    ("kimi-k2-1t-a32b", None, True, "float32", "gspmd"),
    ("dbrx-132b", None, False, "bfloat16", "gspmd"),
    ("dbrx-132b", None, False, "float32", "ep"),
]


@pytest.mark.parametrize("arch,factor,zero_router,dtype,impl", MOE_CASES)
def test_moe_matches_reference_gspmd(arch, factor, zero_router, dtype, impl):
    over = {"dtype": dtype, "moe_impl": impl}
    if factor is not None:
        over["moe_capacity_factor"] = factor
    cfg = get_smoke_config(arch).reduced(**over)
    ref_cfg = replace(ref_smoke_config(arch), kernel_mode="xla", **over)
    np_dtype = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    layer = {k: v[0] for k, v in numpy_params(cfg, seed=11, dtype=np_dtype)["blocks"].items()}
    if zero_router:
        layer["router"] = np.zeros_like(layer["router"])
    # tokens that share a component prefer the same experts, so the default
    # capacity drops entries, as a real batch's correlated tokens do
    rng = np.random.default_rng(12)
    h = rng.standard_normal((3, 16, cfg.d_model)) + 2.0 * rng.standard_normal(cfg.d_model)
    h = h.astype(np.float32).astype(np_dtype)

    ref_model = ref_build_model(ref_cfg)
    want = np.asarray(jax.jit(ref_model.impl._moe)(to_jax(layer), jnp.asarray(h)), np.float32)
    e_ref, pos_ref, cap_ref = _ref_route(jnp.asarray(layer["router"]),
                                         jnp.asarray(h).reshape(-1, cfg.d_model), cfg)
    model = build_model(cfg, device="cpu")
    p = params_from_numpy(layer)
    x = params_from_numpy({"h": h})["h"]
    got = model.impl._moe(p, x)
    route = model.impl.moe_route(p, x.reshape(-1, cfg.d_model))

    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(route.experts.numpy(), e_ref)
    np.testing.assert_array_equal(route.positions.numpy(), pos_ref)
    np.testing.assert_array_equal(route.in_capacity.numpy(), cap_ref)
    dropped = int((~cap_ref).sum())
    if factor == 8.0:
        assert dropped == 0
    else:  # the default factor (1.25) drops entries at these shapes
        assert dropped > 0
    if zero_router:  # every probability ties: experts 0..K-1, lower index first
        K = cfg.n_experts_per_token
        np.testing.assert_array_equal(e_ref.reshape(-1, K), np.tile(np.arange(K), (48, 1)))
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    if dtype == "bfloat16":  # one bf16 ulp of the output's scale
        atol = 2.0 ** (math.floor(math.log2(scale)) - 7)
    else:
        atol = 1e-5 * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if impl == "ep":  # the same function as the gspmd path
        gspmd = build_model(cfg.reduced(moe_impl="gspmd"), device="cpu").impl._moe(p, x)
        assert torch.equal(torch.from_numpy(got), gspmd)


# --------------------------------------------------------------------------
# paged serving
# --------------------------------------------------------------------------


def test_paged_prefill_and_decode_match_reference_pallas():
    """Bucket-padded prefills into a shuffled page table and two decode
    steps over four slots (a dead slot, a slot at capacity) against the
    reference's paged path on its interpreted Pallas kernels: logits within
    1e-4.  Each decode step's four tokens route under one capacity, the
    dead slot's token included, on both sides."""
    arch = "dbrx-132b"
    cfg = get_smoke_config(arch)
    np_params = numpy_params(cfg, seed=3)
    params, ref_params = params_from_numpy(np_params), to_jax(np_params)
    pallas = ref_build_model(replace(ref_smoke_config(arch), kernel_mode="pallas"))
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(1)
    ps = 8
    bt = np.asarray([[4, 2], [1, 5], [3, 6], [0, 0]], np.int32)
    tcache = model.init_paged_cache(7, ps)
    jcache = pallas.init_paged_cache(7, ps)
    ops.set_interpret(True)
    try:
        prefill, insert = jax.jit(pallas.prefill_paged), jax.jit(pallas.insert_pages)
        decode = jax.jit(pallas.decode_step_paged)
        for s, n in enumerate([5, 13, 15]):
            prompt = np.zeros((1, 16), np.int32)
            prompt[0, :n] = rng.integers(2, cfg.vocab_size, size=n)
            jl, jk, jv = prefill(ref_params, jnp.asarray(prompt), jnp.int32(n))
            jcache = insert(jcache, jk, jv, jnp.asarray(bt[s]))
            tl, tk, tv = model.prefill_paged(params, _t(prompt), n)
            model.insert_pages(tcache, tk, tv, _t(bt[s].astype(np.int64)))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
        lens = np.asarray([5, 13, 15, 0], np.int32)
        tokens = np.asarray([7, 8, 9, 0], np.int32)
        for _ in range(2):
            # both sides start each step from the port's cache (a prefilled
            # value near a bf16 rounding boundary may land one ulp apart)
            start = {n: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                     for n, t in tcache.items()}
            jl, _ = decode(ref_params, start, jnp.asarray(bt), jnp.asarray(lens),
                           jnp.asarray(tokens))
            tl, tcache = model.decode_step_paged(params, tcache, _t(bt), _t(lens), _t(tokens))
            live = lens > 0
            np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], rtol=0,
                                       atol=1e-4)
            tokens = np.where(live, np.argmax(np.asarray(jl), axis=-1), 0).astype(np.int32)
            lens = np.where(live, lens + 1, 0).astype(np.int32)
        # slot 2's second step wrote at position 16, its pages' capacity: the
        # write landed on the null page 0
        assert lens[2] == 2 * ps + 1
    finally:
        ops.set_interpret(None)


# --------------------------------------------------------------------------
# first-order loss
# --------------------------------------------------------------------------


def test_fo_loss_gradients_match_reference():
    """``fo_loss_fn`` with autograd through the dispatch scatter and the
    combine gather: the loss within 1e-5 relative and each leaf's gradient
    within 1e-5 of its largest |g|, and more than one expert of layer 0
    receives gradient (the reference's own test_models.py check)."""
    arch = "dbrx-132b"
    cfg = get_smoke_config(arch)
    np_params = numpy_params(cfg, seed=7)
    batch = batch_at_step(DataConfig(seq_len=24, global_batch=3, vocab_size=256, seed=2), 0)
    ref = ref_build_model(replace(ref_smoke_config(arch), kernel_mode="xla"))
    want_loss, want_g = jax.jit(jax.value_and_grad(ref.loss_fn))(
        to_jax(np_params), {k: jnp.asarray(v) for k, v in batch.items()})

    params = params_from_numpy(np_params)
    for w in flatten_with_path(params):
        w[1].requires_grad_(True)
    loss = build_model(cfg, device="cpu").fo_loss_fn(params, {k: _t(v) for k, v in batch.items()})
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    ref_g = {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_leaves_with_path(want_g)}
    for path, w in flatten_with_path(params):
        g, want = w.grad.numpy(), ref_g[path]
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=path)
    norms = np.sqrt((params["blocks"]["we_down"].grad[0].numpy() ** 2).sum(axis=(1, 2)))
    assert (norms > 1e-9).sum() >= 2, norms


def test_engine_refuses_spec_decode_on_moe():
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue C item 2"):
        ServeEngine(get_smoke_config("kimi-k2-1t-a32b"), device="cpu", spec_decode=True)
