"""The shapes the port's kernels take since they were widened to the
reference wrappers' range, checked on the CPU through their plain versions
against the reference's oracles, twins and Pallas kernels (under the
interpreter):

* flash attention at head dim 256 (paligemma-3b's), GQA and a window:
  f32 within 1e-5;
* paged verify attention with T·G·dh above 1024 (GQA G = 8 at draft_len
  4, T = 5, dh 128; and dh 256): f32 within 1e-5 of the reference's twin
  (f32 pages, so the twin's softmax weights stay f32) and its Pallas kernel;
* subzo_perturb at r = 96 (above one shared-memory Σ of 64 x 64): f32
  within 1e-6, bf16 within 1 bf16 ulp of the reference's chain oracle.

The CUDA kernels are held against these plain versions at the same shapes
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import layers as ref_layers
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import subzo_perturb as tsub


@pytest.fixture
def force_interpret():
    ops.set_interpret(True)
    yield
    ops.set_interpret(None)


def _randn(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("B,S,T,H,KV,dh,window,q_offset", [
    (1, 40, 40, 4, 4, 256, 0, 0), (2, 33, 57, 4, 2, 256, 16, 24), (1, 9, 9, 2, 1, 200, 0, 0)])
def test_flash_plain_takes_head_dim_256(B, S, T, H, KV, dh, window, q_offset):
    q, k, v = _randn((B, S, H, dh), 1), _randn((B, T, KV, dh), 2), _randn((B, T, KV, dh), 3)
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 window=window, q_offset=q_offset)
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _paged(S, T, H, KV, dh, ps, pps, lengths, seed):
    rng = np.random.default_rng(seed)
    n_pages = S * pps + 1
    tables = (rng.permutation(n_pages - 1) + 1).astype(np.int32).reshape(S, pps)
    return (_randn((S, T, H, dh), seed, 0.3), _randn((n_pages, ps, KV, dh), seed + 1, 0.3),
            _randn((n_pages, ps, KV, dh), seed + 2, 0.3), tables,
            np.asarray(lengths, np.int32))


# T * G * dh: 5 * 8 * 128 = 5120 and 3 * 2 * 256 = 1536 (past 1024)
WIDE = [(3, 5, 16, 2, 128, 8, 6, [7, 33, 44]), (2, 3, 4, 2, 256, 4, 5, [1, 18])]


@pytest.mark.parametrize("S,T,H,KV,dh,ps,pps,lengths", WIDE)
def test_verify_plain_takes_wide_windows(S, T, H, KV, dh, ps, pps, lengths, force_interpret):
    args = _paged(S, T, H, KV, dh, ps, pps, lengths, seed=dh + T)
    got = tdec.paged_verify_attention(*(torch.from_numpy(a) for a in args)).numpy()
    twin = ref_layers.paged_verify_attention_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got, np.asarray(twin), rtol=0, atol=1e-5)
    pallas = ops.paged_verify_attention(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_subzo_plain_takes_rank_96(dtype):
    m, n, r, k = 70, 40, 96, 2
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((m, n)) * 0.1).astype(np.float32)
    u = (rng.standard_normal((m, r)) / np.sqrt(r)).astype(np.float32)
    v = (rng.standard_normal((n, r)) / np.sqrt(r)).astype(np.float32)
    sig = rng.standard_normal((k, r, r)).astype(np.float32)
    scales = [1e-2, -2e-2]
    tdt = getattr(torch, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got = tsub.subzo_perturb(torch.from_numpy(w.copy()).to(tdt), *(torch.from_numpy(a) for a in
                                                              (u, v, sig)), scales, decay=0.99)
    want = ref.subzo_chain_ref(jnp.asarray(w).astype(jdt), jnp.asarray(u), jnp.asarray(v),
                               jnp.asarray(sig), scales, 0.99)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= np.ldexp(1.0, e - 8))
