"""The port's CUDA kernels, engine and trainer on the card: each kernel
against its plain PyTorch version on the same inputs, the serving engine
through the kernels, and the ZO step's chained == unchained contract.  Marked ``cuda``; every test skips where no card is present
(decided in the fixture, never at import time).  Run on a card with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX, which a card machine
serving the port need not have.)

Tolerances: attention f32 outputs within 1e-4 of the plain version (sums
in another order); bf16 outputs within 2 bf16 ulps (+1e-5) of the plain
version computed in f32 from the same bf16 inputs.  The weight-pass
kernels: f32 within 1e-5 of the plain version (the rank-r sums in another
order), bf16 within 1 bf16 ulp of the plain version on the same bf16
weights, the ulp taken at the larger of the results and the input weight.
The noise kernels do the plain version's arithmetic op for op, so z, the
perturbed W and the moments are bitwise the plain version's; only the Adam
step's rsqrt (the kernel's correctly rounded one, the plain version's
formed in f64 and rounded once) may put W an ulp apart, so W after an
Adam update is held to 1 f32 / bf16 ulp."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import dispatch, quant
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import quant_matmul as tqmm
from repro_torch.kernels import selective_scan as tscan
from repro_torch.kernels import subzo_perturb as tsub
from repro_torch.kernels import tezo_adam as tadam
from repro_torch.kernels import tezo_perturb as tpert
from repro_torch.kernels import zo_noise as tnoise
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import build_model
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path

pytestmark = pytest.mark.cuda

F32_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bf16_ok(got: torch.Tensor, ref_f32: torch.Tensor) -> bool:
    _, e = torch.frexp(ref_f32.abs())
    ulp = torch.ldexp(torch.ones_like(ref_f32), e - 8)  # bf16: 8 significant bits
    return bool(torch.all((got.float() - ref_f32).abs() <= 2 * ulp + 1e-5))


def _randn(shape, device, seed, scale=0.5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device)


FLASH_CASES = [
    # B, S, T, H, KV, dh, causal, window, q_offset
    (1, 200, 200, 12, 12, 64, True, 0, 0),
    (2, 37, 37, 4, 2, 40, True, 0, 0),
    (1, 24, 88, 6, 2, 128, True, 0, 64),
    (1, 130, 130, 4, 1, 16, True, 48, 0),
    (2, 20, 33, 2, 2, 8, False, 0, 0),
    # head dim 256 (paligemma-3b's; eight threads per row, 16-row K/V tiles)
    (1, 70, 70, 4, 2, 256, True, 0, 0),
    (2, 33, 57, 4, 2, 256, True, 16, 24),
    # hymba-1.5b's prefill past its 1024 window: 25 heads over 5 kv heads
    (1, 1100, 1100, 25, 5, 64, True, 1024, 0),
    # the dense configs' GQA at dh 128: granite-8b G = 4, qwen2.5-14b G = 5,
    # yi-34b G = 7
    (2, 256, 256, 32, 8, 128, True, 0, 0),
    (2, 256, 256, 40, 8, 128, True, 0, 0),
    (2, 256, 256, 56, 8, 128, True, 0, 0),
    # kimi-k2's 64 heads over 8 kv heads of 112: the first head dim that
    # fills its 128-wide instance only in part
    (2, 256, 256, 64, 8, 112, True, 0, 0),
]


@pytest.mark.parametrize("B,S,T,H,KV,dh,causal,window,q_offset", FLASH_CASES)
def test_flash_kernel_vs_plain(cuda, B, S, T, H, KV, dh, causal, window, q_offset):
    q = _randn((B, S, H, dh), cuda, 1)
    k = _randn((B, T, KV, dh), cuda, 2)
    v = _randn((B, T, KV, dh), cuda, 3)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    n = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == n + 1
    want = tflash.flash_attention_plain(q, k, v, **kw)
    assert (got - want).abs().max().item() <= F32_ATOL
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got_b = tflash.flash_attention(qb, kb, vb, **kw)
    assert got_b.dtype == torch.bfloat16
    assert _bf16_ok(got_b, tflash.flash_attention_plain(qb.float(), kb.float(), vb.float(), **kw))


# The bf16 kernel's tiles: 32 query rows a block (16 a warp), 64 kv rows a
# tile (32 above a head dim of 64).  S and T off the tile multiples, a window
# edge inside a tile, q_offset > 0, and head dims 32, 64, 128 and 256.
FLASH_TILE_CASES = [
    # B, S, T, H, KV, dh, causal, window, q_offset
    (1, 33, 33, 4, 4, 64, True, 0, 0),
    (2, 95, 95, 4, 2, 64, True, 0, 0),
    (1, 47, 129, 2, 1, 64, True, 0, 82),
    (1, 150, 150, 4, 2, 64, True, 40, 0),
    (1, 17, 100, 3, 1, 64, True, 37, 83),
    (2, 70, 70, 4, 2, 32, True, 21, 0),
    (1, 100, 163, 4, 4, 128, True, 50, 63),
    (1, 65, 65, 2, 2, 256, True, 0, 0),
    (1, 40, 97, 2, 1, 256, True, 33, 57),
    (1, 31, 45, 2, 2, 64, False, 0, 0),
    (1, 100, 163, 8, 1, 112, True, 50, 63),
    (2, 65, 65, 16, 2, 112, True, 0, 0),
]


@pytest.mark.parametrize("B,S,T,H,KV,dh,causal,window,q_offset", FLASH_TILE_CASES)
def test_flash_bf16_at_tile_boundaries(cuda, B, S, T, H, KV, dh, causal, window, q_offset):
    """The tensor-core kernel against its plain version (in f32 from the same
    bf16 inputs) within 2 bf16 ulps, where the q- and kv-tiles are ragged."""
    q, k, v = (_randn(shape, cuda, s).to(torch.bfloat16) for shape, s in
               (((B, S, H, dh), 11), ((B, T, KV, dh), 12), ((B, T, KV, dh), 13)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = tflash.flash_attention(q, k, v, **kw)
    assert _bf16_ok(got, tflash.flash_attention_plain(q.float(), k.float(), v.float(), **kw))


def test_flash_kernel_rows_are_independent(cuda):
    """A batch row's output is bitwise the same alone or next to another."""
    q, k, v = (_randn((2, 77, 4, 64), cuda, s) for s in (4, 5, 6))
    both = tflash.flash_attention(q, k, v)
    solo = tflash.flash_attention(q[1:].contiguous(), k[1:].contiguous(), v[1:].contiguous())
    assert torch.equal(both[1:], solo)


def test_flash_kernel_rejects_wide_heads(cuda):
    q = torch.zeros((1, 4, 2, 320), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(q, q, q)


SCAN_ATOL = 1e-5  # of the largest |y| (or |h|): expf against torch.exp in the last ulp
SCAN_CASES = [  # B, S, D, N: the training shape, ragged D and S, S = 1, N of 4 and 64
    (8, 128, 3200, 16), (2, 37, 100, 16), (3, 1, 100, 16), (1, 50, 24, 4), (2, 20, 70, 64),
    # N of 5, 32 and 64 at S = 1 and over several staged 16-step chunks with a
    # ragged last one; D not a multiple of 4 (the x and dt staging's 4-byte
    # copies); batches wide enough that the kernel gives a lane 2 or 4 states
    (2, 53, 100, 5), (1, 1, 3200, 32), (2, 70, 64, 32), (1, 33, 40, 64), (3, 1, 36, 64),
    (2, 49, 101, 16), (16, 40, 3200, 16), (8, 37, 3200, 16),
]


def _scan_inputs(B, S, D, N, cuda, seed):
    x = _randn((B, S, D), cuda, seed, 0.5)
    dt = torch.nn.functional.softplus(_randn((B, S, D), cuda, seed + 1, 1.0))
    a = -torch.exp(_randn((D, N), cuda, seed + 2, 0.3))
    b, c = _randn((B, S, N), cuda, seed + 3, 0.5), _randn((B, S, N), cuda, seed + 4, 0.5)
    h0 = _randn((B, D, N), cuda, seed + 5, 0.1)
    return x, dt, a, b, c, h0


@pytest.mark.parametrize("B,S,D,N", SCAN_CASES)
def test_scan_kernel_vs_plain(cuda, B, S, D, N):
    """y and h_last within 1e-5 of the largest |y| (expf against torch.exp
    in the last ulp); one launch per call, S = 1 included; two chained
    launches are bitwise one launch over the whole sequence."""
    args = _scan_inputs(B, S, D, N, cuda, seed=S + D)
    n0 = tscan.selective_scan.launches
    y, h = tscan.selective_scan(*args)
    torch.cuda.synchronize()
    assert tscan.selective_scan.launches == n0 + 1
    y_p, h_p = tscan.selective_scan_plain(*args)
    scale = max(1.0, y_p.abs().max().item())
    assert (y - y_p).abs().max().item() <= SCAN_ATOL * scale
    assert (h - h_p).abs().max().item() <= SCAN_ATOL * max(1.0, h_p.abs().max().item())
    if S > 1:
        x, dt, a, b, c, h0 = args
        cut = S // 3
        y1, h1 = tscan.selective_scan(x[:, :cut], dt[:, :cut], a, b[:, :cut], c[:, :cut], h0)
        y2, h2 = tscan.selective_scan(x[:, cut:], dt[:, cut:], a, b[:, cut:], c[:, cut:], h1)
        assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, h)


@pytest.mark.parametrize("N", [5, 16, 32, 64])
def test_scan_rows_are_bitwise_across_batches(cuda, N):
    """The kernel gives a lane 1, 2 or 4 states by the grid's size; every
    instance runs the same arithmetic, so a batch row scanned within a wide
    batch is bitwise that row scanned alone."""
    args = _scan_inputs(16, 40, 3200, N, cuda, seed=N)
    y, h = tscan.selective_scan(*args)
    x, dt, a, b, c, h0 = args
    for r in (0, 7, 15):
        y1, h1 = tscan.selective_scan(x[r:r + 1], dt[r:r + 1], a, b[r:r + 1], c[r:r + 1],
                                      h0[r:r + 1])
        assert torch.equal(y1[0], y[r]) and torch.equal(h1[0], h[r]), r


def test_scan_dispatch_launches_at_every_length(cuda):
    for S in (1, 5):
        args = _scan_inputs(2, S, 40, 16, cuda, seed=S)
        n0 = tscan.selective_scan.launches
        dispatch.selective_scan_fwd(*args)
        assert tscan.selective_scan.launches == n0 + 1


def _paged(cuda, S, H, KV, dh, ps, pps, lengths, seed):
    g = np.random.default_rng(seed)
    n_pages = S * pps + 1
    q = _randn((S, H, dh), cuda, seed, 0.3)
    kp = _randn((n_pages, ps, KV, dh), cuda, seed + 1, 0.3)
    vp = _randn((n_pages, ps, KV, dh), cuda, seed + 2, 0.3)
    bt = torch.from_numpy((g.permutation(n_pages - 1) + 1).astype(np.int32).reshape(S, pps))
    return q, kp, vp, bt.to(cuda), torch.tensor(lengths, dtype=torch.int32, device=cuda)


PAGED_CASES = [
    (8, 12, 12, 64, 16, 20, [0, 1, 16, 17, 250, 31, 0, 320]),
    (3, 8, 2, 40, 8, 3, [5, 24, 9]),
    (4, 4, 1, 128, 8, 2, [8, 16, 3, 0]),
    # slots at capacity (P*ps + 1, as decode_step_paged gives a full slot):
    # the kernel must stop at the slot's P pages, in the middle of the table
    # and in its last row
    (4, 8, 4, 64, 8, 3, [25, 7, 0, 25]),
    # the dense configs' GQA at dh 128 (G = 4, 5, 7), lengths across the
    # 64-position splits
    (6, 32, 8, 128, 16, 21, [0, 63, 64, 65, 200, 336]),
    (6, 40, 8, 128, 16, 21, [7, 63, 0, 129, 318, 336]),
    (6, 56, 8, 128, 16, 21, [1, 64, 130, 0, 250, 336]),
    # kimi-k2's G = 8 at dh 112
    (6, 64, 8, 112, 16, 21, [0, 63, 64, 65, 200, 336]),
]


@pytest.mark.parametrize("S,H,KV,dh,ps,pps,lengths", PAGED_CASES)
def test_paged_kernel_vs_plain(cuda, S, H, KV, dh, ps, pps, lengths):
    args = _paged(cuda, S, H, KV, dh, ps, pps, lengths, seed=S + dh)
    n = tdec.paged_decode_attention.launches
    got = tdec.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert tdec.paged_decode_attention.launches == n + 1
    want = tdec.paged_decode_attention_plain(*args)
    assert (got - want).abs().max().item() <= F32_ATOL
    dead = torch.tensor(lengths, device=cuda) == 0
    assert torch.all(got[dead] == 0)
    q, kp, vp, bt, lens = args
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, kp, vp))
    got_b = tdec.paged_decode_attention(qb, kb, vb, bt, lens)
    want_b = tdec.paged_decode_attention_plain(qb.float(), kb.float(), vb.float(), bt, lens)
    assert _bf16_ok(got_b, want_b)
    # f32 queries over a bf16 pool (an f32 model's cache)
    got_m = tdec.paged_decode_attention(q, kb, vb, bt, lens)
    want_m = tdec.paged_decode_attention_plain(q, kb, vb, bt, lens)
    assert (got_m - want_m).abs().max().item() <= F32_ATOL
    # a slot's output does not depend on the other slots
    solo = tdec.paged_decode_attention(q[1:2].contiguous(), kp, vp, bt[1:2].contiguous(),
                                       lens[1:2].contiguous())
    assert torch.equal(got[1:2], solo)


def test_engine_on_card_matches_cpu_and_uses_kernels(cuda):
    """The smoke engine in f32 on the card: the same greedy streams as on
    the CPU from the same weights, through both kernels, solo == mixed."""
    cfg = get_smoke_config("opt-125m")
    kw = dict(max_concurrent_decodes=3, max_prompt_len=16, max_new_tokens=8, page_size=8)
    cpu = ServeEngine(cfg, device="cpu", seed=1, **kw)
    gpu_params = {
        "embed": cpu.params["embed"].to(cuda),
        "blocks": {k: w.to(cuda) for k, w in cpu.params["blocks"].items()},
        "final_norm": cpu.params["final_norm"].to(cuda),
        "lm_head": cpu.params["lm_head"].to(cuda),
    }
    gpu = ServeEngine(cfg, gpu_params, device=cuda, **kw)
    gpu.warmup()
    rng = np.random.default_rng(0)
    reqs = [Request(id=f"r{i}", tokens=rng.integers(2, 256, size=n).astype(np.int32),
                    max_new=6, arrival=a)
            for i, (n, a) in enumerate(zip((5, 8, 13, 16, 3), (0, 0, 0, 1, 4)))]
    nf, nd = tflash.flash_attention.launches, tdec.paged_decode_attention.launches
    res_gpu, stats = gpu.serve(reqs, step_clock=True)
    assert tflash.flash_attention.launches - nf == cfg.n_layers * len(reqs)
    assert tdec.paged_decode_attention.launches - nd == cfg.n_layers * stats["decode_steps"]
    res_cpu, _ = cpu.serve(reqs, step_clock=True)
    for r in reqs:
        np.testing.assert_array_equal(res_gpu[r.id]["tokens"], res_cpu[r.id]["tokens"])
        solo, _ = gpu.serve([Request(id="s", tokens=r.tokens, max_new=6)], step_clock=True)
        np.testing.assert_array_equal(solo["s"]["tokens"], res_gpu[r.id]["tokens"])


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_engine_and_step_on_card_match_cpu(cuda, arch):
    """An MoE smoke model in f32 from the same weights: the engine's greedy
    streams on the card equal the CPU's under the same schedule (routing
    couples a call's tokens, so solo == mixed is not the bar), through both
    attention kernels; one TeZO-Adam step's loss within 1e-5 relative and
    params within 1e-5, its expert leaves through the weight kernels."""
    from repro_torch.utils.tree import map_with_path

    cfg = get_smoke_config(arch)
    kw = dict(max_concurrent_decodes=3, max_prompt_len=16, max_new_tokens=8, page_size=8)
    cpu = ServeEngine(cfg, device="cpu", seed=1, **kw)
    gpu = ServeEngine(cfg, map_with_path(lambda _, w: w.to(cuda), cpu.params), device=cuda, **kw)
    rng = np.random.default_rng(0)
    reqs = [Request(id=f"r{i}", tokens=rng.integers(2, 256, size=n).astype(np.int32),
                    max_new=6, arrival=a)
            for i, (n, a) in enumerate(zip((5, 8, 13, 16, 3), (0, 0, 0, 1, 4)))]
    gpu.warmup()
    nf, nd = tflash.flash_attention.launches, tdec.paged_decode_attention.launches
    res_gpu, stats = gpu.serve(reqs, step_clock=True)
    assert tflash.flash_attention.launches - nf == cfg.n_layers * len(reqs)
    assert tdec.paged_decode_attention.launches - nd == cfg.n_layers * stats["decode_steps"]
    res_cpu, _ = cpu.serve(reqs, step_clock=True)
    for r in reqs:
        np.testing.assert_array_equal(res_gpu[r.id]["tokens"], res_cpu[r.id]["tokens"])

    zc = ZOConfig(method="tezo_adam", rank=8, lr=1e-3)
    batch = batch_at_step(DataConfig(seq_len=32, global_batch=4, vocab_size=256), 0)
    out = {}
    for dev, params in (("cpu", cpu.params), (cuda, gpu.params)):
        model = build_model(cfg, dev)
        state = init_zo_state(map_with_path(lambda _, w: w.clone(), params), zc)
        n0 = tadam.tezo_adam_update.launches
        state, metrics = build_zo_train_step(model.loss_fn, zc)(
            state, {k: torch.from_numpy(x).to(dev) for k, x in batch.items()})
        out[str(dev)] = (float(metrics["loss"]), dict(flatten_with_path(state.params)),
                         tadam.tezo_adam_update.launches - n0, set(state.mstate["factors"]))
    (lc, pc, _, _), (lg, pg, n_adam, lowrank) = out["cpu"], out[str(cuda)]
    assert n_adam == len(lowrank) and {f"['blocks']['{n}']" for n in
                                       ("we_gate", "we_up", "we_down")} <= lowrank
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for path, w in pg.items():
        assert (w.cpu() - pc[path]).abs().max().item() <= 1e-5, path


# --------------------------------------------------------------------------
# the weight-pass kernels and the ZO step
# --------------------------------------------------------------------------


def _within_bf16_ulp(got: torch.Tensor, want: torch.Tensor, w_in: torch.Tensor) -> bool:
    """1 bf16 ulp at the larger of the results and the input weight (an
    update that cancels W to ~0 keeps the absolute rounding of its inputs)."""
    got, want = got.float(), want.float()
    mag = torch.maximum(torch.maximum(got.abs(), want.abs()), w_in.float().abs())
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    return bool(torch.all((got - want).abs() <= ulp))


# hymba-1.5b's low-rank leaves at rank 24, the layer axis cut to 2: a_log
# (r = 16), w_dt1, w_dt2, w_bc, GQA wk / wv, a [L, D] norm scale, and the
# odd-n embedding and lm_head at full size
HYMBA_LEAVES = [((2, 3200, 16), 16), ((2, 3200, 100), 24), ((2, 100, 3200), 24),
                ((2, 3200, 32), 24), ((2, 1600, 320), 24), ((32, 1600), 24),
                ((32001, 1600), 24), ((1600, 32001), 24)]
# the dense configs' new leaf shapes: the stacked [L, H·dh] / [L, KV·dh]
# QKV biases and [L, dh] qk-norm scales (at L = 2, as phase 2 of
# chip_smoke.py cuts them, and at full depth, where they are low-rank leaves
# of rank 24), and qwen3-32b's [5120, 8192] projection
DENSE_LEAVES = [((2, 5120), 2), ((2, 1024), 2), ((2, 128), 2), ((48, 5120), 24),
                ((48, 1024), 24), ((64, 128), 24), ((5120, 8192), 24)]
# the MoE leaves: expert leaves with two batch dims (L, E), [L, E, D, F] and
# [L, E, F, D] (rows and columns off the tile multiples in one), and a
# router [L, D, E] of kimi-k2's 384 experts
MOE_LEAVES = [((2, 16, 96, 200), 24), ((2, 16, 200, 96), 24), ((1, 6, 130, 257), 12),
              ((2, 7168, 384), 24)]
# xlstm-350m's new leaf shapes: w_if [2048, 8] at r = 8 (n = r = 8, its
# rank 24 capped by n), the 4-head smoke model's w_if [64, 8], and the
# batched sLSTM recurrence r_h [4, 256, 1024]
XLSTM_LEAVES = [((2048, 8), 8), ((64, 8), 8), ((4, 256, 1024), 24)]
TEZO_CASES = [  # W shape, r
    ((50, 40), 8), ((3, 70, 200), 24), ((12, 130), 12), ((24, 32), 1), ((130, 257), 128),
] + HYMBA_LEAVES + DENSE_LEAVES + MOE_LEAVES + XLSTM_LEAVES


@pytest.mark.parametrize("shape,r", TEZO_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tezo_kernels_vs_plain(cuda, shape, r, dtype):
    *batch, m, n = shape
    w = _randn(shape, cuda, 1, 0.1).to(dtype)
    u, v = _randn((*batch, m, r), cuda, 2, 1.0), _randn((*batch, n, r), cuda, 3, 1.0)
    taus = _randn((*batch, 3, r), cuda, 4, 1.0)
    tm, tv = _randn((*batch, r), cuda, 5, 0.3), _randn((*batch, r), cuda, 6, 0.3) ** 2
    scales = [1e-3, -2e-3, 1e-3]

    def close(got, want):
        if dtype == torch.float32:
            return (got - want).abs().max().item() <= 1e-5
        return _within_bf16_ulp(got, want, w)

    for k in (1, 2, 3):
        n0 = tpert.tezo_perturb.launches
        got = tpert.tezo_perturb(w.clone(), u, v, taus[..., :k, :].contiguous(), scales[:k],
                                 decay=0.99)
        torch.cuda.synchronize()
        assert tpert.tezo_perturb.launches == n0 + 1
        want = tpert.tezo_perturb_plain(w.clone(), u, v, taus[..., :k, :], scales[:k],
                                        decay=0.99)
        assert close(got, want), k
    for tau_r in (None, taus[..., :1, :].contiguous()):
        rs = [] if tau_r is None else [1e-3]
        n0 = tadam.tezo_adam_update.launches
        got = tadam.tezo_adam_update(w.clone(), u, v, tm, tv, 1e-3, 1e-5, tau_r=tau_r,
                                     restore_scale=rs)
        torch.cuda.synchronize()
        assert tadam.tezo_adam_update.launches == n0 + 1
        want = tadam.tezo_adam_update_plain(w.clone(), u, v, tm, tv, 1e-3, 1e-5,
                                            tau_r=tau_r, restore_scale=rs)
        assert close(got, want)
    # the restore folded into the Adam launch is bitwise the perturb launch
    # followed by the Adam launch; out= leaves W untouched
    fused = tadam.tezo_adam_update(w.clone(), u, v, tm, tv, 1e-3, 1e-5,
                                   tau_r=taus[..., :1, :].contiguous(), restore_scale=[1e-3])
    two = tadam.tezo_adam_update(
        tpert.tezo_perturb(w.clone(), u, v, taus[..., :1, :].contiguous(), [1e-3]),
        u, v, tm, tv, 1e-3, 1e-5)
    assert torch.equal(fused, two)
    chain = taus[..., :2, :].contiguous()  # a two-delta restore chain
    fused2 = tadam.tezo_adam_update(w.clone(), u, v, tm, tv, 1e-3, 1e-5, tau_r=chain,
                                    restore_scale=[1e-3, -2e-3])
    three = tadam.tezo_adam_update(tpert.tezo_perturb(w.clone(), u, v, chain, [1e-3, -2e-3]),
                                   u, v, tm, tv, 1e-3, 1e-5)
    assert torch.equal(fused2, three)
    out = torch.empty_like(w)
    before = w.clone()
    tpert.tezo_perturb(w, u, v, taus[..., :2, :].contiguous(), scales[:2], out=out)
    assert torch.equal(w, before)


SUBZO_CASES = [  # W shape, r; r = 96 and 130 stage Σ in column chunks
    ((50, 40), 8), ((3, 70, 200), 24), ((12, 130), 12), ((24, 32), 1), ((130, 257), 64),
    ((200, 257), 96), ((2, 300, 140), 130),
] + HYMBA_LEAVES


def _orthonormal(shape, device, seed):
    return torch.linalg.qr(_randn(shape, "cpu", seed, 1.0)).Q.contiguous().to(device)


@pytest.mark.parametrize("shape,r", SUBZO_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subzo_kernel_vs_plain(cuda, shape, r, dtype):
    """k = 1, 2, 3 (a decay on the last) against the plain version; a chain
    is bitwise its deltas' single launches; out= leaves W untouched."""
    *batch, m, n = shape
    w = _randn(shape, cuda, 1, 0.1).to(dtype)
    u, v = _orthonormal((*batch, m, r), cuda, 2), _orthonormal((*batch, n, r), cuda, 3)
    sig = _randn((*batch, 3, r, r), cuda, 4, 1.0)
    scales = [1e-3, -2e-3, 1e-3]
    for k in (1, 2, 3):
        n0 = tsub.subzo_perturb.launches
        sk = sig[..., :k, :, :].contiguous()
        got = tsub.subzo_perturb(w.clone(), u, v, sk, scales[:k], decay=0.99)
        torch.cuda.synchronize()
        assert tsub.subzo_perturb.launches == n0 + 1
        want = tsub.subzo_perturb_plain(w.clone(), u, v, sk, scales[:k], decay=0.99)
        if dtype == torch.float32:
            assert (got - want).abs().max().item() <= 1e-5, k
        else:
            assert _within_bf16_ulp(got, want, w), k
        single = w.clone()
        for s in range(k):
            single = tsub.subzo_perturb(single, u, v, sig[..., s:s + 1, :, :].contiguous(),
                                        [scales[s]], decay=0.99 if s == k - 1 else None)
        assert torch.equal(got, single), k
    out = torch.empty_like(w)
    before = w.clone()
    tsub.subzo_perturb(w, u, v, sig[..., :2, :, :].contiguous(), scales[:2], out=out)
    assert torch.equal(w, before)


def test_subzo_kernel_rejects_bad_operands(cuda):
    w = torch.zeros(16, 16, device=cuda)
    u = torch.zeros(16, 4097, device=cuda)
    with pytest.raises(ValueError, match="r <= 4096"):
        tsub.subzo_perturb(w, u, u, torch.zeros(1, 4097, 4097, device=cuda), [1.0])
    u = torch.zeros(16, 4, device=cuda)
    with pytest.raises(ValueError, match="sigmas"):
        tsub.subzo_perturb(w, u, u, torch.zeros(2, 4, 4, device=cuda), [1.0])


# the weight passes' rank chunks (32 columns) and factor copies (16-byte
# where r % 4 == 0, else 4-byte) on rows that take the 16-byte W path
# (264 bf16 columns) and rows that do not (257); 1, 2, 3 and 7 are ranks
# Eq. 7 selects (r = 1 for every leaf of full-width opt-125m)
RANK_SWEEP = [1, 2, 3, 7, 12, 24, 33, 64, 65, 96, 130]


@pytest.mark.parametrize("r", RANK_SWEEP)
@pytest.mark.parametrize("shape", [(2, 150, 264), (130, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_kernels_across_ranks(cuda, r, shape, dtype):
    """tezo_adam_update (restores of 0, 1 and 2 deltas) and subzo_perturb
    (k = 1, 2) against their plain versions; the folded restore bitwise
    the perturb launch then the Adam launch, SubZO's chain bitwise its
    single launches, and out= leaving W untouched, for each."""
    *batch, m, n = shape
    w = _randn(shape, cuda, 11, 0.1).to(dtype)
    u, v = _randn((*batch, m, r), cuda, 12, 1.0), _randn((*batch, n, r), cuda, 13, 1.0)
    taus = _randn((*batch, 2, r), cuda, 14, 1.0)
    tm, tv = _randn((*batch, r), cuda, 15, 0.3), _randn((*batch, r), cuda, 16, 0.3) ** 2
    uo, vo = _orthonormal((*batch, m, r), cuda, 17), _orthonormal((*batch, n, r), cuda, 18)
    sig = _randn((*batch, 2, r, r), cuda, 19, 1.0)
    scales = [1e-3, -2e-3]

    def close(got, want):
        if dtype == torch.float32:
            return (got - want).abs().max().item() <= 1e-5
        return _within_bf16_ulp(got, want, w)

    for k in (0, 1, 2):
        tr = taus[..., :k, :].contiguous() if k else None
        got = tadam.tezo_adam_update(w.clone(), u, v, tm, tv, 1e-3, 1e-5, tau_r=tr,
                                     restore_scale=scales[:k])
        want = tadam.tezo_adam_update_plain(w.clone(), u, v, tm, tv, 1e-3, 1e-5, tau_r=tr,
                                            restore_scale=scales[:k])
        assert close(got, want), k
        if k:
            two = tadam.tezo_adam_update(tpert.tezo_perturb(w.clone(), u, v, tr, scales[:k]),
                                         u, v, tm, tv, 1e-3, 1e-5)
            assert torch.equal(got, two), k
    for k in (1, 2):
        sk = sig[..., :k, :, :].contiguous()
        got = tsub.subzo_perturb(w.clone(), uo, vo, sk, scales[:k], decay=0.99)
        want = tsub.subzo_perturb_plain(w.clone(), uo, vo, sk, scales[:k], decay=0.99)
        assert close(got, want), k
        single = w.clone()
        for s in range(k):
            single = tsub.subzo_perturb(single, uo, vo, sig[..., s:s + 1, :, :].contiguous(),
                                        [scales[s]], decay=0.99 if s == k - 1 else None)
        assert torch.equal(got, single), k
    before, out = w.clone(), torch.empty_like(w)
    tadam.tezo_adam_update(w, u, v, tm, tv, 1e-3, 1e-5, tau_r=taus, restore_scale=scales,
                           out=out)
    tsub.subzo_perturb(w, uo, vo, sig, scales, out=out)
    assert torch.equal(w, before)


@pytest.mark.parametrize("shape,r", [((50, 40), 8), ((3, 70, 200), 24), ((12, 130), 12),
                                     ((130, 257), 24), ((2, 300, 256), 24), ((130, 257), 1),
                                     ((2, 150, 264), 2), ((12, 130), 3), ((3, 70, 200), 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lozo_chain_kernel_is_single_passes(cuda, shape, r, dtype):
    """LOZO's chain on the tezo_perturb kernel, k = 2 and 3, each delta over
    its own r columns: bitwise its k = 1 launches, bitwise the chain widened
    to k·r columns with a one-hot τ (exact zeros outside each delta's
    block), and close to the plain version; over several row and column
    tiles, with rows of 16-byte multiples and not."""
    *batch, m, n = shape
    w = _randn(shape, cuda, 1, 0.1).to(dtype)
    u = _randn((*batch, m, r), cuda, 2, 1.0)
    vs = [_randn((*batch, n, r), cuda, 3 + i, 1.0) for i in range(3)]
    scales = [1e-3, -2e-3, 1e-3]
    for k in (2, 3):
        n0 = tpert.tezo_perturb.launches
        got = tpert.lozo_chain_k(w.clone(), u, vs[:k], scales[:k], decay=0.99)
        torch.cuda.synchronize()
        assert tpert.tezo_perturb.launches == n0 + 1
        single = w.clone()
        for s in range(k):
            single = tpert.lozo_chain_k(single, u, [vs[s]], [scales[s]],
                                        decay=0.99 if s == k - 1 else None)
        assert torch.equal(got, single), k
        taus = torch.eye(k, device=cuda)[:, :, None].expand(k, k, r).reshape(k, k * r)
        widened = tpert.tezo_perturb(w.clone(), torch.cat([u] * k, dim=-1).contiguous(),
                                     torch.cat(vs[:k], dim=-1).contiguous(),
                                     taus.expand(*batch, k, k * r).contiguous(), scales[:k],
                                     decay=0.99)
        assert torch.equal(got, widened), k
        want = tpert.lozo_chain_plain(w.clone(), u, vs[:k], scales[:k], decay=0.99)
        if dtype == torch.float32:
            assert (got - want).abs().max().item() <= 1e-5, k
        else:
            assert _within_bf16_ulp(got, want, w), k


# and hymba-1.5b's leaves with the layer axis cut to 2 (the full-size
# embedding and lm_head run in chip_smoke.py's Hymba weight-pass phase)
NOISE_SHAPES = [(50, 40), (3, 24, 137), (2, 2, 16, 36), (12, 768), (2, 3200, 16),
                (2, 3200, 100), (2, 100, 3200), (2, 3200, 32), (2, 1600, 320), (32, 1600)]


def _ulp_close(got: torch.Tensor, want: torch.Tensor, w_in: torch.Tensor) -> bool:
    if got.dtype == torch.bfloat16:
        return _within_bf16_ulp(got, want, w_in)
    return bool(torch.all((got - want).abs() <= torch.finfo(torch.float32).eps
                          * torch.maximum(got.abs(), want.abs())))


@pytest.mark.parametrize("shape", NOISE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_kernels_vs_plain(cuda, shape, dtype):
    seed = tnoise.leaf_seed(PRNGKey(3), "['blocks']['wq']")
    z = tnoise.noise_perturb(torch.zeros(shape, device=cuda), seed, [2], [1.0])
    assert torch.equal(z, tnoise.noise_perturb_plain(torch.zeros(shape, device=cuda), seed,
                                                     [2], [1.0]))
    w = _randn(shape, cuda, 1, 0.1).to(dtype)
    probes, scales = [0, 1, 2], [1e-3, -2e-3, 1e-3]
    for k in (1, 2, 3):
        n0 = tnoise.noise_perturb.launches
        got = tnoise.noise_perturb(w.clone(), seed, probes[:k], scales[:k])
        torch.cuda.synchronize()
        assert tnoise.noise_perturb.launches == n0 + 1
        assert torch.equal(got, tnoise.noise_perturb_plain(w.clone(), seed, probes[:k],
                                                           scales[:k])), k
    kap = torch.tensor([0.7, -1.3, 0.4], device=cuda)
    m0, v0 = _randn(shape, cuda, 2, 0.01), _randn(shape, cuda, 3, 0.1) ** 2
    for variant in tnoise.VARIANTS:
        # the kernel reuses the last restore probe's draw when g takes that
        # probe too; the last two cases restore a chain that ends inside and
        # outside g's probes
        for q, rp, decay in ((1, [], None), (1, [0], 0.99), (3, [], 0.99), (3, [2], 0.99),
                             (2, [3, 0], None), (3, [1, 4], 0.99)):
            outs = []
            for fn in (tnoise.noise_update, tnoise.noise_update_plain):
                outs.append(fn(w.clone(), seed, kap[:q], variant, 1e-3, 0.9, 0.99, 1e-5,
                               decay=decay, m_buf=m0.clone(), v_buf=v0.clone(),
                               restore_probes=rp, restore_scales=[1e-3] * len(rp)))
            got, want = outs
            what = (variant, q)
            assert len(got) == len(want), what
            if variant == "adam":
                assert _ulp_close(got[0], want[0], w), what
            else:
                assert torch.equal(got[0], want[0]), what
            for a, b in zip(got[1:], want[1:]):
                assert torch.equal(a, b), what
    # moments not 16-byte aligned move column by column, as a ragged row does
    shifted = [torch.empty(t.numel() + 1, device=cuda)[1:].view(shape).copy_(t) for t in (m0, v0)]
    got = tnoise.noise_update(w.clone(), seed, kap[:1], "adam", 1e-3, 0.9, 0.99, 1e-5,
                              m_buf=shifted[0], v_buf=shifted[1], restore_probes=[0],
                              restore_scales=[1e-3])
    want = tnoise.noise_update_plain(w.clone(), seed, kap[:1], "adam", 1e-3, 0.9, 0.99, 1e-5,
                                     m_buf=m0.clone(), v_buf=v0.clone(), restore_probes=[0],
                                     restore_scales=[1e-3])
    assert _ulp_close(got[0], want[0], w) and all(torch.equal(a, b)
                                                  for a, b in zip(got[1:], want[1:]))
    # restore-into-update is bitwise a perturb launch then an update launch
    fused = tnoise.noise_update(w.clone(), seed, kap[:2], "adam", 1e-3, 0.9, 0.99, 1e-5,
                                m_buf=m0.clone(), v_buf=v0.clone(), restore_probes=[1],
                                restore_scales=[1e-3])
    two = tnoise.noise_update(tnoise.noise_perturb(w.clone(), seed, [1], [1e-3]), seed,
                              kap[:2], "adam", 1e-3, 0.9, 0.99, 1e-5, m_buf=m0.clone(),
                              v_buf=v0.clone())
    assert all(torch.equal(a, b) for a, b in zip(fused, two))
    out = torch.empty_like(w)
    before = w.clone()
    tnoise.noise_perturb(w, seed, [0, 1], scales[:2], out=out)
    assert torch.equal(w, before) and not torch.equal(out, before)


def test_noise_perturb_large_leaf_is_the_stream(cuda):
    """On zeros at scale 1 the perturbed leaf is z itself: a leaf of more
    than 2^24 elements with an odd row length (most threads' four columns
    unaligned, a ragged end on every row) is bitwise the plain stream."""
    seed = tnoise.leaf_seed(PRNGKey(5), "['embed']")
    for probes, scales in (([0], [1.0]), ([3, 1], [1.0, 1.0])):
        got = tnoise.noise_perturb(torch.zeros(4100, 4099, device=cuda), seed, probes, scales)
        want = tnoise.noise_perturb_plain(torch.zeros(4100, 4099, device=cuda), seed, probes,
                                          scales)
        assert got.numel() > 1 << 24 and torch.equal(got, want), probes


def test_noise_draw_where_u1_rounds_to_one(cuda):
    """Once in 2^24 draws the counter's top 24 bits are all set, u1 rounds
    to 1 and Box-Muller's radius is sqrt(-2 log 1) = sqrt(-0): z = 0 there,
    as in the plain stream (a Newton step from rsqrt(-0) would give NaN)."""
    seed = tnoise.leaf_seed(PRNGKey(6), "['lm_head']")
    for probe in range(32):
        want = tnoise.noise_perturb_plain(torch.zeros(4100, 4099, device=cuda), seed, [probe],
                                          [1.0])
        if bool((want == 0).any()):
            got = tnoise.noise_perturb(torch.zeros(4100, 4099, device=cuda), seed, [probe],
                                       [1.0])
            assert torch.equal(got, want), probe
            return
    pytest.fail("no draw with u1 = 1 in 32 probes of 16.8 M elements")


@pytest.mark.parametrize("shape", [(50, 40), (3, 24, 137), (12, 768), (2, 3200, 16),
                                   (2048, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_kernels_on_unaligned_leaf(cuda, shape, dtype):
    """A leaf that starts one element into its buffer (not 8-byte aligned)
    takes the scalar accesses, with the same bits as the plain version."""
    seed = tnoise.leaf_seed(PRNGKey(4), "['blocks']['w_up']")
    n = math.prod(shape)
    w = _randn(shape, cuda, 6, 0.1).to(dtype)

    def shifted(t):
        return torch.empty(n + 1, dtype=t.dtype, device=cuda)[1:].view(shape).copy_(t)

    probes, scales = [0, 1, 2], [1e-3, -2e-3, 1e-3]
    for k in (1, 2, 3):
        x = shifted(w)
        assert x.data_ptr() % 8 != 0
        got = tnoise.noise_perturb(x, seed, probes[:k], scales[:k])
        assert torch.equal(got, tnoise.noise_perturb_plain(w.clone(), seed, probes[:k],
                                                           scales[:k])), k
        out = shifted(torch.zeros_like(w))
        tnoise.noise_perturb(w, seed, probes[:k], scales[:k], out=out)
        assert torch.equal(out, got), k
    kap = torch.tensor([0.7], device=cuda)
    m0, v0 = _randn(shape, cuda, 2, 0.01), _randn(shape, cuda, 3, 0.1) ** 2
    got = tnoise.noise_update(shifted(w), seed, kap, "adam", 1e-3, 0.9, 0.99, 1e-5,
                              m_buf=shifted(m0), v_buf=shifted(v0), restore_probes=[0],
                              restore_scales=[1e-3])
    want = tnoise.noise_update_plain(w.clone(), seed, kap, "adam", 1e-3, 0.9, 0.99, 1e-5,
                                     m_buf=m0.clone(), v_buf=v0.clone(), restore_probes=[0],
                                     restore_scales=[1e-3])
    assert _ulp_close(got[0], want[0], w) and all(torch.equal(a, b)
                                                  for a, b in zip(got[1:], want[1:]))


def test_noise_kernels_reject_bad_operands(cuda):
    seed = (1, 2)
    w = torch.zeros(16, 16, device=cuda)
    with pytest.raises(ValueError):
        tnoise.noise_perturb(w.t(), seed, [0], [1.0])  # not contiguous
    with pytest.raises(ValueError):
        tnoise.noise_update(w, seed, torch.ones(1), "adam", 1e-3,
                            m_buf=torch.zeros(16, 16, device=cuda))


def _card_run(cuda, method, q, mode, dtype, steps=3):
    model = build_model(get_smoke_config("opt-125m").reduced(dtype=dtype), cuda)
    zc = ZOConfig(method=method, q_probes=q, restore_mode=mode, rank=8, lr=1e-2,
                  lazy_interval=2)
    state = init_zo_state(model.init(PRNGKey(0)), zc)
    step = build_zo_train_step(model.loss_fn, zc)
    data = DataConfig(seq_len=32, global_batch=4, vocab_size=256)
    for s in range(steps):
        batch = {k: torch.from_numpy(x).to(cuda) for k, x in batch_at_step(data, s).items()}
        state, _ = step(state, batch)
    return state


@pytest.mark.parametrize("method", ["tezo", "tezo_m", "tezo_adam", "mezo", "mezo_m",
                                    "mezo_adam", "lozo", "lozo_m", "subzo"])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_equals_unchained_on_card(cuda, method, q, dtype):
    """3 steps; the low-rank methods refresh their subspace at step 2."""
    kernel = (tnoise.noise_perturb if method.startswith("mezo") else
              tsub.subzo_perturb if method == "subzo" else tpert.tezo_perturb)
    n0 = kernel.launches
    a = _card_run(cuda, method, q, "inplace", dtype)
    assert kernel.launches > n0
    b = _card_run(cuda, method, q, "unchained", dtype)
    for name, w in a.params["blocks"].items():
        assert torch.equal(w, b.params["blocks"][name]), name
    for name in ("embed", "lm_head", "final_norm"):
        assert torch.equal(a.params[name], b.params[name]), name
    fb = dict(flatten_with_path(b.mstate))
    for path, t in flatten_with_path(a.mstate):
        if isinstance(t, torch.Tensor):
            assert torch.equal(t, fb[path]), path
        else:
            assert np.array_equal(t, fb[path]), path


# The largest |W_card - W_cpu| a leaf may show after test_lowrank_card_matches_cpu's
# three steps, as a fraction of how far those steps moved it on the CPU: a few
# times the largest seen on the card (H100 80GB HBM3, 700 W: LOZO 1.11e-4 on wq,
# LOZO-m 1.31e-4 on wv, SubZO 1.93e-3 on the embedding, whose orthonormal
# factors move it least).
LOWRANK_CARD_CPU_MOVE_FRAC = {"lozo": 5e-4, "lozo_m": 5e-4, "subzo": 5e-3}


@pytest.mark.parametrize("method", ["lozo", "lozo_m", "subzo"])
def test_lowrank_card_matches_cpu(cuda, method):
    """Three f32 steps at lr 1e-3 across a window boundary on the card (the
    kernels, the device draws and QR) and on the CPU (their plain
    versions).  κ carries the forwards' rounding into the update amplified
    by 1/(2ρ), and LOZO's unnormalized U·Vᵀ moves W by ~√r·κ·lr, so each
    leaf's gap is held to a fraction of its own movement."""
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        model = build_model(get_smoke_config("opt-125m"), dev)
        zc = ZOConfig(method=method, lr=1e-3, rank=8, lazy_interval=2)
        state = init_zo_state(model.init(PRNGKey(0)), zc)
        init = {p: w.cpu().clone() for p, w in flatten_with_path(state.params)}
        step = build_zo_train_step(model.loss_fn, zc)
        losses = []
        for s in range(3):
            batch = {k: torch.from_numpy(x).to(dev) for k, x in
                     batch_at_step(DataConfig(seq_len=32, global_batch=4, vocab_size=256),
                                   s).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        runs[dev.type] = (state, losses, init)
    (g, lg, _), (c, lc, init) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    pc = dict(flatten_with_path(c.params))
    ratios = {}
    for path, w in flatten_with_path(g.params):
        moved = (pc[path] - init[path]).abs().max().item()
        gap = (w.cpu() - pc[path]).abs().max().item()
        ratios[path] = gap / moved if moved else math.inf if gap else 0.0
        assert gap <= LOWRANK_CARD_CPU_MOVE_FRAC[method] * moved, (path, gap, moved)
    print(f"{method}: largest gap / movement {max(ratios.values()):.3e} "
          f"({max(ratios, key=ratios.get)})")


def test_device_draws_equal_host_draws(cuda):
    """normal_many on the card is bit for bit the host's."""
    from repro_torch.utils import jax_random

    sizes = [768 * 24, 0, 5, 12 * 3072 * 24, 50272 * 24]
    keys = [jax_random.fold_in(PRNGKey(1), i) for i in range(len(sizes))]
    assert torch.equal(jax_random.normal_many(keys, sizes, cuda).cpu(),
                       jax_random.normal_many(keys, sizes))


def test_mezo_adam_card_matches_cpu(cuda):
    """Three f32 MeZO-Adam steps on the card (the noise kernels) and on the
    CPU (their plain versions) from the same seed."""
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        n0 = tnoise.noise_update.launches
        model = build_model(get_smoke_config("opt-125m"), dev)
        zc = ZOConfig(method="mezo_adam", lr=1e-3)
        state = init_zo_state(model.init(PRNGKey(0)), zc)
        step = build_zo_train_step(model.loss_fn, zc)
        losses = []
        for s in range(3):
            batch = {k: torch.from_numpy(x).to(dev) for k, x in
                     batch_at_step(DataConfig(seq_len=32, global_batch=4, vocab_size=256),
                                   s).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        runs[dev.type] = (state, losses, tnoise.noise_update.launches - n0)
    (g, lg, ng), (c, lc, nc) = runs["cuda"], runs["cpu"]
    assert ng == 3 * 8 and nc == 0  # the smoke model's 8 eligible leaves
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for name, w in g.params["blocks"].items():
        assert (w.cpu() - c.params["blocks"][name]).abs().max().item() <= 1e-5, name


# --------------------------------------------------------------------------
# speculative verify and quantized leaves
# --------------------------------------------------------------------------

VERIFY_CASES = [  # S, T, H, KV, dh, ps, pps, lengths
    # opt-125m's heads, page 16: dead, mid-page, page-aligned, a window
    # overhanging capacity (29 + 4 > 2 x 16) and a slot at capacity
    (5, 5, 12, 12, 64, 16, 2, [0, 7, 16, 29, 32]),
    (4, 2, 12, 12, 64, 16, 3, [1, 17, 0, 48]),
    (3, 4, 8, 2, 32, 8, 3, [5, 24, 9]),  # GQA G = 4: 4 x 4 rows of 32
    (2, 3, 4, 1, 40, 8, 2, [7, 13]),  # MQA, awkward head dim
    # the spec path's shapes, over the kernel's 64-position splits: row 0
    # masked out of a split row 4 reaches (62), lengths across several
    # split boundaries (200, 318), and windows overhanging the 21 x 16
    # capacity (330, 336)
    (8, 5, 12, 12, 64, 16, 21, [30, 62, 95, 200, 318, 330, 336, 0]),
    # windows wider than one block's 1024 / dh rows: GQA G = 8 at draft_len
    # 4 (T = 5, dh 128: 5 row blocks), and head dim 256
    (3, 5, 16, 2, 128, 16, 4, [7, 33, 60]),
    (2, 3, 4, 2, 256, 8, 3, [1, 18]),
    (2, 1, 8, 1, 256, 8, 2, [0, 11]),
    # the dense configs' GQA at dh 128 at draft_len 4: G = 4, 5 and 7
    (4, 5, 32, 8, 128, 16, 21, [0, 63, 200, 333]),
    (4, 5, 40, 8, 128, 16, 21, [64, 0, 129, 318]),
    (4, 5, 56, 8, 128, 16, 21, [7, 65, 250, 0]),
    # kimi-k2's G = 8 at dh 112
    (4, 5, 64, 8, 112, 16, 21, [0, 63, 200, 333]),
]


@pytest.mark.parametrize("S,T,H,KV,dh,ps,pps,lengths", VERIFY_CASES)
def test_verify_kernel_vs_plain(cuda, S, T, H, KV, dh, ps, pps, lengths):
    """f32, bf16 and f32 q over a bf16 pool against the plain version; dead
    slots exact zeros; each window position t equals a decode launch at
    length + t (so the intra-window mask is live), and position 0 is
    bitwise the decode kernel's; one launch per call."""
    q1, kp, vp, bt, lens = _paged(cuda, S, H, KV, dh, ps, pps, lengths, seed=T + dh)
    q = _randn((S, T, H, dh), cuda, 40 + T)
    n = tdec.paged_verify_attention.launches
    got = tdec.paged_verify_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert tdec.paged_verify_attention.launches == n + 1
    want = tdec.paged_verify_attention_plain(q, kp, vp, bt, lens)
    assert (got - want).abs().max().item() <= F32_ATOL
    dead = lens == 0
    assert torch.all(got[dead] == 0)
    dec0 = tdec.paged_decode_attention(q[:, 0].contiguous(), kp, vp, bt, lens)
    assert torch.equal(got[:, 0], dec0)
    for t in range(1, T):
        dec = tdec.paged_decode_attention(q[:, t].contiguous(), kp, vp, bt,
                                          torch.where(dead, 0, lens + t).to(torch.int32))
        assert (got[:, t] - dec).abs().max().item() <= 1e-6, t
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, kp, vp))
    got_b = tdec.paged_verify_attention(qb, kb, vb, bt, lens)
    assert _bf16_ok(got_b, tdec.paged_verify_attention_plain(qb.float(), kb.float(),
                                                             vb.float(), bt, lens))
    got_m = tdec.paged_verify_attention(q, kb, vb, bt, lens)
    want_m = tdec.paged_verify_attention_plain(q, kb, vb, bt, lens)
    assert (got_m - want_m).abs().max().item() <= F32_ATOL


@pytest.mark.parametrize("H,KV,dh", [(12, 12, 64), (16, 2, 128), (8, 2, 256), (32, 8, 128),
                                     (40, 8, 128), (56, 8, 128), (64, 8, 112)])
def test_verify_t1_bitwise_decode_kernel(cuda, H, KV, dh):
    """A one-token window is the decode kernel, bit for bit, in f32 and
    bf16, at opt-125m's heads, at G = 8 and at head dim 256."""
    q, kp, vp, bt, lens = _paged(cuda, 8, H, KV, dh, 16, 20,
                                 [0, 1, 16, 17, 250, 31, 0, 320], seed=3)
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dt) for x in (q, kp, vp))
        win = tdec.paged_verify_attention(qd[:, None].contiguous(), kd, vd, bt, lens)
        assert torch.equal(win[:, 0], tdec.paged_decode_attention(qd, kd, vd, bt, lens))


# lengths around the kernel's 64-position splits: split - 1, split, split
# + 1, two splits and a tail, a dead slot, and a window overhanging capacity
SPLIT_LENGTHS = [tdec.SPLIT - 1, tdec.SPLIT, tdec.SPLIT + 1, 2 * tdec.SPLIT + 37, 0, 318]


@pytest.mark.parametrize("T", [2, 5])
@pytest.mark.parametrize("H,KV,dh", [(12, 12, 64), (25, 5, 64), (32, 4, 128), (40, 8, 128),
                                     (56, 8, 128), (64, 8, 112)])
def test_verify_rows_are_bitwise_decode_across_splits(cuda, T, H, KV, dh):
    """Window row t is bitwise the decode kernel at length + t, at G = 1
    (opt-125m), 5 (hymba-1.5b) and 8, in bf16 and f32, with lengths on
    either side of a split boundary."""
    q1, kp, vp, bt, lens = _paged(cuda, len(SPLIT_LENGTHS), H, KV, dh, 16, 20, SPLIT_LENGTHS,
                                  seed=T + H)
    q = _randn((len(SPLIT_LENGTHS), T, H, dh), cuda, 70 + T, 0.3)
    dead = lens == 0
    for dt in (torch.bfloat16, torch.float32):
        qd, kd, vd = (x.to(dt) for x in (q, kp, vp))
        win = tdec.paged_verify_attention(qd, kd, vd, bt, lens)
        assert torch.all(win[dead] == 0)
        for t in range(T):
            at = torch.where(dead, 0, lens + t).to(torch.int32)
            dec = tdec.paged_decode_attention(qd[:, t].contiguous(), kd, vd, bt, at)
            assert torch.equal(win[:, t], dec), (dt, t)



def test_decode_slot_is_unchanged_by_other_slots_lengths(cuda):
    """A slot's decode output is bitwise the same while the other slots'
    lengths cross from one split to five."""
    base = None
    for other in (5, tdec.SPLIT - 1, tdec.SPLIT + 1, 2 * tdec.SPLIT + 9, 318):
        lengths = [200, other, 0, other]
        q, kp, vp, bt, lens = _paged(cuda, 4, 12, 12, 64, 16, 20, lengths, seed=9)
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, kp, vp))
        out = tdec.paged_decode_attention(qb, kb, vb, bt, lens)[0]
        base = out if base is None else base
        assert torch.equal(out, base), other


def test_verify_kernel_refuses_oversized_window(cuda):
    """A head dim past the kernel's largest instance (256) raises; it is
    never truncated.  A window of any T * G is taken (more row blocks)."""
    q, kp, vp, bt, lens = _paged(cuda, 2, 4, 1, 320, 8, 2, [3, 5], seed=1)
    qw = _randn((2, 5, 4, 320), cuda, 2)
    with pytest.raises(ValueError, match="head dim"):
        tdec.paged_verify_attention(qw, kp, vp, bt, lens)


QMM_CASES = [  # scheme, M, K, N
    ("nf4", 37, 96, 80), ("lut3", 129, 200, 72), ("lut4", 64, 768, 130),
    ("lut3", 1, 768, 768), ("lut4", 300, 3072, 96),
    # lut3 pads K = 768 to 1280: planes 6-9 are skipped, and their codes
    # are nonzero here; the FFN down-projection at the forward's rows
    ("lut3", 200, 768, 192), ("lut4", 1024, 3072, 768),
]


def _qmm_leaf(scheme, K, N, device):
    """A quantized [K, N] leaf with a nonzero acc and nacc, and nonzero
    codes in the packing's pad rows (K up to Kp), which x's zeros there
    must cancel."""
    w = _randn((K, N), device, 1, 0.1)
    leaf = quant.quantize_leaf(w, scheme=scheme, rank=8, key=(1, 2), path="['w']",
                               with_nacc=True)
    # xu @ qvᵀ about a third of the dequantized product: both must be right
    leaf = leaf.replace(acc=_randn((8,), device, 2, 0.01), nacc=_randn((K, N), device, 3, 0.01))
    kp = leaf.codes.shape[0] * (32 // leaf.bits)
    codes = quant.unpack_codes(leaf.codes, leaf.bits, kp)
    g = torch.Generator().manual_seed(5)
    codes[K:] = torch.randint(1, 1 << leaf.bits, (kp - K, N), generator=g).to(device)
    return leaf.replace(codes=quant.pack_codes(codes, leaf.bits))


@pytest.mark.parametrize("scheme,M,K,N", QMM_CASES)
def test_quant_matmul_kernel_vs_plain(cuda, scheme, M, K, N):
    """Ragged M and N, K padded to 128 or 640 with nonzero pad codes, a
    nonzero acc; the same through dispatch with ``nacc``."""
    leaf = _qmm_leaf(scheme, K, N, cuda)
    x = _randn((M, K), cuda, 4, 1.0)
    lut = quant.scaled_lut(leaf)
    xu = x @ (leaf.qu * leaf.acc)
    n0 = tqmm.quant_matmul.launches
    got = tqmm.quant_matmul(x, leaf.codes, lut, xu, leaf.qv, bits=leaf.bits)
    torch.cuda.synchronize()
    assert tqmm.quant_matmul.launches == n0 + 1
    want = tqmm.quant_matmul_plain(x, leaf.codes, lut, xu, leaf.qv, bits=leaf.bits)
    tol = 2e-5 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    no_delta = tqmm.quant_matmul_plain(x, leaf.codes, lut, torch.zeros_like(xu), leaf.qv,
                                       bits=leaf.bits)
    assert (no_delta - want).abs().max().item() > 100 * tol  # the check sees xu @ qvᵀ
    xb = x.to(torch.bfloat16)
    got_b = tqmm.quant_matmul(xb, leaf.codes, lut, xu, leaf.qv, bits=leaf.bits)
    assert got_b.dtype == torch.bfloat16
    assert _bf16_ok(got_b, tqmm.quant_matmul_plain(xb.float(), leaf.codes, lut, xu, leaf.qv,
                                                   bits=leaf.bits))
    fwd = dispatch.quant_matmul_fwd(x, leaf)
    ref = dispatch._quant_matmul_ref(x, leaf)
    assert (fwd - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


@pytest.mark.parametrize("scheme,M,K,N", [("lut4", 129, 768, 200), ("lut3", 64, 200, 72)])
def test_quant_matmul_tiles_agree(cuda, scheme, M, K, N):
    """Every bf16 block of ``TILE_CHOICES`` sums each output in the same
    order, so all give the forward's result bitwise."""
    leaf = _qmm_leaf(scheme, K, N, cuda)
    xb = _randn((M, K), cuda, 4, 1.0).to(torch.bfloat16)
    lut = quant.scaled_lut(leaf)
    xu = xb.float() @ (leaf.qu * leaf.acc)
    want = tqmm.quant_matmul(xb, leaf.codes, lut, xu, leaf.qv, bits=leaf.bits)
    for tile in tqmm.TILE_CHOICES:
        got = tqmm.quant_matmul_tile(xb, leaf.codes, lut, xu, leaf.qv, bits=leaf.bits, tile=tile)
        assert torch.equal(got, want), tile


@pytest.mark.parametrize("method", ["tezo_adam", "mezo_adam"])
def test_quantized_training_on_card(cuda, method):
    """Three lut4 steps of the smoke model: chained == unchained bitwise on
    the card, and the card's losses within 1e-4 relative of the CPU's; the
    forward runs on quant_matmul (6 quantized leaves x 2 layers per forward)."""
    def run(dev, mode):
        model = build_model(get_smoke_config("opt-125m"), dev)
        zc = ZOConfig(method=method, q_probes=2, restore_mode=mode, rank=8, lr=1e-2,
                      weight_quant="lut4")
        state = init_zo_state(model.init(PRNGKey(0)), zc)
        step = build_zo_train_step(model.loss_fn, zc)
        data = DataConfig(seq_len=32, global_batch=4, vocab_size=256)
        losses = []
        for s in range(3):
            batch = {k: torch.from_numpy(x).to(dev) for k, x in batch_at_step(data, s).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        return state, losses

    n0 = tqmm.quant_matmul.launches
    a, la = run(cuda, "inplace")
    # 3 steps x (2q forwards) x 2 layers x 6 quantized leaves
    assert tqmm.quant_matmul.launches - n0 == 3 * 4 * 2 * 6
    b, lb = run(cuda, "unchained")
    assert la == lb
    fb = dict(flatten_with_path(b))
    for path, t in flatten_with_path(a):
        assert (torch.equal(t, fb[path]) if isinstance(t, torch.Tensor)
                else np.array_equal(t, fb[path])), path
    _, lc = run(torch.device("cpu"), "inplace")
    np.testing.assert_allclose(la, lc, rtol=1e-4)


def test_verify_window_is_bitwise_decode_steps_on_card(cuda):
    """The smoke model in bf16 on the card: each window position's logits
    are bitwise the decode step's at its length (the verify step runs the
    decode step's GEMM shapes per position), so spec and non-spec greedy
    streams agree."""
    cfg = get_smoke_config("opt-125m").reduced(dtype="bfloat16")
    model = build_model(cfg, cuda)
    params = model.init(PRNGKey(3))
    bt = torch.tensor([[1, 2], [3, 4], [0, 0]], dtype=torch.int32, device=cuda)
    cache = model.init_paged_cache(5, 8)
    rng = np.random.default_rng(4)
    for s, n in enumerate([6, 9]):
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :n] = rng.integers(2, 256, size=n)
        _, k, v = model.prefill_paged(params, torch.from_numpy(prompt).to(cuda), n)
        model.insert_pages(cache, k, v, bt[s].long())
    lens = torch.tensor([6, 9, 0], dtype=torch.int32, device=cuda)
    window = torch.from_numpy(rng.integers(2, 256, size=(3, 5)).astype(np.int32)).to(cuda)
    n0 = tdec.paged_verify_attention.launches
    ver, cache = model.verify_step_paged(params, cache, bt, lens, window)
    assert tdec.paged_verify_attention.launches - n0 == cfg.n_layers
    for t in range(5):
        dec, _ = model.decode_step_paged(params, cache, bt, torch.where(lens > 0, lens + t, 0)
                                         .to(torch.int32), window[:, t].contiguous())
        assert torch.equal(ver[:2, t], dec[:2]), t


@pytest.mark.parametrize("r", [1, 2, 3, 7])
@pytest.mark.parametrize("shape", [(2, 150, 264), (130, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tezo_perturb_at_small_ranks(cuda, r, shape, dtype):
    """tezo_perturb chains of k = 1, 2, 3 (decay on the last) against the
    plain version at the ranks Eq. 7 selects, and each chain bitwise its
    single launches."""
    *batch, m, n = shape
    w = _randn(shape, cuda, 21, 0.1).to(dtype)
    u, v = _randn((*batch, m, r), cuda, 22, 1.0), _randn((*batch, n, r), cuda, 23, 1.0)
    taus = _randn((*batch, 3, r), cuda, 24, 1.0)
    scales = [1e-3, -2e-3, 1e-3]
    for k in (1, 2, 3):
        tk = taus[..., :k, :].contiguous()
        got = tpert.tezo_perturb(w.clone(), u, v, tk, scales[:k], decay=0.99)
        want = tpert.tezo_perturb_plain(w.clone(), u, v, tk, scales[:k], decay=0.99)
        if dtype == torch.float32:
            assert (got - want).abs().max().item() <= 1e-5, k
        else:
            assert _within_bf16_ulp(got, want, w), k
        single = w.clone()
        for s in range(k):
            single = tpert.tezo_perturb(single, u, v, taus[..., s:s + 1, :].contiguous(),
                                        [scales[s]], decay=0.99 if s == k - 1 else None)
        assert torch.equal(got, single), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_tezo_adam_on_card(cuda, dtype):
    """TeZO-Adam, q = 2, 3 steps with per-layer rank masks on the stacked
    block leaves: chained == unchained bitwise through the kernels, the
    masked τ_M / τ_V components exactly 0 and the kept ones not."""
    cfg = get_smoke_config("opt-125m").reduced(dtype=dtype)
    model = build_model(cfg, cuda)
    params = model.init(PRNGKey(0))
    mask = np.array([[1] * 5 + [0] * 3, [1] * 8], np.float32)
    masks = {f"['blocks']['{n}']": mask for n, w in params["blocks"].items() if w.dim() == 3}
    data = DataConfig(seq_len=32, global_batch=4, vocab_size=256)
    states = {}
    for mode in ("inplace", "unchained"):
        zc = ZOConfig(method="tezo_adam", q_probes=2, restore_mode=mode, rank=8, lr=1e-2)
        state = init_zo_state(model.init(PRNGKey(0)), zc, rank_masks=masks)
        step = build_zo_train_step(model.loss_fn, zc)
        for s in range(3):
            batch = {k: torch.from_numpy(x).to(cuda) for k, x in batch_at_step(data, s).items()}
            state, _ = step(state, batch)
        states[mode] = state
    a, b = states["inplace"], states["unchained"]
    fb = dict(flatten_with_path(b))
    for path, t in flatten_with_path(a):
        if isinstance(t, torch.Tensor):
            assert torch.equal(t, fb[path]), path
        else:
            assert np.array_equal(t, fb[path]), path
    for path in masks:
        for moment in ("tau_m", "tau_v"):
            t = a.mstate[moment][path].cpu()
            assert torch.all(t[0, 5:] == 0) and torch.all(t[0, :5] != 0), (moment, path)
            assert torch.all(t[1] != 0), (moment, path)


def _autograd_calls(cuda):
    q = torch.randn(1, 8, 2, 16, device=cuda, requires_grad=True)
    pages = torch.randn(3, 4, 2, 16, device=cuda)
    bt = torch.tensor([[1, 2], [2, 1]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    x = torch.randn(2, 5, 8, device=cuda, requires_grad=True)
    return {
        "flash_attention": lambda: tflash.flash_attention(q, q.detach(), q.detach()),
        "paged_decode_attention": lambda: tdec.paged_decode_attention(q[0, :2], pages, pages,
                                                                      bt, lens),
        "paged_verify_attention": lambda: tdec.paged_verify_attention(
            q[0, :4].reshape(2, 2, 2, 16), pages, pages, bt, lens),
        "selective_scan": lambda: tscan.selective_scan(
            x, x.detach().abs(), -torch.ones(8, 4, device=cuda), torch.randn(2, 5, 4, device=cuda),
            torch.randn(2, 5, 4, device=cuda), torch.zeros(2, 8, 4, device=cuda)),
        "quant_matmul": lambda: tqmm.quant_matmul(
            torch.randn(4, 8, device=cuda, requires_grad=True),
            torch.zeros(1, 6, dtype=torch.int32, device=cuda), torch.zeros(6, 16, device=cuda),
            torch.zeros(4, 2, device=cuda), torch.zeros(6, 2, device=cuda), bits=4),
    }


@pytest.mark.parametrize("name", ["flash_attention", "paged_decode_attention",
                                  "paged_verify_attention", "selective_scan", "quant_matmul"])
def test_kernel_wrappers_raise_under_autograd_on_card(cuda, name):
    """No kernel has a backward: a call autograd would record raises before
    anything launches, so no path can drop a gradient quietly; under
    no_grad the kernel runs."""
    call = _autograd_calls(cuda)[name]
    counter = {"flash_attention": tflash.flash_attention,
               "paged_decode_attention": tdec.paged_decode_attention,
               "paged_verify_attention": tdec.paged_verify_attention,
               "selective_scan": tscan.selective_scan, "quant_matmul": tqmm.quant_matmul}[name]
    n0 = counter.launches
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call()
    assert counter.launches == n0
    if name != "quant_matmul":  # its operands above are not a packed leaf
        with torch.no_grad():
            call()
        assert counter.launches == n0 + 1


# --------------------------------------------------------------------------
# the xLSTM family: no kernel in its forward; the chunkwise form on the card
# --------------------------------------------------------------------------


def test_xlstm_chunkwise_on_card_matches_sequential(cuda):
    """The f32 smoke model on a 2 x 512 batch: the card's default chunk of
    256 (the reference's "pallas" default) against the sequential form on
    the card (``mlstm_chunk`` 512: a chunk not shorter than S) and on the
    CPU, hidden states and carried states within the reference's 1e-3, and
    explicit chunks of 8 on the card against the CPU's within 1e-5; no
    kernel launches."""
    from repro_torch.utils.tree import map_with_path

    cfg = get_smoke_config("xlstm-350m")
    cpu_params = build_model(cfg, "cpu").init(PRNGKey(0))
    params = map_with_path(lambda _, w: w.to(cuda), cpu_params)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 128, size=(2, 512))
                              .astype(np.int32))
    chunked = build_model(cfg, cuda)
    assert chunked.impl._mlstm_chunk(tokens.to(cuda)) == 256
    n0 = sum(f.launches for f in (tflash.flash_attention, tscan.selective_scan))
    x256, s256 = chunked.impl.hidden_states(params, {"tokens": tokens.to(cuda)})
    xseq, sseq = build_model(cfg.reduced(mlstm_chunk=512), cuda).impl.hidden_states(
        params, {"tokens": tokens.to(cuda)})
    xcpu, scpu = build_model(cfg, "cpu").impl.hidden_states(cpu_params, {"tokens": tokens})
    assert sum(f.launches for f in (tflash.flash_attention, tscan.selective_scan)) == n0
    for a, b in ((x256, xseq), (x256, xcpu), (xseq, xcpu)):
        assert (a.cpu() - b.cpu()).abs().max().item() <= 1e-3
    for key in scpu:
        for a, b, c in zip(s256[key], sseq[key], scpu[key]):
            assert (a.cpu() - c).abs().max().item() <= 1e-3, key
            assert (b.cpu() - c).abs().max().item() <= 1e-3, key
    small = cfg.reduced(mlstm_chunk=8)
    x8 = build_model(small, cuda).impl.hidden_states(params, {"tokens": tokens.to(cuda)})[0]
    x8c = build_model(small, "cpu").impl.hidden_states(cpu_params, {"tokens": tokens})[0]
    assert torch.isfinite(x8).all() and (x8.cpu() - x8c).abs().max().item() <= 1e-5


def test_xlstm_step_on_card_matches_cpu(cuda):
    """One TeZO-Adam step of the 4-head smoke model (w_if [64, 8] low-rank
    at r = 8) in f32 from the same weights: 2 tezo_perturb and 1
    tezo_adam_update launches per low-rank leaf, the loss within 1e-5
    relative and params within 1e-5 of the CPU's."""
    from repro_torch.utils.tree import map_with_path

    cfg = get_smoke_config("xlstm-350m").reduced(n_heads=4, n_kv_heads=4)
    params = build_model(cfg, "cpu").init(PRNGKey(1))
    zc = ZOConfig(method="tezo_adam", rank=8, lr=1e-3)
    batch = batch_at_step(DataConfig(seq_len=32, global_batch=4, vocab_size=128), 0)
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev)
        state = init_zo_state(map_with_path(lambda _, w: w.clone().to(dev), params), zc)
        n0 = (tpert.tezo_perturb.launches, tadam.tezo_adam_update.launches)
        state, metrics = build_zo_train_step(model.loss_fn, zc)(
            state, {k: torch.from_numpy(x).to(dev) for k, x in batch.items()})
        launched = (tpert.tezo_perturb.launches - n0[0], tadam.tezo_adam_update.launches - n0[1])
        out[str(dev)] = (float(metrics["loss"]), dict(flatten_with_path(state.params)), launched,
                         state.mstate["factors"])
    (lc, pc, _, _), (lg, pg, launched, factors) = out["cpu"], out[str(cuda)]
    assert tuple(factors["['blocks']['l00_m']['w_if']"].u.shape) == (64, 8)
    assert launched == (2 * len(factors), len(factors))
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for path, w in pg.items():
        assert (w.cpu() - pc[path]).abs().max().item() <= 1e-5, path


# the probe-parallel step's chains (ROADMAP item 13a): the q = 3 and q = 4
# trajectories (9 and 12 deltas) and the limit, on a [768, 3072] leaf and a
# stacked one
LONG_CHAINS = (9, 12, 64)
LONG_CHAIN_SHAPES = [(768, 3072), (3, 130, 257)]


@pytest.mark.parametrize("k", LONG_CHAINS)
@pytest.mark.parametrize("shape", LONG_CHAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_chains_are_single_passes(cuda, k, shape, dtype):
    """Every chain-taking kernel at k deltas (+ρ, −2ρ, +ρ per probe):
    bitwise its deltas as single launches, each of those within the file's
    bars of the plain delta on the same input weight (over 64 deltas the
    per-delta roundings that put a bf16 weight an ulp apart add up, so
    the whole chain is not held to the whole plain chain); tezo_adam_update's
    and noise_update's restore chains bitwise the perturb chain's launch,
    then the update's, the update close to the plain one."""
    from repro_torch.kernels import _build

    assert k <= _build.MAX_CHAIN
    *batch, m, n = shape
    r = 24
    w = _randn(shape, cuda, 1, 0.05).to(dtype)
    u, v = _randn((*batch, m, r), cuda, 2, 1.0), _randn((*batch, n, r), cuda, 3, 1.0)
    taus = _randn((*batch, k, r), cuda, 4, 1.0)
    vs = [_randn((*batch, n, r), cuda, 10 + j, 1.0) for j in range(k)]
    uo, vo = _orthonormal((*batch, m, r), cuda, 5), _orthonormal((*batch, n, r), cuda, 6)
    sig = _randn((*batch, k, r, r), cuda, 7, 1.0)
    tm, tv = _randn((*batch, r), cuda, 8, 0.3), _randn((*batch, r), cuda, 9, 0.3) ** 2
    sc = [(1e-3, -2e-3, 1e-3)[j % 3] for j in range(k)]
    ss = [x * math.sqrt(m * n / r) for x in sc]
    probes = [j // 3 for j in range(k)]
    seed = tnoise.leaf_seed(PRNGKey(3), "['blocks']['w1']")

    def last(j):
        return 0.99 if j == k - 1 else None

    def close(got, want, w_in):
        if dtype == torch.float32:
            return (got - want).abs().max().item() <= 1e-5
        return _within_bf16_ulp(got, want, w_in)

    def check(chain, one, plain_one, exact=False):
        got, cur = chain(), w.clone()
        for j in range(k):
            nxt = one(cur.clone(), j)
            want = plain_one(cur.clone(), j)
            assert (torch.equal(nxt, want) if exact else close(nxt, want, cur)), j
            cur = nxt
        assert torch.equal(got, cur)
        return got

    check(lambda: tpert.tezo_perturb(w.clone(), u, v, taus, sc, decay=0.99),
          lambda x, j: tpert.tezo_perturb(x, u, v, taus[..., j:j + 1, :].contiguous(), [sc[j]],
                                          decay=last(j)),
          lambda x, j: tpert.tezo_perturb_plain(x, u, v, taus[..., j:j + 1, :], [sc[j]],
                                                decay=last(j)))
    check(lambda: tpert.lozo_chain_k(w.clone(), u, vs, sc, decay=0.99),
          lambda x, j: tpert.lozo_chain_k(x, u, [vs[j]], [sc[j]], decay=last(j)),
          lambda x, j: tpert.lozo_chain_plain(x, u, [vs[j]], [sc[j]], decay=last(j)))
    check(lambda: tsub.subzo_perturb(w.clone(), uo, vo, sig, ss, decay=0.99),
          lambda x, j: tsub.subzo_perturb(x, uo, vo, sig[..., j:j + 1, :, :].contiguous(),
                                          [ss[j]], decay=last(j)),
          lambda x, j: tsub.subzo_perturb_plain(x, uo, vo, sig[..., j:j + 1, :, :], [ss[j]],
                                                decay=last(j)))
    got = tadam.tezo_adam_update(w.clone(), u, v, tm, tv, 1e-3, 1e-5, tau_r=taus,
                                 restore_scale=sc)
    rest = tpert.tezo_perturb(w.clone(), u, v, taus, sc)
    assert torch.equal(got, tadam.tezo_adam_update(rest.clone(), u, v, tm, tv, 1e-3, 1e-5))
    assert close(got, tadam.tezo_adam_update_plain(rest.clone(), u, v, tm, tv, 1e-3, 1e-5),
                 rest)
    # the noise kernels draw the plain version's bits: each delta is exact
    rest = check(lambda: tnoise.noise_perturb(w.clone(), seed, probes, sc),
                 lambda x, j: tnoise.noise_perturb(x, seed, [probes[j]], [sc[j]]),
                 lambda x, j: tnoise.noise_perturb_plain(x, seed, [probes[j]], [sc[j]]),
                 exact=True)
    kap = _randn((4,), cuda, 11, 1.0)
    m0, v0 = _randn(shape, cuda, 12, 0.01), _randn(shape, cuda, 13, 0.1) ** 2
    fused = tnoise.noise_update(w.clone(), seed, kap, "adam", 1e-3, 0.9, 0.99, 1e-5, decay=0.99,
                                m_buf=m0.clone(), v_buf=v0.clone(), restore_probes=probes,
                                restore_scales=sc)
    seq = tnoise.noise_update(rest.clone(), seed, kap, "adam", 1e-3, 0.9, 0.99, 1e-5, decay=0.99,
                              m_buf=m0.clone(), v_buf=v0.clone())
    assert all(torch.equal(a, b) for a, b in zip(fused, seq))
    plain = tnoise.noise_update_plain(rest.clone(), seed, kap, "adam", 1e-3, 0.9, 0.99, 1e-5,
                                      decay=0.99, m_buf=m0.clone(), v_buf=v0.clone())
    assert _ulp_close(fused[0], plain[0], rest)


def test_probe_parallel_on_card_is_the_sequential_step(cuda, tmp_path):
    """Two ranks on the card (opt-125m-smoke, bf16, over gloo): TeZO-Adam
    and MeZO-Adam at q = 3 and LOZO at q = 4, two steps each, bitwise the
    sequential chained step on every rank (tests/_torch_dist_rank.py)."""
    from repro_torch.kernels import _build

    _build.load()  # built once, before the ranks load it
    repo = Path(__file__).resolve().parents[1]
    out = tmp_path / "pp.jsonl"
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    proc = subprocess.run([sys.executable, str(repo / "tests" / "_torch_dist_rank.py"), str(out),
                           "--device", "cuda", "--cases", "card"], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 3
    for rec in recs:
        assert rec["bitwise"] and rec["ranks_agree"] and rec["moved"], rec
        assert rec["zo_passes"] == [2 * math.ceil(rec["q"] / 2) + 1] * 2


def test_sharded_step_on_card(cuda, tmp_path):
    """Four ranks sharing the card (opt-125m-smoke, over gloo staged through
    pinned host memory): TeZO-Adam and MeZO-Adam at q = 2 on a 1 x 2 mesh
    bitwise the single-process chained step (the noise kernels at the
    shards' offsets, the low-rank kernels on the shards), and TeZO-Adam on
    2 x 1 in f32 within the reference's bars, with kappa_abs within 1e-3
    relative, after a step that moved half the params past ten times the
    params bar, and bitwise across two runs (tests/_torch_shard_rank.py)."""
    from repro_torch.kernels import _build

    _build.load()  # built once, before the ranks load it
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    proc = subprocess.run([sys.executable, str(repo / "tests" / "_torch_shard_rank.py"),
                           str(tmp_path), "--device", "cuda", "--cases", "card"], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    recs = [json.loads(line) for line in (tmp_path / "shard.jsonl").read_text().splitlines()]
    assert len(recs) == 3
    for rec in recs:
        assert rec["zo_passes"] == [5, 5] and rec["resident"] < rec["resident_whole"], rec
        if rec["data"] == 1:
            assert rec["bitwise"], rec
        else:  # f32 at lr 1e-2: the step moves the params past ten times the bar
            assert rec["loss_rel"] <= 2e-4 and rec["param_diff"] <= 2e-4, rec
            assert rec["moved"] >= 0.5 and rec["kappa_rel"] <= 1e-3, rec
            assert rec["repeat_bitwise"], rec


@pytest.mark.parametrize("shape,cut", [
    ((3, 130, 257), (slice(1, 3), slice(17, 100), slice(5, 200))),
    ((2, 4, 96, 160), (slice(None), slice(2, 4), slice(None), slice(None))),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_kernels_on_shards(cuda, shape, cut, dtype):
    """noise_perturb and noise_update (each variant) on a shard with its
    global offsets are bitwise the matching slice of the whole-leaf launch,
    and equal their plain versions with the same offsets."""
    seed = tnoise.leaf_seed(PRNGKey(5), "['blocks']['w_up']")
    g = torch.Generator(device="cpu").manual_seed(0)
    w = (torch.randn(shape, generator=g) * 0.1).to(dtype).to(cuda)
    off = [s.start or 0 for s in cut]
    whole = tnoise.noise_perturb(w.clone(), seed, [0, 1], [1e-3, -2e-3])
    part = tnoise.noise_perturb(w[cut].contiguous(), seed, [0, 1], [1e-3, -2e-3], offsets=off)
    assert torch.equal(part, whole[cut])
    assert torch.equal(part, tnoise.noise_perturb_plain(w[cut].contiguous(), seed, [0, 1],
                                                        [1e-3, -2e-3], offsets=off))
    kap = torch.tensor([0.4, -0.9], device=cuda)
    m0 = torch.randn(shape, generator=g).to(cuda) * 0.01
    v0 = torch.randn(shape, generator=g).abs().to(cuda) * 0.01
    for variant in tnoise.VARIANTS:
        kw = dict(decay=0.99, restore_probes=[1], restore_scales=[1e-3])
        full = tnoise.noise_update(w.clone(), seed, kap, variant, 1e-2, 0.9, 0.99, 1e-5,
                                   m_buf=m0.clone(), v_buf=v0.clone(), **kw)
        mine = tnoise.noise_update(w[cut].contiguous(), seed, kap, variant, 1e-2, 0.9, 0.99,
                                   1e-5, m_buf=m0[cut].contiguous(), v_buf=v0[cut].contiguous(),
                                   offsets=off, **kw)
        for a, b in zip(mine, full):
            assert torch.equal(a, b[cut]), variant
