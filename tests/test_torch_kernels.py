"""The port's attention kernels on the CPU: their plain PyTorch versions
against the reference's Pallas kernels (run under the interpreter, as the
reference's own tests run them) and its jnp oracles, and the wrappers'
routing of CPU tensors.  The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Inputs are made with numpy from a seed and fed to both sides.  Tolerances
are f32: 1e-5 absolute (the two sides sum in different orders)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.ref import flash_attention_ref
from repro.models import layers as jlayers
from repro_torch.core import dispatch
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import quant_matmul as tqmm
from repro_torch.models import layers as tlayers

ATOL = 1e-5

# the reference's oracles, compiled once per shape (eager dispatch of their
# many small ops costs more than a jit here)
_flash_oracle = jax.jit(flash_attention_ref, static_argnames=("causal", "window", "q_offset"))
_paged_twin = jax.jit(jlayers.paged_decode_attention_ref)


@pytest.fixture(scope="session", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def force_interpret():
    ops.set_interpret(True)
    yield
    ops.set_interpret(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

FLASH_CASES = [
    # B, S, T, H, KV, dh, causal, window, q_offset
    (2, 37, 37, 4, 2, 40, True, 0, 0),  # GQA G=2, awkward S and dh
    (1, 24, 56, 6, 2, 32, True, 0, 32),  # q_offset: a chunk at the cache's end
    (1, 50, 50, 4, 1, 24, True, 16, 0),  # MQA + sliding window
    (2, 20, 33, 2, 2, 8, False, 0, 0),  # MHA, non-causal, S != T
]


def _flash_inputs(B, S, T, H, KV, dh, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, dh)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, T, KV, dh)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, T, KV, dh)) * 0.5).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,S,T,H,KV,dh,causal,window,q_offset", FLASH_CASES)
def test_flash_plain_vs_reference_kernel(
    force_interpret, B, S, T, H, KV, dh, causal, window, q_offset
):
    """Plain flash == the reference's Pallas kernel (interpret) and its
    jnp oracle."""
    q, k, v = _flash_inputs(B, S, T, H, KV, dh, seed=S * 7 + dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = tflash.flash_attention_plain(_t(q), _t(k), _t(v), **kw).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(ops.flash_attention(jq, jk, jv, **kw)),
                               atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(_flash_oracle(jq, jk, jv, **kw)),
                               atol=ATOL)


def test_flash_plain_bf16_vs_oracle():
    """bf16 inputs widen to f32 before both products and round once at the
    end, as the oracle does: agreement within one bf16 rounding."""
    q, k, v = _flash_inputs(1, 33, 33, 4, 2, 32, seed=3)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = tflash.flash_attention_plain(*bf, window=8)
    assert got.dtype == torch.bfloat16
    jin = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf]
    want = np.asarray(_flash_oracle(*jin, window=8), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-8, atol=ATOL)


# --------------------------------------------------------------------------
# paged decode attention
# --------------------------------------------------------------------------

PAGED_CASES = [
    # S, H, KV, dh, page_size, pages_per_slot, lengths
    (2, 8, 2, 32, 16, 2, [1, 32]),  # GQA G=4; min length / capacity
    (4, 4, 1, 64, 8, 2, [8, 16, 3, 9]),  # MQA; exact page boundaries
    (2, 4, 2, 40, 8, 2, [7, 13]),  # awkward head dim
    (4, 12, 12, 64, 16, 3, [0, 17, 48, 0]),  # MHA (opt-125m heads); full; dead
    # a slot at capacity: decode_step_paged attends length P*ps + 1, which
    # stops at the slot's P pages (first and last rows of the table)
    (3, 4, 2, 16, 8, 2, [17, 5, 17]),
]


def _paged_inputs(S, H, KV, dh, ps, pps, lengths, seed):
    """Random q/pages and a shuffled block table; page 0 (the null page)
    stays out of every slot's row."""
    rng = np.random.default_rng(seed)
    n_pages = S * pps + 1
    q = (rng.standard_normal((S, H, dh)) * 0.3).astype(np.float32)
    kp = (rng.standard_normal((n_pages, ps, KV, dh)) * 0.3).astype(np.float32)
    vp = (rng.standard_normal((n_pages, ps, KV, dh)) * 0.3).astype(np.float32)
    bt = (rng.permutation(n_pages - 1) + 1).astype(np.int32).reshape(S, pps)
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("S,H,KV,dh,ps,pps,lengths", PAGED_CASES)
def test_paged_plain_vs_reference_kernel(force_interpret, S, H, KV, dh, ps, pps, lengths):
    """Plain paged decode == the reference's Pallas kernel (interpret), over
    shuffled tables, MHA/GQA/MQA, page-boundary lengths and dh=40 — dead
    slots included, where both give exact zeros."""
    args = _paged_inputs(S, H, KV, dh, ps, pps, lengths, seed=S * 13 + dh)
    got = tdec.paged_decode_attention_plain(*map(_t, args)).numpy()
    want = np.asarray(ops.paged_decode_attention(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    dead = np.asarray(lengths) == 0
    assert np.all(got[dead] == 0.0) and np.all(want[dead] == 0.0)


@pytest.mark.parametrize("S,H,KV,dh,ps,pps,lengths", PAGED_CASES)
def test_paged_twin_vs_reference_twin(S, H, KV, dh, ps, pps, lengths):
    """The ported XLA twin == the reference's twin on live slots.  Dead slots
    are left out: both twins spread a uniform softmax over the null page's
    rows there, which the kernels do not (they give zeros)."""
    args = _paged_inputs(S, H, KV, dh, ps, pps, lengths, seed=S * 17 + dh)
    got = tlayers.paged_decode_attention_ref(*map(_t, args)).numpy()
    want = np.asarray(_paged_twin(*map(jnp.asarray, args)))
    live = np.asarray(lengths) > 0
    np.testing.assert_allclose(got[live], want[live], atol=ATOL)


def test_dead_slots_are_exact_zeros():
    """Every length-0 slot gives exact zeros, whatever its table row and the
    pool hold; live slots are untouched by them."""
    q, kp, vp, bt, _ = _paged_inputs(4, 4, 2, 16, 8, 2, [1, 1, 1, 1], seed=5)
    lens = np.asarray([0, 9, 0, 16], np.int32)
    out = tdec.paged_decode_attention_plain(*map(_t, (q, kp, vp, bt, lens)))
    assert torch.all(out[[0, 2]] == 0.0)
    solo = tdec.paged_decode_attention_plain(
        *map(_t, (q[1:2], kp, vp, bt[1:2], lens[1:2]))
    )
    assert torch.equal(out[1:2], solo)


# --------------------------------------------------------------------------
# wrappers and dispatch on CPU tensors
# --------------------------------------------------------------------------


def test_cpu_wrappers_route_to_plain_versions():
    """On CPU tensors the wrappers run the plain versions (bitwise) and the
    launch counters do not move."""
    n_flash, n_dec = tflash.flash_attention.launches, tdec.paged_decode_attention.launches
    q, k, v = map(_t, _flash_inputs(1, 12, 12, 4, 2, 16, seed=1))
    assert torch.equal(
        tflash.flash_attention(q, k, v, window=4),
        tflash.flash_attention_plain(q, k, v, window=4),
    )
    args = tuple(map(_t, _paged_inputs(2, 4, 2, 16, 8, 2, [3, 11], seed=2)))
    assert torch.equal(
        tdec.paged_decode_attention(*args), tdec.paged_decode_attention_plain(*args)
    )
    # dispatch: full attention below chunked_min_seq, the plain flash at or
    # above it (the reference's XLA-path rule, kept on the CPU only)
    assert torch.equal(
        dispatch.attention_fwd(q, k, v), tlayers.full_attention(q, k, v)
    )
    assert torch.equal(
        dispatch.attention_fwd(q, k, v, chunked_min_seq=12),
        tflash.flash_attention_plain(q, k, v),
    )
    assert torch.equal(dispatch.decode_attention_fwd(*args), tdec.paged_decode_attention(*args))
    assert tflash.flash_attention.launches == n_flash
    assert tdec.paged_decode_attention.launches == n_dec


def test_kernel_constants_match_their_sources():
    """The wrappers' copies of the kernels' compile-time tile constants: the
    paged kernel's split and the bf16 flash block's warps."""
    csrc = Path(tdec.__file__).resolve().parents[1] / "csrc"
    assert f"constexpr int kPagedSplit = {tdec.SPLIT};" in (csrc / "paged_attention.cuh").read_text()
    flash = (csrc / "flash_attention.cu").read_text()
    assert f"constexpr int kRowWarps = {tflash.ROW_WARPS};" in flash
    assert f"return DHMAX <= 128 ? {tflash.KV_WARPS} : 1;" in flash
    assert f"return DHMAX <= 64 ? {tflash.KV_TILE} : 32;" in flash
    for rw, kw, bk in tflash.WARP_CHOICES:
        assert f"case {1000 * rw + 100 * kw + bk}: REPRO_FLASH_TC(64, {rw}, {kw}, {bk});" in flash


def test_weight_kernel_constants_match_their_sources():
    """The wrappers' copies of quant_matmul's compile-time constants (its K
    group, the blocks it launches and those timed beside them, the
    epilogue's rank limit) and the chain length a FactorList holds."""
    csrc = Path(tqmm.__file__).resolve().parents[1] / "csrc"
    qmm = (csrc / "quant_matmul.cu").read_text()

    def code(t):
        return 100 * t[0] + 10 * t[1] + t[2]

    assert f"constexpr int kBK = {tqmm.GROUP_ROWS};" in qmm
    assert f"constexpr int kTileWide = {code(tqmm.TILE_WIDE)}, kTile = {code(tqmm.TILE)};" in qmm
    assert tqmm.TILE in tqmm.TILE_CHOICES and tqmm.TILE_WIDE in tqmm.TILE_CHOICES
    for wm, wn, mt in tqmm.TILE_CHOICES:
        assert f"case {code((wm, wn, mt))}: REPRO_QMM_TC({wm}, {wn}, {mt});" in qmm
    assert f"constexpr int kMaxRank = {tqmm.MAX_RANK};" in qmm
    common = (csrc / "common.cuh").read_text()
    assert f"constexpr int kMaxChain = {_build.MAX_CHAIN};" in common
    assert len(_build.FactorList().p) == _build.MAX_CHAIN


@pytest.mark.parametrize("pps,ps,splits", [(1, 1, 1), (4, 16, 1), (8, 8, 1), (1, 65, 2),
                                           (21, 16, 6), (34, 16, 9)])
def test_paged_workspace_arithmetic(pps, ps, splits):
    """The splits cover a full slot (pages_per_slot * page_size positions),
    and the workspace holds (m, l) and dh partial sums per row and split."""
    assert tdec.split_count(pps, ps) == splits
    assert (splits - 1) * tdec.SPLIT < pps * ps <= splits * tdec.SPLIT
    assert tdec.workspace_floats(8, 5, 12, 64, pps, ps) == 8 * 5 * 12 * splits * 66


def test_wrappers_refuse_other_devices():
    """Neither wrapper quietly computes anywhere but the CPU or the card."""
    q = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention(q, q, q)
    qd = torch.empty((2, 2, 8), device="meta")
    pages = torch.empty((3, 4, 2, 8), device="meta")
    bt = torch.empty((2, 1), dtype=torch.int32, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdec.paged_decode_attention(qd, pages, pages, bt, lens)


def test_chain_past_the_limit_raises():
    """Every chain-taking wrapper refuses one delta past ``MAX_CHAIN`` on
    either device, with the limit in the message (here the CPU's plain
    versions; the card's in chip_smoke.py), and takes the limit itself."""
    from repro_torch.kernels import subzo_perturb as tsub
    from repro_torch.kernels import tezo_adam as tadam
    from repro_torch.kernels import tezo_perturb as tpert
    from repro_torch.kernels import zo_noise as tnoise

    w = torch.zeros((16, 24))
    u, v = torch.ones((16, 4)), torch.ones((24, 4))
    for k in (_build.MAX_CHAIN, _build.MAX_CHAIN + 1):
        sc = [1e-3] * k
        calls = [
            lambda: tpert.tezo_perturb(w.clone(), u, v, torch.ones((k, 4)), sc),
            lambda: tpert.lozo_chain_k(w.clone(), u, [v] * k, sc),
            lambda: tsub.subzo_perturb(w.clone(), u, v, torch.ones((k, 4, 4)), sc),
            lambda: tadam.tezo_adam_update(w.clone(), u, v, torch.ones(4), torch.ones(4), 1e-3,
                                           1e-5, tau_r=torch.ones((k, 4)), restore_scale=sc),
            lambda: tnoise.noise_perturb(w.clone(), (1, 2), [0] * k, sc),
            lambda: tnoise.noise_update(w.clone(), (1, 2), torch.ones(2), "sgd", 1e-3,
                                        restore_probes=[0] * k, restore_scales=sc),
        ]
        for call in calls:
            if k == _build.MAX_CHAIN:
                out = call()
                assert torch.isfinite(out[0] if isinstance(out, tuple) else out).all()
            else:
                with pytest.raises(ValueError, match=f"at most {_build.MAX_CHAIN} deltas"):
                    call()
