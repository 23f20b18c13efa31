#!/usr/bin/env python3
"""Variants of the port's redesigned kernels, built from edited
copies of their sources and measured beside the real build on one card.

    python3 tools/kernel_variants.py [--kernels quant_matmul,selective_scan,...]
                                        # from the root of a checkout, on a card

There is no ``ncu`` on the card's machine, so a design choice is measured by
taking it out: each variant below is the kernel's source with a few
statements replaced (the edits must apply, or the script stops), built with
nvcc into ``build/kernel_variants/`` and loaded beside the real library.

quant_matmul (bf16 x, lut4 unless stated, M = 1024 rows):
  one_level   each group's products go straight into the running sum
              (no second f32 register sum);
  two_part    the weight as hi + mid only; one_part  as hi only;
  no_mma      the products replaced by a cheap use of the same operands;
  no_lut      the lookups replaced by the code words themselves.
Each is held against the bf16 bar of chip_smoke.py's phase 2 (within 2 bf16
ulps + 1e-5 of the f32 plain version) at the forward's three shapes for
nf4, lut3 and lut4: ``bar_ratio`` is the largest error over its bar (> 1
fails).  Then every variant's time for one lut4 layer forward (six calls).

tezo_perturb (bf16, r = 24, k = 1, over full-width opt-125m's ten low-rank
leaves): no_product (the deltas are zeros: the W stream alone) and
no_stream (W neither loaded nor stored: the factors and products alone).

subzo_perturb (bf16, the k = 1 pass and the k = 2 update pass over SubZO's
ten leaves at r = 24, and r = 96 on a [1536, 2048] leaf): no_product and
no_stream as for tezo_perturb, and row_tile: no U·Σ launch; one block per
64-row tile forms its rows of U·Σ_s (into its rows of the scratch, read
back from L2) and then walks every column tile (a grid of row tiles only).

tezo_adam_update (bf16, its pass over the ten leaves with the folded
restore): no_product (no restore, M or V sums: the W stream, the staging
and the update alone), no_stream (W neither loaded nor stored), unroll1
(the moments' sweep not unrolled, against its register pressure),
fast_rsqrt (the approximate rsqrtf in place of the correctly rounded
one), no_transpose (the moments' four operands not formed: garbage sums,
the cost of the transposition) and tensor_core (M and V on mma.sync, each
f32 operand split into bf16 hi + lo parts, three products a pair; the
restore on the CUDA cores).  Each is held against the plain version at
phase 2's bf16 bar (1 bf16 ulp at the larger of the results and the input
weight; ``bar_ratio`` > 1 fails) at the run's lr and at 1e-3, and its
folded restore against a tezo_perturb launch followed by its own launch
without the restore (bitwise, as chained == unchained needs).

selective_scan (f32, at chip_smoke.py's SCAN_TIME_CASES: the training
forward, a decode step and the serve phase's two prefills): states1,
states2 and states4 (a lane owns 1, 2 or 4 states at every shape, in place
of the choice by the wave), no_staging (x and dt read from device memory in
the time loop) and row (the thread-per-row body the kernel replaced: one
thread carries a channel's 16 states, B and C staged, x, dt and y in the
time loop); and, to weigh the parts, no_sum (y is one product: the sum
over n left out), no_bc_reads (the (B, C) pairs constants, not read from
shared memory), no_prod_writes (the products h * C not written: the sums
read stale rows), no_sync (the ring's per-chunk cp.async wait and the
block's two barriers per chunk left out: y wrong, the cost of the syncs),
fast_exp (the approximate __expf) and unroll1 (the
product batch's steps not unrolled).  Each says whether its y and h_last
are bitwise the kernel's.  rows1 (each lane sums one (step, channel) row
a product batch: half the steps between warp syncs), chunk16 (16 steps a
stage), fewest_states (one state a lane wherever one wave holds
that grid), blocks8 (at most 64 registers: eight blocks an SM) and
threads64 / threads256 (the block size) are the layout's alternatives.

noise_perturb (bf16, the k = 1 pass over full-width opt-125m's ten eligible
leaves from a seeded init): branchy_cos (glibc's two-path cosine and its
sine / cosine branch), unrolled_scalar (the unrolled draw, scalar accesses),
scalar (the column loop that leaves at the ragged edge, one draw at a time
with the chain's length read at run time, scalar accesses: the body the
kernel replaced), generic_chain (the chain's length read at run time),
thread_key (every thread derives its stacked slice's key, not thread 0
once a block), threads128 / threads512 (the block size), and, to weigh the parts of a
draw, no_cos (z = r * u2) and no_threefry (the counter words xor-ed with
the key in place of the 20 rounds).  Each says whether its output is
bitwise the kernel's.

Times are device time per call (chip_smoke.timed); the card's name and power
limit lead the output.  Each subzo_perturb and tezo_adam_update variant that
computes the same function says whether its output is bitwise the real
kernel's.  The variants are measurements only: nothing in the
port runs them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _between(name: str, start: str, end: str) -> str:
    """The text of csrc/<name> from ``start`` up to ``end``."""
    text = (CSRC / name).read_text()
    i = text.index(start)
    return text[i:text.index(end, i)]


QMM_VARIANTS = {
    "one_level": [("mma_bf16(gacc[mb][nb], a[mb]", "mma_bf16(acc[mb][nb], a[mb]"),
                  ("acc[mb][nb][e] = __fadd_rn(acc[mb][nb][e], gacc[mb][nb][e]);", ";")],
    "two_part": [("for (int p = 0; p < 3; ++p)", "for (int p = 0; p < 2; ++p)")],
    "one_part": [("for (int p = 0; p < 3; ++p)", "for (int p = 0; p < 1; ++p)")],
    "no_mma": [("for (int nb = 0; nb < 2; ++nb) mma_bf16(gacc[mb][nb], a[mb], bp[p][nb][0], "
                "bp[p][nb][1]);",
                "for (int nb = 0; nb < 2; ++nb) gacc[mb][nb][0] += "
                "__uint_as_float((a[mb][0] ^ bp[p][nb][0]) & 0x3fffffu);")],
    "no_lut": [("e[j] = lut0[nb * kLutNb + 4 * static_cast<int>(cw[nb][j] & MASK)];",
                "e[j] = make_uint2(cw[nb][j], cw[nb][j] >> 16);")],
}
# common.cuh chain_pass, which tezo_perturb.cu and subzo_perturb.cu run
CHAIN_VARIANTS = {
    "no_product": [("      rank_fma(z, sm, jn);", "")],
    "no_stream": [("  stage_w_tile(ws, w, t, vec);", "  cp_async_commit();"),
                  ("  store_w_tile(out, ws, t, vec);", "")],
}
ROW_TILE_KERNEL = """
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) subzo_row_tile_kernel(
    const T* w, T* out, const float* __restrict__ u, const float* __restrict__ sigma,
    float* us, const float* __restrict__ v, DeltaChain chain, int m, int n, int r, bool vec,
    bool vec_f) {
  __shared__ tezo::RankSmem sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* ws = reinterpret_cast<T*>(dyn);
  tezo::RawFactors& raw = *reinterpret_cast<tezo::RawFactors*>(dyn + sizeof(T) * kBM * kBN);
  const size_t b = blockIdx.z;
  const int row0 = static_cast<int>(blockIdx.y) * kBM;
  const size_t mn = static_cast<size_t>(m) * n, mr = static_cast<size_t>(m) * r,
               rr = static_cast<size_t>(r) * r;
  for (int s = 0; s < chain.k; ++s)
    for (int c0 = 0; c0 < r; c0 += kUC)
      us_tile(us + (b * chain.k + s) * mr, u + b * mr, sigma + (b * chain.k + s) * rr, m, r,
              row0, c0);
  __syncthreads();
  for (int col0 = 0; col0 < n; col0 += kBN) {
    const tezo::Tile t{m, n, r, row0, col0};
    tezo::chain_pass<T, false>(ws, raw, sm, w + b * mn, out + b * mn,
                               SubzoSrc{us + b * chain.k * mr, v + b * n * r, mr}, chain, t,
                               vec, vec_f);
    __syncthreads();
  }
}

template <typename T>
int launch("""
SUBZO_VARIANTS = {
    **CHAIN_VARIANTS,
    "row_tile": [
        ("\ntemplate <typename T>\nint launch(", ROW_TILE_KERNEL),
        ("constexpr auto kernel = subzo_perturb_kernel<T>;",
         "constexpr auto kernel = subzo_row_tile_kernel<T>;"),
        ("  us_kernel<<<ugrid, kThreads, 0, st>>>(us, u, sigma, chain.k, m, r);\n", ""),
        ("const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, B);",
         "const dim3 grid(1, (m + kBM - 1) / kBM, B);"),
        ("static_cast<T*>(out), us, v,\n                                       chain,",
         "static_cast<T*>(out), u, sigma,\n                                       us, v, chain,"),
    ],
}
# tezo_adam_update's M and V on the tensor cores (mma.sync m16n8k16, bf16
# operands in hi + lo parts, three products a part pair: hi*hi, hi*lo,
# lo*hi, f32 accumulation); the restore stays on the CUDA cores.  Each warp
# owns 16 rows x 64 columns of the block's tile.
TC_MOMENTS = """
constexpr int kTP = kRC + 8;  // bf16 pitch: 80-byte rows, fragment loads free of conflicts
struct TcSmem {
  __nv_bfloat16 am[2][kBM][kTP], av[2][kBM][kTP], bm[2][kBN][kTP], bv[2][kBN][kTP];
};
static_assert(sizeof(TcSmem) == 61440, "TcSmem");

__device__ __forceinline__ void split2(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

__device__ __forceinline__ void split_moments(TcSmem& s, const RawAdam& raw, int jn) {
  const int kp = (jn + 15) & ~15;
  for (int idx = threadIdx.x; idx < kBM * kRC; idx += kThreads) {
    const int i = idx / kRC, j = idx % kRC;
    if (j >= kp) continue;
    const bool in = j < jn;
    const float x = in ? raw.f.u[i][j] : 0.f;
    split2(in ? __fmul_rn(x, raw.f.tau[j]) : 0.f, s.am[0][i][j], s.am[1][i][j]);
    split2(in ? __fmul_rn(__fmul_rn(x, x), raw.tau_v[j]) : 0.f, s.av[0][i][j], s.av[1][i][j]);
  }
  for (int idx = threadIdx.x; idx < kBN * kRC; idx += kThreads) {
    const int l = idx / kRC, j = idx % kRC;
    if (j >= kp) continue;
    const float y = j < jn ? raw.f.v[l][j] : 0.f;
    split2(y, s.bm[0][l][j], s.bm[1][l][j]);
    split2(__fmul_rn(y, y), s.bv[0][l][j], s.bv[1][l][j]);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void moments_mma(float (&mm)[8][4], float (&vv)[8][4],
                                            const TcSmem& s, int jn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int r0 = (warp % 4) * 16, n0 = (warp / 4) * 64, kp = (jn + 15) & ~15;
  for (int k0 = 0; k0 < kp; k0 += 16) {
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat16 (*A)[kTP] = pr ? s.av[h] : s.am[h];
        a[h][0] = ld32(&A[r0 + g][k0 + 2 * q]);
        a[h][1] = ld32(&A[r0 + g + 8][k0 + 2 * q]);
        a[h][2] = ld32(&A[r0 + g][k0 + 2 * q + 8]);
        a[h][3] = ld32(&A[r0 + g + 8][k0 + 2 * q + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + nt * 8 + g;
        const __nv_bfloat16 (*Bh)[kTP] = pr ? s.bv[0] : s.bm[0];
        const __nv_bfloat16 (*Bl)[kTP] = pr ? s.bv[1] : s.bm[1];
        const uint32_t h0 = ld32(&Bh[col][k0 + 2 * q]), h1 = ld32(&Bh[col][k0 + 2 * q + 8]);
        const uint32_t l0 = ld32(&Bl[col][k0 + 2 * q]), l1 = ld32(&Bl[col][k0 + 2 * q + 8]);
        float (&acc)[4] = pr ? vv[nt] : mm[nt];
        mma_bf16(acc, a[0], h0, h1);
        mma_bf16(acc, a[0], l0, l1);
        mma_bf16(acc, a[1], h0, h1);
      }
    }
  }
}
"""
TC_OLD_UPDATE = """  float mm[kTM][kTN], vv[kTM][kTN];
  tezo::zero(mm);
  tezo::zero(vv);
  for (int c0 = 0; c0 < r; c0 += kRC) moments_fma(mm, vv, sm, next_chunk(k, c0));
  if (k == 0) wait_w();
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int c = 0; c < kTN; ++c)
      mm[a][c] = __fmul_rn(mm[a][c], __frsqrt_rn(__fadd_rn(vv[a][c], eps)));  // g
  tezo::apply_delta_smem<T>(ws, mm, decay, neg_lr);
"""
TC_NEW_UPDATE = """  float mm[8][4], vv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) mm[i][c] = vv[i][c] = 0.f;
  for (int c0 = 0; c0 < r; c0 += kRC) {
    const int jn = next_chunk(k, c0);
    moments_mma(mm, vv, *reinterpret_cast<const TcSmem*>(&sm), jn);
  }
  if (k == 0) wait_w();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp % 4) * 16 + lane / 4, n0 = (warp / 4) * 64 + 2 * (lane % 4);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      T* p = ws + (r0 + 8 * (e / 2)) * kBN + n0 + nt * 8 + e % 2;
      const float g = __fmul_rn(mm[nt][e], __frsqrt_rn(__fadd_rn(vv[nt][e], eps)));
      *p = from_f32<T>(__fadd_rn(__fmul_rn(decay, to_f32(*p)), __fmul_rn(neg_lr, g)));
    }
"""
ADAM_VARIANTS = {
    "no_product": [("tezo::rank_fma(z, sm.m, next_chunk(p, c0));", "next_chunk(p, c0);"),
                   ("moments_fma(mm, vv, sm, next_chunk(k, c0));", "next_chunk(k, c0);")],
    "no_stream": [("  tezo::stage_w_tile(ws, w + b * mn, t, vec);", "  cp_async_commit();"),
                  ("  tezo::store_w_tile(out + b * mn, ws, t, vec);", "")],
    "unroll1": [("  for (int j = 0; j < jn; ++j) {\n    terms(mm",
                 "#pragma unroll 1\n  for (int j = 0; j < jn; ++j) {\n    terms(mm")],
    "fast_rsqrt": [("__frsqrt_rn(", "rsqrtf(")],
    "no_transpose": [("      transpose_moments(sm, raw, jn);", "      ;")],
    "tensor_core": [
        ("// Phases p = 0 .. k-1 are the restore deltas", TC_MOMENTS + "\n// Phases p = 0 .. k-1 are the restore deltas"),
        ("constexpr size_t kSmemNoW = sizeof(MomentSmem) + sizeof(RawAdam);",
         "constexpr size_t kSmemNoW = 61440 + sizeof(RawAdam);  // TcSmem"),
        ("reinterpret_cast<RawAdam*>(dyn + sizeof(MomentSmem));",
         "reinterpret_cast<RawAdam*>(dyn + 61440);"),
        ("      transpose_moments(sm, raw, jn);",
         "      split_moments(*reinterpret_cast<TcSmem*>(&sm), raw, jn);"),
        (TC_OLD_UPDATE, TC_NEW_UPDATE),
    ],
}

# the thread-per-row scan: one thread carries a channel's N states in
# registers, B and C staged per 32 steps, x, dt and y in the time loop
ROW_SCAN = """
constexpr int kRowThreads = 128, kRowChunk = 32;

template <int NMAX>
__global__ void __launch_bounds__(kRowThreads) scan_row_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ bm, const float* __restrict__ cm, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_last, int S, int D, int N) {
  __shared__ float bs[kRowChunk][NMAX];
  __shared__ float cs[kRowChunk][NMAX];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kRowThreads + threadIdx.x;
  const bool valid = d < D;
  float h[NMAX], ar[NMAX];
  const size_t hrow = (static_cast<size_t>(b) * D + (valid ? d : 0)) * N;
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool in = valid && n < N;
    h[n] = in ? h0[hrow + n] : 0.f;
    ar[n] = in ? a[static_cast<size_t>(d) * N + n] : 0.f;
  }
  const float* brow = bm + static_cast<size_t>(b) * S * N;
  const float* crow = cm + static_cast<size_t>(b) * S * N;
  for (int t0 = 0; t0 < S; t0 += kRowChunk) {
    const int steps = min(kRowChunk, S - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < steps * N; idx += kRowThreads) {
      const int j = idx / N, n = idx % N;
      bs[j][n] = brow[static_cast<size_t>(t0 + j) * N + n];
      cs[j][n] = crow[static_cast<size_t>(t0 + j) * N + n];
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < steps; ++j) {
      const size_t off = (static_cast<size_t>(b) * S + t0 + j) * D + d;
      const float dt_t = dt[off];
      const float u = __fmul_rn(dt_t, x[off]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          const float da = expf(__fmul_rn(dt_t, ar[n]));
          h[n] = __fadd_rn(__fmul_rn(da, h[n]), __fmul_rn(u, bs[j][n]));
          acc = __fadd_rn(acc, __fmul_rn(h[n], cs[j][n]));
        }
      }
      y[off] = acc;
    }
  }
  if (valid) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) h_last[hrow + n] = h[n];
  }
}

int launch_row(const float* x, const float* dt, const float* a, const float* b, const float* c,
               const float* h0, float* y, float* h_last, int B, int S, int D, int N,
               cudaStream_t st) {
  const dim3 grid((D + kRowThreads - 1) / kRowThreads, B);
  if (N <= 16)
    scan_row_kernel<16><<<grid, kRowThreads, 0, st>>>(x, dt, a, b, c, h0, y, h_last, S, D, N);
  else if (N <= 32)
    scan_row_kernel<32><<<grid, kRowThreads, 0, st>>>(x, dt, a, b, c, h0, y, h_last, S, D, N);
  else
    scan_row_kernel<64><<<grid, kRowThreads, 0, st>>>(x, dt, a, b, c, h0, y, h_last, S, D, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch
"""
# x and dt left out of the ring and read from device memory in the time loop
NO_STAGING = [
    ("  if (vec_x) {  // D % 4 == 0: whole 16-byte pieces, cols a multiple of 4\n",
     "  if (false) {\n  if (vec_x) {\n"),
    ("  const size_t boff = (static_cast<size_t>(b) * S + t0) * N;",
     "  }\n  const size_t boff = (static_cast<size_t>(b) * S + t0) * N;"),
    ("                                        int j0, int steps, int ch, int l) {",
     "                                        const float* __restrict__ gdt,\n"
     "                                        const float* __restrict__ gx, int D,\n"
     "                                        int j0, int steps, int ch, int l) {"),
    ("const float dt_t = dtc[j * L::kChannels + ch];",
     "const float dt_t = gdt[static_cast<size_t>(j) * D];"),
    ("const float u = __fmul_rn(dt_t, xc[j * L::kChannels + ch]);",
     "const float u = __fmul_rn(dt_t, gx[static_cast<size_t>(j) * D]);"),
    ("      advance<L, NPAD, SPL>(h, ar, dtc, xc, bcc, prod + wc, j0, steps, ch, l);",
     "      const size_t g0 = (static_cast<size_t>(b) * S + t0) * D + (valid ? d : 0);\n"
     "      advance<L, NPAD, SPL>(h, ar, dtc, xc, bcc, prod + wc, dt + g0, x + g0, D, j0, steps,"
     " ch, l);"),
]
SCAN_VARIANTS = {
    **{f"states{k}": [("return launch_fitting<16, 2, 4>(", f"return launch<16, {k}>(")]
       for k in (1, 2, 4)},
    "no_staging": NO_STAGING,
    "no_sum": [("for (int n = 0; n < NPAD; ++n) acc = __fadd_rn(acc, prod[n * L::kPitch + row]);",
                "acc = prod[row];")],
    "no_bc_reads": [("          const float4 v = q[s / 2];",
                     "          const float4 v = make_float4(0.5f, 0.25f, 0.5f, 0.25f);")],
    "no_prod_writes": [
        ("        p[jj * L::kWarpChannels + n * L::kPitch] = __fmul_rn(h[s], bc.y);\n", "")],
    # the ring's per-chunk wait and the two block barriers left out (one
    # wait at the end, so no copy is in flight when the block leaves)
    "no_sync": [("    cp_async_wait<0>();\n    // chunk c", "    // chunk c"),
                ("    __syncthreads();\n    if (c + 1 < chunks) {", "    if (c + 1 < chunks) {"),
                ("    __syncthreads();  // the chunk's y is whole\n", ""),
                ("\n  if (valid) {\n#pragma unroll",
                 "\n  cp_async_wait<0>();\n  if (valid) {\n#pragma unroll")],
    "fast_exp": [("const float da = expf(", "const float da = __expf(")],
    "unroll1": [("#pragma unroll\n  for (int jj = 0;", "#pragma unroll 1\n  for (int jj = 0;")],
    "rows1": [("constexpr int kSumRows = 2;", "constexpr int kSumRows = 1;")],
    "chunk16": [("constexpr int kChunk = 32;", "constexpr int kChunk = 16;")],
    "fewest_states": [("launch_fitting<16, 2, 4>(", "launch_fitting<16, 1, 2, 4>(")],
    "blocks8": [("__global__ void __launch_bounds__(kThreads) selective_scan_kernel(",
                 "__global__ void __launch_bounds__(kThreads, 8) selective_scan_kernel(")],
    **{f"threads{t}": [("constexpr int kThreads = 128;", f"constexpr int kThreads = {t};")]
       for t in (64, 256)},
    "row": [("\n}  // namespace\n}  // namespace repro_torch\n", ROW_SCAN),
            ("  if (N <= 16) return launch_fitting<16, 2, 4>(",
             "  if (N <= 64) return launch_row(x, dt, a, b, c, h0, y, h_last, B, S, D, N, st);\n"
             "  if (N <= 16) return launch_fitting<16, 2, 4>(")],
}
# glibc's cosine as two paths (below pi/4, and the reduction) and a sine /
# cosine branch, as the kernel first ran it
BRANCHY_COS = """// glibc's cosf, branching as glibc does
__device__ __forceinline__ double cos_poly(double x, double x2, double sgn, bool odd) {
  if (!odd) {  // sine
    const double x3 = __dmul_rn(x, x2);
    const double s1 = __dadd_rn(0x1.1107605230bc4p-7, __dmul_rn(x2, -0x1.994eb3774cf24p-13));
    const double x7 = __dmul_rn(x3, x2);
    const double s = __dadd_rn(x, __dmul_rn(x3, -0x1.555545995a603p-3));
    return __dadd_rn(s, __dmul_rn(x7, s1));
  }
  const double x4 = __dmul_rn(x2, x2);  // cosine: sgn flips the table's signs
  const double c2 = __dadd_rn(sgn * -0x1.6c087e89a359dp-10,
                              __dmul_rn(x2, sgn * 0x1.99343027bf8c3p-16));
  const double c1 = __dadd_rn(sgn * 1.0, __dmul_rn(x2, sgn * -0x1.ffffffd0c621cp-2));
  const double x6 = __dmul_rn(x4, x2);
  const double c = __dadd_rn(c1, __dmul_rn(x4, sgn * 0x1.55553e1068f19p-5));
  return __dadd_rn(c, __dmul_rn(x6, c2));
}

__device__ __forceinline__ float glibc_cosf(float y) {
  const uint32_t top = (__float_as_uint(y) >> 20) & 0x7ff;
  const double x = static_cast<double>(y);
  if (top < 0x3f4u) {  // below pi/4 (abstop12)
    if (top < 0x398u) return 1.f;  // below 2^-12
    return __double2float_rn(cos_poly(x, __dmul_rn(x, x), 1.0, true));
  }
  const double r = __dmul_rn(x, 0x1.45F306DC9C883p+23);
  const int n = (__double2int_rz(r) + 0x800000) >> 24;
  const double xr = __dsub_rn(x, __dmul_rn(static_cast<double>(n), 0x1.921FB54442D18p0));
  const double s = ((n & 3) == 1 || (n & 3) == 2) ? -1.0 : 1.0;
  return __double2float_rn(cos_poly(__dmul_rn(xr, s), __dmul_rn(xr, xr), (n & 2) ? -1.0 : 1.0,
                                    ((n ^ 1) & 1) != 0));
}

"""
NOISE_VEC = ("  const bool vec = cols == kCols && noise::packable(w + i0) && "
             "noise::packable(out + i0);")
NOISE_BODY = _between("noise_perturb.cu", "  const int cols = min(kCols, n - p.col0);",
                      "}\n\ntemplate <typename T, int K>\nint launch(")
ROW_NOISE_BODY = """#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = p.col0 + c;
    if (col >= n) break;
    const size_t i = p.base + col;
    float z;
    const float v = noise::chain<T>(to_f32(w[i]), ch, s0, s1, p.grow, p.gcol0 + c, z);
    out[i] = from_f32<T>(v);
  }
"""
NOISE_VARIANTS = {
    "branchy_cos": [(_between("zo_noise.cuh", "// glibc's cosf (sysdeps/ieee754/flt-32",
                              "// z ~ N(0, 1)"), BRANCHY_COS)],
    "unrolled_scalar": [(NOISE_VEC, "  const bool vec = false;")],
    "scalar": [(NOISE_BODY, ROW_NOISE_BODY)],
    "generic_chain": [("noise::chain<T, K>(", "noise::chain<T>(")],
    "thread_key": [(_between("noise_perturb.cu", "  __shared__ uint32_t key[2];",
                             "  const uint32_t s0 = key[0], s1 = key[1];\n"),
                    "  noise::Place p;\n  if (!noise::place(p, m, n, off)) return;\n"
                    "  uint32_t s0 = k0, s1 = k1;\n"
                    "  noise::slice_key(s0, s1, lead, off, blockIdx.y);\n"),
                   ("  const uint32_t s0 = key[0], s1 = key[1];\n", "")],
    "no_cos": [("return __fmul_rn(r, glibc_cosf(__fmul_rn(0x1.921fb6p+2f, u2)));",
                "return __fmul_rn(r, u2);")],
    "no_threefry": [("  uint32_t x0 = col, x1 = row | (probe << 24);\n"
                     "  threefry2x32(k0, k1, x0, x1);",
                     "  uint32_t x0 = col ^ k0, x1 = (row | (probe << 24)) ^ k1;")],
    **{f"threads{t}": [("constexpr int kThreads = 256;", f"constexpr int kThreads = {t};")]
       for t in (128, 512)},
}


def build(name: str, source: str, edits: list) -> ctypes.CDLL:
    """The edited copy of csrc/<source>.cu (and of the headers, where an
    edit's text is not in the source) as its own shared library."""
    from repro_torch.kernels import _build

    files = {f"{source}.cu": (CSRC / f"{source}.cu").read_text(),
             **{h.name: h.read_text() for h in sorted(CSRC.glob("*.cuh"))}}
    for old, new in edits:
        where = next((f for f, text in files.items() if old in text), None)
        if where is None:
            raise SystemExit(f"variant {name}: {old!r} is in neither {source}.cu nor a header")
        files[where] = files[where].replace(old, new)
    out = ROOT / "build" / "kernel_variants" / f"{source}_{name}"
    out.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (out / f).write_text(text)
    so = out / f"{name}.so"
    cmd = [_build._nvcc(), *_build._ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
           "-Xptxas", "-v", "-o", str(so), str(out / f"{source}.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"variant {name} does not build:\n{done.stdout}{done.stderr}")
    print(json.dumps({"variant": f"{source}_{name}", "ptxas": [
        ln.strip() for ln in (done.stdout + done.stderr).splitlines()
        if "registers" in ln or "spill" in ln]}), flush=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("quant_matmul_fwd", "tezo_perturb_fwd", "subzo_perturb_fwd",
               "tezo_adam_update_fwd", "selective_scan_fwd", "noise_perturb_fwd"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
    return lib


def qmm_call(lib, x, leaf, lut, xu):
    out = torch.empty((x.shape[0], leaf.codes.shape[1]), dtype=x.dtype, device=x.device)
    err = lib.quant_matmul_fwd(x.data_ptr(), leaf.codes.data_ptr(), lut.data_ptr(),
                               xu.data_ptr(), leaf.qv.data_ptr(), out.data_ptr(), x.shape[0],
                               x.shape[1], leaf.codes.shape[0], leaf.codes.shape[1],
                               leaf.qv.shape[1], leaf.bits, 1,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"quant_matmul_fwd: cudaError {err}")
    return out


def main(argv: list) -> int:
    import argparse

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.core.estimator import ZOConfig
    from repro_torch.core.zo_step import init_zo_state
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models import build_model
    from repro_torch.utils.jax_random import PRNGKey
    from repro_torch.utils.tree import flatten_with_path

    ap = argparse.ArgumentParser(description="Time the kernels' design variants.")
    ap.add_argument("--kernels", default="quant_matmul,tezo_perturb,subzo_perturb,"
                    "tezo_adam_update,selective_scan,noise_perturb",
                    help="comma-separated kernels to measure")
    kinds = set(ap.parse_args(argv).kernels.split(","))
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(cs.nvidia_smi_line(), flush=True)
    real = _build.load()

    def bar_ratio(got, ref):
        _, e = torch.frexp(ref.abs())
        ulp = torch.ldexp(torch.ones_like(ref), e - 8)
        return ((got.float() - ref).abs() / (2 * ulp + 1e-5)).max().item()

    def report(kernel, name, unit, fn, **extra):
        t = cs.timed(fn, 30)
        print(json.dumps({"kernel": kernel, "variant": name, "unit": unit, "us": t["ms"] * 1e3,
                          "timer": t["timer"], **extra}), flush=True)

    if "quant_matmul" in kinds:
        qlibs = {"main": real,
                 **{n: build(n, "quant_matmul", e) for n, e in QMM_VARIANTS.items()}}
        for i, (K, N) in enumerate(cs.QMM_SHAPES):
            for scheme in ("nf4", "lut3", "lut4"):
                leaf = cs._qmm_leaf(K, N, scheme, dev, 70 + i)
                x = cs.drandn((cs.QMM_M, K), 80 + i, dev, dtype=torch.bfloat16)
                lut = quant.scaled_lut(leaf)
                xu = x.float() @ (leaf.qu * leaf.acc)
                ref = qm.quant_matmul_plain(x.float(), leaf.codes, lut, xu, leaf.qv,
                                            bits=leaf.bits)
                row = {n: bar_ratio(qmm_call(lib, x, leaf, lut, xu), ref)
                       for n, lib in qlibs.items() if n not in ("no_mma", "no_lut")}
                print(json.dumps({"kernel": "quant_matmul", "scheme": scheme, "M": cs.QMM_M,
                                  "K": K, "N": N, "bar_ratio": row}), flush=True)
        layer = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
        ops = []
        for i, (K, N) in enumerate(layer):
            leaf = cs._qmm_leaf(K, N, "lut4", dev, 100 + i)
            x = cs.drandn((cs.QMM_M, K), 110 + i, dev, dtype=torch.bfloat16)
            ops.append((x, leaf, quant.scaled_lut(leaf), x.float() @ (leaf.qu * leaf.acc)))
        for name, lib in qlibs.items():
            report("quant_matmul", name, "lut4 layer forward (six calls)",
                   lambda lib=lib: [qmm_call(lib, *o) for o in ops])

    params = build_model(get_config("opt-125m"), dev).init(PRNGKey(0))
    flat = dict(flatten_with_path(params))
    state = init_zo_state(params, ZOConfig(method="tezo_adam", rank=24))
    factors = sorted(state.mstate["factors"].items())

    def batch_of(w):
        *_, m, n = w.shape
        return max(1, w.numel() // (m * n)), m, n

    def check(name, err):
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")

    if "tezo_perturb" in kinds:
        tlibs = {"main": real,
                 **{n: build(n, "tezo_perturb", e) for n, e in CHAIN_VARIANTS.items()}}
        leaves = [(flat[path].clone(), f.u, f.v, cs.drandn((*f.batch, 1, f.rank), 100 + i, dev),
                   f.rank) for i, (path, f) in enumerate(factors)]
        chain = _build.DeltaChain.of([cs.TRAIN_RHO], [1.0])

        def tezo_pass(lib):
            for w, u, v, tau, r in leaves:
                B, m, n = batch_of(w)
                check("tezo_perturb_fwd", lib.tezo_perturb_fwd(
                    w.data_ptr(), w.data_ptr(), u.data_ptr(), v.data_ptr(), tau.data_ptr(), chain,
                    B, m, n, r, 1, stream))

        for name, lib in tlibs.items():
            report("tezo_perturb", name, "k = 1 pass over the 10 low-rank leaves",
                   lambda lib=lib: tezo_pass(lib))

    if "subzo_perturb" in kinds:
        slibs = {"main": real,
                 **{n: build(n, "subzo_perturb", e) for n, e in SUBZO_VARIANTS.items()}}
        sub = init_zo_state(params, ZOConfig(method="subzo", rank=24)).mstate
        sleaves = [(flat[p].clone(), sub["U"][p], sub["V"][p],
                    cs.drandn((*sub["U"][p].shape[:-2], 2, 24, 24), 500 + i, dev))
                   for i, p in enumerate(sorted(sub["U"]))]
        r96 = (cs.drandn((1536, 2048), 610, dev, 0.05, torch.bfloat16),
               cs.orthonormal((1536, 96), 611, dev), cs.orthonormal((2048, 96), 612, dev),
               cs.drandn((1, 96, 96), 613, dev))

        pristine = {id(x[0]): x[0].clone() for x in sleaves + [r96]}

        def subzo_pass(lib, leaves, scales, fresh=False):
            """In place, or (``fresh``) on copies of the untimed inputs."""
            k, outs = len(scales), []
            chain = _build.DeltaChain.of(scales, [1.0] * k)
            for w, u, v, sig in leaves:
                B, m, n = batch_of(w)
                r = u.shape[-1]
                x = pristine[id(w)].clone() if fresh else w
                us = torch.empty((B, k, m, r), dtype=torch.float32, device=dev)
                check("subzo_perturb_fwd", lib.subzo_perturb_fwd(
                    x.data_ptr(), x.data_ptr(), u.data_ptr(), v.data_ptr(),
                    sig[..., :k, :, :].contiguous().data_ptr(), us.data_ptr(), chain, B, m, n,
                    r, 1, stream))
                outs.append(x)
            return outs

        units = [("k = 1 pass over the 10 low-rank leaves", sleaves, [cs.TRAIN_RHO]),
                 ("k = 2 update pass over the 10 low-rank leaves", sleaves,
                  [cs.TRAIN_RHO, -cs.TRAIN_LR]),
                 ("r = 96 on [1536, 2048], k = 1", [r96], [1e-3])]
        for unit, leaves, scales in units:
            want = subzo_pass(real, leaves, scales, fresh=True)
            for name, lib in slibs.items():
                diff = {}
                if name in ("main", "row_tile"):
                    got = subzo_pass(lib, leaves, scales, fresh=True)
                    diff = {"bitwise_main": all(torch.equal(a, b) for a, b in zip(got, want)),
                            "unequal": sum(int((a != b).sum()) for a, b in zip(got, want)),
                            "max_abs_diff": max((a.float() - b.float()).abs().max().item()
                                                for a, b in zip(got, want))}
                report("subzo_perturb", name, unit,
                       lambda lib=lib: subzo_pass(lib, leaves, scales), **diff)

    if "tezo_adam_update" in kinds:
        from repro_torch.kernels import tezo_adam as ta
        from repro_torch.kernels import tezo_perturb as tp

        alibs = {"main": real,
                 **{n: build(n, "tezo_adam", e) for n, e in ADAM_VARIANTS.items()}}
        aleaves = [(flat[path].clone(), f.u, f.v,
                    cs.drandn((*f.batch, f.rank), 200 + i, dev, 0.3),
                    cs.drandn((*f.batch, f.rank), 300 + i, dev, 0.3) ** 2,
                    cs.drandn((*f.batch, 1, f.rank), 100 + i, dev))
                   for i, (path, f) in enumerate(factors)]
        pristine = {id(x[0]): x[0].clone() for x in aleaves}

        def adam_pass(lib, fresh=False, lr=cs.TRAIN_LR, restore=True, before=None):
            """In place, or (``fresh``) on copies of the untimed inputs (or of
            ``before``, one tensor per leaf)."""
            chain = _build.DeltaChain.of([cs.TRAIN_RHO] if restore else [], [1.0] * restore)
            outs = []
            for i, (w, u, v, tm, tv, tr) in enumerate(aleaves):
                B, m, n = batch_of(w)
                x = (pristine[id(w)] if before is None else before[i]).clone() if fresh else w
                check("tezo_adam_update_fwd", lib.tezo_adam_update_fwd(
                    x.data_ptr(), x.data_ptr(), u.data_ptr(), v.data_ptr(), tm.data_ptr(),
                    tv.data_ptr(), tr.data_ptr(), chain, -lr, cs.TRAIN_EPS, 1.0, B, m, n,
                    u.shape[-1], 1, stream))
                outs.append(x)
            return outs

        def ulp_ratio(got, want, w_in):
            """Largest |got - want| over phase 2's bf16 bar (1 ulp at the
            larger of the results and the input weight): > 1 fails."""
            mag = torch.maximum(torch.maximum(got.float().abs(), want.float().abs()),
                                w_in.float().abs())
            _, e = torch.frexp(mag)
            return ((got.float() - want.float()).abs() / torch.ldexp(torch.ones_like(mag), e - 8)
                    ).max().item()

        lrs = (cs.TRAIN_LR, 1e-3)
        plain = {lr: [ta.tezo_adam_update_plain(pristine[id(w)].clone(), u, v, tm, tv, lr,
                                                cs.TRAIN_EPS, tau_r=tr,
                                                restore_scale=[cs.TRAIN_RHO])
                      for w, u, v, tm, tv, tr in aleaves] for lr in lrs}
        perturbed = [tp.tezo_perturb(pristine[id(w)].clone(), u, v, tr, [cs.TRAIN_RHO])
                     for w, u, v, tm, tv, tr in aleaves]
        want = adam_pass(real, fresh=True)
        for name, lib in alibs.items():
            extra = {}
            if name in ("main", "unroll1", "fast_rsqrt", "tensor_core"):
                got = adam_pass(lib, fresh=True)
                unchained = adam_pass(lib, fresh=True, restore=False, before=perturbed)
                extra = {
                    "bitwise_main": all(torch.equal(a, b) for a, b in zip(got, want)),
                    "bar_ratio": {str(lr): max(
                        ulp_ratio(a, b, pristine[id(x[0])]) for a, b, x in
                        zip(adam_pass(lib, fresh=True, lr=lr), plain[lr], aleaves))
                        for lr in lrs},
                    "folded_restore_bitwise": all(torch.equal(a, b)
                                                  for a, b in zip(got, unchained))}
            report("tezo_adam_update", name, "pass over the 10 low-rank leaves, with the restore",
                   lambda lib=lib: adam_pass(lib), **extra)

    if "selective_scan" in kinds:
        sclibs = {"main": real,
                  **{n: build(n, "selective_scan", e) for n, e in SCAN_VARIANTS.items()}}

        def scan_call(lib, args):
            x, dt, a, b, c, h0 = args
            (B, S, D), N = x.shape, a.shape[-1]
            y = torch.empty((B, S, D), dtype=torch.float32, device=dev)
            h = torch.empty((B, D, N), dtype=torch.float32, device=dev)
            check("selective_scan_fwd", lib.selective_scan_fwd(
                *(t.data_ptr() for t in (x, dt, a, b, c, h0, y, h)), B, S, D, N, stream))
            return y, h

        for label, (B, S, D, N) in cs.SCAN_TIME_CASES:
            args = cs._scan_inputs(B, S, D, N, dev, 700)
            want = scan_call(real, args)
            for name, lib in sclibs.items():
                got = scan_call(lib, args)
                report("selective_scan", name, f"{label} (B {B}, S {S}, D {D}, N {N})",
                       lambda lib=lib: scan_call(lib, args),
                       bitwise_main=all(torch.equal(a, b) for a, b in zip(got, want)))

    if "noise_perturb" in kinds:
        from repro_torch.core import dispatch
        from repro_torch.kernels import zo_noise as zn
        from repro_torch.kernels.tezo_perturb import _DTYPES

        nlibs = {"main": real,
                 **{n: build(n, "noise_perturb", e) for n, e in NOISE_VARIANTS.items()}}
        nleaves = [(w.clone(), zn.leaf_seed(PRNGKey(7), path), w)
                   for path, w in flatten_with_path(params) if dispatch.noise_kernel_eligible(w)]
        chain = _build.NoiseChain.of(zn._chain([0], [cs.TRAIN_RHO]))

        def noise_pass(lib, fresh=False):
            """In place, or (``fresh``) on copies of the untimed inputs."""
            outs = []
            for w, seed, w0 in nleaves:
                x = w0.clone() if fresh else w
                lead, B, m, n = zn._check_leaf(x, seed)
                check("noise_perturb_fwd", lib.noise_perturb_fwd(
                    x.data_ptr(), x.data_ptr(), seed[0], seed[1], chain, lead,
                    _build.NoiseOffsets.of(None), B, m, n, _DTYPES[x.dtype], stream))
                outs.append(x)
            return outs

        want = noise_pass(real, fresh=True)
        for name, lib in nlibs.items():
            got = noise_pass(lib, fresh=True)
            report("noise_perturb", name, f"k = 1 pass over the {len(nleaves)} eligible leaves",
                   lambda lib=lib: noise_pass(lib),
                   bitwise_main=all(torch.equal(a, b) for a, b in zip(got, want)),
                   unequal=sum(int((a != b).sum()) for a, b in zip(got, want)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
