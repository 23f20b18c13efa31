// Helpers shared by the port's kernels: f32 conversion of the two input
// types, the reference's finite mask constant, cp.async, the tensor-core
// operand loads and products, and the low-rank weight-pass tile (the W
// stream, the factor staging, the rank-r sum and the rounded delta) that
// tezo_perturb.cu, tezo_adam.cu and subzo_perturb.cu all run, so that a
// restore folded into the Adam launch is bitwise the separate perturb
// launch it replaces.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

// The reference masks with -1e30, not -inf, so an all-masked row stays
// finite (exp(-1e30 - m) underflows to an exact 0 for any finite m).
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
}

// cp.async: 16 bytes global -> shared, asynchronous (LDGSTS); where !pred
// the 16 bytes are zeros and src is not read.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// cp.async of 4 bytes (LDGSTS); where !pred the 4 bytes are zeros and src
// is not read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tensor-core operand loads and products (mma.sync m16n8k16), shared by
// flash_attention.cu and quant_matmul.cu.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b on a 16 x 8 x 16 tile: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> hi = bf16x2(x, y), lo = bf16x2 of what hi leaves out
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// The opt-in to more than 48 KB of shared memory a block (static plus
// dynamic), made once per kernel instance; returns its cudaError_t.
template <auto kKernel>
inline int allow_smem(size_t bytes) {
  static const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  return static_cast<int>(err);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// --------------------------------------------------------------------------
// TeZO weight passes
// --------------------------------------------------------------------------

// A chain of up to kMaxChain rank-r deltas applied in order in one pass:
// W <- round_W(decay[s] * W + scale[s] * Z_s), Z_s = (u * diag(tau_s)) v^T.
// Passed to the kernels by value; the host fills it from Python floats.
constexpr int kMaxChain = 8;
struct DeltaChain {
  float scale[kMaxChain];
  float decay[kMaxChain];
  int k;
};

// One f32 factor per delta of a chain (LOZO's fresh V), by value.
struct FactorList {
  const float* p[kMaxChain];
};

namespace tezo {

// A block owns a kBM x kBN tile of one matrix of the (batched) leaf; thread
// (tx, ty) owns rows ty*kTM .. +3 and columns tx*4 .. +3 and 64 + tx*4 .. +3.
// The rank-r sum is staged through shared memory kRC factor columns at a
// time, as f32 [j][row] and [j][col] so each step is three 16-byte loads
// (kPad keeps the transposed stores to 4-way bank conflicts with 16-byte
// aligned rows).
constexpr int kBM = 64, kBN = 128, kRC = 32, kPad = 4;
constexpr int kTM = 4, kTN = 8;
constexpr int kThreads = 256;

struct Tile {
  int m, n, r, row0, col0;
};

struct __align__(16) RankSmem {
  float a[kRC][kBM + kPad];
  float b[kRC][kBN];
};

__device__ __forceinline__ int tile_row(int a) { return (threadIdx.x / 16) * kTM + a; }
__device__ __forceinline__ int tile_col(int c) {
  return (c < 4 ? 0 : 64 - 4) + (threadIdx.x % 16) * 4 + c;
}

// acc[a][c] += sum_j sm.a[j][row a] * sm.b[j][column c] over the staged
// rank columns j = 0 .. jn-1 in ascending order, one f32 fma per term.  A
// sum split over consecutive column chunks is bitwise the sum over all.
__device__ __forceinline__ void rank_fma(float (&acc)[kTM][kTN], const RankSmem& sm, int jn) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int j = 0; j < jn; ++j) {
    const float4 a4 = *reinterpret_cast<const float4*>(&sm.a[j][ty * kTM]);
    const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[j][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[j][64 + tx * 4]);
    const float av[kTM] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[a][c] = 0.f;
}

// The weight tile through shared memory: ws is the block's [kBM][kBN] tile
// of W in W's own type, so a delta that rounds to T and widens back is a
// store to ws and a load from it.  stage_w_tile fills it by 16-byte
// cp.async where vec (every row 16-byte aligned: n a multiple of 16 /
// sizeof(T) and an aligned base), else element by element, and commits one
// cp.async group either way (empty in the second case), to be waited for
// before the first apply_delta_smem; store_w_tile writes the tile back the
// same way.  Rows >= m and columns >= n are neither read nor written in W.
template <typename T>
__device__ __forceinline__ void stage_w_tile(T* ws, const T* W, const Tile& t, bool vec) {
  constexpr int kPer = 16 / sizeof(T), kCPR = kBN / kPer;  // elements per chunk, chunks per row
  if (vec) {
    for (int idx = threadIdx.x; idx < kBM * kCPR; idx += kThreads) {
      const int i = idx / kCPR, c = (idx % kCPR) * kPer, row = t.row0 + i, col = t.col0 + c;
      const bool ok = row < t.m && col < t.n;
      cp_async16(ws + i * kBN + c, W + (ok ? static_cast<size_t>(row) * t.n + col : 0), ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
      const int i = idx / kBN, c = idx % kBN, row = t.row0 + i, col = t.col0 + c;
      ws[idx] = (row < t.m && col < t.n) ? W[static_cast<size_t>(row) * t.n + col]
                                         : from_f32<T>(0.f);
    }
  }
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ void store_w_tile(T* W, const T* ws, const Tile& t, bool vec) {
  constexpr int kPer = 16 / sizeof(T), kCPR = kBN / kPer;
  if (vec) {
    for (int idx = threadIdx.x; idx < kBM * kCPR; idx += kThreads) {
      const int i = idx / kCPR, c = (idx % kCPR) * kPer, row = t.row0 + i, col = t.col0 + c;
      if (row < t.m && col < t.n)
        *reinterpret_cast<uint4*>(W + static_cast<size_t>(row) * t.n + col) =
            *reinterpret_cast<const uint4*>(ws + i * kBN + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
      const int i = idx / kBN, c = idx % kBN, row = t.row0 + i, col = t.col0 + c;
      if (row < t.m && col < t.n) W[static_cast<size_t>(row) * t.n + col] = ws[idx];
    }
  }
}

// four consecutive elements of a shared tile as f32, and back (rounded)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __halves2bfloat162(from_f32<__nv_bfloat16>(v[0]),
                                              from_f32<__nv_bfloat16>(v[1]));
  const __nv_bfloat162 b = __halves2bfloat162(from_f32<__nv_bfloat16>(v[2]),
                                              from_f32<__nv_bfloat16>(v[3]));
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// One delta on the thread's elements of the shared tile: w <- round_T(d *
// w + sc * z), each product and the sum rounded on its own (no fma: the
// reference's f32 accumulate keeps them apart).
template <typename T>
__device__ __forceinline__ void apply_delta_smem(T* ws, const float (&z)[kTM][kTN], float d,
                                                 float sc) {
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int h = 0; h < kTN / 4; ++h) {
      T* p = ws + tile_row(a) * kBN + tile_col(4 * h);
      float w[4];
      load4(p, w);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[c] = __fadd_rn(__fmul_rn(d, w[c]), __fmul_rn(sc, z[a][4 * h + c]));
      store4(p, w);
    }
}

// A chunk of rank columns c0 .. c0 + kRC - 1 as it lies in the a-side's
// rows, the b-side's rows and tau (pitch kRP: 16-byte rows, a transposing
// read 4-way at most).
constexpr int kRP = kRC + 4;
struct RawFactors {
  float u[kBM][kRP];
  float v[kBN][kRP];
  float tau[kRC];
};

// One factor's rows for this tile (rows row0 .. row0 + rows - 1, rank
// columns c0 .. c0 + jn - 1) into dst [rows][kRP]: 16-byte copies where vec
// (r a multiple of 4, an aligned base), else 4-byte ones; zeros at rows >=
// limit.  Part of the caller's commit group.
template <int kRows>
__device__ __forceinline__ void stage_rows(float (*dst)[kRP], const float* __restrict__ src,
                                           int row0, int limit, int r, int c0, int jn,
                                           bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < kRows * (kRC / 4); idx += kThreads) {
      const int i = idx / (kRC / 4), q = idx % (kRC / 4), row = row0 + i;
      if (4 * q >= jn) continue;
      const bool ok = row < limit;
      cp_async16(&dst[i][4 * q], src + static_cast<size_t>(ok ? row : 0) * r + c0 + 4 * q, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * kRC; idx += kThreads) {
      const int i = idx / kRC, j = idx % kRC, row = row0 + i;
      if (j >= jn) continue;
      const bool ok = row < limit;
      cp_async4(&dst[i][j], src + static_cast<size_t>(ok ? row : 0) * r + c0 + j, ok);
    }
  }
}

// tau's chunk c0 .. c0 + jn - 1 into dst, part of the caller's commit group.
__device__ __forceinline__ void stage_tau(float* dst, const float* __restrict__ tau, int c0,
                                          int jn, bool vec) {
  if (vec) {
    if (4 * static_cast<int>(threadIdx.x) < jn)
      cp_async16(dst + 4 * threadIdx.x, tau + c0 + 4 * threadIdx.x, true);
  } else if (static_cast<int>(threadIdx.x) < jn) {
    cp_async4(dst + threadIdx.x, tau + c0 + threadIdx.x, true);
  }
}

// What a delta's chunk stages, and transposes: the a-side rows, the b-side
// rows, tau (the a-side's scale).  A later delta of a one-chunk rank
// restages only what changed: TeZO's tau, LOZO's fresh b-side (V), SubZO's
// a-side (U * Sigma_s).
struct Parts {
  bool u, v, tau;
};

// The chunk's factor rows into raw, one commit group.
__device__ __forceinline__ void stage_factors(RawFactors& raw, const float* __restrict__ u,
                                              const float* __restrict__ v,
                                              const float* __restrict__ tau, const Tile& t,
                                              int c0, Parts parts, bool vec) {
  const int jn = min(kRC, t.r - c0);
  if (parts.u) stage_rows<kBM>(raw.u, u, t.row0, t.m, t.r, c0, jn, vec);
  if (parts.v) stage_rows<kBN>(raw.v, v, t.col0, t.n, t.r, c0, jn, vec);
  if (parts.tau) stage_tau(raw.tau, tau, c0, jn, vec);
  cp_async_commit();
}

// The raw chunk into the staging tile: sm.a[j][i] = u[row0 + i, c0 + j] *
// tau[c0 + j] (kTau; the product rounded as the reference's elementwise
// product) or u as it is, sm.b[j][l] = v[col0 + l, c0 + j], for the chunk's
// jn columns; the a-side where parts.u or parts.tau, the b-side where
// parts.v.  The caller synchronises around it.
template <bool kTau>
__device__ __forceinline__ void transpose_factors(RankSmem& sm, const RawFactors& raw, int jn,
                                                  Parts parts) {
  if (parts.u || parts.tau) {
    for (int idx = threadIdx.x; idx < kBM * kRC; idx += kThreads) {
      const int i = idx / kRC, j = idx % kRC;
      if (j < jn) sm.a[j][i] = kTau ? __fmul_rn(raw.u[i][j], raw.tau[j]) : raw.u[i][j];
    }
  }
  if (parts.v) {
    for (int idx = threadIdx.x; idx < kBN * kRC; idx += kThreads) {
      const int l = idx % kBN, j = idx / kBN;
      if (j < jn) sm.b[j][l] = raw.v[l][j];
    }
  }
}

// The chain of deltas over one tile, W through shared memory (ws, T
// [kBM][kBN]) and the factors through raw and sm.  Src names delta s's
// a-side rows (src.a(s), [m][r]), b-side rows (src.b(s), [n][r]) and tau
// (src.tau_of(s), [r]; read where kTau), and src.later(), what a later delta of
// a one-chunk rank restages.  Chunks run in order (delta s, rank columns
// c0); a chunk's copies are issued as soon as the previous one is
// transposed, so they overlap its product, and the first chunk's copies
// are issued before the W tile's, so the first product waits for the
// factors alone.  Each delta's chunks go through rank_fma in ascending
// column order into Z (registers), then apply_delta_smem.
template <typename T, bool kTau, typename Src>
__device__ __forceinline__ void chain_pass(T* ws, RawFactors& raw, RankSmem& sm, const T* w,
                                           T* out, const Src& src, const DeltaChain& chain,
                                           const Tile& t, bool vec, bool vec_f) {
  const int r = t.r;
  const Parts all{true, true, kTau};
  const auto parts_of = [&](int s) { return s > 0 && r <= kRC ? src.later() : all; };
  stage_factors(raw, src.a(0), src.b(0), src.tau_of(0), t, 0, all, vec_f);
  stage_w_tile(ws, w, t, vec);
  bool next_issued = false;
  for (int s = 0; s < chain.k; ++s) {
    float z[kTM][kTN];
    zero(z);
    for (int c0 = 0; c0 < r; c0 += kRC) {
      if (s == 0 && c0 == 0)
        cp_async_wait<1>();  // the factors; the W tile may still be in flight
      else
        cp_async_wait<0>();
      __syncthreads();  // this chunk is in, whoever copied it; the last product is done
      const int jn = min(kRC, r - c0);
      transpose_factors<kTau>(sm, raw, jn, parts_of(s));
      __syncthreads();  // raw is free again
      const int ns = c0 + kRC < r ? s : s + 1, nc0 = c0 + kRC < r ? c0 + kRC : 0;
      next_issued = ns < chain.k;
      if (next_issued)
        stage_factors(raw, src.a(ns), src.b(ns), src.tau_of(ns), t, nc0, parts_of(ns), vec_f);
      rank_fma(z, sm, jn);
    }
    if (s == 0) {  // the W tile (issued before any next chunk's copies)
      if (next_issued)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // the tile is in, whoever copied each element
    }
    apply_delta_smem<T>(ws, z, chain.decay[s], chain.scale[s]);
  }
  __syncthreads();
  store_w_tile(out, ws, t, vec);
}

// chain_pass's dynamic shared memory: the W tile, then the raw chunk.
template <typename T>
constexpr size_t kChainSmem = sizeof(T) * kBM * kBN + sizeof(RawFactors);

}  // namespace tezo

}  // namespace repro_torch
