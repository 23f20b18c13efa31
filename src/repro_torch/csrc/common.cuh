// Helpers shared by the port's kernels: f32 conversion of the two input
// types, the reference's finite mask constant, cp.async, the tensor-core
// operand loads and products, and the low-rank weight-pass tile (the rank-r
// product and the rounded delta) that tezo_perturb.cu, tezo_adam.cu and
// subzo_perturb.cu all run, so that a restore folded into the Adam launch
// is bitwise the separate perturb launch it replaces.
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
// time, as f32 [j][row] and [j][col] so each step is three 16-byte loads.
// A warp stages 32 rows of one rank column, except for an a-side loader
// that sets kWarpPerRow (SubZO's U * Sigma, an r-term sum per value): there
// a warp takes one row and kRC consecutive columns, so each term is one
// broadcast read of U's row instead of 32 cache lines, and kPad keeps the
// transposed stores to 4-way bank conflicts with 16-byte aligned rows.
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

template <typename T>
__device__ __forceinline__ void load_tile(float (&w)[kTM][kTN], const T* W, const Tile& t) {
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int row = t.row0 + tile_row(a);
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int col = t.col0 + tile_col(c);
      w[a][c] = (row < t.m && col < t.n)
                    ? to_f32(W[static_cast<size_t>(row) * t.n + col]) : 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* W, const float (&w)[kTM][kTN], const Tile& t) {
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int row = t.row0 + tile_row(a);
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int col = t.col0 + tile_col(c);
      if (row < t.m && col < t.n) W[static_cast<size_t>(row) * t.n + col] = from_f32<T>(w[a][c]);
    }
  }
}

// acc[a][c] += sum_j sm.a[j][row a] * sm.b[j][column c] over the staged
// rank columns j = 0 .. jn-1 in ascending order, one f32 fma per term.
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

// acc[i][l] += sum_j a(row_i, j) * b(l, j) for rank columns j = c_begin ..
// c_end-1 in ascending order, one f32 fma per term (rank_fma), with b = v
// (kSquaredB: v * v) and a given by the loader ``ALoad::a(u, aux, row, c0,
// j, r)`` for rank column c0 + j: TeZO's u * tau (TauA<false>, aux = tau),
// its squared form (TauA<true>) or SubZO's row of U * Sigma
// (subzo_perturb.cu, aux = Sigma's staged columns).  Rows >= m and columns
// >= n read zeros.  A sum split over consecutive column ranges is bitwise
// the sum over all of them.
template <bool kSquaredB, typename ALoad, typename Aux>
__device__ __forceinline__ void rank_product_cols(float (&acc)[kTM][kTN],
                                                  const float* __restrict__ u,
                                                  const float* __restrict__ v,
                                                  const Aux& aux, const Tile& t,
                                                  RankSmem& sm, int c_begin, int c_end) {
  for (int c0 = c_begin; c0 < c_end; c0 += kRC) {
    const int jn = min(kRC, c_end - c0);
    __syncthreads();  // the previous chunk has been read
    for (int idx = threadIdx.x; idx < kRC * kBM; idx += kThreads) {
      const int j = ALoad::kWarpPerRow ? idx % kRC : idx / kBM;
      const int i = ALoad::kWarpPerRow ? idx / kRC : idx % kBM, row = t.row0 + i;
      float x = 0.f;
      if (j < jn && row < t.m) x = ALoad::a(u, aux, row, c0, j, t.r);
      sm.a[j][i] = x;
    }
    for (int idx = threadIdx.x; idx < kRC * kBN; idx += kThreads) {
      const int l = idx % kBN, j = idx / kBN, col = t.col0 + l;
      float y = 0.f;
      if (j < jn && col < t.n) {
        const float vv = v[static_cast<size_t>(col) * t.r + c0 + j];
        y = kSquaredB ? __fmul_rn(vv, vv) : vv;
      }
      sm.b[j][l] = y;
    }
    __syncthreads();
    rank_fma(acc, sm, jn);
  }
}

// acc = the whole rank-r product (rank_product_cols over columns 0 .. r-1).
template <bool kSquaredB, typename ALoad, typename Aux>
__device__ __forceinline__ void rank_product(float (&acc)[kTM][kTN],
                                             const float* __restrict__ u,
                                             const float* __restrict__ v, const Aux& aux,
                                             const Tile& t, RankSmem& sm) {
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[a][c] = 0.f;
  rank_product_cols<kSquaredB, ALoad>(acc, u, v, aux, t, sm, 0, t.r);
}

// TeZO's a-side: u * tau (kSquared: (u * u) * tau), each factor product
// rounded as the reference's elementwise products are.
template <bool kSquared>
struct TauA {
  static constexpr bool kWarpPerRow = false;
  static __device__ __forceinline__ float a(const float* __restrict__ u,
                                            const float* __restrict__ tau, int row, int c0,
                                            int j, int r) {
    const float uu = u[static_cast<size_t>(row) * r + c0 + j];
    return kSquared ? __fmul_rn(__fmul_rn(uu, uu), tau[c0 + j]) : __fmul_rn(uu, tau[c0 + j]);
  }
};

// TeZO's product: a = u * tau (kSquared: (u * u) * tau), b = v (v * v).
template <bool kSquared>
__device__ __forceinline__ void rank_r_product(float (&acc)[kTM][kTN],
                                               const float* __restrict__ u,
                                               const float* __restrict__ v,
                                               const float* __restrict__ tau,
                                               const Tile& t, RankSmem& sm) {
  rank_product<kSquared, TauA<kSquared>>(acc, u, v, tau, t, sm);
}

// One delta: w <- round_T(d * w + sc * z), each product and the sum rounded
// on its own (no fma: the reference's f32 accumulate keeps them apart),
// then widened back to f32 for the next delta.
template <typename T>
__device__ __forceinline__ void apply_delta(float (&w)[kTM][kTN], const float (&z)[kTM][kTN],
                                            float d, float sc) {
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int c = 0; c < kTN; ++c)
      w[a][c] = to_f32(from_f32<T>(__fadd_rn(__fmul_rn(d, w[a][c]), __fmul_rn(sc, z[a][c]))));
}

// The weight tile through shared memory, for tezo_perturb.cu: ws is the
// block's [kBM][kBN] tile of W in W's own type, so a delta that rounds to
// T and widens back (apply_delta) is a store to ws and a load from it.
// stage_w_tile fills it by 16-byte cp.async where vec (every row 16-byte
// aligned: n a multiple of 16 / sizeof(T) and an aligned base), else
// element by element, and commits one cp.async group either way (empty in
// the second case), to be waited for before the first apply_delta_smem;
// store_w_tile writes the tile back the same way.  Rows >= m and columns
// >= n are neither read nor written in W.
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

// apply_delta on the thread's elements of the shared tile: w <- round_T(d *
// w + sc * z), the products and the sum rounded apart, as apply_delta.
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

// The chain's deltas in order; taus is [k][r] for this tile's matrix.
template <typename T>
__device__ __forceinline__ void delta_chain(float (&w)[kTM][kTN], const float* __restrict__ u,
                                            const float* __restrict__ v,
                                            const float* __restrict__ taus,
                                            const DeltaChain& ch, const Tile& t,
                                            RankSmem& sm) {
  for (int s = 0; s < ch.k; ++s) {
    float z[kTM][kTN];
    rank_r_product<false>(z, u, v, taus + static_cast<size_t>(s) * t.r, t, sm);
    apply_delta<T>(w, z, ch.decay[s], ch.scale[s]);
  }
}

}  // namespace tezo

}  // namespace repro_torch
