// TeZO perturbation chain for Hopper: in place (or into a second buffer),
// for s = 0 .. k-1,
//   W <- round_W(d_s * W + scale_s * (u * diag(tau_s)) v^T),  d_s = 1 but the last,
// and LOZO's chain on the same kernel,
//   W <- round_W(d_s * W + scale_s * u v_s^T),  one fresh v_s per delta.
//
// Replaces the TPU kernel repro/kernels/tezo_perturb.py::tezo_perturb
// (through repro.kernels.ops.tezo_perturb, which maps it over a leaf's
// leading dims).  One launch covers a whole leaf: the grid is (column tiles,
// row tiles, batch index), so a stacked [12, 768, 3072] leaf is one launch.
// Each block owns a 64 x 128 tile of W and forms each rank-r delta Z in
// registers: 32 rank columns at a time, the block's rows of u, v and tau
// arrive as they lie in memory (16-byte cp.async, every copy of a chunk in
// flight at once), are transposed in shared memory into the staging tile
// (TeZO's u * tau formed there), and are summed with one fma per term in
// ascending order (common.cuh rank_fma, as tezo_adam.cu's restore and
// moments sum theirs).
// Z never reaches device memory; W is read once and written once per chain.
//
// What bounds it on the H100: per element and delta, 2r f32 flops on the
// CUDA cores against 4 bytes of bf16 traffic per pass (read and write).  At
// r = 24 and k = 1 the bytes bound it (4 B / 3.35 TB/s > 48 flop / 67
// TFLOP/s), by less than a factor of two; LOZO's two-delta update tips it
// to the operations.  chip_smoke.py computes both bounds.
//
// The W stream: the block's tile arrives in shared memory by 16-byte
// cp.async, issued before the factors are staged, so the tile's load
// overlaps the rank-r product instead of standing in front of it.  Each
// delta is applied from shared memory (the tile holds W in its own type,
// which is the rounding every delta ends in), Z stays in registers, and the
// tile goes back with 16-byte stores, coalesced across the warp.  Rows whose
// length is not a multiple of 16 bytes (n % 8 for bf16: a vocabulary of
// 32001, a leaf of 257 columns) are loaded and stored element by element.
// Ragged edges are masked, not padded.
//
// LOZO's chain passes u as it is and the k fresh V factors by pointer
// (FactorList), so delta s sums only its own r columns: u v_s^T with u's
// entries as they are (TeZO's u * tau at tau = 1 is the same value).  The
// same chain on k * r widened factors with a one-hot tau adds exact zeros
// outside each delta's block to a sum that starts at +0: the same sums, at
// k times the operations and four elementwise launches a leaf to build the
// widened operands (tests/test_torch_cuda.py holds the two bitwise equal).
//
// Numerics follow the reference's f32 accumulate: each delta is
// round_W(d*w + sc*z) with the two products and the sum rounded separately
// (no fma), and the next delta reads the rounded value, so a k-delta chain
// is bitwise k single launches.  bf16 stores round to nearest even.

#include "common.cuh"

namespace repro_torch {
namespace {

using tezo::kBM;
using tezo::kBN;
using tezo::kThreads;
using tezo::kTM;
using tezo::kTN;
using tezo::kRC;

// cp.async of 4 bytes (LDGSTS); where !pred the 4 bytes are zeros and src
// is not read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// A chunk of rank columns c0 .. c0 + kRC - 1 as it lies in u's rows, v's
// rows and tau (pitch kRP: 16-byte rows, a transposing read 4-way at most).
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

// What a delta's chunk stages, and transposes: u (a-side), v (b-side),
// tau (a-side scale).  A later delta of a one-chunk rank restages only
// what changed: LOZO's fresh v, or TeZO's tau (its u and v stay).
struct Parts {
  bool u, v, tau;
};

// The chunk's factor rows into raw, one commit group.
__device__ __forceinline__ void stage_factors(RawFactors& raw, const float* __restrict__ u,
                                              const float* __restrict__ v,
                                              const float* __restrict__ tau,
                                              const tezo::Tile& t, int c0, Parts parts,
                                              bool vec) {
  const int jn = min(kRC, t.r - c0);
  if (parts.u) stage_rows<kBM>(raw.u, u, t.row0, t.m, t.r, c0, jn, vec);
  if (parts.v) stage_rows<kBN>(raw.v, v, t.col0, t.n, t.r, c0, jn, vec);
  if (parts.tau) {
    if (vec) {
      if (4 * static_cast<int>(threadIdx.x) < jn)
        cp_async16(&raw.tau[4 * threadIdx.x], tau + c0 + 4 * threadIdx.x, true);
    } else if (static_cast<int>(threadIdx.x) < jn) {
      cp_async4(&raw.tau[threadIdx.x], tau + c0 + threadIdx.x, true);
    }
  }
  cp_async_commit();
}

// The raw chunk into the staging tile, in the places rank_product_cols's
// loops put it: sm.a[j][i] = u[row0 + i, c0 + j] * tau[c0 + j] (rounded as
// TauA<false> rounds it; u as it is for LOZO), sm.b[j][l] = v[col0 + l, c0
// + j], for the chunk's jn columns; the a-side where parts.u or parts.tau,
// the b-side where parts.v.  The caller synchronises around it.
template <bool kTau>
__device__ __forceinline__ void transpose_factors(tezo::RankSmem& sm, const RawFactors& raw,
                                                  int jn, Parts parts) {
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

// kLozo: the deltas are u vs.p[s]^T (tau unused); else (u * tau_s) v^T.
// Each delta's factor chunks go through rank_fma (common.cuh), the sums
// tezo_adam.cu's restore forms; the first chunk's copies are issued before
// the W tile's, so the product waits for the factors alone.
template <typename T, bool kLozo>
__global__ void __launch_bounds__(kThreads, 3) tezo_perturb_kernel(
    const T* w, T* out, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ tau, FactorList vs, DeltaChain chain, int m, int n, int r,
    bool vec, bool vec_f) {
  __shared__ tezo::RankSmem sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* ws = reinterpret_cast<T*>(dyn);  // [kBM][kBN]
  RawFactors& raw = *reinterpret_cast<RawFactors*>(dyn + sizeof(T) * kBM * kBN);
  const size_t b = blockIdx.z;
  const tezo::Tile t{m, n, r, static_cast<int>(blockIdx.y) * kBM,
                     static_cast<int>(blockIdx.x) * kBN};
  const size_t mn = static_cast<size_t>(m) * n;
  const float* ub = u + b * m * r;
  const auto vof = [&](int s) { return (kLozo ? vs.p[s] : v) + b * n * r; };
  const auto tauof = [&](int s) {
    return kLozo ? nullptr : tau + (b * chain.k + s) * static_cast<size_t>(r);
  };
  // Chunks run in order (delta s, rank columns c0); a chunk's copies are
  // issued as soon as the previous one is transposed, so they overlap its
  // product.  A one-chunk rank keeps what the deltas share staged.
  const Parts all{true, true, !kLozo};
  const auto parts_of = [&](int s) {
    return s > 0 && r <= kRC ? Parts{false, kLozo, !kLozo} : all;
  };
  stage_factors(raw, ub, vof(0), tauof(0), t, 0, all, vec_f);
  tezo::stage_w_tile(ws, w + b * mn, t, vec);
  bool next_issued = false;
  for (int s = 0; s < chain.k; ++s) {
    float z[kTM][kTN];
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int c = 0; c < kTN; ++c) z[a][c] = 0.f;
    for (int c0 = 0; c0 < r; c0 += kRC) {
      if (s == 0 && c0 == 0)
        cp_async_wait<1>();  // the factors; the W tile may still be in flight
      else
        cp_async_wait<0>();
      __syncthreads();  // this chunk is in, whoever copied it; the last product is done
      const int jn = min(kRC, r - c0);
      transpose_factors<!kLozo>(sm, raw, jn, parts_of(s));
      __syncthreads();  // raw is free again
      const int ns = c0 + kRC < r ? s : s + 1, nc0 = c0 + kRC < r ? c0 + kRC : 0;
      next_issued = ns < chain.k;
      if (next_issued) stage_factors(raw, ub, vof(ns), tauof(ns), t, nc0, parts_of(ns), vec_f);
      tezo::rank_fma(z, sm, jn);
    }
    if (s == 0) {  // the W tile (issued before any next chunk's copies)
      if (next_issued)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // the tile is in, whoever copied each element
    }
    tezo::apply_delta_smem<T>(ws, z, chain.decay[s], chain.scale[s]);
  }
  __syncthreads();
  tezo::store_w_tile(out + b * mn, ws, t, vec);
}

template <typename T, bool kLozo>
int launch(const void* w, void* out, const float* u, const float* v, const float* tau,
           const FactorList& vs, const DeltaChain& chain, int B, int m, int n, int r,
           cudaStream_t st) {
  constexpr size_t smem = sizeof(T) * kBM * kBN + sizeof(RawFactors);
  auto kernel = tezo_perturb_kernel<T, kLozo>;
  if (smem + sizeof(tezo::RankSmem) > 48 * 1024) {  // static + dynamic above 48 KB: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = (n * sizeof(T)) % 16 == 0 && ((addr(w) | addr(out)) % 16) == 0;
  bool vec_f = r % 4 == 0 && ((addr(u) | addr(v) | addr(tau)) % 16) == 0;
  for (int s = 0; kLozo && s < chain.k; ++s) vec_f = vec_f && addr(vs.p[s]) % 16 == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, B);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(w), static_cast<T*>(out), u, v,
                                       tau, vs, chain, m, n, r, vec, vec_f);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int m, int n, int r, int k) {
  return B <= 0 || m <= 0 || n <= 0 || r <= 0 || k < 1 || k > kMaxChain || B > 65535 ||
         (m + kBM - 1) / kBM > 65535;
}

}  // namespace
}  // namespace repro_torch

// w, out: [B, m, n] (may be the same buffer); u [B, m, r], v [B, n, r] and
// tau [B, k, r] f32; dtype 0 = f32, 1 = bf16.
extern "C" int tezo_perturb_fwd(const void* w, void* out, const float* u, const float* v,
                                const float* tau, repro_torch::DeltaChain chain, int B,
                                int m, int n, int r, int dtype, void* stream) {
  using namespace repro_torch;
  if (bad_shape(B, m, n, r, chain.k)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FactorList none{};
  if (dtype == 0) return launch<float, false>(w, out, u, v, tau, none, chain, B, m, n, r, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(w, out, u, v, tau, none, chain, B, m, n, r, st);
  return cudaErrorInvalidValue;
}

// LOZO's chain: w, out [B, m, n] (may be the same buffer); u [B, m, r] and
// vs.p[s] [B, n, r] f32 for s < chain.k; dtype 0 = f32, 1 = bf16.
extern "C" int lozo_chain_fwd(const void* w, void* out, const float* u,
                              repro_torch::FactorList vs, repro_torch::DeltaChain chain, int B,
                              int m, int n, int r, int dtype, void* stream) {
  using namespace repro_torch;
  if (bad_shape(B, m, n, r, chain.k)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(w, out, u, nullptr, nullptr, vs, chain, B, m, n, r, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(w, out, u, nullptr, nullptr, vs, chain, B, m, n, r, st);
  return cudaErrorInvalidValue;
}
