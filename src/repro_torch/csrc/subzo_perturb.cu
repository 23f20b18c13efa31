// SubZO perturbation chain for Hopper: in place (or into a second buffer),
// for s = 0 .. k-1,
//   W <- round_W(d_s * W + scale_s * (U * Sigma_s) V^T),  d_s = 1 but the last.
//
// Replaces the TPU kernel repro/kernels/zo_noise.py::subzo_perturb (through
// repro.kernels.ops.subzo_perturb, which maps it over a leaf's leading
// dims).  U [m, r] and V [n, r] are the window's orthonormal f32 factors,
// Sigma_s an f32 [r, r] core per delta.  A call is two launches:
//
// 1. us_kernel forms U * Sigma_s once per leaf and delta into an f32 scratch
//    [B, k, m, r] that the caller passes (the wrapper takes it from the
//    caching allocator: 9.7 MB for a [50272, 768] embedding at r = 24 and
//    k = 2).  A block owns 64 rows x 32 columns of one matrix; U's rows and
//    Sigma's columns are staged 32 terms at a time and each value is one
//    fma per term over Sigma's rows in ascending order from +0.
// 2. subzo_perturb_kernel is tezo_perturb.cu's weight pass (common.cuh
//    chain_pass): the block's 64 x 128 tile of W arrives in shared memory by
//    16-byte cp.async, the factor rows are copied as they lie and transposed
//    in shared memory, each delta is summed with one fma per term in
//    ascending order into registers and applied to the shared tile, which
//    goes back with 16-byte stores.  U * Sigma_s is the a-side (as is, no
//    tau) and V the fixed b-side: LOZO's chain with the roles swapped, so a
//    later delta of a one-chunk rank restages only the a-side.  Above 32
//    rank columns the sum runs in chunks of 32, in the same ascending order.
//
// Each value of U * Sigma_s and each rank-r sum is the one the previous
// design formed per tile (it formed U * Sigma_s again in every 128-column
// tile), so every bit of the result is the same; forming it once takes the
// 2r^2 flops a row off every column tile but the first.
//
// What bounds it on the H100: as tezo_perturb, 2r f32 flops per element and
// delta against 4 bytes of bf16 traffic per pass, plus U * Sigma's 2r^2
// flops per row and its scratch, written once and read once per column tile
// (from L2).
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

// The wrapper's limit on r (kernels/subzo_perturb.py MAX_RANK).
constexpr int kMaxRank = 4096;

// us_kernel's tile: 64 rows x 32 columns of U * Sigma_s, 32 terms staged at
// a time; thread (tx, ty) owns column tx of rows ty * 8 .. +7.
constexpr int kUR = 64, kUC = 32, kUK = 32, kURows = kUR / (kThreads / kUC);

// us[row, c0 + tx] = sum_q u[row, q] * sig[q, c0 + tx] for this block's rows
// row0 .. row0 + 63, q ascending, one fma per term from +0.  u is [m][r],
// sig [r][r], us [m][r].
__device__ __forceinline__ void us_tile(float* __restrict__ us, const float* __restrict__ u,
                                        const float* __restrict__ sig, int m, int r, int row0,
                                        int c0) {
  __shared__ float su[kUR][kUK + 1];
  __shared__ float ss[kUK][kUC];
  const int tx = threadIdx.x % kUC, ty = threadIdx.x / kUC;
  float acc[kURows];
#pragma unroll
  for (int i = 0; i < kURows; ++i) acc[i] = 0.f;
  for (int q0 = 0; q0 < r; q0 += kUK) {
    const int qn = min(kUK, r - q0);
    __syncthreads();  // the previous terms have been read
    for (int idx = threadIdx.x; idx < kUR * kUK; idx += kThreads) {
      const int i = idx / kUK, q = idx % kUK, row = row0 + i;
      su[i][q] = row < m && q < qn ? u[static_cast<size_t>(row) * r + q0 + q] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kUK * kUC; idx += kThreads) {
      const int q = idx / kUC, c = idx % kUC;
      ss[q][c] = q < qn && c0 + c < r ? sig[static_cast<size_t>(q0 + q) * r + c0 + c] : 0.f;
    }
    __syncthreads();
    for (int q = 0; q < qn; ++q) {
      const float s = ss[q][tx];
#pragma unroll
      for (int i = 0; i < kURows; ++i) acc[i] = fmaf(su[ty * kURows + i][q], s, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kURows; ++i) {
    const int row = row0 + ty * kURows + i;
    if (row < m && c0 + tx < r) us[static_cast<size_t>(row) * r + c0 + tx] = acc[i];
  }
}

// grid (column tiles of r, row tiles of m, batch index); every delta's
// U * Sigma_s in turn.
__global__ void __launch_bounds__(kThreads) us_kernel(float* us, const float* __restrict__ u,
                                                      const float* __restrict__ sigma, int k,
                                                      int m, int r) {
  const size_t b = blockIdx.z, mr = static_cast<size_t>(m) * r, rr = static_cast<size_t>(r) * r;
  for (int s = 0; s < k; ++s)
    us_tile(us + (b * k + s) * mr, u + b * mr, sigma + (b * k + s) * rr, m, r,
            static_cast<int>(blockIdx.y) * kUR, static_cast<int>(blockIdx.x) * kUC);
}

// The main pass's factors: U * Sigma_s (the scratch, restaged per delta)
// against V.
struct SubzoSrc {
  const float *us, *v;
  size_t mr;
  __device__ tezo::Parts later() const { return {true, false, false}; }
  __device__ const float* a(int s) const { return us + s * mr; }
  __device__ const float* b(int) const { return v; }
  __device__ const float* tau_of(int) const { return nullptr; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) subzo_perturb_kernel(
    const T* w, T* out, const float* __restrict__ us, const float* __restrict__ v,
    __grid_constant__ const DeltaChain chain, int m, int n, int r, bool vec, bool vec_f) {
  __shared__ tezo::RankSmem sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* ws = reinterpret_cast<T*>(dyn);  // [kBM][kBN]
  tezo::RawFactors& raw = *reinterpret_cast<tezo::RawFactors*>(dyn + sizeof(T) * kBM * kBN);
  const size_t b = blockIdx.z;
  const tezo::Tile t{m, n, r, static_cast<int>(blockIdx.y) * kBM,
                     static_cast<int>(blockIdx.x) * kBN};
  const size_t mn = static_cast<size_t>(m) * n, mr = static_cast<size_t>(m) * r;
  tezo::chain_pass<T, false>(ws, raw, sm, w + b * mn, out + b * mn,
                             SubzoSrc{us + b * chain.k * mr, v + b * n * r, mr}, chain, t, vec,
                             vec_f);
}

template <typename T>
int launch(const void* w, void* out, const float* u, const float* v, const float* sigma,
           float* us, const DeltaChain& chain, int B, int m, int n, int r, cudaStream_t st) {
  constexpr size_t smem = tezo::kChainSmem<T>;
  constexpr auto kernel = subzo_perturb_kernel<T>;
  if (const int err = allow_smem<kernel>(smem)) return err;
  const dim3 ugrid((r + kUC - 1) / kUC, (m + kUR - 1) / kUR, B);
  us_kernel<<<ugrid, kThreads, 0, st>>>(us, u, sigma, chain.k, m, r);
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = (n * sizeof(T)) % 16 == 0 && ((addr(w) | addr(out)) % 16) == 0;
  const bool vec_f = r % 4 == 0 && ((addr(us) | addr(v)) % 16) == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, B);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(w), static_cast<T*>(out), us, v,
                                       chain, m, n, r, vec, vec_f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// w, out: [B, m, n] (may be the same buffer); u [B, m, r], v [B, n, r],
// sigma [B, k, r, r] f32, and us an f32 scratch of [B, k, m, r] that the
// call overwrites; dtype 0 = f32, 1 = bf16.  r above kMaxRank or a chain
// longer than kMaxChain is cudaErrorInvalidValue.
extern "C" int subzo_perturb_fwd(const void* w, void* out, const float* u, const float* v,
                                 const float* sigma, float* us, repro_torch::DeltaChain chain,
                                 int B, int m, int n, int r, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || m <= 0 || n <= 0 || r <= 0 || r > kMaxRank || chain.k < 1 ||
      chain.k > kMaxChain || B > 65535 || (m + tezo::kBM - 1) / tezo::kBM > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(w, out, u, v, sigma, us, chain, B, m, n, r, st);
  if (dtype == 1) return launch<__nv_bfloat16>(w, out, u, v, sigma, us, chain, B, m, n, r, st);
  return cudaErrorInvalidValue;
}
