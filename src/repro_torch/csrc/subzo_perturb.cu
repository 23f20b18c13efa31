// SubZO perturbation chain for Hopper: in place (or into a second buffer),
// for s = 0 .. k-1,
//   W <- round_W(d_s * W + scale_s * (U * Sigma_s) V^T),  d_s = 1 but the last.
//
// Replaces the TPU kernel repro/kernels/zo_noise.py::subzo_perturb (through
// repro.kernels.ops.subzo_perturb, which maps it over a leaf's leading
// dims).  U [m, r] and V [n, r] are the window's orthonormal f32 factors,
// Sigma_s an f32 [r, r] core per delta.  One launch covers a whole leaf: the
// grid is (column tiles, row tiles, batch index), as tezo_perturb.cu's.
// Each block holds a 64 x 128 tile of W in registers as f32 for the whole
// chain.  Per delta it stages Sigma_s in shared memory, forms its rows of
// U * Sigma_s while staging the rank-r product's a-side (common.cuh
// rank_product_cols with the SigmaA loader: one fma per term over Sigma's
// rows in ascending order), then sums that against V's columns as TeZO
// does.  Sigma's r x r floats fit the shared buffer up to r = kMaxRank;
// above it the delta runs over Sigma's columns in chunks of kMaxRank^2 / r,
// each staged in turn, with Z accumulating in f32 registers across the
// chunks (in the same ascending column order) before the delta's single
// rounding.  Z and U * Sigma never reach device memory; W is read once and
// written once per chain.  Ragged edges (a vocabulary of 50272 rows, a
// [12, 768] norm at r = 12) are masked, not padded.
//
// What bounds it on the H100: as tezo_perturb, 2r f32 flops per element and
// delta against 4 bytes of bf16 traffic per pass; the function needs U *
// Sigma's 2r^2 flops once per row, which each 128-column tile recomputes for
// its rows (about 2r^2 / 128 per element; chip_smoke.py's bound counts only
// the once per row).  The staging puts a warp on one row of U and 32
// consecutive columns of Sigma, so U's row is one broadcast read per term and
// Sigma's reads are conflict-free.  Forming U * Sigma once per delta for the
// whole leaf, and tensor cores, are later work.
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

// Sigma's floats that fit the shared buffer beside the rank product's
// staging (16 KB + 25 KB, under the 48 KB of static shared memory): all of
// Sigma up to r = kMaxRank, else a chunk of its columns.
constexpr int kMaxRank = 64;
constexpr int kSigmaFloats = kMaxRank * kMaxRank;

// Sigma's columns c_begin .. c_begin + width - 1, staged as [r][width].
struct SigmaCols {
  const float* sig;
  int c_begin, width;
};

// a(row, c0 + j) = sum_k u[row, k] * sigma[k, c0 + j], k ascending, one fma
// per term.
struct SigmaA {
  static constexpr bool kWarpPerRow = true;
  static __device__ __forceinline__ float a(const float* __restrict__ u,
                                            const SigmaCols& s, int row, int c0, int j,
                                            int r) {
    const float* ur = u + static_cast<size_t>(row) * r;
    const int col = c0 - s.c_begin + j;
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < r; ++k) acc = fmaf(__ldg(ur + k), s.sig[k * s.width + col], acc);
    return acc;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) subzo_perturb_kernel(
    const T* w, T* out, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ sigma, DeltaChain chain, int m, int n, int r) {
  __shared__ tezo::RankSmem sm;
  __shared__ float sig[kSigmaFloats];
  const size_t b = blockIdx.z;
  const tezo::Tile t{m, n, r, static_cast<int>(blockIdx.y) * kBM,
                     static_cast<int>(blockIdx.x) * kBN};
  const size_t mn = static_cast<size_t>(m) * n;
  const size_t rr = static_cast<size_t>(r) * r;
  const float* ub = u + b * m * r;
  const float* vb = v + b * n * r;
  const int cw = r <= kMaxRank ? r : kSigmaFloats / r;  // Sigma's columns per stage
  float wt[kTM][kTN];
  tezo::load_tile(wt, w + b * mn, t);
  for (int s = 0; s < chain.k; ++s) {
    const float* sg = sigma + (b * chain.k + s) * rr;
    float z[kTM][kTN];
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int c = 0; c < kTN; ++c) z[a][c] = 0.f;
    for (int cb = 0; cb < r; cb += cw) {
      const int width = min(cw, r - cb);
      __syncthreads();  // the previous stage has read sig
      for (int i = threadIdx.x; i < r * width; i += kThreads)
        sig[i] = sg[static_cast<size_t>(i / width) * r + cb + i % width];
      __syncthreads();
      tezo::rank_product_cols<false, SigmaA>(z, ub, vb, SigmaCols{sig, cb, width}, t, sm, cb,
                                             cb + width);
    }
    tezo::apply_delta<T>(wt, z, chain.decay[s], chain.scale[s]);
  }
  tezo::store_tile(out + b * mn, wt, t);
}

template <typename T>
int launch(const void* w, void* out, const float* u, const float* v, const float* sigma,
           const DeltaChain& chain, int B, int m, int n, int r, cudaStream_t st) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, B);
  subzo_perturb_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(w), static_cast<T*>(out), u, v, sigma, chain, m, n, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// w, out: [B, m, n] (may be the same buffer); u [B, m, r], v [B, n, r] and
// sigma [B, k, r, r] f32; dtype 0 = f32, 1 = bf16.  r above kMaxRank^2 (no
// column of Sigma would fit) or a chain longer than kMaxChain is
// cudaErrorInvalidValue.
extern "C" int subzo_perturb_fwd(const void* w, void* out, const float* u, const float* v,
                                 const float* sigma, repro_torch::DeltaChain chain, int B,
                                 int m, int n, int r, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || m <= 0 || n <= 0 || r <= 0 || r > kSigmaFloats || chain.k < 1 ||
      chain.k > kMaxChain || B > 65535 || (m + tezo::kBM - 1) / tezo::kBM > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(w, out, u, v, sigma, chain, B, m, n, r, st);
  if (dtype == 1) return launch<__nv_bfloat16>(w, out, u, v, sigma, chain, B, m, n, r, st);
  return cudaErrorInvalidValue;
}
