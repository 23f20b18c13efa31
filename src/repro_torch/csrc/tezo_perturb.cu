// TeZO perturbation chain for Hopper: in place (or into a second buffer),
// for s = 0 .. k-1,
//   W <- round_W(d_s * W + scale_s * (u * diag(tau_s)) v^T),  d_s = 1 but the last.
//
// Replaces the TPU kernel repro/kernels/tezo_perturb.py::tezo_perturb
// (through repro.kernels.ops.tezo_perturb, which maps it over a leaf's
// leading dims).  One launch covers a whole leaf: the grid is (column tiles,
// row tiles, batch index), so a stacked [12, 768, 3072] leaf is one launch.
// Each block holds a 64 x 128 tile of W in registers as f32 for the whole
// chain and forms each rank-r delta Z there (common.cuh): the factor columns
// are staged through shared memory 32 at a time and summed with one fma per
// term in ascending order.  Z never reaches device memory; W is read once
// and written once per chain.  Ragged edges (a vocabulary of 50272 rows, a
// [12, 768] norm stack smaller than one tile) are masked, not padded.
//
// What bounds it on the H100: per element and delta, 2r f32 flops on the
// CUDA cores against 4 bytes of bf16 traffic per pass (read and write).  At
// r = 24 and k = 1 the bytes bound it (4 B / 3.35 TB/s > 48 flop / 67
// TFLOP/s), by less than a factor of two; a two-delta chain or a larger r
// tips it to the operations.  chip_smoke.py computes both bounds.  Moving
// the product onto the tensor cores is later work.
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

template <typename T>
__global__ void __launch_bounds__(kThreads) tezo_perturb_kernel(
    const T* w, T* out, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ tau, DeltaChain chain, int m, int n, int r) {
  __shared__ tezo::RankSmem sm;
  const size_t b = blockIdx.z;
  const tezo::Tile t{m, n, r, static_cast<int>(blockIdx.y) * kBM,
                     static_cast<int>(blockIdx.x) * kBN};
  const size_t mn = static_cast<size_t>(m) * n;
  float wt[kTM][kTN];
  tezo::load_tile(wt, w + b * mn, t);
  tezo::delta_chain<T>(wt, u + b * m * r, v + b * n * r,
                       tau + b * static_cast<size_t>(chain.k) * r, chain, t, sm);
  tezo::store_tile(out + b * mn, wt, t);
}

template <typename T>
int launch(const void* w, void* out, const float* u, const float* v, const float* tau,
           const DeltaChain& chain, int B, int m, int n, int r, cudaStream_t st) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, B);
  tezo_perturb_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(w), static_cast<T*>(out), u, v, tau, chain, m, n, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// w, out: [B, m, n] (may be the same buffer); u [B, m, r], v [B, n, r] and
// tau [B, k, r] f32; dtype 0 = f32, 1 = bf16.
extern "C" int tezo_perturb_fwd(const void* w, void* out, const float* u, const float* v,
                                const float* tau, repro_torch::DeltaChain chain, int B,
                                int m, int n, int r, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || m <= 0 || n <= 0 || r <= 0 || chain.k < 1 || chain.k > kMaxChain ||
      B > 65535 || (m + tezo::kBM - 1) / tezo::kBM > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(w, out, u, v, tau, chain, B, m, n, r, st);
  if (dtype == 1) return launch<__nv_bfloat16>(w, out, u, v, tau, chain, B, m, n, r, st);
  return cudaErrorInvalidValue;
}
