// Fused TeZO-Adam update for Hopper: optional restore deltas, then
//   W <- round_W(decay * W + (-lr) * M / sqrt(V + eps)),
//   M = (u * diag(tau_M)) v^T,  V = ((u * u) * diag(tau_V)) (v * v)^T   (paper Eq. 8).
//
// Replaces the TPU kernel repro/kernels/tezo_adam.py::tezo_adam_update
// (through repro.kernels.ops.tezo_adam_update).  Same tiling as
// tezo_perturb.cu, one launch per leaf over (column tiles, row tiles, batch
// index).  The restore deltas (the chained step folds the last probe's
// +rho * Z restore into this pass) go through the very device function
// tezo_perturb.cu runs (common.cuh), so restore-into-update is bitwise a
// perturb launch followed by an Adam launch.  M and V are two more rank-r
// sums over the same factor rows, formed in registers; neither reaches
// device memory, so W is read once and written once.
//
// What bounds it on the H100: three rank-r products per element (restore,
// M, V), 6r f32 flops on the CUDA cores against 4 bytes of bf16 traffic, so
// the operations bound it (about 23 GFLOP for a full opt-125m pass at
// r = 24).  Tensor-core products are later work.
//
// Numerics: M and V sum their r terms with one fma each in ascending order;
// g = M * rsqrt(V + eps) with the correctly rounded reciprocal square root
// (__frsqrt_rn, not the fast approximation); the update is
// round_W(decay*w + (-lr)*g) with each product and the sum rounded
// separately, the order of the reference's add_scaled(w, g, -lr, decay).

#include "common.cuh"

namespace repro_torch {
namespace {

using tezo::kBM;
using tezo::kBN;
using tezo::kThreads;
using tezo::kTM;
using tezo::kTN;

template <typename T>
__global__ void __launch_bounds__(kThreads) tezo_adam_kernel(
    const T* w, T* out, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ tau_m, const float* __restrict__ tau_v,
    const float* __restrict__ tau_r, DeltaChain restore, float neg_lr, float eps,
    float decay, int m, int n, int r) {
  __shared__ tezo::RankSmem sm;
  const size_t b = blockIdx.z;
  const tezo::Tile t{m, n, r, static_cast<int>(blockIdx.y) * kBM,
                     static_cast<int>(blockIdx.x) * kBN};
  const size_t mn = static_cast<size_t>(m) * n;
  u += b * m * r;
  v += b * n * r;
  float wt[kTM][kTN];
  tezo::load_tile(wt, w + b * mn, t);
  if (restore.k > 0)
    tezo::delta_chain<T>(wt, u, v, tau_r + b * static_cast<size_t>(restore.k) * r, restore,
                         t, sm);
  float mm[kTM][kTN], vv[kTM][kTN];
  tezo::rank_r_product<false>(mm, u, v, tau_m + b * r, t, sm);
  tezo::rank_r_product<true>(vv, u, v, tau_v + b * r, t, sm);
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const float g = __fmul_rn(mm[a][c], __frsqrt_rn(__fadd_rn(vv[a][c], eps)));
      wt[a][c] = __fadd_rn(__fmul_rn(decay, wt[a][c]), __fmul_rn(neg_lr, g));
    }
  tezo::store_tile(out + b * mn, wt, t);
}

template <typename T>
int launch(const void* w, void* out, const float* u, const float* v, const float* tau_m,
           const float* tau_v, const float* tau_r, const DeltaChain& restore, float neg_lr,
           float eps, float decay, int B, int m, int n, int r, cudaStream_t st) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, B);
  tezo_adam_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(w), static_cast<T*>(out), u, v, tau_m, tau_v, tau_r, restore,
      neg_lr, eps, decay, m, n, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// w, out: [B, m, n] (may be the same buffer); u [B, m, r], v [B, n, r],
// tau_m / tau_v [B, r], tau_r [B, k, r] f32 (ignored when restore.k == 0);
// dtype 0 = f32, 1 = bf16.
extern "C" int tezo_adam_update_fwd(const void* w, void* out, const float* u, const float* v,
                                    const float* tau_m, const float* tau_v,
                                    const float* tau_r, repro_torch::DeltaChain restore,
                                    float neg_lr, float eps, float decay, int B, int m, int n,
                                    int r, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || m <= 0 || n <= 0 || r <= 0 || restore.k < 0 || restore.k > kMaxChain ||
      B > 65535 || (m + tezo::kBM - 1) / tezo::kBM > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(w, out, u, v, tau_m, tau_v, tau_r, restore, neg_lr, eps, decay, B,
                         m, n, r, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(w, out, u, v, tau_m, tau_v, tau_r, restore, neg_lr, eps,
                                 decay, B, m, n, r, st);
  return cudaErrorInvalidValue;
}
