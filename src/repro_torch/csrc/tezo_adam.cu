// Fused TeZO-Adam update for Hopper: optional restore deltas, then
//   W <- round_W(decay * W + (-lr) * M / sqrt(V + eps)),
//   M = (u * diag(tau_M)) v^T,  V = ((u * u) * diag(tau_V)) (v * v)^T   (paper Eq. 8).
//
// Replaces the TPU kernel repro/kernels/tezo_adam.py::tezo_adam_update
// (through repro.kernels.ops.tezo_adam_update).  Same tiling as
// tezo_perturb.cu, one launch per leaf over (column tiles, row tiles, batch
// index), and the same weight stream: the block's 64 x 128 tile of W
// arrives in shared memory by 16-byte cp.async while the first factor chunk
// is staged, and goes back with 16-byte stores.
//
// The restore deltas (the chained step folds the last probe's +rho * Z
// restore into this pass) run tezo_perturb's staging, sums and rounding
// (common.cuh stage_factors, transpose_factors, rank_fma, apply_delta_smem),
// so restore-into-update is bitwise a perturb launch followed by an Adam
// launch.  Then M and V from one staging per 32 rank columns: the chunk's
// rows of u and v arrive as they lie, with tau_M's and tau_V's columns, and
// are transposed once into four operands (u * tau_M, (u * u) * tau_V, v and
// v * v, each product rounded as the reference's elementwise products), and
// one sweep sums M and V with one fma per term in ascending order: each
// element's M and V are the values three separate sweeps formed.  Only Z
// (during the restore) or M and V (after it) are live beside the shared W
// tile, two 256-thread blocks an SM.  Neither reaches device memory, so W is
// read once and written once.
//
// What bounds it on the H100: three rank-r products per element (restore,
// M, V), 6r f32 flops on the CUDA cores against 4 bytes of bf16 traffic, so
// the operations bound it (about 23 GFLOP for a full opt-125m pass at
// r = 24).
//
// Numerics: g = M * rsqrt(V + eps) with the correctly rounded reciprocal
// square root (__frsqrt_rn, not the fast approximation); the update is
// round_W(decay*w + (-lr)*g) with each product and the sum rounded
// separately, the order of the reference's add_scaled(w, g, -lr, decay).

#include "common.cuh"

namespace repro_torch {
namespace {

using tezo::kBM;
using tezo::kBN;
using tezo::kRC;
using tezo::kThreads;
using tezo::kTM;
using tezo::kTN;

// The moments' operands: M's (u * tau_M against v) and V's ((u * u) * tau_V
// against v * v).  The restore stages through m.
struct __align__(16) MomentSmem {
  tezo::RankSmem m, v;
};

// The raw chunk: u's and v's rows with tau_M (or a restore delta's tau),
// and tau_V.
struct __align__(16) RawAdam {
  tezo::RawFactors f;
  float tau_v[kRC];
};

constexpr size_t kSmemNoW = sizeof(MomentSmem) + sizeof(RawAdam);

// The raw chunk into the moments' four operands, m's b-side too (a restore
// before it staged the same v there).  A thread takes four consecutive
// columns of a row with one 16-byte load; a warp takes 32 consecutive rows,
// so the loads and the transposed stores are free of bank conflicts.  The
// caller synchronises around it.
__device__ __forceinline__ void transpose_moments(MomentSmem& sm, const RawAdam& raw, int jn) {
  for (int idx = threadIdx.x; idx < kBM * (kRC / 4); idx += kThreads) {
    const int i = idx % kBM, j = 4 * (idx / kBM);
    if (j >= jn) continue;
    float x[4], tm[4], tv[4];
    tezo::load4(&raw.f.u[i][j], x);
    tezo::load4(&raw.f.tau[j], tm);
    tezo::load4(&raw.tau_v[j], tv);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j + c < jn) {
        sm.m.a[j + c][i] = __fmul_rn(x[c], tm[c]);
        sm.v.a[j + c][i] = __fmul_rn(__fmul_rn(x[c], x[c]), tv[c]);
      }
  }
  for (int idx = threadIdx.x; idx < kBN * (kRC / 4); idx += kThreads) {
    const int l = idx % kBN, j = 4 * (idx / kBN);
    if (j >= jn) continue;
    float y[4];
    tezo::load4(&raw.f.v[l][j], y);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j + c < jn) {
        sm.m.b[j + c][l] = y[c];
        sm.v.b[j + c][l] = __fmul_rn(y[c], y[c]);
      }
  }
}

// mm += M's chunk and vv += V's, one sweep over the staged columns (each
// the order and the fmas of common.cuh rank_fma); per column M's terms,
// then V's, so only one product's operands are live at a time.
__device__ __forceinline__ void moments_fma(float (&mm)[kTM][kTN], float (&vv)[kTM][kTN],
                                            const MomentSmem& sm, int jn) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const auto terms = [&](float (&acc)[kTM][kTN], const tezo::RankSmem& s, int j) {
    const float4 a4 = *reinterpret_cast<const float4*>(&s.a[j][ty * kTM]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s.b[j][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&s.b[j][64 + tx * 4]);
    const float av[kTM] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  };
  for (int j = 0; j < jn; ++j) {
    terms(mm, sm.m, j);
    terms(vv, sm.v, j);
  }
}

// Phases p = 0 .. k-1 are the restore deltas, p = k the moments; their
// chunks run in order, each chunk's copies issued as soon as the previous
// one is transposed (across the phases too), the first chunk's before the
// W tile's.  A one-chunk rank stages u and v once: a later phase restages
// only its tau (and tau_V).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) tezo_adam_kernel(
    const T* w, T* out, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ tau_m, const float* __restrict__ tau_v,
    const float* __restrict__ tau_r, __grid_constant__ const DeltaChain restore, float neg_lr,
    float eps,
    float decay, int m, int n, int r, bool vec, bool vec_f) {
  extern __shared__ __align__(16) unsigned char dyn[];
  MomentSmem& sm = *reinterpret_cast<MomentSmem*>(dyn);
  RawAdam& raw = *reinterpret_cast<RawAdam*>(dyn + sizeof(MomentSmem));
  T* ws = reinterpret_cast<T*>(dyn + kSmemNoW);  // [kBM][kBN]
  const size_t b = blockIdx.z;
  const tezo::Tile t{m, n, r, static_cast<int>(blockIdx.y) * kBM,
                     static_cast<int>(blockIdx.x) * kBN};
  const size_t mn = static_cast<size_t>(m) * n;
  const int k = restore.k;
  u += b * m * r;
  v += b * n * r;
  tau_m += b * r;
  tau_v += b * r;
  if (k > 0) tau_r += b * k * static_cast<size_t>(r);

  const tezo::Parts all{true, true, true};
  const auto parts_of = [&](int p) { return p > 0 && r <= kRC ? tezo::Parts{false, false, true}
                                                              : all; };
  const auto stage = [&](int p, int c0) {  // one commit group
    if (p == k) tezo::stage_tau(raw.tau_v, tau_v, c0, min(kRC, r - c0), vec_f);
    tezo::stage_factors(raw.f, u, v, p < k ? tau_r + static_cast<size_t>(p) * r : tau_m, t, c0,
                        parts_of(p), vec_f);
  };
  bool first = true, next_issued = false;
  // wait for chunk (p, c0), transpose it, issue the next chunk; returns its
  // column count
  const auto next_chunk = [&](int p, int c0) {
    if (first)
      cp_async_wait<1>();  // the factors; the W tile may still be in flight
    else
      cp_async_wait<0>();
    first = false;
    __syncthreads();  // this chunk is in, whoever copied it; the last product is done
    const int jn = min(kRC, r - c0);
    if (p < k)
      tezo::transpose_factors<true>(sm.m, raw.f, jn, parts_of(p));
    else
      transpose_moments(sm, raw, jn);
    __syncthreads();  // raw is free again
    const int np = c0 + kRC < r ? p : p + 1, nc0 = c0 + kRC < r ? c0 + kRC : 0;
    next_issued = np <= k;
    if (next_issued) stage(np, nc0);
    return jn;
  };
  const auto wait_w = [&]() {  // the W tile (issued before any next chunk's copies)
    if (next_issued)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // the tile is in, whoever copied each element
  };

  stage(0, 0);
  tezo::stage_w_tile(ws, w + b * mn, t, vec);
  for (int p = 0; p < k; ++p) {
    float z[kTM][kTN];
    tezo::zero(z);
    for (int c0 = 0; c0 < r; c0 += kRC) tezo::rank_fma(z, sm.m, next_chunk(p, c0));
    if (p == 0) wait_w();
    tezo::apply_delta_smem<T>(ws, z, restore.decay[p], restore.scale[p]);
  }
  float mm[kTM][kTN], vv[kTM][kTN];
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
  __syncthreads();
  tezo::store_w_tile(out + b * mn, ws, t, vec);
}

template <typename T>
int launch(const void* w, void* out, const float* u, const float* v, const float* tau_m,
           const float* tau_v, const float* tau_r, const DeltaChain& restore, float neg_lr,
           float eps, float decay, int B, int m, int n, int r, cudaStream_t st) {
  constexpr size_t smem = kSmemNoW + sizeof(T) * kBM * kBN;
  constexpr auto kernel = tezo_adam_kernel<T>;
  if (const int err = allow_smem<kernel>(smem)) return err;
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = (n * sizeof(T)) % 16 == 0 && ((addr(w) | addr(out)) % 16) == 0;
  const bool vec_f = r % 4 == 0 &&
                     ((addr(u) | addr(v) | addr(tau_m) | addr(tau_v) |
                       (restore.k > 0 ? addr(tau_r) : 0)) % 16) == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, B);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(w), static_cast<T*>(out), u, v,
                                       tau_m, tau_v, tau_r, restore, neg_lr, eps, decay, m, n,
                                       r, vec, vec_f);
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
