// Fused dense-noise ZO update for Hopper (the MeZO family): in one pass over
// W (and the f32 moments M, V, in place),
//   the restore chain   W <- round_W(W + rs_s * z_{rp_s})     (optional)
//   the probe mean      g = (sum_p kappa_p * z_p) * f32(1/q)
//   sgd                 W <- round_W(decay * W - lr * g)
//   momentum            M <- b1 * M + (1 - b1) * g;  W <- round_W(decay * W - lr * M)
//   adam                ... V <- b2 * V + (1 - b2) * g * g;
//                       W <- round_W(decay * W - lr * M * rsqrt(V + eps))
// z drawn on the card from the counter stream of zo_noise.cuh.
//
// Replaces the TPU kernel repro/kernels/zo_noise.py::noise_update (through
// repro.kernels.ops.noise_update_sgd / _momentum / _adam).  The tiling of
// noise_perturb.cu: one launch per leaf, the slice of a stacked leaf on
// grid.y (its key derived once per block), four neighbouring columns per
// thread, ragged edges masked; here W, M and V move as one vector access
// per thread where the rows hold whole groups (the f32 moments are 16 of
// the Adam pass's 20 bytes per element).  The restore (the chained step
// folds the last probe's +rho * z restore into this pass) runs the very
// device function noise_perturb.cu runs, so restore-into-update is bitwise
// a perturb launch followed by an update launch.  kappa stays on the card (a
// [q] f32 vector the step computed there), staged in shared memory.
//
// Each element draws one normal per distinct probe: the z of the last
// restore probe is kept and reused by g (the chained step restores probe
// q - 1, so q = 1 with a restore is one Threefry block, not two).  What
// bounds it on the H100: instruction issue for the draws (chip_smoke.py's
// per-draw count), against 4 bytes of bf16 W traffic plus 8 bytes per f32
// moment read and written (Adam: 20 bytes per element in all, which makes
// Adam at q = 1 bound by the bytes).  chip_smoke.py counts both.
//
// Numerics follow the reference kernel's f32 math op for op, each op
// rounded on its own (__fmul_rn / __fadd_rn; nvcc would otherwise contract
// them): the probe mean is a left fold in probe order times f32(1/q), as
// the Pallas kernel multiplies (the reference's jnp oracle divides by q
// instead); 1 - b1 and 1 - b2 are formed in f32 on the host; the Adam
// rsqrt is the correctly rounded one (__frsqrt_rn), not the fast
// approximation.

#include "zo_noise.cuh"

namespace repro_torch {

// lr, the moments' coefficients (1 - b formed in f32 on the host, as the
// reference forms it from its f32 hyperparameter vector), eps, the
// decoupled weight-decay factor (1 for none) and f32(1/q).
struct NoiseHyp {
  float lr, b1, one_minus_b1, b2, one_minus_b2, eps, decay, inv_q;
};

namespace {

using noise::kCols;
using noise::kThreads;

enum Variant { kSgd = 0, kMomentum = 1, kAdam = 2 };

// A thread's kCols neighbouring elements as one vector access (8 bytes of
// bf16, 16 of f32); used where every group of the leaf is whole and each
// buffer aligned (all of opt-125m's leaves), else column by column with the
// ragged edge masked.
template <typename T>
struct alignas(sizeof(T) * kCols) Pack {
  T v[kCols];
};

template <typename T>
__device__ __forceinline__ bool packable(const T* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % sizeof(Pack<T>) == 0;
}

template <typename T>
__device__ __forceinline__ void load(const T* p, float (&x)[kCols], int cols, bool vec) {
  if (vec) {
    const Pack<T> pk = *reinterpret_cast<const Pack<T>*>(p);
#pragma unroll
    for (int c = 0; c < kCols; ++c) x[c] = to_f32(pk.v[c]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) x[c] = c < cols ? to_f32(p[c]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store(T* p, const float (&x)[kCols], int cols, bool vec) {
  if (vec) {
    Pack<T> pk;
#pragma unroll
    for (int c = 0; c < kCols; ++c) pk.v[c] = from_f32<T>(x[c]);
    *reinterpret_cast<Pack<T>*>(p) = pk;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < cols) p[c] = from_f32<T>(x[c]);
  }
}

template <typename T, int kVariant>
__global__ void __launch_bounds__(kThreads) noise_update_kernel(
    T* w, float* mbuf, float* vbuf, const float* __restrict__ kappas, int q, uint32_t k0,
    uint32_t k1, noise::NoiseChain restore, NoiseHyp hyp, noise::LeadDims lead, int m, int n) {
  __shared__ uint32_t key[2];
  __shared__ float kap[noise::kMaxProbes];
  if (threadIdx.x == 0) {
    uint32_t a = k0, b = k1;
    noise::slice_key(a, b, lead, blockIdx.y);
    key[0] = a;
    key[1] = b;
  }
  for (int i = threadIdx.x; i < q; i += kThreads) kap[i] = kappas[i];
  __syncthreads();
  noise::Place p;
  if (!noise::place(p, m, n)) return;
  const uint32_t s0 = key[0], s1 = key[1];
  // the last restore probe's z is drawn once: the restore applies it and g
  // takes it again (the chained step restores probe q - 1 here)
  const int reuse = restore.k > 0 ? restore.probe[restore.k - 1] : -1;
  const bool vec = n % kCols == 0 && packable(w) && packable(mbuf) && packable(vbuf);
  const int cols = min(kCols, n - p.col0);
  const size_t i0 = p.base + p.col0;
  float wv[kCols], mv[kCols], vv[kCols];
  load(w + i0, wv, cols, vec);
  if (kVariant != kSgd) load(mbuf + i0, mv, cols, vec);
  if (kVariant == kAdam) load(vbuf + i0, vv, cols, vec);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c >= cols) break;
    const int col = p.col0 + c;
    float z_rp = 0.f;
    const float wr = noise::chain<T>(wv[c], restore, s0, s1, p.row, col, z_rp);
    auto z_of = [&](int pr) {
      return pr == reuse ? z_rp : noise::counter_normal(s0, s1, p.row, col, pr);
    };
    float g = __fmul_rn(kap[0], z_of(0));
    for (int pr = 1; pr < q; ++pr) g = __fadd_rn(g, __fmul_rn(kap[pr], z_of(pr)));
    g = __fmul_rn(g, hyp.inv_q);
    float step = g;
    if (kVariant != kSgd) {
      mv[c] = __fadd_rn(__fmul_rn(hyp.b1, mv[c]), __fmul_rn(hyp.one_minus_b1, g));
      step = mv[c];
      if (kVariant == kAdam) {
        vv[c] = __fadd_rn(__fmul_rn(hyp.b2, vv[c]), __fmul_rn(__fmul_rn(hyp.one_minus_b2, g), g));
        step = __fmul_rn(mv[c], __frsqrt_rn(__fadd_rn(vv[c], hyp.eps)));
      }
    }
    wv[c] = __fsub_rn(__fmul_rn(hyp.decay, wr), __fmul_rn(hyp.lr, step));
  }
  store(w + i0, wv, cols, vec);
  if (kVariant != kSgd) store(mbuf + i0, mv, cols, vec);
  if (kVariant == kAdam) store(vbuf + i0, vv, cols, vec);
}

template <typename T, int kVariant>
int launch(void* w, float* mbuf, float* vbuf, const float* kappas, int q, uint32_t k0,
           uint32_t k1, const noise::NoiseChain& restore, const NoiseHyp& hyp,
           const noise::LeadDims& lead, const dim3& grid, int m, int n, cudaStream_t st) {
  noise_update_kernel<T, kVariant><<<grid, kThreads, 0, st>>>(
      static_cast<T*>(w), mbuf, vbuf, kappas, q, k0, k1, restore, hyp, lead, m, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int variant, void* w, float* mbuf, float* vbuf, const float* kappas, int q,
             uint32_t k0, uint32_t k1, const noise::NoiseChain& restore, const NoiseHyp& hyp,
             const noise::LeadDims& lead, const dim3& grid, int m, int n, cudaStream_t st) {
  if (variant == kSgd)
    return launch<T, kSgd>(w, mbuf, vbuf, kappas, q, k0, k1, restore, hyp, lead, grid, m, n, st);
  if (variant == kMomentum)
    return launch<T, kMomentum>(w, mbuf, vbuf, kappas, q, k0, k1, restore, hyp, lead, grid, m,
                                n, st);
  return launch<T, kAdam>(w, mbuf, vbuf, kappas, q, k0, k1, restore, hyp, lead, grid, m, n, st);
}

}  // namespace
}  // namespace repro_torch

// w: B slices [m, n], updated in place; mbuf / vbuf: f32 of W's shape, in
// place (momentum: mbuf; adam: both; else ignored); kappas: [q] f32 on the
// card; restore: the restore chain (k = 0 for none); variant 0 sgd,
// 1 momentum, 2 adam; dtype 0 = f32, 1 = bf16.
extern "C" int noise_update_fwd(void* w, float* mbuf, float* vbuf, const float* kappas, int q,
                                uint32_t k0, uint32_t k1, repro_torch::noise::NoiseChain restore,
                                repro_torch::NoiseHyp hyp, repro_torch::noise::LeadDims lead,
                                int variant, int B, int m, int n, int dtype, void* stream) {
  using namespace repro_torch;
  dim3 grid;
  if (q < 1 || q >= noise::kMaxProbes || variant < 0 || variant > 2 ||
      !noise::valid(restore, 0) || !noise::valid(lead, B) || m >= (1 << 24) ||
      !noise::grid_of(grid, B, m, n) || (variant >= 1 && mbuf == nullptr) ||
      (variant == 2 && vbuf == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(variant, w, mbuf, vbuf, kappas, q, k0, k1, restore, hyp, lead, grid,
                           m, n, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(variant, w, mbuf, vbuf, kappas, q, k0, k1, restore, hyp,
                                   lead, grid, m, n, st);
  return cudaErrorInvalidValue;
}
