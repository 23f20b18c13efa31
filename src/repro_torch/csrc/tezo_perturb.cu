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
// ascending order.  The pass is common.cuh chain_pass, which
// subzo_perturb.cu runs too; tezo_adam.cu's restore and moments sum with
// the same rank_fma.  Z never reaches device memory; W is read once and
// written once per chain.
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
using tezo::kRC;
using tezo::kThreads;

// TeZO's factors: u * tau_s against v for every delta (a later delta of a
// one-chunk rank restages only tau).
struct TezoSrc {
  const float *u, *v, *tau;
  int r;
  __device__ tezo::Parts later() const { return {false, false, true}; }
  __device__ const float* a(int) const { return u; }
  __device__ const float* b(int) const { return v; }
  __device__ const float* tau_of(int s) const { return tau + static_cast<size_t>(s) * r; }
};

// LOZO's: u as it is against a fresh V per delta (restaged alone).
struct LozoSrc {
  const float* u;
  FactorList vs;
  size_t off;  // the batch index's offset into each V
  __device__ tezo::Parts later() const { return {false, true, false}; }
  __device__ const float* a(int) const { return u; }
  __device__ const float* b(int s) const { return vs.p[s] + off; }
  __device__ const float* tau_of(int) const { return nullptr; }
};

// kLozo: the deltas are u vs.p[s]^T (tau unused); else (u * tau_s) v^T.
template <typename T, bool kLozo>
__global__ void __launch_bounds__(kThreads, 3) tezo_perturb_kernel(
    const T* w, T* out, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ tau, FactorList vs, DeltaChain chain, int m, int n, int r,
    bool vec, bool vec_f) {
  __shared__ tezo::RankSmem sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* ws = reinterpret_cast<T*>(dyn);  // [kBM][kBN]
  tezo::RawFactors& raw = *reinterpret_cast<tezo::RawFactors*>(dyn + sizeof(T) * kBM * kBN);
  const size_t b = blockIdx.z;
  const tezo::Tile t{m, n, r, static_cast<int>(blockIdx.y) * kBM,
                     static_cast<int>(blockIdx.x) * kBN};
  const size_t mn = static_cast<size_t>(m) * n;
  const float* ub = u + b * m * r;
  if constexpr (kLozo)
    tezo::chain_pass<T, false>(ws, raw, sm, w + b * mn, out + b * mn,
                               LozoSrc{ub, vs, b * n * r}, chain, t, vec, vec_f);
  else
    tezo::chain_pass<T, true>(ws, raw, sm, w + b * mn, out + b * mn,
                              TezoSrc{ub, v + b * n * r, tau + b * chain.k * r, r}, chain, t,
                              vec, vec_f);
}

template <typename T, bool kLozo>
int launch(const void* w, void* out, const float* u, const float* v, const float* tau,
           const FactorList& vs, const DeltaChain& chain, int B, int m, int n, int r,
           cudaStream_t st) {
  constexpr size_t smem = tezo::kChainSmem<T>;
  constexpr auto kernel = tezo_perturb_kernel<T, kLozo>;
  if (const int err = allow_smem<kernel>(smem)) return err;
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
