// Dense-noise perturbation chain for Hopper (the MeZO family): in place (or
// into a second buffer), for s = 0 .. k-1,
//   W <- round_W(W + scale_s * z_{probe_s}),
// z drawn on the card from the counter stream of zo_noise.cuh, never stored.
//
// Replaces the TPU kernel repro/kernels/zo_noise.py::noise_perturb (through
// repro.kernels.ops.noise_perturb / noise_perturb_pair, which map it over a
// leaf's leading dims and pad awkward shapes).  One launch covers a whole
// leaf: grid.y is the slice of a stacked leaf, whose key thread 0 derives
// once per block into shared memory; grid.x covers the slice's rows in
// groups of four neighbouring columns per thread.  Ragged edges (a 50272-row
// vocabulary, a 12-row norm stack) are masked, not padded.  A k-probe chain
// (the bridge: restore probe i, perturb probe i+1) reads and writes W once.
//
// What bounds it on the H100: instruction issue.  Each element costs one
// Threefry-2x32-20 block per probe (20 rounds of add, funnel shift and
// xor, the shifts and xors on the 64-lane integer ALU) plus the f32 and f64
// ops of Box-Muller, at least ~115 instructions per draw against 4 bytes
// of bf16 traffic (read and write); chip_smoke.py counts them and reports
// the larger of the issue, ALU and bytes times as the bound.  This first
// version keeps one element's draw per loop trip and scalar loads; it
// makes no attempt to overlap the ALU with the memory traffic beyond what
// the warp scheduler does.
//
// Numerics: each delta is round_W(w + scale * z), the product and the sum
// rounded apart (no fma), and the next delta reads the rounded value, so a
// k-probe chain is bitwise k single launches.  bf16 stores round to nearest
// even.

#include "zo_noise.cuh"

namespace repro_torch {
namespace {

using noise::kCols;
using noise::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads) noise_perturb_kernel(
    const T* w, T* out, uint32_t k0, uint32_t k1, noise::NoiseChain ch, noise::LeadDims lead,
    int m, int n) {
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) {
    uint32_t a = k0, b = k1;
    noise::slice_key(a, b, lead, blockIdx.y);
    key[0] = a;
    key[1] = b;
  }
  __syncthreads();
  noise::Place p;
  if (!noise::place(p, m, n)) return;
  const uint32_t s0 = key[0], s1 = key[1];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = p.col0 + c;
    if (col >= n) break;
    const size_t i = p.base + col;
    float z;
    const float v = noise::chain<T>(to_f32(w[i]), ch, s0, s1, p.row, col, z);
    out[i] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* w, void* out, uint32_t k0, uint32_t k1, const noise::NoiseChain& ch,
           const noise::LeadDims& lead, const dim3& grid, int m, int n, cudaStream_t st) {
  noise_perturb_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(w), static_cast<T*>(out), k0, k1, ch, lead, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// w, out: B slices [m, n] (may be the same buffer); (k0, k1) the leaf key;
// lead the leaf's leading dims (their product B); dtype 0 = f32, 1 = bf16.
extern "C" int noise_perturb_fwd(const void* w, void* out, uint32_t k0, uint32_t k1,
                                 repro_torch::noise::NoiseChain chain,
                                 repro_torch::noise::LeadDims lead, int B, int m, int n,
                                 int dtype, void* stream) {
  using namespace repro_torch;
  dim3 grid;
  if (!noise::valid(chain, 1) || !noise::valid(lead, B) || m >= (1 << 24) ||
      !noise::grid_of(grid, B, m, n))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(w, out, k0, k1, chain, lead, grid, m, n, st);
  if (dtype == 1) return launch<__nv_bfloat16>(w, out, k0, k1, chain, lead, grid, m, n, st);
  return cudaErrorInvalidValue;
}
