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
// vocabulary, a 12-row norm stack, a 32001-column embedding) are masked,
// not padded.  A k-probe chain (the bridge: restore probe i, perturb probe
// i+1) reads and writes W once.
//
// What bounds it on the H100: instruction issue.  Each element costs one
// Threefry-2x32-20 block per probe (20 rounds of add, funnel shift and
// xor, the shifts and xors on the 64-lane integer ALU) plus the f32 and f64
// ops of Box-Muller, at least ~115 instructions per draw against 4 bytes
// of bf16 traffic (read and write); chip_smoke.py counts them and reports
// the larger of the issue, ALU and bytes times as the bound.  So the design
// spends no issue slot it can keep:
// - a draw does not branch: glibc's cosine runs one path (zo_noise.cuh
//   glibc_cosf; its argument is uniform on [0, 2 pi), so glibc's short path
//   below pi/4 and its sine / cosine split would divide nearly every warp),
//   and the correctly rounded sqrt is nvcc's fast path without the branch
//   to its slow one (sqrt_rn_box_muller);
// - a thread's four columns are drawn unconditionally (the ragged edge is
//   masked at the load and the store, not by leaving the loop), and the
//   chain is instanced for k = 1 and k = 2, so the four Threefry blocks are
//   four independent chains the scheduler interleaves;
// - W moves as one 8-byte (bf16) or 16-byte (f32) access per thread wherever
//   the thread's four columns are whole and aligned, scalar accesses only
//   at a ragged row end or an unaligned leaf.
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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) noise_perturb_kernel(
    const T* w, T* out, uint32_t k0, uint32_t k1, __grid_constant__ const noise::NoiseChain ch,
    noise::LeadDims lead, noise::Offsets off,
    int m, int n) {
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) {  // a stacked leaf's slice key: ~150 instructions, once a block
    uint32_t a = k0, b = k1;
    noise::slice_key(a, b, lead, off, blockIdx.y);
    key[0] = a;
    key[1] = b;
  }
  __syncthreads();
  noise::Place p;
  if (!noise::place(p, m, n, off)) return;
  const uint32_t s0 = key[0], s1 = key[1];
  const int cols = min(kCols, n - p.col0);
  const size_t i0 = p.base + p.col0;
  const bool vec = cols == kCols && noise::packable(w + i0) && noise::packable(out + i0);
  float v[kCols];
  noise::load(w + i0, v, cols, vec);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {  // columns past n draw too; their store is masked
    float z;
    v[c] = noise::chain<T, K>(v[c], ch, s0, s1, p.grow, p.gcol0 + c, z);
  }
  noise::store(out + i0, v, cols, vec);
}

template <typename T, int K>
int launch(const void* w, void* out, uint32_t k0, uint32_t k1, const noise::NoiseChain& ch,
           const noise::LeadDims& lead, const noise::Offsets& off, const dim3& grid, int m,
           int n, cudaStream_t st) {
  noise_perturb_kernel<T, K><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(w), static_cast<T*>(out), k0, k1, ch, lead, off, m, n);
  return static_cast<int>(cudaGetLastError());
}

// k = 1 (a perturb) and k = 2 (the bridge) get their own instances.
template <typename T>
int dispatch(const void* w, void* out, uint32_t k0, uint32_t k1, const noise::NoiseChain& ch,
             const noise::LeadDims& lead, const noise::Offsets& off, const dim3& grid, int m,
             int n, cudaStream_t st) {
  if (ch.k == 1) return launch<T, 1>(w, out, k0, k1, ch, lead, off, grid, m, n, st);
  if (ch.k == 2) return launch<T, 2>(w, out, k0, k1, ch, lead, off, grid, m, n, st);
  return launch<T, 0>(w, out, k0, k1, ch, lead, off, grid, m, n, st);
}

}  // namespace
}  // namespace repro_torch

// w, out: B slices [m, n] (may be the same buffer); (k0, k1) the leaf key;
// lead the leaf's leading dims (their product B); off the global origin of
// a shard (zeros for a whole leaf); dtype 0 = f32, 1 = bf16.
extern "C" int noise_perturb_fwd(const void* w, void* out, uint32_t k0, uint32_t k1,
                                 repro_torch::noise::NoiseChain chain,
                                 repro_torch::noise::LeadDims lead,
                                 repro_torch::noise::Offsets off, int B, int m, int n,
                                 int dtype, void* stream) {
  using namespace repro_torch;
  dim3 grid;
  if (!noise::valid(chain, 1) || !noise::valid(lead, B) || m >= (1 << 24) ||
      !noise::valid(off, lead, m) || !noise::grid_of(grid, B, m, n))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(w, out, k0, k1, chain, lead, off, grid, m, n, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(w, out, k0, k1, chain, lead, off, grid, m, n, st);
  return cudaErrorInvalidValue;
}
