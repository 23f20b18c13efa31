// Mamba-1 selective scan for Hopper: for each batch row b, channel d and
// state n, over t = 0 .. S-1,
//   h[n] <- exp(dt[b,t,d] * A[d,n]) * h[n] + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   y[b,t,d] = sum_n h[n] * C[b,t,n]
// from h = h0[b,d,:], returning y [B,S,D] f32 and h_last [B,D,N] f32 (the
// caller adds the D * x skip).
//
// Replaces the TPU kernel repro/kernels/selective_scan.py::selective_scan
// (body _scan_kernel; through repro.kernels.ops.selective_scan).  There a
// (batch, channel-block, sequence-block) grid keeps a [bd, N] state tile in
// VMEM scratch and carries it across the in-order sequence axis.  Here one
// thread owns one (b, d) row and keeps its N-vector of f32 state, and its
// row of A, in registers for the whole sequence: the sequence axis is a
// loop inside the thread, so nothing is carried between blocks.  A block
// holds 128 consecutive channels of one batch row; B_t and C_t, which every
// channel of the row shares, are staged in shared memory kChunk time steps
// at a time.  x, dt and y are read and written once, neighbouring threads
// on neighbouring channels (coalesced).  The kernel masks channels >= D
// itself, so D and S take any value without padding, and h_last is exact.
//
// What bounds it on the H100: the bytes of x, dt and y (12 bytes per
// (b, t, d)) against N exp + 4N flops per (b, t, d) -- at N = 16 the
// sequential dependence over t and the exp latency, not the bytes, limit
// this first version: each thread walks S steps in order, and a grid of
// B * D / 128 blocks (200 at the training shape) fills the 132 SMs once.  A
// split over S with a chunked associative scan is later work.
//
// Numerics follow the Pallas kernel: every input widened to f32, exp by the
// full-precision expf (no fast math), the two products of the state update
// rounded on their own and then added (no fma contraction, as XLA keeps
// them), and y's reduction over n runs sequentially in ascending n -- the
// order in which jnp.sum(h * c) is written at selective_scan.py:44; the
// plain version (kernels/selective_scan.py) sums in the same order.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // time steps of B and C staged per chunk

template <int NMAX>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ bm, const float* __restrict__ cm, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_last, int S, int D, int N) {
  __shared__ float bs[kChunk][NMAX];
  __shared__ float cs[kChunk][NMAX];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = d < D;

  float h[NMAX], ar[NMAX];
  const size_t hrow = (static_cast<size_t>(b) * D + (valid ? d : 0)) * N;
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool in = valid && n < N;
    h[n] = in ? h0[hrow + n] : 0.f;
    ar[n] = in ? a[static_cast<size_t>(d) * N + n] : 0.f;
  }
  const float* brow = bm + static_cast<size_t>(b) * S * N;
  const float* crow = cm + static_cast<size_t>(b) * S * N;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk has been read
    for (int idx = threadIdx.x; idx < steps * N; idx += kThreads) {
      const int j = idx / N, n = idx % N;
      bs[j][n] = brow[static_cast<size_t>(t0 + j) * N + n];
      cs[j][n] = crow[static_cast<size_t>(t0 + j) * N + n];
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < steps; ++j) {
      const size_t off = (static_cast<size_t>(b) * S + t0 + j) * D + d;
      const float dt_t = dt[off];
      const float u = __fmul_rn(dt_t, x[off]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          const float da = expf(__fmul_rn(dt_t, ar[n]));
          h[n] = __fadd_rn(__fmul_rn(da, h[n]), __fmul_rn(u, bs[j][n]));
          acc = __fadd_rn(acc, __fmul_rn(h[n], cs[j][n]));
        }
      }
      y[off] = acc;
    }
  }
  if (valid) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) h_last[hrow + n] = h[n];
  }
}

template <int NMAX>
int launch(const float* x, const float* dt, const float* a, const float* b, const float* c,
           const float* h0, float* y, float* h_last, int B, int S, int D, int N,
           cudaStream_t st) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  selective_scan_kernel<NMAX><<<grid, kThreads, 0, st>>>(x, dt, a, b, c, h0, y, h_last, S,
                                                          D, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// x, dt [B,S,D], a [D,N], b, c [B,S,N], h0 [B,D,N], y [B,S,D], h_last
// [B,D,N]; all f32, contiguous.  N above 64 is cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launch.
extern "C" int selective_scan_fwd(const float* x, const float* dt, const float* a,
                                  const float* b, const float* c, const float* h0, float* y,
                                  float* h_last, int B, int S, int D, int N, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || D <= 0 || N <= 0 || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 16) return launch<16>(x, dt, a, b, c, h0, y, h_last, B, S, D, N, st);
  if (N <= 32) return launch<32>(x, dt, a, b, c, h0, y, h_last, B, S, D, N, st);
  if (N <= 64) return launch<64>(x, dt, a, b, c, h0, y, h_last, B, S, D, N, st);
  return cudaErrorInvalidValue;
}
