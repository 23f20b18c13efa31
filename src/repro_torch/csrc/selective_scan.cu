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
// VMEM scratch and carries it across the in-order sequence axis.  Here the
// sequence axis is a loop inside the block, so nothing is carried between
// blocks, and the state is spread over lanes: a lane owns SPL neighbouring
// states of one channel's N (SPL l .. SPL l + SPL - 1), so a 128-thread
// block holds 128 / kLanes channels of one batch row, and each lane keeps its
// states and their row of A in registers for the whole sequence.  SPL is
// 2 where one wave of the card holds that grid (as the occupancy API
// reports it for the instance), else 4 (4 at N = 64: 16 lanes a channel at
// most).  Measured (tools/kernel_variants.py), two states a lane beat one
// at every main-path shape, decode included: their two independent exp
// chains are worth more than twice the warps; four win where two would
// need a second wave, which would run a few blocks alone (the training
// shape).
//
// What bounds it on the H100: instruction issue.  Per (b, t, d, n) the
// update costs expf (about 8 instructions around one MUFU.EX2) and 6 f32
// operations, against 12 bytes of x, dt and y per (b, t, d); chip_smoke.py
// counts both.  The design keeps the issue slots for that arithmetic:
// - every lane's states are independent, so a warp issues 32 lanes' expf
//   (not one thread's 16 in a row) and a lane interleaves its own states';
// - x, dt, B and C for kSteps time steps are staged in shared memory by
//   cp.async in a two-stage ring, the next chunk in flight while this one
//   is scanned, so the time loop reads only shared memory and registers:
//   x and dt in rows of the block's channels (16-byte copies where D and
//   the pointers allow), B and C interleaved into (B, C) pairs at a pitch
//   of NPAD states, so a lane reads its states' pairs at constant offsets,
//   16 bytes (two states) a read;
// - y's sum over n is off the recurrence's path: each lane writes its
//   rounded products h * C for kSub steps into its warp's shared buffer
//   (laid out [n][step, channel], so neither the writes nor the reads meet
//   a bank conflict), then each lane of the warp sums kSumRows (step,
//   channel) rows of them, each into the slot of the x it replaces, and
//   the chunk's y leaves in rows of the block's channels (coalesced).
// Masked lanes (n >= N, d >= D) and a ragged last chunk take any N <= 64
// and any D and S without padding, so h_last is exact.  A split of S across
// blocks by an associative scan would re-round h (chained != one call).
//
// Numerics follow the Pallas kernel, so every bit of y and h_last is the
// thread-per-row version's: every input widened to f32, exp by the
// full-precision expf (no fast math), the two products of the state update
// rounded on their own and then added (no fma contraction, as XLA keeps
// them), and y's reduction over n runs sequentially in ascending n from +0
// -- the order in which jnp.sum(h * c) is written at selective_scan.py:44;
// the plain version (kernels/selective_scan.py) sums in the same order.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;         // time steps staged per ring stage (at least)
constexpr int kSumRows = 2;        // (step, channel) rows each lane sums per batch

// The block's layout for a state of NPAD (>= N) with SPL states a lane.
template <int NPAD, int SPL>
struct Layout {
  static constexpr int kLanes = NPAD / SPL;             // lanes of one channel
  static constexpr int kChannels = kThreads / kLanes;   // channels of the block
  static constexpr int kWarpChannels = 32 / kLanes;     // channels of one warp
  static constexpr int kSub = kLanes * kSumRows;        // steps per product batch
  static constexpr int kSteps = kSub > kChunk ? kSub : kChunk;  // steps per stage
  // a warp's products, [n][32 kSumRows (step, channel) rows + pad]: the
  // summing lanes read a row each, and one state of every lane is written
  // at once, both free of bank conflicts (but for N = 64's, two-way)
  static constexpr int kPitch = 32 * kSumRows + (NPAD <= 32 ? 32 / NPAD : 1);
  static constexpr int kProd = NPAD * kPitch;
  static constexpr int kXdt = kSteps * kChannels;       // floats of x (or dt) per stage
  static constexpr int kBc = 2 * kSteps * NPAD;         // floats of (B, C) pairs per stage
  static constexpr size_t kSmem =
      sizeof(float) * (4 * kXdt + 2 * kBc + (kThreads / 32) * kProd);
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0, "lanes of a channel");
  static_assert(kSteps % kSub == 0 && kChannels % 4 == 0, "chunk and channel tiling");
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One commit group: x[b, t0 .. t0+steps-1, d0 .. d0+cols-1] (and dt) into
// the stage's [kSteps][kChannels] rows (channels past D are zeros), and B
// and C's steps * N floats, each contiguous in memory, into (B, C) pairs
// at [kSteps][NPAD] (states past N are zeros).
template <typename L, int NPAD>
__device__ __forceinline__ void stage_chunk(float* xs, float* dts, float2* bcs, const float* x,
                                            const float* dt, const float* bm, const float* cm,
                                            int b, int t0, int steps, int d0, int cols, int S,
                                            int D, int N, bool vec_x) {
  if (vec_x) {  // D % 4 == 0: whole 16-byte pieces, cols a multiple of 4
    constexpr int kQ = L::kChannels / 4;
    for (int idx = threadIdx.x; idx < steps * kQ; idx += kThreads) {
      const int j = idx / kQ, q = 4 * (idx % kQ);
      const bool ok = q < cols;
      const size_t off = (static_cast<size_t>(b) * S + t0 + j) * D + d0 + (ok ? q : 0);
      cp_async16(xs + j * L::kChannels + q, x + off, ok);
      cp_async16(dts + j * L::kChannels + q, dt + off, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < steps * L::kChannels; idx += kThreads) {
      const int j = idx / L::kChannels, c = idx % L::kChannels;
      const bool ok = c < cols;
      const size_t off = (static_cast<size_t>(b) * S + t0 + j) * D + d0 + (ok ? c : 0);
      cp_async4(xs + idx, x + off, ok);
      cp_async4(dts + idx, dt + off, ok);
    }
  }
  const size_t boff = (static_cast<size_t>(b) * S + t0) * N;
  for (int i = threadIdx.x; i < steps * NPAD; i += kThreads) {
    const int j = i / NPAD, n = i % NPAD;
    const bool ok = n < N;
    const size_t src = boff + (ok ? static_cast<size_t>(j) * N + n : 0);
    cp_async4(&bcs[i].x, bm + src, ok);
    cp_async4(&bcs[i].y, cm + src, ok);
  }
  cp_async_commit();
}

// kSub steps of the lane's states from step j0 of the staged chunk, their
// rounded products h * C into the warp's buffer at p.  The operands are
// restrict-qualified, so a step's reads may issue ahead of the previous
// step's product stores.
template <typename L, int NPAD, int SPL>
__device__ __forceinline__ void advance(float (&h)[SPL], const float (&ar)[SPL],
                                        const float* __restrict__ dtc,
                                        const float* __restrict__ xc,
                                        const float2* __restrict__ bcc, float* __restrict__ p,
                                        int j0, int steps, int ch, int l) {
#pragma unroll
  for (int jj = 0; jj < L::kSub; ++jj) {
    const int j = j0 + jj;
    if (j < steps) {
      const float dt_t = dtc[j * L::kChannels + ch];
      const float u = __fmul_rn(dt_t, xc[j * L::kChannels + ch]);
      float2 bcs[SPL];  // the lane's (B, C) pairs, 16 bytes a read
      if constexpr (SPL % 2 == 0) {
        const float4* q = reinterpret_cast<const float4*>(bcc + j * NPAD + l * SPL);
#pragma unroll
        for (int s = 0; s < SPL; s += 2) {
          const float4 v = q[s / 2];
          bcs[s] = make_float2(v.x, v.y);
          bcs[s + 1] = make_float2(v.z, v.w);
        }
      } else {
#pragma unroll
        for (int s = 0; s < SPL; ++s) bcs[s] = bcc[j * NPAD + l * SPL + s];
      }
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        const int n = l * SPL + s;
        const float2 bc = bcs[s];
        const float da = expf(__fmul_rn(dt_t, ar[s]));
        h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(u, bc.x));
        p[jj * L::kWarpChannels + n * L::kPitch] = __fmul_rn(h[s], bc.y);
      }
    }
  }
}

template <int NPAD, int SPL>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ bm, const float* __restrict__ cm, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_last, int S, int D, int N) {
  using L = Layout<NPAD, SPL>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [2][kSteps][kChannels]; a chunk's y after its x
  float* dts = xs + 2 * L::kXdt;     // [2][kSteps][kChannels]
  float2* bcs = reinterpret_cast<float2*>(dts + 2 * L::kXdt);  // [2][kSteps * NPAD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* prod = dts + 2 * L::kXdt + 2 * L::kBc + warp * L::kProd;  // [NPAD][kPitch]

  const int b = blockIdx.y, d0 = blockIdx.x * L::kChannels;
  const int wc = lane / L::kLanes, l = lane % L::kLanes;
  const int ch = warp * L::kWarpChannels + wc;  // the lane's channel in the block
  const int d = d0 + ch, cols = min(L::kChannels, D - d0);
  const bool valid = d < D;

  float h[SPL], ar[SPL];
  const size_t hrow = (static_cast<size_t>(b) * D + (valid ? d : 0)) * N;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int n = l * SPL + s;
    const bool in = valid && n < N;
    h[s] = in ? h0[hrow + n] : 0.f;
    ar[s] = in ? a[static_cast<size_t>(d) * N + n] : 0.f;
  }
  const bool vec_x = D % 4 == 0 && aligned16(x) && aligned16(dt);

  const int chunks = (S + L::kSteps - 1) / L::kSteps;
  stage_chunk<L, NPAD>(xs, dts, bcs, x, dt, bm, cm, b, 0, min(L::kSteps, S), d0, cols, S, D,
                       N, vec_x);
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * L::kSteps, st = c & 1, steps = min(L::kSteps, S - t0);
    cp_async_wait<0>();
    // chunk c has landed for every thread, and chunk c - 1's y rows have
    // left stage st ^ 1, which chunk c + 1 now fills while c is scanned
    __syncthreads();
    if (c + 1 < chunks) {
      const int o = st ^ 1;
      stage_chunk<L, NPAD>(xs + o * L::kXdt, dts + o * L::kXdt, bcs + o * L::kBc / 2, x, dt,
                           bm, cm, b, t0 + L::kSteps, min(L::kSteps, S - t0 - L::kSteps), d0,
                           cols, S, D, N, vec_x);
    }
    float* xc = xs + st * L::kXdt;
    const float* dtc = dts + st * L::kXdt;
    const float2* bcc = bcs + st * L::kBc / 2;
    for (int j0 = 0; j0 < steps; j0 += L::kSub) {
      advance<L, NPAD, SPL>(h, ar, dtc, xc, bcc, prod + wc, j0, steps, ch, l);
      __syncwarp();
      // lane i sums product row i + 32 r: step (i + 32 r) / kWarpChannels of
      // the batch, the warp's channel i % kWarpChannels; n ascending from +0.
      // States past N hold h = +0 and C = 0: their +0 products leave the
      // sum's bits as they are (it is never -0), so every row sums NPAD.
#pragma unroll
      for (int r = 0; r < kSumRows; ++r) {
        const int row = lane + 32 * r, j = j0 + row / L::kWarpChannels;
        if (j < steps) {
          float acc = 0.f;
#pragma unroll
          for (int n = 0; n < NPAD; ++n) acc = __fadd_rn(acc, prod[n * L::kPitch + row]);
          // x of this (step, channel) was read by this warp's lanes only,
          // before the __syncwarp: its slot takes y
          xc[j * L::kChannels + warp * L::kWarpChannels + row % L::kWarpChannels] = acc;
        }
      }
      __syncwarp();  // the batch's products are read before the next overwrites them
    }
    __syncthreads();  // the chunk's y is whole
    for (int idx = threadIdx.x; idx < steps * L::kChannels; idx += kThreads) {
      const int j = idx / L::kChannels, k = idx % L::kChannels;
      if (k < cols) y[(static_cast<size_t>(b) * S + t0 + j) * D + d0 + k] = xc[idx];
    }
  }
  if (valid) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int n = l * SPL + s;
      if (n < N) h_last[hrow + n] = h[s];
    }
  }
}

template <int NPAD, int SPL>
int launch(const float* x, const float* dt, const float* a, const float* b, const float* c,
           const float* h0, float* y, float* h_last, int B, int S, int D, int N,
           cudaStream_t st) {
  using L = Layout<NPAD, SPL>;
  constexpr auto kernel = selective_scan_kernel<NPAD, SPL>;
  if (L::kSmem > 48 * 1024)
    if (const int err = allow_smem<kernel>(L::kSmem)) return err;
  const dim3 grid((D + L::kChannels - 1) / L::kChannels, B);
  kernel<<<grid, kThreads, L::kSmem, st>>>(x, dt, a, b, c, h0, y, h_last, S, D, N);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of this instance that one wave of the card holds (queried
// once; 0 if the query fails, so the instance is never taken for fitting).
template <int NPAD, int SPL>
int wave_blocks() {
  static const int blocks = [] {
    using L = Layout<NPAD, SPL>;
    constexpr auto kernel = selective_scan_kernel<NPAD, SPL>;
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        (L::kSmem > 48 * 1024 && allow_smem<kernel>(L::kSmem) != 0) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, L::kSmem) !=
            cudaSuccess)
      return 0;
    return sms * per_sm;
  }();
  return blocks;
}

// The first of the instances <NPAD, SPL>, <NPAD, MORE>... whose grid one
// wave holds, else the last.
template <int NPAD, int SPL, int... MORE>
int launch_fitting(const float* x, const float* dt, const float* a, const float* b, const float* c,
           const float* h0, float* y, float* h_last, int B, int S, int D, int N,
           cudaStream_t st) {
  if constexpr (sizeof...(MORE) > 0) {
    const long long blocks =
        static_cast<long long>(B) * ((D + Layout<NPAD, SPL>::kChannels - 1) /
                                     Layout<NPAD, SPL>::kChannels);
    if (blocks > wave_blocks<NPAD, SPL>())
      return launch_fitting<NPAD, MORE...>(x, dt, a, b, c, h0, y, h_last, B, S, D, N, st);
  }
  return launch<NPAD, SPL>(x, dt, a, b, c, h0, y, h_last, B, S, D, N, st);
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
  if (N <= 16) return launch_fitting<16, 2, 4>(x, dt, a, b, c, h0, y, h_last, B, S, D, N, st);
  if (N <= 32) return launch_fitting<32, 2, 4>(x, dt, a, b, c, h0, y, h_last, B, S, D, N, st);
  if (N <= 64) return launch_fitting<64, 4>(x, dt, a, b, c, h0, y, h_last, B, S, D, N, st);
  return cudaErrorInvalidValue;
}
