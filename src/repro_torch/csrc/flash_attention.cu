// Forward flash attention (causal, GQA, sliding window, q_offset) for Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention.
// That kernel walks a (B, H, q-block, kv-block) grid whose kv axis runs in
// order and carries the online-softmax state (m, l, acc) in VMEM scratch.
// Here the kv axis is a loop inside one CUDA block: one block per
// (q-tile of 64 rows, head, batch row), 256 threads, four threads per query
// row, each owning a quarter of the head dim (d = part + 4*i, so the four
// read neighbouring shared-memory words); at head dim 256, eight threads per
// row and 32-row q-tiles.  Each 32-row K/V tile is staged
// once in shared memory as f32 and reused by all 64 query rows; the score
// tile lives in registers and never reaches device memory.  Tiles that the
// causal mask or the window rule out for the whole q-tile are skipped;
// positions >= T are masked, so S, T and dh (up to 256) need no padding.
//
// What bounds it on the H100: at the serving shapes (S <= 512, dh 64) the
// bytes moved are small (q, k, v, o once: 4*S*H*dh elements) and the work is
// 4*H*dh*S^2/2 multiply-adds, which this first version runs as f32 FMAs on
// the CUDA cores, not on the tensor cores -- the operations bound it, and
// with one block per (64 rows, head) a short prompt fills few of the 132
// SMs.  Moving the two products onto mma/wgmma and splitting the kv loop
// across blocks for short, wide grids are later work.
//
// Numerics follow the Pallas kernel: bf16 inputs are widened to f32 before
// every product, scores are dot * dh^-0.5, masked scores are -1e30, and
// the output is acc / max(l, 1e-30) rounded once to the input type.  A
// row's result depends only on that row's q and on k, v: no atomics, and
// the partial dot products are combined in a fixed butterfly order.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

// kTPR: threads per query row, so kThreads / kTPR query rows per block.
// kBK: kv rows per shared-memory tile.  Up to a head dim of 128, four
// threads per row and 32-row tiles; the head-dim-256 instance takes eight
// threads per row, so each thread's q and acc rows stay at 32 elements (at
// four, 233 registers held one block per SM), and 16-row tiles, so its f32
// K/V tiles (2 x 16 x 256 x 4 bytes) stay within the 48 KB of static shared
// memory.
template <int DHMAX>
struct FlashShape {
  static constexpr int kTPR = DHMAX <= 128 ? 4 : 8;
  static constexpr int kBQ = kThreads / kTPR;
  static constexpr int kBK = DHMAX <= 128 ? 32 : 16;
};

template <typename T, int DHMAX>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int Tk, int H, int KV, int dh, int q_offset,
    int window, int causal, float scale) {
  constexpr int kTPR = FlashShape<DHMAX>::kTPR;
  constexpr int kBQ = FlashShape<DHMAX>::kBQ;
  constexpr int kBK = FlashShape<DHMAX>::kBK;
  constexpr int DPT = DHMAX / kTPR;  // head-dim elements per thread
  __shared__ float ks[kBK][DHMAX];
  __shared__ float vs[kBK][DHMAX];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int part = tid % kTPR;
  const int row = tile * kBQ + tid / kTPR;
  const bool row_ok = row < S;
  const int qpos = row + q_offset;

  float qr[DPT], acc[DPT];
  const T* qrow = q + ((static_cast<size_t>(b) * S + (row_ok ? row : 0)) * H + h) * dh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = part + kTPR * i;
    qr[i] = (row_ok && d < dh) ? to_f32(qrow[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int q_lo = tile * kBQ + q_offset;
  const int q_hi = q_lo + kBQ - 1;
  for (int k_lo = 0; k_lo < Tk; k_lo += kBK) {
    // block-level skip, uniform across the block (so __syncthreads is safe)
    if (causal && k_lo > q_hi) break;
    if (window > 0 && q_lo - (k_lo + kBK - 1) >= window) continue;

    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < kBK * DHMAX; idx += kThreads) {
      const int j = idx / DHMAX, d = idx % DHMAX, t = k_lo + j;
      float kx = 0.f, vx = 0.f;
      if (t < Tk && d < dh) {
        const size_t off = ((static_cast<size_t>(b) * Tk + t) * KV + kvh) * dh + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    float s[kBK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dot = fmaf(qr[i], ks[j][part + kTPR * i], dot);
#pragma unroll
      for (int sh = 1; sh < kTPR; sh <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, sh);
      const int kpos = k_lo + j;
      bool allow = kpos < Tk;
      if (causal) allow = allow && kpos <= qpos;
      if (window > 0) allow = allow && (qpos - kpos < window);
      s[j] = allow ? dot * scale : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kBK; ++j) a = fmaf(s[j], vs[j][part + kTPR * i], a);
      acc[i] = a;
    }
    m = m_new;
  }

  if (row_ok) {
    T* orow = o + ((static_cast<size_t>(b) * S + row) * H + h) * dh;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = part + kTPR * i;
      if (d < dh) orow[d] = from_f32<T>(acc[i] / denom);
    }
  }
}

template <typename T, int DHMAX>
void launch_dh(const T* q, const T* k, const T* v, T* o, int B, int S, int Tk, int H, int KV,
               int dh, int q_offset, int window, int causal, float scale,
               cudaStream_t stream) {
  constexpr int kBQ = FlashShape<DHMAX>::kBQ;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, DHMAX><<<grid, kThreads, 0, stream>>>(
      q, k, v, o, S, Tk, H, KV, dh, q_offset, window, causal, scale);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int Tk, int H, int KV, int dh, int q_offset, int window,
                   int causal, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (dh <= 32) {
    launch_dh<T, 32>(qp, kp, vp, op, B, S, Tk, H, KV, dh, q_offset, window, causal, scale,
                     stream);
  } else if (dh <= 64) {
    launch_dh<T, 64>(qp, kp, vp, op, B, S, Tk, H, KV, dh, q_offset, window, causal, scale,
                     stream);
  } else if (dh <= 128) {
    launch_dh<T, 128>(qp, kp, vp, op, B, S, Tk, H, KV, dh, q_offset, window, causal, scale,
                      stream);
  } else if (dh <= 256) {
    launch_dh<T, 256>(qp, kp, vp, op, B, S, Tk, H, KV, dh, q_offset, window, causal, scale,
                      stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q [B,S,H,dh], k/v [B,T,KV,dh], o [B,S,H,dh], all contiguous, one dtype
// (0 = f32, 1 = bf16).  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int T, int H, int KV,
                                   int dh, int q_offset, int window, int causal,
                                   float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, S, T, H, KV, dh, q_offset, window, causal, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, dh, q_offset, window,
                                 causal, scale, st);
  return cudaErrorInvalidValue;
}
