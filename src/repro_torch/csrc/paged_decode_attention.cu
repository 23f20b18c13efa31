// Paged (block-table) KV-cache decode attention for Hopper: one query token
// per slot against that slot's pages.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention.  There, scalar prefetch brings the block table and
// the lengths ahead of a (slot, kv head, page) grid whose page axis runs in
// order and carries (m, l, acc) in VMEM scratch.  Here one CUDA block per
// (slot, kv head) reads its own block-table row and length and loops over
// the slot's kv positions in chunks of 32: each chunk gathers its rows
// through the block table (page = table[pos / page_size], row = pos %
// page_size) into shared memory as f32, so only pages below
// ceil(length / page_size) are ever read and the tail of the last page is
// masked.  A length past the slot's pages_per_slot * page_size positions (a
// slot at capacity) is clamped to them, as the Pallas grid stops there.  The G = H / KV query rows of the kv head share every staged
// chunk.  A slot of length 0 reads nothing and writes exact zeros, as the
// Pallas kernel does.  Each block touches only its own slot: nothing depends
// on another slot's values and nothing uses atomics, which is what keeps
// the serving engine's solo == mixed contract on the card.
//
// What bounds it on the H100: the bytes of the live KV pages (2 * length *
// dh elements per slot and kv head) against a few FMAs per byte -- decode
// attention is bandwidth-bound.  This first version stages each chunk with
// plain loads and runs f32 FMAs; with one block per (slot, kv head) a small
// batch fills few SMs, so its time is latency, not bandwidth.  Splitting the
// kv loop across blocks and vectorised / asynchronous page loads are later
// work.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;         // kv positions per staged chunk (= warp size)
constexpr int kMaxRowElems = 1024;  // G * DHMAX held in registers across the block
constexpr int kPerThread = kMaxRowElems / kThreads;

// TQ: the query and output type; TKV: the page pool's type (an f32 model
// keeps a bf16 cache, as the reference's decode_cache_dtype does).
template <typename TQ, typename TKV, int DHMAX>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, TQ* __restrict__ o, int H, int KV, int dh,
    int page_size, int pages_per_slot, float scale) {
  constexpr int GMAX = kMaxRowElems / DHMAX;
  __shared__ float qs[GMAX][DHMAX];
  __shared__ float ks[kChunk][DHMAX + 1];  // +1: score reads walk rows
  __shared__ float vs[kChunk][DHMAX];
  __shared__ float ps[GMAX][kChunk];
  __shared__ float m_s[GMAX], l_s[GMAX], corr_s[GMAX];

  const int slot = blockIdx.x, kvh = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int length = min(lengths[slot], pages_per_slot * page_size);
  const int* table = block_tables + static_cast<size_t>(slot) * pages_per_slot;
  const TQ* qhead = q + (static_cast<size_t>(slot) * H + kvh * G) * dh;

  for (int idx = tid; idx < GMAX * DHMAX; idx += kThreads) {
    const int g = idx / DHMAX, d = idx % DHMAX;
    qs[g][d] = (g < G && d < dh) ? to_f32(qhead[g * dh + d]) : 0.f;
  }
  for (int g = tid; g < GMAX; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc[e] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < length; c0 += kChunk) {
    // stage the chunk's K/V rows through the block table
    for (int idx = tid; idx < kChunk * DHMAX; idx += kThreads) {
      const int j = idx / DHMAX, d = idx % DHMAX, pos = c0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < length && d < dh) {
        const size_t page = static_cast<size_t>(table[pos / page_size]);
        const size_t off =
            ((page * page_size + pos % page_size) * KV + kvh) * static_cast<size_t>(dh) + d;
        kx = to_f32(k_pages[off]);
        vx = to_f32(v_pages[off]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    // scores: one (query row, position) pair per thread
    for (int idx = tid; idx < G * kChunk; idx += kThreads) {
      const int g = idx / kChunk, j = idx % kChunk;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qs[g][d], ks[j][d], dot);
      ps[g][j] = (c0 + j < length) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query row, one lane per position
    for (int g = warp; g < G; g += kThreads / 32) {
      const float sc = ps[g][lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float p = expf(sc - m_new);
      const float psum = warp_sum(p);
      ps[g][lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * corr + sum_j p[g][j] * v[j][d]
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int idx = tid + kThreads * e;
      const int g = idx / DHMAX, d = idx % DHMAX;
      if (g < G) {
        float a = acc[e] * corr_s[g];
#pragma unroll 8
        for (int j = 0; j < kChunk; ++j) a = fmaf(ps[g][j], vs[j][d], a);
        acc[e] = a;
      }
    }
    __syncthreads();
  }

  TQ* ohead = o + (static_cast<size_t>(slot) * H + kvh * G) * dh;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int idx = tid + kThreads * e;
    const int g = idx / DHMAX, d = idx % DHMAX;
    if (g < G && d < dh) ohead[g * dh + d] = from_f32<TQ>(acc[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* bt,
                   const int* lens, void* o, int S, int H, int KV, int dh,
                   int page_size, int pages_per_slot, float scale,
                   cudaStream_t stream) {
  const dim3 grid(S, KV);
  const dim3 block(kThreads);
  const int G = H / KV;
  const TQ* qq = static_cast<const TQ*>(q);
  const TKV* kk = static_cast<const TKV*>(kp);
  const TKV* vv = static_cast<const TKV*>(vp);
  TQ* oo = static_cast<TQ*>(o);
  if (dh <= 32 && G * 32 <= kMaxRowElems) {
    paged_decode_kernel<TQ, TKV, 32><<<grid, block, 0, stream>>>(
        qq, kk, vv, bt, lens, oo, H, KV, dh, page_size, pages_per_slot, scale);
  } else if (dh <= 64 && G * 64 <= kMaxRowElems) {
    paged_decode_kernel<TQ, TKV, 64><<<grid, block, 0, stream>>>(
        qq, kk, vv, bt, lens, oo, H, KV, dh, page_size, pages_per_slot, scale);
  } else if (dh <= 128 && G * 128 <= kMaxRowElems) {
    paged_decode_kernel<TQ, TKV, 128><<<grid, block, 0, stream>>>(
        qq, kk, vv, bt, lens, oo, H, KV, dh, page_size, pages_per_slot, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q [S,H,dh], k/v pages [n_pages,page_size,KV,dh], block_tables [S,P] int32,
// lengths [S] int32, o [S,H,dh]; all contiguous.  q and o share q_dtype, the
// pages kv_dtype (0 = f32, 1 = bf16): f32/f32, bf16/bf16 and f32 q over bf16
// pages.  Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_attention_fwd(const void* q, const void* k_pages,
                                          const void* v_pages, const void* block_tables,
                                          const void* lengths, void* o, int S, int H,
                                          int KV, int dh, int page_size,
                                          int pages_per_slot, float scale, int q_dtype,
                                          int kv_dtype, void* stream) {
  using namespace repro_torch;
  if (S <= 0 || KV <= 0 || H % KV != 0 || page_size <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k_pages, v_pages, bt, lens, o, S, H, KV, dh,
                                page_size, pages_per_slot, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<bf16, bf16>(q, k_pages, v_pages, bt, lens, o, S, H, KV, dh,
                              page_size, pages_per_slot, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, bf16>(q, k_pages, v_pages, bt, lens, o, S, H, KV, dh,
                               page_size, pages_per_slot, scale, st);
  return cudaErrorInvalidValue;
}
