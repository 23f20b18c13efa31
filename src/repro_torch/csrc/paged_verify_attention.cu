// Paged (block-table) KV-cache attention for Hopper over a window of T query
// tokens per slot: the speculative-verify kernel, and with T = 1 the decode
// kernel (paged_decode_attention.cu launches this one).
//
// Replaces the TPU kernels repro/kernels/decode_attention.py::
// paged_verify_attention (and, at T = 1, ::paged_decode_attention).  There,
// scalar prefetch brings the block table and the lengths ahead of a (slot,
// kv head, page) grid whose page axis runs in order and carries (m, l, acc)
// in VMEM scratch, with the T-token window folded into the query tile as
// [T * G, dh] rows.  Here one CUDA block per (slot, kv head) reads its own
// block-table row and length and loops over the slot's kv positions in
// chunks of 32: each chunk gathers its rows through the block table (page =
// table[pos / page_size], row = pos % page_size) into shared memory as f32,
// so only pages the window reaches are ever read and the tail of the last
// page is masked.  The T * G query rows of the kv head (window position t,
// group member g at row t * G + g, as the Pallas kernel folds them) are cut
// into blocks of 1024 / DHMAX rows, which is what a block holds in
// registers; a third grid axis runs over these row blocks, and each block
// re-reads its kv head's pages up to its last row's reach (a decode step,
// and any window of T * G <= 1024 / DHMAX rows, is one row block).  The rows
// of a block share every staged chunk; row t attends kpos < length + t, the causal
// intra-window mask over the draft tokens whose KV the engine has already
// written at length - 1 .. length + T - 2.  Every limit is clamped to the
// slot's pages_per_slot * page_size positions (a window overhanging a slot
// at capacity), as the Pallas grid stops there.  A slot of length 0 reads
// nothing and writes exact zeros.  Each block touches only its own slot:
// nothing depends on another slot's values and nothing uses atomics, which
// is what keeps the serving engine's solo == mixed contract on the card.
//
// What bounds it on the H100: the bytes of the live KV pages (2 * length *
// dh elements per slot and kv head) against a few FMAs per byte for each of
// the T * G rows -- bandwidth-bound at the window sizes speculative decoding
// uses.  The K/V chunk lives in dynamic shared memory (64 KB at a head dim
// of 256, above the 48 KB default, so that instance opts in).  This first version stages each chunk with plain loads and runs f32
// FMAs; with one block per (slot, kv head) a small batch fills few SMs, so
// its time is latency, not bandwidth.  Splitting the kv loop across blocks
// and vectorised / asynchronous page loads are later work.

#include "common.cuh"
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;          // kv positions per staged chunk (= warp size)
constexpr int kMaxRowElems = 1024;  // a block's query rows x DHMAX, held in registers
constexpr int kPerThread = kMaxRowElems / kThreads;

// Dynamic shared memory of one block: the chunk's K ([kChunk][DHMAX + 1],
// +1: score reads walk rows) and V ([kChunk][DHMAX]) rows as f32.
template <int DHMAX>
constexpr size_t kv_smem_bytes() {
  return sizeof(float) * kChunk * (2 * DHMAX + 1);
}

// TQ: the query and output type; TKV: the page pool's type (an f32 model
// keeps a bf16 cache, as the reference's decode_cache_dtype does).  Block
// (slot, kv head, row block z) serves query rows z * RMAX .. of the head's
// T * G window rows.
template <typename TQ, typename TKV, int DHMAX>
__global__ void __launch_bounds__(kThreads) paged_window_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, TQ* __restrict__ o, int T, int H, int KV, int dh,
    int page_size, int pages_per_slot, float scale) {
  constexpr int RMAX = kMaxRowElems / DHMAX;  // query rows per block
  extern __shared__ float kv_smem[];
  float(*ks)[DHMAX + 1] = reinterpret_cast<float(*)[DHMAX + 1]>(kv_smem);
  float(*vs)[DHMAX] = reinterpret_cast<float(*)[DHMAX]>(kv_smem + kChunk * (DHMAX + 1));
  __shared__ float qs[RMAX][DHMAX];
  __shared__ float ps[RMAX][kChunk];
  __shared__ float m_s[RMAX], l_s[RMAX], corr_s[RMAX];
  __shared__ int lim_s[RMAX];

  const int slot = blockIdx.x, kvh = blockIdx.y;
  const int G = H / KV;
  const int r0 = blockIdx.z * RMAX;                // this block's first window row
  const int R = min(RMAX, T * G - r0);             // and its row count
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cap = pages_per_slot * page_size;
  const int len0 = lengths[slot];
  // the block's last row's reach; 0 for a dead slot.  A row's chunks past
  // its own limit add exact zeros, so where the loop stops changes no row.
  const int length = len0 > 0 ? min(len0 + (r0 + R - 1) / G, cap) : 0;
  const int* table = block_tables + static_cast<size_t>(slot) * pages_per_slot;

  for (int idx = tid; idx < RMAX * DHMAX; idx += kThreads) {
    const int rr = idx / DHMAX, d = idx % DHMAX;
    float x = 0.f;
    if (rr < R && d < dh) {
      const int t = (r0 + rr) / G, g = (r0 + rr) % G;
      x = to_f32(q[((static_cast<size_t>(slot) * T + t) * H + kvh * G + g) * dh + d]);
    }
    qs[rr][d] = x;
  }
  for (int rr = tid; rr < RMAX; rr += kThreads) {
    m_s[rr] = kNegInf;
    l_s[rr] = 0.f;
    lim_s[rr] = (rr < R && len0 > 0) ? min(len0 + (r0 + rr) / G, cap) : 0;
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
    for (int idx = tid; idx < R * kChunk; idx += kThreads) {
      const int rr = idx / kChunk, j = idx % kChunk;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qs[rr][d], ks[j][d], dot);
      ps[rr][j] = (c0 + j < lim_s[rr]) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query row, one lane per position
    for (int rr = warp; rr < R; rr += kThreads / 32) {
      const float sc = ps[rr][lane];
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float p = expf(sc - m_new);
      const float psum = warp_sum(p);
      ps[rr][lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[rr] = corr;
        l_s[rr] = l_s[rr] * corr + psum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();

    // acc[rr][d] = acc * corr + sum_j p[rr][j] * v[j][d]
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int idx = tid + kThreads * e;
      const int rr = idx / DHMAX, d = idx % DHMAX;
      if (rr < R) {
        float a = acc[e] * corr_s[rr];
#pragma unroll 8
        for (int j = 0; j < kChunk; ++j) a = fmaf(ps[rr][j], vs[j][d], a);
        acc[e] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int idx = tid + kThreads * e;
    const int rr = idx / DHMAX, d = idx % DHMAX;
    if (rr < R && d < dh) {
      const int t = (r0 + rr) / G, g = (r0 + rr) % G;
      o[((static_cast<size_t>(slot) * T + t) * H + kvh * G + g) * dh + d] =
          from_f32<TQ>(acc[e] / fmaxf(l_s[rr], 1e-30f));
    }
  }
}

template <typename TQ, typename TKV, int DHMAX>
cudaError_t launch_dh(const TQ* q, const TKV* kp, const TKV* vp, const int* bt,
                      const int* lens, TQ* o, int S, int T, int H, int KV, int dh,
                      int page_size, int pages_per_slot, float scale, cudaStream_t stream) {
  constexpr int RMAX = kMaxRowElems / DHMAX;
  const int R = T * (H / KV);
  const dim3 grid(S, KV, (R + RMAX - 1) / RMAX);
  constexpr size_t smem = kv_smem_bytes<DHMAX>();
  auto kernel = paged_window_kernel<TQ, TKV, DHMAX>;
  if (smem > 48 * 1024) {  // above the default: opt in (the 256 instance)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(q, kp, vp, bt, lens, o, T, H, KV, dh, page_size,
                                           pages_per_slot, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* bt,
                   const int* lens, void* o, int S, int T, int H, int KV, int dh,
                   int page_size, int pages_per_slot, float scale, cudaStream_t stream) {
  const TQ* qq = static_cast<const TQ*>(q);
  const TKV* kk = static_cast<const TKV*>(kp);
  const TKV* vv = static_cast<const TKV*>(vp);
  TQ* oo = static_cast<TQ*>(o);
  if (dh <= 32)
    return launch_dh<TQ, TKV, 32>(qq, kk, vv, bt, lens, oo, S, T, H, KV, dh, page_size,
                                  pages_per_slot, scale, stream);
  if (dh <= 64)
    return launch_dh<TQ, TKV, 64>(qq, kk, vv, bt, lens, oo, S, T, H, KV, dh, page_size,
                                  pages_per_slot, scale, stream);
  if (dh <= 128)
    return launch_dh<TQ, TKV, 128>(qq, kk, vv, bt, lens, oo, S, T, H, KV, dh, page_size,
                                   pages_per_slot, scale, stream);
  if (dh <= 256)
    return launch_dh<TQ, TKV, 256>(qq, kk, vv, bt, lens, oo, S, T, H, KV, dh, page_size,
                                   pages_per_slot, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t paged_window_attention(const void* q, const void* k_pages, const void* v_pages,
                                   const int* block_tables, const int* lengths, void* o,
                                   int S, int T, int H, int KV, int dh, int page_size,
                                   int pages_per_slot, float scale, int q_dtype,
                                   int kv_dtype, cudaStream_t stream) {
  if (S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || page_size <= 0 || KV > 65535 ||
      T * (H / KV) > 65535)
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k_pages, v_pages, block_tables, lengths, o, S, T, H, KV,
                                dh, page_size, pages_per_slot, scale, stream);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<bf16, bf16>(q, k_pages, v_pages, block_tables, lengths, o, S, T, H, KV,
                              dh, page_size, pages_per_slot, scale, stream);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, bf16>(q, k_pages, v_pages, block_tables, lengths, o, S, T, H, KV,
                               dh, page_size, pages_per_slot, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace repro_torch

// q [S,T,H,dh], k/v pages [n_pages,page_size,KV,dh], block_tables [S,P] int32,
// lengths [S] int32 (the kv count window position 0 attends), o [S,T,H,dh];
// all contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int paged_verify_attention_fwd(const void* q, const void* k_pages,
                                          const void* v_pages, const void* block_tables,
                                          const void* lengths, void* o, int S, int T, int H,
                                          int KV, int dh, int page_size,
                                          int pages_per_slot, float scale, int q_dtype,
                                          int kv_dtype, void* stream) {
  return repro_torch::paged_window_attention(
      q, k_pages, v_pages, static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), o, S, T, H, KV, dh, page_size, pages_per_slot,
      scale, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream));
}
