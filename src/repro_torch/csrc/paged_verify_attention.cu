// Paged (block-table) KV-cache attention for Hopper over a window of T query
// tokens per slot: the speculative-verify kernel, and with T = 1 the decode
// kernel (paged_decode_attention.cu launches this one).
//
// Replaces the TPU kernels repro/kernels/decode_attention.py::
// paged_verify_attention (and, at T = 1, ::paged_decode_attention).  There,
// scalar prefetch brings the block table and the lengths ahead of a (slot,
// kv head, page) grid whose page axis runs in order and carries (m, l, acc)
// in VMEM scratch, with the T-token window folded into the query tile as
// [T * G, dh] rows (window position t, group member g at row t * G + g).
//
// Here the kv axis is split across blocks.  The grid is (slot, kv head,
// split x row block): a split is kPagedSplit = 64 positions, a compile-time
// constant, never derived from T, the slot count or a length.  A row block
// is 1024 / DHMAX of the head's T * G rows, what a block holds in registers
// (dh padded to 32, 64, 128 or 256).  A block reads its slot's length and
// the block-table entries of its split together (entries past the length
// are read, never used), then gathers its positions' K and V rows (page =
// table[pos / page_size], row = pos % page_size) by cp.async, 16 bytes a
// thread (a bf16 row of 64 is 8 threads), into a
// two-stage ring of chunks in shared memory, in the pool's type: the next
// chunk's gathers are in flight while this chunk's products run.  Positions
// past the block's reach (its last row's limit) are staged as zeros and never
// read from the pool.  Each block writes its rows' partial (m, l, acc) for
// its split to a workspace the wrapper allocates; a second kernel combines a
// row's splits in ascending split order, always, even for one split:
//   M = max_s m_s,  l = sum_s l_s e^(m_s - M),  o = sum_s acc_s e^(m_s - M) / max(l, 1e-30)
// rounded once to q's type.  A split that lies wholly past a row's limit
// adds exactly l = 0 and acc = 0: masked positions get p = 0 (not exp(-1e30
// - m), which is 1 while m is still -1e30), and the combine reads only the
// splits below the row's limit.  A slot of length 0 reads nothing and writes
// exact zeros.
//
// Row t attends kpos < length + t, the causal intra-window mask over the
// draft tokens whose KV the engine has written at length - 1 .. length + T -
// 2, and every limit is clamped to the slot's pages_per_slot * page_size
// positions, as the Pallas grid stops there.  Each block touches only its own
// slot, and nothing uses atomics, which keeps the engine's solo == mixed
// contract.  The route and every tile size (the split, the chunk of 64, 32 or
// 16 positions, the row block) depend on dh and the dtypes only, and a row's
// sums run in an order fixed by its own limit: so window row t is bitwise
// the decode kernel at length + t, and a T = 1 verify is the decode kernel.
//
// The products run on the CUDA cores: a row is a matrix-vector product (G =
// 1 on opt-125m).  The scores take one thread per (row, position) over the
// head dim in order, widening 16-byte K loads in registers; the softmax one
// warp per row; P V one thread per (row, dim) over the chunk's positions in
// order.  (Four threads per score, or per P V sum, each a quarter of the
// work, made decode and verify slower on the card: the shuffles, and for P
// V 167-216 registers a thread.)
// The f32 instances (f32 pages, and f32 q over bf16 pages) take the same
// body in f32, as the repo's f32 numerics ask.
//
// What bounds it on the H100: the bytes of the live KV pages (2 * length *
// dh elements per slot and kv head) against a few FMAs per byte for each of
// the T * G rows.  At decode's sizes (8 slots, ~2.5 MB) that is under a
// microsecond, so a call is bound by latency: two launches, and per block
// two dependent reads (the length and table entries, then the gathers)
// before one chunk of products at a head dim of 64; the split puts ~230
// live blocks on the 132 SMs at decode's lengths, where one block per (slot,
// kv head) walked the whole history.

#include "common.cuh"
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kMaxRowElems = 1024;  // a block's query rows x DHMAX, held in registers
constexpr int kPerThread = kMaxRowElems / kThreads;
constexpr int kCombineThreads = 64;

template <typename TKV, int DHMAX>
struct PagedShape {
  static constexpr int kRows = kMaxRowElems / DHMAX;                        // rows per block
  static constexpr int kChunk = DHMAX <= 64 ? 64 : DHMAX <= 128 ? 32 : 16;  // positions per stage
  static constexpr int kVec = 16 / sizeof(TKV);                             // elements per 16 B
  static constexpr int kPitch = DHMAX + kVec;  // a staged row, padded by 16 bytes
  static_assert(kPagedSplit % kChunk == 0, "a split is whole chunks");
  static constexpr size_t smem_bytes() { return sizeof(TKV) * 4 * kChunk * kPitch; }
  // the kernel's static shared memory: q rows, p rows, (m, l, corr), limits, table
  static constexpr size_t static_bytes() {
    return sizeof(float) * (kRows * DHMAX + kRows * kChunk + 3 * kRows) +
           sizeof(int) * (kRows + kPagedSplit + 1);
  }
};

// q . k over d = 0 .. dh-1 in order, one f32 fma each; k from a staged row,
// read 16 bytes at a time and widened in registers.  Staged rows hold dh
// values (a multiple of 16 bytes where cp.async staged them) or zeros up to
// DHMAX, and q's row zeros past dh, so reading on to the 16 bytes' end adds 0.
template <int DHMAX>
__device__ __forceinline__ float dot_row(const float* qr, const __nv_bfloat16* kr, int dh) {
  float dot = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < DHMAX; d0 += 8) {
    if (d0 >= dh) break;
    const uint4 raw = *reinterpret_cast<const uint4*>(kr + d0);
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 kf = __bfloat1622float2(k2[i]);
      dot = fmaf(qr[d0 + 2 * i], kf.x, dot);
      dot = fmaf(qr[d0 + 2 * i + 1], kf.y, dot);
    }
  }
  return dot;
}
template <int DHMAX>
__device__ __forceinline__ float dot_row(const float* qr, const float* kr, int dh) {
  float dot = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < DHMAX; d0 += 4) {
    if (d0 >= dh) break;
    const float4 k4 = *reinterpret_cast<const float4*>(kr + d0);
    dot = fmaf(qr[d0], k4.x, dot);
    dot = fmaf(qr[d0 + 1], k4.y, dot);
    dot = fmaf(qr[d0 + 2], k4.z, dot);
    dot = fmaf(qr[d0 + 3], k4.w, dot);
  }
  return dot;
}

// TQ: the query and output type; TKV: the page pool's type (an f32 model
// keeps a bf16 cache, as the reference's decode_cache_dtype does).
template <typename TQ, typename TKV, int DHMAX>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages, const TKV* __restrict__ v_pages,
    const int* __restrict__ block_tables, const int* __restrict__ lengths,
    float* __restrict__ ml, float* __restrict__ accp, int T, int H, int KV, int dh,
    int page_size, int pages_per_slot, int n_splits, float scale, int vec) {
  using Shape = PagedShape<TKV, DHMAX>;
  constexpr int RMAX = Shape::kRows, C = Shape::kChunk, kP = Shape::kPitch, kE = Shape::kVec;
  constexpr int kPL = (C + 31) / 32;  // positions per lane in the softmax
  extern __shared__ __align__(16) unsigned char kv_smem[];
  TKV* ks = reinterpret_cast<TKV*>(kv_smem);  // [2][C][kP]
  TKV* vs = ks + 2 * C * kP;                  // [2][C][kP]
  __shared__ float qs[RMAX][DHMAX];
  __shared__ float ps[RMAX][C];
  __shared__ float m_s[RMAX], l_s[RMAX], corr_s[RMAX];
  __shared__ int lim_s[RMAX];
  __shared__ int tbl[kPagedSplit + 1];

  const int slot = blockIdx.x, kvh = blockIdx.y;
  const int split = blockIdx.z % n_splits, rb = blockIdx.z / n_splits;
  const int G = H / KV, R_all = T * G;
  const int r0 = rb * RMAX, R = min(RMAX, R_all - r0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cap = pages_per_slot * page_size;
  const int len0 = lengths[slot];
  // the table entries the split's positions can use, and the q rows, read
  // while the length is in flight (entries past the length are not used)
  const int p_lo = split * kPagedSplit, pg_lo = p_lo / page_size;
  const int* table = block_tables + static_cast<size_t>(slot) * pages_per_slot;
  const int n_tbl = min(min(kPagedSplit / page_size + 2, kPagedSplit + 1), pages_per_slot - pg_lo);
  for (int i = tid; i < n_tbl; i += kThreads) tbl[i] = table[pg_lo + i];
  for (int idx = tid; idx < RMAX * DHMAX; idx += kThreads) {
    const int rr = idx / DHMAX, d = idx % DHMAX;
    float x = 0.f;
    if (rr < R && d < dh) {
      const int t = (r0 + rr) / G, g = (r0 + rr) % G;
      x = to_f32(q[((static_cast<size_t>(slot) * T + t) * H + kvh * G + g) * dh + d]);
    }
    qs[rr][d] = x;
  }
  // the block's last row's limit; 0 for a dead slot
  const int reach = len0 > 0 ? min(len0 + (r0 + R - 1) / G, cap) : 0;
  if (p_lo >= reach) return;  // no row of the block reaches this split: the combine skips it
  const int p_hi = min(p_lo + kPagedSplit, reach);
  const int n_chunks = (p_hi - p_lo + C - 1) / C;
  for (int rr = tid; rr < RMAX; rr += kThreads) {
    m_s[rr] = kNegInf;
    l_s[rr] = 0.f;
    lim_s[rr] = rr < R ? min(len0 + (r0 + rr) / G, cap) : 0;
  }
  __syncthreads();  // the table entries are in

  // stage chunk c (positions p_lo + c*C ..) into ring stage st
  auto stage = [&](int c, int st) {
    TKV* kd = ks + st * C * kP;
    TKV* vd = vs + st * C * kP;
    const int base = p_lo + c * C;
    if (vec) {
      const int cpr = dh / kE;
      for (int idx = tid; idx < C * cpr; idx += kThreads) {
        const int j = idx / cpr, piece = idx % cpr, pos = base + j;
        const bool ok = pos < p_hi;
        size_t off = 0;
        if (ok) {
          const size_t page = static_cast<size_t>(tbl[pos / page_size - pg_lo]);
          off = ((page * page_size + pos % page_size) * KV + kvh) * static_cast<size_t>(dh) +
                piece * kE;
        }
        cp_async16(kd + j * kP + piece * kE, k_pages + off, ok);
        cp_async16(vd + j * kP + piece * kE, v_pages + off, ok);
      }
    } else {
      for (int idx = tid; idx < C * DHMAX; idx += kThreads) {
        const int j = idx / DHMAX, d = idx % DHMAX, pos = base + j;
        TKV kx = from_f32<TKV>(0.f), vx = from_f32<TKV>(0.f);
        if (pos < p_hi && d < dh) {
          const size_t page = static_cast<size_t>(tbl[pos / page_size - pg_lo]);
          const size_t off =
              ((page * page_size + pos % page_size) * KV + kvh) * static_cast<size_t>(dh) + d;
          kx = k_pages[off];
          vx = v_pages[off];
        }
        kd[j * kP + d] = kx;
        vd[j * kP + d] = vx;
      }
    }
  };

  float acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc[e] = 0.f;

  stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1, base = p_lo + c * C;
    if (c + 1 < n_chunks) stage(c + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: chunk c has landed
    __syncthreads();
    const TKV* kc = ks + st * C * kP;
    const TKV* vc = vs + st * C * kP;

    // scores: one (row, position) per thread
    for (int idx = tid; idx < R * C; idx += kThreads) {
      const int rr = idx / C, j = idx % C;
      ps[rr][j] = dot_row<DHMAX>(qs[rr], kc + j * kP, dh) * scale;
    }
    __syncthreads();

    // online softmax: one warp per row; masked positions get p = 0
    for (int rr = warp; rr < R; rr += kThreads / 32) {
      const int lim = lim_s[rr];
      float sv[kPL];
      float mloc = kNegInf;
#pragma unroll
      for (int e = 0; e < kPL; ++e) {
        const int j = lane + 32 * e;
        sv[e] = (j < C && base + j < lim) ? ps[rr][j] : kNegInf;
        mloc = fmaxf(mloc, sv[e]);
      }
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, warp_max(mloc));
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < kPL; ++e) {
        const int j = lane + 32 * e;
        const float p = (j < C && base + j < lim) ? expf(sv[e] - m_new) : 0.f;
        if (j < C) ps[rr][j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
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
      if (rr < R && d < dh) {
        float a = acc[e] * corr_s[rr];
#pragma unroll 8
        for (int j = 0; j < C; ++j) a = fmaf(ps[rr][j], to_f32(vc[j * kP + d]), a);
        acc[e] = a;
      }
    }
    __syncthreads();  // this stage and ps are read: the next chunk may refill them
  }

  // the partials: record (slot, kv head, row, split)
  const size_t rec0 = (static_cast<size_t>(slot) * KV + kvh) * R_all + r0;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int idx = tid + kThreads * e;
    const int rr = idx / DHMAX, d = idx % DHMAX;
    if (rr < R && d < dh) accp[((rec0 + rr) * n_splits + split) * dh + d] = acc[e];
  }
  for (int rr = tid; rr < R; rr += kThreads) {
    ml[((rec0 + rr) * n_splits + split) * 2] = m_s[rr];
    ml[((rec0 + rr) * n_splits + split) * 2 + 1] = l_s[rr];
  }
}

// One block per output row (slot, t, h): its splits below the row's limit,
// in ascending order.
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads) paged_combine_kernel(
    const float* __restrict__ ml, const float* __restrict__ accp,
    const int* __restrict__ lengths, TQ* __restrict__ o, int T, int H, int KV, int dh, int cap,
    int n_splits) {
  const int row = blockIdx.x;  // (slot * T + t) * H + h, o's row
  const int h = row % H, t = (row / H) % T, slot = row / (H * T);
  const int G = H / KV;
  const int len0 = lengths[slot];
  const int lim = len0 > 0 ? min(len0 + t, cap) : 0;
  const int ns = (lim + kPagedSplit - 1) / kPagedSplit;
  const size_t rec = ((static_cast<size_t>(slot) * KV + h / G) * (T * G) + t * G + h % G) *
                     n_splits;
  TQ* out = o + static_cast<size_t>(row) * dh;
  float M = kNegInf, L = 0.f;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, ml[(rec + s) * 2]);
  for (int s = 0; s < ns; ++s) L += ml[(rec + s) * 2 + 1] * expf(ml[(rec + s) * 2] - M);
  const float denom = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < dh; d += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < ns; ++s) a += accp[(rec + s) * dh + d] * expf(ml[(rec + s) * 2] - M);
    out[d] = from_f32<TQ>(ns > 0 ? a / denom : 0.f);
  }
}

template <typename TQ, typename TKV, int DHMAX>
cudaError_t launch_dh(const TQ* q, const TKV* kp, const TKV* vp, const int* bt,
                      const int* lens, TQ* o, float* work, long long work_floats, int S, int T,
                      int H, int KV, int dh, int page_size, int pages_per_slot, float scale,
                      cudaStream_t stream) {
  using Shape = PagedShape<TKV, DHMAX>;
  const int cap = pages_per_slot * page_size;
  const int n_splits = (cap + kPagedSplit - 1) / kPagedSplit;
  const int R = T * (H / KV);
  const int n_rb = (R + Shape::kRows - 1) / Shape::kRows;
  const long long records = static_cast<long long>(S) * T * H * n_splits;
  if (n_splits <= 0 || static_cast<long long>(n_splits) * n_rb > 65535 ||
      static_cast<long long>(S) * T * H > 0x7fffffffLL || work_floats < records * (dh + 2))
    return cudaErrorInvalidValue;
  float* ml = work;
  float* accp = work + 2 * records;
  constexpr size_t smem = Shape::smem_bytes();
  auto kernel = paged_split_kernel<TQ, TKV, DHMAX>;
  if (smem + Shape::static_bytes() > 48 * 1024) {  // above the default: opt in (f32 pools)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const int vec = (dh * sizeof(TKV)) % 16 == 0 && ((addr(kp) | addr(vp)) % 16) == 0;
  kernel<<<dim3(S, KV, n_splits * n_rb), kThreads, smem, stream>>>(
      q, kp, vp, bt, lens, ml, accp, T, H, KV, dh, page_size, pages_per_slot, n_splits, scale,
      vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<TQ><<<S * T * H, kCombineThreads, 0, stream>>>(ml, accp, lens, o, T, H,
                                                                       KV, dh, cap, n_splits);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* bt,
                   const int* lens, void* o, float* work, long long work_floats, int S, int T,
                   int H, int KV, int dh, int page_size, int pages_per_slot, float scale,
                   cudaStream_t stream) {
  const TQ* qq = static_cast<const TQ*>(q);
  const TKV* kk = static_cast<const TKV*>(kp);
  const TKV* vv = static_cast<const TKV*>(vp);
  TQ* oo = static_cast<TQ*>(o);
  if (dh <= 32)
    return launch_dh<TQ, TKV, 32>(qq, kk, vv, bt, lens, oo, work, work_floats, S, T, H, KV, dh,
                                  page_size, pages_per_slot, scale, stream);
  if (dh <= 64)
    return launch_dh<TQ, TKV, 64>(qq, kk, vv, bt, lens, oo, work, work_floats, S, T, H, KV, dh,
                                  page_size, pages_per_slot, scale, stream);
  if (dh <= 128)
    return launch_dh<TQ, TKV, 128>(qq, kk, vv, bt, lens, oo, work, work_floats, S, T, H, KV,
                                   dh, page_size, pages_per_slot, scale, stream);
  if (dh <= 256)
    return launch_dh<TQ, TKV, 256>(qq, kk, vv, bt, lens, oo, work, work_floats, S, T, H, KV,
                                   dh, page_size, pages_per_slot, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t paged_window_attention(const void* q, const void* k_pages, const void* v_pages,
                                   const int* block_tables, const int* lengths, void* o,
                                   float* work, long long work_floats, int S, int T, int H,
                                   int KV, int dh, int page_size, int pages_per_slot,
                                   float scale, int q_dtype, int kv_dtype, cudaStream_t stream) {
  if (S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || page_size <= 0 || pages_per_slot <= 0 ||
      KV > 65535)
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k_pages, v_pages, block_tables, lengths, o, work,
                                work_floats, S, T, H, KV, dh, page_size, pages_per_slot, scale,
                                stream);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<bf16, bf16>(q, k_pages, v_pages, block_tables, lengths, o, work, work_floats,
                              S, T, H, KV, dh, page_size, pages_per_slot, scale, stream);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, bf16>(q, k_pages, v_pages, block_tables, lengths, o, work, work_floats,
                               S, T, H, KV, dh, page_size, pages_per_slot, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace repro_torch

// q [S,T,H,dh], k/v pages [n_pages,page_size,KV,dh], block_tables [S,P] int32,
// lengths [S] int32 (the kv count window position 0 attends), o [S,T,H,dh];
// all contiguous; work f32 of work_floats (paged_attention.cuh).  Returns
// cudaGetLastError() after the launches.
extern "C" int paged_verify_attention_fwd(const void* q, const void* k_pages,
                                          const void* v_pages, const void* block_tables,
                                          const void* lengths, void* o, void* work,
                                          long long work_floats, int S, int T, int H, int KV,
                                          int dh, int page_size, int pages_per_slot,
                                          float scale, int q_dtype, int kv_dtype,
                                          void* stream) {
  return repro_torch::paged_window_attention(
      q, k_pages, v_pages, static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), o, static_cast<float*>(work), work_floats, S, T, H, KV,
      dh, page_size, pages_per_slot, scale, q_dtype, kv_dtype,
      static_cast<cudaStream_t>(stream));
}
