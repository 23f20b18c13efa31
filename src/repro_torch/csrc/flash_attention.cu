// Forward flash attention (causal, GQA, sliding window, q_offset) for Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention.
// That kernel walks a (B, H, q-block, kv-block) grid whose kv axis runs in
// order and carries the online-softmax state (m, l, acc) in VMEM scratch.
// Here the kv axis is a loop inside one CUDA block, one block per (q-tile,
// head, batch row); the score tile lives in registers and never reaches
// device memory.  Tiles that the causal mask or the window rule out for the
// whole q-tile are not loaded, and a warp skips the products of a tile that
// is masked for all its 16 rows; positions >= T are masked, so S, T and dh
// (up to 256) need no padding.
//
// bf16 inputs (every full-width config) run on the tensor cores.  A block
// of four warps owns 32 query rows: two slices of 16 rows (the m16n8k16
// tile's M side), and for each slice two warps that take the kv tiles in
// turn and combine their softmax states at the end, in warp order (head
// dims above 128: one warp a slice).  That is 96 blocks at S = 256 and 12
// heads, against 48 with 64-row tiles, and half the chain of dependent tile
// products per warp.
// - K and V tiles of 64 rows (32 above a head dim of 64) are copied by
//   cp.async, 16 bytes a thread, into a two-stage ring of bf16 tiles in
//   shared memory (rows padded by 16 bytes, so ldmatrix is conflict-free);
//   the next round's copies are in flight while this round's products run.
//   The ring and the Q tile (78.3 KB at head dims 64 and 128, 84.5 KB at
//   256) live in dynamic shared memory above 48 KB, opted in with
//   cudaFuncSetAttribute.
// - S = Q K^T is mma.sync m16n8k16 bf16 -> f32 with both operands from
//   shared memory by ldmatrix.  A product of two bf16 values is exact in
//   f32, so this is the Pallas kernel's widen-then-dot; only the order of
//   the sum differs.
// - The online softmax runs in the accumulator's layout: a thread holds two
//   rows of each 16 x 8 tile, their max and sum reduced over the quad of
//   threads that share a row by shuffles.  Masked scores are -1e30, scores
//   are dot * dh^-0.5, and the output is acc / max(l, 1e-30) rounded once.
//   The exponentials are __expf (ex2.approx of x * log2 e, a few f32 ulps:
//   far inside the bf16 output's rounding; exp(-1e30 - m) is still 0).
// - O += P V keeps P near f32: P is split into P_hi = bf16(P) and P_lo =
//   bf16(P - P_hi), two mma into the same f32 accumulator, about 16 bits of
//   P's mantissa, where rounding P to bf16 alone would lose 2^-9 of each
//   weight; V comes from shared memory by ldmatrix.trans.
// A row's result depends only on its own q and on k, v: no atomics, and the
// tiles a row sees, the warp that takes each and the order of every sum
// depend only on the row's position.
// Where dh is not a multiple of 8 or a pointer is not 16-byte aligned the
// tiles are staged by plain loads instead (the products are the same).
//
// f32 inputs (the smoke configs and the card-vs-CPU checks) keep the CUDA
// core body: the repo's f32 numerics are full-f32 dots with TF32 off, and
// f32 is not on the full-width path.  One block per (q-tile of 64 rows,
// head, batch row), four threads per query row (eight, and 32-row q-tiles,
// at head dim 256), 32-row K/V tiles (16 at 256) widened to f32 in shared
// memory, the products as f32 FMAs.
//
// What bounds it on the H100: at the serving and training shapes (S <= 512,
// dh 64) the bytes (q, k, v, o once: 4*S*H*dh elements) and the work
// (4*H*dh*S^2/2 multiply-adds) both take under a microsecond at the card's
// peaks, so a call is bound by latency: the launch, the dependent chain of
// tile loads and products per block, and how many SMs the grid fills.

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

// --------------------------------------------------------------------------
// f32: CUDA-core body
// --------------------------------------------------------------------------

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

template <int DHMAX>
void launch_f32(const float* q, const float* k, const float* v, float* o, int B, int S,
                int Tk, int H, int KV, int dh, int q_offset, int window, int causal,
                float scale, cudaStream_t stream) {
  constexpr int kBQ = FlashShape<DHMAX>::kBQ;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<float, DHMAX><<<grid, kThreads, 0, stream>>>(
      q, k, v, o, S, Tk, H, KV, dh, q_offset, window, causal, scale);
}

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------

// A bf16 block is kRowWarps x kv_warps() warps: kRowWarps slices of 16
// query rows (the m16n8k16 tile's M side), and for each slice warps that
// take the kv tiles in turn (tile i to warp i % kv warps) and combine their
// softmax states at the end, in warp order.  kv_tile() rows a tile: 64 up
// to a head dim of 64 (two stages of two warps' K and V tiles and the Q
// tile: 78.3 KB, two blocks an SM), 32 above; head dims above 128 take one
// kv warp.  Against 32-row tiles at a head dim of 64 (41.5 KB, four blocks
// an SM by registers) the 64-row tiles ran S = 256 at 9.95 us against 12.66
// and the training shape (8 x 128) at 14.5 against 10.7 (chip_smoke.py's
// flash_tile_choice, H100 80GB HBM3, 700 W): the prefill is taken here.
constexpr int kRowWarps = 2;
template <int DHMAX>
__host__ __device__ constexpr int kv_warps() {
  return DHMAX <= 128 ? 2 : 1;
}
template <int DHMAX>
__host__ __device__ constexpr int kv_tile() {
  return DHMAX <= 64 ? 64 : 32;
}

// A shared-memory row in bf16 elements: the head dim padded by 16 bytes,
// so the 8 rows an ldmatrix reads fall in 8 different 16-byte bank groups.
template <int DHMAX>
__host__ __device__ constexpr int pitch() {
  return DHMAX + 8;
}

// the Q tile and two stages of KW K and V tiles of BK rows
template <int DHMAX, int QW, int KW, int BK>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * pitch<DHMAX>() * (16 * QW + 4 * KW * BK);
}

// Rows first .. first + n - 1 of a [rows, stride] bf16 array into a [n][kPitch]
// tile, columns [0, dh); rows >= limit as zeros.  vec: cp.async, else loads.
template <int DHMAX, int NTHR>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, size_t stride, int first,
                                           int limit, int n, int dh, bool vec) {
  constexpr int kP = pitch<DHMAX>();
  if (vec) {
    const int cpr = dh / 8;  // 16-byte pieces per row
    for (int idx = threadIdx.x; idx < n * cpr; idx += NTHR) {
      const int r = idx / cpr, c = idx % cpr, row = first + r;
      const bool ok = row < limit;
      cp_async16(dst + r * kP + c * 8, src + (ok ? row * stride + c * 8 : 0), ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * DHMAX; idx += NTHR) {
      const int r = idx / DHMAX, d = idx % DHMAX, row = first + r;
      dst[r * kP + d] = (row < limit && d < dh) ? src[row * stride + d] : __float2bfloat16(0.f);
    }
  }
}

template <int DHMAX, int QW, int KW, int BK>
__global__ void __launch_bounds__(32 * QW * KW) flash_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int S, int Tk, int H, int KV, int dh, int q_offset, int window,
    int causal, float scale, int vec) {
  constexpr int kBQ = 16 * QW, kThr = 32 * QW * KW;
  constexpr int kBK = BK, kP = pitch<DHMAX>();
  constexpr int kNT = kBK / 8;     // score tiles (16 x 8) per kv tile
  constexpr int kDT = DHMAX / 8;   // output tiles (16 x 8) per row slice
  constexpr int kStage = 2 * KW * kBK * kP;  // one stage: KW K tiles, then KW V tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][kP]
  bf16* ring = qs + kBQ * kP;                    // [2][2 * KW][kBK][kP]

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wq = warp % QW, wk = warp / QW;  // row slice, kv turn
  const int row0 = tile * kBQ;
  const size_t q_stride = static_cast<size_t>(H) * dh, kv_stride = static_cast<size_t>(KV) * dh;
  const bf16* qb = q + (static_cast<size_t>(b) * S * H + h) * dh;
  const bf16* kb = k + (static_cast<size_t>(b) * Tk * KV + kvh) * dh;
  const bf16* vb = v + (static_cast<size_t>(b) * Tk * KV + kvh) * dh;

  // the kv tiles any row of the block reaches: [k_begin, k_end)
  const int q_lo = row0 + q_offset, q_hi = q_lo + kBQ - 1;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) / kBK * kBK : 0;
  const int k_end = causal ? min(Tk, q_hi + 1) : Tk;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int n_rounds = (n_tiles + KW - 1) / KW;

  // round r's tiles r*KW .. into ring stage st
  auto stage_round = [&](int r, int st) {
    for (int j = 0; j < KW && r * KW + j < n_tiles; ++j) {
      const int k_lo = k_begin + (r * KW + j) * kBK;
      bf16* kd = ring + st * kStage + j * kBK * kP;
      stage_rows<DHMAX, kThr>(kd, kb, kv_stride, k_lo, Tk, kBK, dh, vec);
      stage_rows<DHMAX, kThr>(kd + KW * kBK * kP, vb, kv_stride, k_lo, Tk, kBK, dh, vec);
    }
  };

  if (vec && dh < DHMAX) {  // cp.async never writes the padding columns: zero them once
    const int pad = DHMAX - dh;
    for (int idx = threadIdx.x; idx < (kBQ + 2 * kStage / kP) * pad; idx += kThr)
      qs[(idx / pad) * kP + dh + idx % pad] = __float2bfloat16(0.f);
  }
  stage_rows<DHMAX, kThr>(qs, qb, q_stride, row0, S, kBQ, dh, vec);
  if (n_rounds > 0) stage_round(0, 0);
  cp_async_commit();

  // this thread's two rows of the warp's 16: r and r + 8
  const int wrow = wq * 16, r_in = lane / 4;
  const int wq_lo = q_lo + wrow, wq_hi = wq_lo + 15;
  const int qp[2] = {wq_lo + r_in, wq_lo + r_in + 8};
  const bool warp_live = row0 + wrow < S;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  for (int rd = 0; rd < n_rounds; ++rd) {
    const int st = rd & 1, it = rd * KW + wk;  // this warp's tile of the round
    if (rd + 1 < n_rounds) stage_round(rd + 1, st ^ 1);  // in flight during the products
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: Q and this round have landed
    __syncthreads();

    const int k_lo = k_begin + it * kBK;
    const bool skip = !warp_live || it >= n_tiles || (causal && k_lo > wq_hi) ||
                      (window > 0 && wq_lo - (k_lo + kBK - 1) >= window);
    if (!skip) {
      const bf16* kt = ring + st * kStage + wk * kBK * kP;
      const bf16* vt = kt + KW * kBK * kP;
      // S = Q K^T
      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DHMAX / 16; ++kk) {
        if (kk * 16 >= dh) break;
        uint32_t a[4];
        ldmatrix_x4(a, qs + (wrow + lane % 16) * kP + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bb[4];
          ldmatrix_x4(bb, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * kP + kk * 16 +
                              ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * np], a, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      // masks, scale, and the online softmax of rows r (i < 2) and r + 8; a
      // tile that every row of the warp sees whole takes no mask
      const bool whole = k_lo + kBK <= Tk && (!causal || k_lo + kBK - 1 <= wq_lo) &&
                         (window <= 0 || wq_hi - k_lo < window);
      if (whole) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] *= scale;
      } else {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kpos = k_lo + n * 8 + 2 * (lane % 4) + (i & 1), qpos = qp[i / 2];
            bool allow = kpos < Tk;
            if (causal) allow = allow && kpos <= qpos;
            if (window > 0) allow = allow && (qpos - kpos < window);
            s[n][i] = allow ? s[n][i] * scale : kNegInf;
          }
      }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = __expf(m_r[r] - mx[r]);
        m_r[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = __expf(s[n][i] - mx[i / 2]);
          psum[i / 2] += s[n][i];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l_r[r] = l_r[r] * corr[r] + psum[r];
      }
#pragma unroll
      for (int t = 0; t < kDT; ++t) {
        acc[t][0] *= corr[0];
        acc[t][1] *= corr[0];
        acc[t][2] *= corr[1];
        acc[t][3] *= corr[1];
      }
      // O += P_hi V + P_lo V: two adjacent score tiles are one A operand
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16x2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16x2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          if (dp * 16 >= dh) break;
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * kP +
                                    dp * 16 + (lane / 16) * 8);
          mma_bf16(acc[2 * dp], hi, bb[0], bb[1]);
          mma_bf16(acc[2 * dp], lo, bb[0], bb[1]);
          mma_bf16(acc[2 * dp + 1], hi, bb[2], bb[3]);
          mma_bf16(acc[2 * dp + 1], lo, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage is read: the next round may refill it
  }
  cp_async_wait<0>();  // no copy outlives the block (Q's, where no tile was needed)

  if constexpr (KW > 1) {
    // the kv warps' states through the (now idle) ring, lane-major; the
    // first kv warp of each row slice combines them in warp order
    constexpr int kVals = kDT * 4 + 4;  // acc, then m and l of both rows
    static_assert(KW * QW * kVals * 32 * sizeof(float) <= 2 * kStage * sizeof(bf16),
                  "the combine scratch fits in the ring");
    float* xs = reinterpret_cast<float*>(ring);
    float* mine = xs + static_cast<size_t>(warp) * kVals * 32 + lane;
#pragma unroll
    for (int t = 0; t < kDT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) mine[(t * 4 + i) * 32] = acc[t][i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mine[(kDT * 4 + r) * 32] = m_r[r];
      mine[(kDT * 4 + 2 + r) * 32] = l_r[r];
    }
    __syncthreads();
    if (wk != 0) return;
    float wgt[KW][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mm = kNegInf;
#pragma unroll
      for (int j = 0; j < KW; ++j) mm = fmaxf(mm, xs[((j * QW + wq) * kVals + kDT * 4 + r) * 32 + lane]);
      l_r[r] = 0.f;
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const float* st = xs + static_cast<size_t>(j * QW + wq) * kVals * 32 + lane;
        wgt[j][r] = __expf(st[(kDT * 4 + r) * 32] - mm);
        l_r[r] += st[(kDT * 4 + 2 + r) * 32] * wgt[j][r];
      }
    }
#pragma unroll
    for (int t = 0; t < kDT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < KW; ++j)
          a += xs[((j * QW + wq) * kVals + t * 4 + i) * 32 + lane] * wgt[j][i / 2];
        acc[t][i] = a;
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + wrow + r_in + 8 * r;
    if (row >= S) continue;
    bf16* orow = o + ((static_cast<size_t>(b) * S + row) * H + h) * dh;
    const float denom = fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      const int d = t * 8 + 2 * (lane % 4);
      if (d < dh) orow[d] = __float2bfloat16_rn(acc[t][2 * r] / denom);
      if (d + 1 < dh) orow[d + 1] = __float2bfloat16_rn(acc[t][2 * r + 1] / denom);
    }
  }
}

template <int DHMAX, int QW, int KW, int BK>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S,
                      int Tk, int H, int KV, int dh, int q_offset, int window, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DHMAX, QW, KW, BK>();
  auto kernel = flash_fwd_tc_kernel<DHMAX, QW, KW, BK>;
  if (smem > 48 * 1024) {  // above the default: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const int vec = dh % 8 == 0 && ((addr(q) | addr(k) | addr(v)) % 16) == 0;
  const dim3 grid((S + 16 * QW - 1) / (16 * QW), H, B);
  kernel<<<grid, 32 * QW * KW, smem, stream>>>(q, k, v, o, S, Tk, H, KV, dh, q_offset, window,
                                               causal, scale, vec);
  return cudaGetLastError();
}

// warps = 0: the instance flash_attention_fwd launches; else 1000 * row
// warps + 100 * kv warps + kv tile rows, one of the alternatives timed at a
// head dim up to 64.
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
                   int H, int KV, int dh, int q_offset, int window, int causal, float scale,
                   int dtype, int warps, cudaStream_t stream) {
  if (dtype == 0) {
    if (warps != 0) return cudaErrorInvalidValue;
    const float* qp = static_cast<const float*>(q);
    const float* kp = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    float* op = static_cast<float*>(o);
    if (dh <= 32)
      launch_f32<32>(qp, kp, vp, op, B, S, Tk, H, KV, dh, q_offset, window, causal, scale, stream);
    else if (dh <= 64)
      launch_f32<64>(qp, kp, vp, op, B, S, Tk, H, KV, dh, q_offset, window, causal, scale, stream);
    else if (dh <= 128)
      launch_f32<128>(qp, kp, vp, op, B, S, Tk, H, KV, dh, q_offset, window, causal, scale,
                      stream);
    else if (dh <= 256)
      launch_f32<256>(qp, kp, vp, op, B, S, Tk, H, KV, dh, q_offset, window, causal, scale,
                      stream);
    else
      return cudaErrorInvalidValue;
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
#define REPRO_FLASH_TC(DHM, QW, KW, BK)                                                 \
  return launch_tc<DHM, QW, KW, BK>(qp, kp, vp, op, B, S, Tk, H, KV, dh, q_offset, window, \
                                    causal, scale, stream)
  if (warps != 0) {
    if (dh > 64) return cudaErrorInvalidValue;
    switch (warps) {
      case 2164: REPRO_FLASH_TC(64, 2, 1, 64);
      case 4164: REPRO_FLASH_TC(64, 4, 1, 64);
      case 1264: REPRO_FLASH_TC(64, 1, 2, 64);
      case 2264: REPRO_FLASH_TC(64, 2, 2, 64);
      case 1232: REPRO_FLASH_TC(64, 1, 2, 32);
      case 2232: REPRO_FLASH_TC(64, 2, 2, 32);
      case 4232: REPRO_FLASH_TC(64, 4, 2, 32);
      case 1432: REPRO_FLASH_TC(64, 1, 4, 32);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dh <= 32) REPRO_FLASH_TC(32, kRowWarps, kv_warps<32>(), kv_tile<32>());
  if (dh <= 64) REPRO_FLASH_TC(64, kRowWarps, kv_warps<64>(), kv_tile<64>());
  if (dh <= 128) REPRO_FLASH_TC(128, kRowWarps, kv_warps<128>(), kv_tile<128>());
  if (dh <= 256) REPRO_FLASH_TC(256, kRowWarps, kv_warps<256>(), kv_tile<256>());
#undef REPRO_FLASH_TC
  return cudaErrorInvalidValue;
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
  return launch(q, k, v, o, B, S, T, H, KV, dh, q_offset, window, causal, scale, dtype, 0,
                static_cast<cudaStream_t>(stream));
}

// The same with the bf16 block chosen by the caller, at a head dim up to
// 64: warps = 1000 * row warps + 100 * kv warps + kv tile rows, one of 2164,
// 4164, 1264, 2264 (what flash_attention_fwd launches), 1232, 2232, 4232 and
// 1432.  For timing the choice; the port's forward calls
// flash_attention_fwd.
extern "C" int flash_attention_fwd_warps(const void* q, const void* k, const void* v, void* o,
                                         int B, int S, int T, int H, int KV, int dh,
                                         int q_offset, int window, int causal, float scale,
                                         int dtype, int warps, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || warps <= 0)
    return cudaErrorInvalidValue;
  return launch(q, k, v, o, B, S, T, H, KV, dh, q_offset, window, causal, scale, dtype, warps,
                static_cast<cudaStream_t>(stream));
}
