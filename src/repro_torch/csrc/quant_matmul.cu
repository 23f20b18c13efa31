// Fused LUT-dequant matmul for quantized weight leaves on Hopper:
//   out[M, N] = x[M, K] @ dequant(codes)[K, N] + xu[M, r] @ qv[N, r]^T
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul.
// There, a (M/bm, N/bn) grid keeps the whole padded K resident per tile,
// unpacks a [Kw, bn] code tile with cpw shift-and-mask ops and dequantizes
// by a select-sum over the LUT entries (Mosaic has no dynamic gather).
// The packed b-bit codes are the only weight-sized operand read (b / 32 of
// an f32 weight's bytes); the dense weight never reaches device memory.
// The epilogue adds the temporal-factor delta xu @ qv^T (r <= 256, xu =
// x @ (qu * acc) formed by the caller) in f32 and rounds once to x's type.
//
// What bounds it on the H100: the operations at the training forward's
// shapes (M = 1024 rows, K, N in {768, 3072}), not the bytes.  On the CUDA
// cores that is 2 * M * K * N f32 operations at 67 TFLOP/s; the bf16
// instance below does 3 * 2 * M * K * N bf16 operations on the tensor
// cores at 989 TFLOP/s, a bound some 5x lower.  chip_smoke.py computes
// both.
//
// bf16 x (the training forward) runs on the tensor cores: mma.sync
// m16n8k16, bf16 operands, f32 accumulate.  The weight is exact there
// because each scaled-LUT entry W is split once per block into three bf16
// parts, hi = bf16(W), mid = bf16(W - hi), lo = bf16(W - hi - mid), whose
// sum is W exactly (8 + 8 + 8 significant bits cover f32's 24), and x in
// bf16 is exact, so every product x * part is exact in the accumulator.
// A code dequantizes by one 8-byte shared-memory read of its column's
// (hi, mid, lo) entry and three byte permutes a pair of codes; the three
// parts are three mma per fragment.  Tensor-core accumulation truncates
// (it is not round-to-nearest f32), so each K group's products go to a
// zeroed register sum, added to the running sum with an ordinary f32 add.
// One part misses the output's 2-ulp bar by orders of magnitude, two parts
// and a single running sum each miss it at K = 3072
// (tools/kernel_variants.py measures the three on the card;
// tests/test_torch_quant.py shows the one-part miss on the CPU).
//
// The packing is plane-strided: word row i holds dense rows s * Kw + i for
// the cpw = 32 / bits planes s.  The kernel walks K one group of kBK word
// rows at a time: the group's [kBK, BN] code words arrive once (16-byte
// cp.async) and each thread keeps its eight words in registers, unpacking
// them for every plane in turn; plane s of the group covers dense rows
// s * Kw + i0 .. +kBK, contiguous in x, so its [BM, kBK] x tile also
// arrives by 16-byte cp.async, with zeros past K, into a ring of kStages
// groups.  Planes wholly at or past K are neither loaded nor multiplied:
// lut3 pads K = 768 to 1280 (four of ten planes are padding).  That is
// exact only because the pad rows multiply x's zeros, whatever their
// codes.  The B fragments are built in registers from the codes (no
// shared-memory weight tile).  Warps split the block's output into 16 * MT
// x 16 pieces, two warps a piece, one taking each group's even planes and
// the other its odd ones, so that twice the warps hide the latency of the
// lookups and products; their sums meet in a fixed order.  The epilogue's
// xu and qv rows (32 rank columns at a time, the first chunk copied while
// K is walked) give the f32 sum added to the accumulator fragment before
// the one rounding.  default_tile below takes a wide block where its grid
// fits the card's SMs in one wave, a square one where the grid spans
// several (chip_smoke.py's quant_matmul_tile_choice line times the
// blocks).  The result is deterministic: no atomics, one block per output
// tile, and every block shape sums each output in one order.
//
// f32 x (phase 7's f32 runs and the f32 checks) keeps its own CUDA-core
// body: 64 x 64 tiles, eight word rows of every plane a K step, each code
// looked up in its column's f32 LUT, f32 FMAs from shared memory.
//
// Where K is not a multiple of 8, N not of 4, r not of 4, or a pointer not
// 16-byte aligned, that operand's tile is loaded element by element instead.

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxRank = 256;

// ---------------------------------------------------------------------------
// f32 x: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64;  // output tile
constexpr int kBKW = 8;            // packed word rows per K step
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each

template <typename TX, int BITS>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(
    const TX* __restrict__ x, const uint32_t* __restrict__ codes,
    const float* __restrict__ lut, const float* __restrict__ xu,
    const float* __restrict__ qv, TX* __restrict__ out, int M, int K, int Kw, int N,
    int r) {
  constexpr int CPW = 32 / BITS, L = 1 << BITS, CK = CPW * kBKW;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ __align__(16) float xs[CK][kBM + 4];  // +4: transposed stores
  __shared__ __align__(16) float ws[CK][kBN];
  __shared__ float luts[kBN][L + 1];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int idx = tid; idx < kBN * L; idx += kThreads) {
    const int nn = idx / L, j = idx % L, n = n0 + nn;
    luts[nn][j] = n < N ? lut[static_cast<size_t>(n) * L + j] : 0.f;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int i0 = 0; i0 < Kw; i0 += kBKW) {
    // x columns of the step: plane s, word row i0 + ii is dense row
    // k = s * Kw + i0 + ii
    for (int idx = tid; idx < kBM * CK; idx += kThreads) {
      const int mm = idx / CK, c = idx % CK, m = m0 + mm;
      const int k = (c / kBKW) * Kw + i0 + c % kBKW;
      xs[c][mm] = (m < M && k < K) ? to_f32(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    // the code words: every plane unpacked and looked up in its column's LUT
    for (int idx = tid; idx < kBKW * kBN; idx += kThreads) {
      const int ii = idx / kBN, nn = idx % kBN, n = n0 + nn;
      const uint32_t word =
          (n < N && i0 + ii < Kw) ? codes[static_cast<size_t>(i0 + ii) * N + n] : 0u;
#pragma unroll
      for (int s = 0; s < CPW; ++s)
        ws[s * kBKW + ii][nn] = luts[nn][(word >> (BITS * s)) & MASK];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < CK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[c][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[c][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: + xu @ qv^T, one rounding to x's type
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const float* xr = xu + static_cast<size_t>(m) * r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const float* qr = qv + static_cast<size_t>(n) * r;
      float t = 0.f;
      for (int q = 0; q < r; ++q) t = fmaf(xr[q], qr[q], t);
      out[static_cast<size_t>(m) * N + n] = from_f32<TX>(acc[i][j] + t);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 x: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBK = 16;  // packed word rows per group: one k16 step of each plane
constexpr int kStages = 3;  // groups in the cp.async ring
constexpr int kRC = 32;     // epilogue rank columns per chunk
constexpr int kEP = kRC + 4;  // epilogue row pitch (floats)
// The blocks the forward launches, 100 * warps along M + 10 * warps along N
// + m16 tiles per warp (chip_smoke.py's quant_matmul_tile_choice): 64 x 96
// where that grid fits one block per SM (the training forward's 1024 x 768
// outputs: 128 blocks), else 64 x 64 (1024 x 3072: 768 blocks, two an SM).
constexpr int kTileWide = 164, kTile = 144;

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

int default_tile(int M, int N) {
  return ((M + 63) / 64) * ((N + 95) / 96) <= sm_count() ? kTileWide : kTile;
}

// Two warps share each 16 * MT x 16 piece of the block's output, one
// taking a group's even planes and the other its odd ones (half h of the
// block's warps takes planes s = h, h + 2, ...), then its rank columns the
// same way; the halves' sums meet in a fixed order.  Twice the warps hide
// the latency of the lookups and products that one warp's chain exposes.
template <int BITS, int WM, int WN, int MT>
struct Shape {
  static constexpr int CPW = 32 / BITS, L = 1 << BITS;
  static constexpr int BM = WM * 16 * MT, BN = WN * 16, HALF = 32 * WM * WN, THREADS = 2 * HALF;
  static constexpr int CP = BN + 4;  // code tile pitch (words): conflict-free fragment reads
  static constexpr size_t X_BYTES = sizeof(bf16) * CPW * BM * kBK;
  static constexpr size_t STAGE = X_BYTES + sizeof(uint32_t) * kBK * CP;
  static constexpr size_t RING = kStages * STAGE;
  static constexpr size_t EPI = sizeof(float) * (BM + BN) * kEP;
  static constexpr size_t SMEM = RING + EPI + sizeof(uint2) * BN * L;
  static_assert(sizeof(float) * HALF * MT * 8 <= RING, "the halves' exchange fits the ring");
};

// An x tile row is kBK = 16 bf16, two 16-byte chunks; chunk c of row row
// sits at chunk c ^ ((row / 4) % 2), so the 8 rows an ldmatrix reads fall
// in 8 different 16-byte bank groups without padding.
__device__ __forceinline__ int x_chunk(int row, int c) { return (c ^ (row >> 2)) & 1; }

// The LUT entry of column col (of the block) and a code: groups of four
// columns, a code's four entries side by side.
template <int L>
__device__ __forceinline__ int lut_slot(int col, uint32_t code) {
  return ((col >> 2) * L + static_cast<int>(code)) * 4 + (col & 3);
}

// Plane s of the group at word row i0 is live while its first dense row
// s * Kw + i0 is below K.
__device__ __forceinline__ int live_planes(int cpw, int K, int Kw, int i0) {
  return min(cpw, (K - i0 + Kw - 1) / Kw);
}

// The group at word row i0 into a stage: the live planes' x columns
// [CPW][BM][kBK] (swizzled) and the code tile [kBK][CP], one commit group.
// A thread's x chunks are idx = tid, tid + THREADS, ... of the group's
// planes x rows x two 16-byte chunks (2 * BM a power of two, so the index
// splits by shifts), its code chunk the one at tid (kBK * BN / 4 <=
// THREADS).
template <int BITS, int WM, int WN, int MT>
__device__ __forceinline__ void load_group(bf16* xs, uint32_t* cs, const bf16* __restrict__ x,
                                           const uint32_t* __restrict__ codes, int m0, int n0,
                                           int M, int K, int Kw, int N, int i0, bool vec_x,
                                           bool vec_c) {
  using S = Shape<BITS, WM, WN, MT>;
  constexpr int kRowChunks = 2 * S::BM;
  static_assert((kRowChunks & (kRowChunks - 1)) == 0 && kBK * S::BN / 4 <= S::THREADS,
                "copy slots");
  const int np = live_planes(S::CPW, K, Kw, i0);
  for (int idx = threadIdx.x; idx < np * kRowChunks; idx += S::THREADS) {
    const int s = idx / kRowChunks, row = idx % kRowChunks / 2, c = idx % 2;
    const int m = m0 + row, k = s * Kw + i0 + c * 8;
    bf16* dst = xs + (s * S::BM + row) * kBK + x_chunk(row, c) * 8;
    const bf16* src = x + static_cast<size_t>(m) * K + k;
    if (vec_x) {
      const bool ok = m < M && k < K;
      cp_async16(dst, ok ? src : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (m < M && k + e < K) ? src[e] : __float2bfloat16_rn(0.f);
    }
  }
  if (threadIdx.x < kBK * S::BN / 4) {
    const int i = threadIdx.x / (S::BN / 4), c = threadIdx.x % (S::BN / 4) * 4, n = n0 + c;
    const uint32_t* src = codes + static_cast<size_t>(i0 + i) * N + n;
    uint32_t* dst = cs + i * S::CP + c;
    if (vec_c) {
      cp_async16(dst, n < N ? src : codes, n < N);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = n + e < N ? src[e] : 0u;
    }
  }
  cp_async_commit();
}

// Columns c0 .. c0 + kRC - 1 of rows first .. first + rows - 1 of an [*, r]
// f32 array (rows >= limit, columns >= r as zeros) into a [rows][kEP] tile:
// by 16-byte cp.async where vec (r a multiple of 4, an aligned base), else
// by loads.
template <int THREADS>
__device__ __forceinline__ void stage_rank_rows(float* dst, const float* __restrict__ src,
                                                int first, int rows, int limit, int r, int c0,
                                                bool vec) {
  for (int idx = threadIdx.x; idx < rows * (kRC / 4); idx += THREADS) {
    const int i = idx / (kRC / 4), j = (idx % (kRC / 4)) * 4, row = first + i;
    float* d = dst + i * kEP + j;
    if (vec) {
      const bool ok = row < limit && c0 + j < r;
      cp_async16(d, src + (ok ? static_cast<size_t>(row) * r + c0 + j : 0), ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = (row < limit && c0 + j + e < r) ? src[static_cast<size_t>(row) * r + c0 + j + e]
                                               : 0.f;
    }
  }
}

template <int BITS, int WM, int WN, int MT>
__global__ void __launch_bounds__(64 * WM * WN) quant_matmul_tc_kernel(
    const bf16* __restrict__ x, const uint32_t* __restrict__ codes,
    const float* __restrict__ lut, const float* __restrict__ xu,
    const float* __restrict__ qv, bf16* __restrict__ out, int M, int K, int Kw, int N, int r,
    bool vec_x, bool vec_c, bool vec_r) {
  using S = Shape<BITS, WM, WN, MT>;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xe = reinterpret_cast<float*>(smem + S::RING);       // [BM][kEP]: xu's rows
  float* qe = xe + S::BM * kEP;                               // [BN][kEP]: qv's rows
  uint2* luts = reinterpret_cast<uint2*>(smem + S::RING + S::EPI);  // (hi | mid << 16, lo)
  const auto xs_of = [&](int st) { return reinterpret_cast<bf16*>(smem + st * S::STAGE); };
  const auto cs_of = [&](int st) {
    return reinterpret_cast<uint32_t*>(smem + st * S::STAGE + S::X_BYTES);
  };

  const int n0 = blockIdx.x * S::BN, m0 = blockIdx.y * S::BM;
  const int half = threadIdx.x / S::HALF, warp = threadIdx.x % S::HALF / 32, lane = threadIdx.x % 32;
  const int wrow = (warp / WN) * 16 * MT, wcol = (warp % WN) * 16;
  const int g = lane / 4, t = lane % 4;

  // the LUT's loads first (the split waits for them), then the epilogue's
  // first rank chunk and the first kStages - 1 groups in flight: one commit
  // group each (empty past the last), so that the wait below counts groups
  constexpr int kLutPer = S::BN * S::L / S::THREADS;
  float lw[kLutPer];
#pragma unroll
  for (int q = 0; q < kLutPer; ++q) {
    const int idx = threadIdx.x + q * S::THREADS, n = n0 + idx / S::L;
    lw[q] = n < N ? lut[static_cast<size_t>(n) * S::L + idx % S::L] : 0.f;
  }
  stage_rank_rows<S::THREADS>(xe, xu, m0, S::BM, M, r, 0, vec_r);
  stage_rank_rows<S::THREADS>(qe, qv, n0, S::BN, N, r, 0, vec_r);
  cp_async_commit();
  const int ng = (min(Kw, K) + kBK - 1) / kBK;  // groups with a live plane
  for (int gp = 0; gp < kStages - 1; ++gp) {
    if (gp < ng)
      load_group<BITS, WM, WN, MT>(xs_of(gp), cs_of(gp), x, codes, m0, n0, M, K, Kw, N,
                                   gp * kBK, vec_x, vec_c);
    else
      cp_async_commit();
  }

  // the block's columns of the scaled LUT, split into three exact bf16
  // parts below, once the copies are in flight
#pragma unroll
  for (int q = 0; q < kLutPer; ++q) {
    const int idx = threadIdx.x + q * S::THREADS, nn = idx / S::L, j = idx % S::L;
    const float w = lw[q];
    const bf16 hi = __float2bfloat16_rn(w);
    const float r1 = __fsub_rn(w, __bfloat162float(hi));
    const bf16 mid = __float2bfloat16_rn(r1);
    const bf16 lo = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    luts[lut_slot<S::L>(nn, j)] =
        make_uint2(static_cast<uint32_t>(__bfloat16_as_ushort(hi)) |
                       (static_cast<uint32_t>(__bfloat16_as_ushort(mid)) << 16),
                   static_cast<uint32_t>(__bfloat16_as_ushort(lo)));
  }

  float acc[MT][2][4];
#pragma unroll
  for (int mb = 0; mb < MT; ++mb)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0.f;

  // per-thread offsets, fixed for the K walk: the LUT entry of code 0 of
  // its first column (the second's is kLutNb further, a code's entry 4
  // further), its first code word in a stage's code tile (the others at
  // fixed offsets), its first ldmatrix row in a plane's x tile (the others
  // 16 rows apart; every row of the thread has the same swizzle)
  constexpr int kLutNb = 2 * S::L * 4;
  const uint2* lut0 = luts + lut_slot<S::L>(wcol + g, 0);
  const int cw_off = 2 * t * S::CP + wcol + g;
  const int a_off = (wrow + lane % 16) * kBK + x_chunk(lane % 16, lane / 16) * 8;
  for (int gi = 0; gi < ng; ++gi) {
    const int i0 = gi * kBK, st = gi % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // group gi is in; every warp is done with group gi - 1's stage
    const int gn = gi + kStages - 1;
    if (gn < ng)
      load_group<BITS, WM, WN, MT>(xs_of(gn % kStages), cs_of(gn % kStages), x, codes, m0, n0,
                                   M, K, Kw, N, gn * kBK, vec_x, vec_c);
    else
      cp_async_commit();
    // this thread's code words: B fragment rows 2t, 2t + 1, 2t + 8, 2t + 9
    // of its two 8-column blocks, every plane packed in each, shifted to
    // this half's first plane; each plane step shifts them on by two planes
    const uint32_t* cs = cs_of(st) + cw_off;
    uint32_t cw[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cw[nb][j] = cs[((j & 1) + 8 * (j >> 1)) * S::CP + nb * 8] >> (BITS * half);
    float gacc[MT][2][4];
#pragma unroll
    for (int mb = 0; mb < MT; ++mb)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[mb][nb][e] = 0.f;
    const int np = live_planes(S::CPW, K, Kw, i0);
    const bf16* xs = xs_of(st) + half * S::BM * kBK + a_off;
    for (int s = half; s < np; s += 2, xs += 2 * S::BM * kBK) {
      uint32_t bp[3][2][2];  // (hi, mid, lo) x 8-column block x (k rows 2t.., 2t + 8..)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint2 e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          e[j] = lut0[nb * kLutNb + 4 * static_cast<int>(cw[nb][j] & MASK)];
          cw[nb][j] >>= 2 * BITS;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // k rows 2t, 2t + 1 (h = 0) and 2t + 8, 2t + 9
          bp[0][nb][h] = __byte_perm(e[2 * h].x, e[2 * h + 1].x, 0x5410);
          bp[1][nb][h] = __byte_perm(e[2 * h].x, e[2 * h + 1].x, 0x7632);
          bp[2][nb][h] = __byte_perm(e[2 * h].y, e[2 * h + 1].y, 0x5410);
        }
      }
      uint32_t a[MT][4];
#pragma unroll
      for (int mb = 0; mb < MT; ++mb) ldmatrix_x4(a[mb], xs + mb * 16 * kBK);
      // part by part, so that an mma's accumulator was last written 2 * MT
      // products before (the asm statements keep this order)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int mb = 0; mb < MT; ++mb)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) mma_bf16(gacc[mb][nb], a[mb], bp[p][nb][0], bp[p][nb][1]);
    }
#pragma unroll
    for (int mb = 0; mb < MT; ++mb)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mb][nb][e] = __fadd_rn(acc[mb][nb][e], gacc[mb][nb][e]);
  }
  cp_async_wait<0>();

  // epilogue: + xu @ qv^T in f32, xu's and qv's rows kRC columns at a time,
  // half h summing its share of each chunk's columns
  float tsum[MT][2][4];
#pragma unroll
  for (int mb = 0; mb < MT; ++mb)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) tsum[mb][nb][e] = 0.f;
  for (int c0 = 0; c0 < r; c0 += kRC) {
    if (c0 > 0) {
      __syncthreads();  // the previous chunk has been read
      stage_rank_rows<S::THREADS>(xe, xu, m0, S::BM, M, r, c0, vec_r);
      stage_rank_rows<S::THREADS>(qe, qv, n0, S::BN, N, r, c0, vec_r);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const int jn = min(kRC, r - c0), jh = (jn + 1) / 2;
#pragma unroll 4
    for (int j = half * jh; j < (half ? jn : jh); ++j) {
      float xv[MT][2], qw[2][2];
#pragma unroll
      for (int mb = 0; mb < MT; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) xv[mb][h] = xe[(wrow + mb * 16 + g + 8 * h) * kEP + j];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) qw[nb][e] = qe[(wcol + nb * 8 + 2 * t + e) * kEP + j];
#pragma unroll
      for (int mb = 0; mb < MT; ++mb)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tsum[mb][nb][e] = fmaf(xv[mb][e / 2], qw[nb][e % 2], tsum[mb][nb][e]);
    }
  }

  // half 1 hands its sum to half 0 through the ring: out = (acc_0 + tsum_0)
  // + (acc_1 + tsum_1), rounded once
  __syncthreads();  // every warp is done with the ring
  // [value][thread of the half]: a warp's 32 lanes on 32 banks
  float* xch = reinterpret_cast<float*>(smem) + threadIdx.x % S::HALF;
  if (half == 1) {
#pragma unroll
    for (int mb = 0; mb < MT; ++mb)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xch[((mb * 2 + nb) * 4 + e) * S::HALF] = __fadd_rn(acc[mb][nb][e], tsum[mb][nb][e]);
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int mb = 0; mb < MT; ++mb)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mb][nb][e] = __fadd_rn(__fadd_rn(acc[mb][nb][e], tsum[mb][nb][e]),
                                   xch[((mb * 2 + nb) * 4 + e) * S::HALF]);

  // one rounding to bf16; the fragment's (row g or g + 8, columns 2t, 2t + 1)
#pragma unroll
  for (int mb = 0; mb < MT; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wrow + mb * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int n = n0 + wcol + nb * 8 + 2 * t;
        const bf16 v0 = __float2bfloat16_rn(acc[mb][nb][2 * h]);
        const bf16 v1 = __float2bfloat16_rn(acc[mb][nb][2 * h + 1]);
        bf16* o = out + static_cast<size_t>(m) * N + n;
        if (n + 1 < N && N % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(v0, v1);
        } else {
          if (n < N) o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
    }
}

template <int BITS, int WM, int WN, int MT>
cudaError_t launch_tc(const bf16* x, const uint32_t* codes, const float* lut, const float* xu,
                      const float* qv, bf16* out, int M, int K, int Kw, int N, int r,
                      cudaStream_t stream) {
  using S = Shape<BITS, WM, WN, MT>;
  auto kernel = quant_matmul_tc_kernel<BITS, WM, WN, MT>;
  if (S::SMEM > 48 * 1024) {  // above the default: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::SMEM));
    if (err != cudaSuccess) return err;
  }
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec_x = K % 8 == 0 && addr(x) % 16 == 0;
  const bool vec_c = N % 4 == 0 && addr(codes) % 16 == 0;
  const bool vec_r = r % 4 == 0 && ((addr(xu) | addr(qv)) % 16) == 0;
  const dim3 grid((N + S::BN - 1) / S::BN, (M + S::BM - 1) / S::BM);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(x, codes, lut, xu, qv, out, M, K, Kw, N, r,
                                                vec_x, vec_c, vec_r);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_tile(const bf16* x, const uint32_t* codes, const float* lut,
                        const float* xu, const float* qv, bf16* out, int M, int K, int Kw,
                        int N, int r, int tile, cudaStream_t stream) {
#define REPRO_QMM_TC(WM, WN, MT) \
  return launch_tc<BITS, WM, WN, MT>(x, codes, lut, xu, qv, out, M, K, Kw, N, r, stream)
  switch (tile) {
    case 134: REPRO_QMM_TC(1, 3, 4);
    case 144: REPRO_QMM_TC(1, 4, 4);
    case 164: REPRO_QMM_TC(1, 6, 4);
    case 184: REPRO_QMM_TC(1, 8, 4);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_QMM_TC
}

}  // namespace tc

cudaError_t launch(const void* x, const void* codes, const void* lut, const void* xu,
                   const void* qv, void* out, int M, int K, int Kw, int N, int r, int bits,
                   int x_dtype, int tile, cudaStream_t stream) {
  const uint32_t* cc = static_cast<const uint32_t*>(codes);
  const float* ll = static_cast<const float*>(lut);
  const float* uu = static_cast<const float*>(xu);
  const float* vv = static_cast<const float*>(qv);
  if (x_dtype == 1) {
    const bf16* xx = static_cast<const bf16*>(x);
    bf16* oo = static_cast<bf16*>(out);
    const int tl = tile == 0 ? tc::default_tile(M, N) : tile;
    if (bits == 4) return tc::launch_tile<4>(xx, cc, ll, uu, vv, oo, M, K, Kw, N, r, tl, stream);
    return tc::launch_tile<3>(xx, cc, ll, uu, vv, oo, M, K, Kw, N, r, tl, stream);
  }
  if (x_dtype != 0 || tile != 0) return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const float* xx = static_cast<const float*>(x);
  float* oo = static_cast<float*>(out);
  if (bits == 4)
    quant_matmul_kernel<float, 4><<<grid, kThreads, 0, stream>>>(xx, cc, ll, uu, vv, oo, M, K,
                                                                 Kw, N, r);
  else
    quant_matmul_kernel<float, 3><<<grid, kThreads, 0, stream>>>(xx, cc, ll, uu, vv, oo, M, K,
                                                                 Kw, N, r);
  return cudaGetLastError();
}

bool bad_shape(int M, int K, int Kw, int N, int r, int bits) {
  return M <= 0 || N <= 0 || Kw <= 0 || Kw % tc::kBK != 0 || K < 0 || r < 0 ||
         r > kMaxRank || (bits != 3 && bits != 4) || K > (32 / bits) * Kw ||
         (M + kBM - 1) / kBM > 65535;
}

}  // namespace
}  // namespace repro_torch

// x [M, K] (f32 or bf16 by x_dtype 0 / 1), codes uint32 [Kw, N] with Kw a
// multiple of 16 and K <= (32 / bits) * Kw, lut f32 [N, 2^bits], xu f32
// [M, r], qv f32 [N, r], out [M, N] in x's type; all contiguous.  Returns
// cudaGetLastError() after the launch.
extern "C" int quant_matmul_fwd(const void* x, const void* codes, const void* lut,
                                const void* xu, const void* qv, void* out, int M, int K,
                                int Kw, int N, int r, int bits, int x_dtype, void* stream) {
  using namespace repro_torch;
  if (bad_shape(M, K, Kw, N, r, bits)) return cudaErrorInvalidValue;
  return launch(x, codes, lut, xu, qv, out, M, K, Kw, N, r, bits, x_dtype, 0,
                static_cast<cudaStream_t>(stream));
}

// The bf16 kernel with another block, tile = 100 * warps along M + 10 *
// warps along N + m16 tiles per warp: for timing the choice of default_tile.
extern "C" int quant_matmul_fwd_tile(const void* x, const void* codes, const void* lut,
                                     const void* xu, const void* qv, void* out, int M, int K,
                                     int Kw, int N, int r, int bits, int tile, void* stream) {
  using namespace repro_torch;
  if (bad_shape(M, K, Kw, N, r, bits) || tile == 0) return cudaErrorInvalidValue;
  return launch(x, codes, lut, xu, qv, out, M, K, Kw, N, r, bits, 1, tile,
                static_cast<cudaStream_t>(stream));
}
