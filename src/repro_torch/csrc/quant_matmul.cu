// Fused LUT-dequant matmul for quantized weight leaves on Hopper:
//   out[M, N] = x[M, K] @ dequant(codes)[K, N] + xu[M, r] @ qv[N, r]^T
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul.
// There, a (M/bm, N/bn) grid keeps the whole padded K resident per tile,
// unpacks a [Kw, bn] code tile with cpw shift-and-mask ops and dequantizes
// by a select-sum over the LUT entries (Mosaic has no dynamic gather).
// Here one CUDA block owns a 64 x 64 output tile and walks K: each step
// stages kBKW = 8 rows of packed uint32 code words (all cpw = 32 / bits
// planes of them, i.e. cpw * 8 dense rows, plane s covering dense rows
// s * Kw + i0 .. +7) and the matching x columns in shared memory, unpacks
// every word and looks each code up in its column's scaled LUT (an indexed
// shared-memory read), then runs the tile's f32 FMAs, each thread owning a
// 4 x 4 block of outputs.  Codes are read once per output-row tile, so the
// weight operand costs b / 32 of an f32 weight's bytes, and the dense
// weight never reaches device memory.  x is read as zero past its K
// columns: the pad rows of the packing (code 0) multiply zeros, as the
// zero padding of repro.kernels.ops gives them.  The epilogue adds the
// temporal-factor delta xu @ qv^T (r <= 256, xu = x @ (qu * acc) formed by
// the caller) to the f32 accumulator and rounds once to x's type.
//
// What bounds it on the H100: at the training forward's shapes (M = 1024
// rows, K, N in {768, 3072}) the 2 * M * K * N operations, against f32
// FMAs on the CUDA cores (67 TFLOP/s), not the bytes (the codes are b / 32
// of f32).  This first version issues f32 FMAs from shared memory; feeding
// the dequantized tile to bf16 wgmma is later work.

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBM = 64, kBN = 64;  // output tile
constexpr int kBKW = 8;            // packed word rows per K step
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxRank = 256;

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

template <typename TX>
cudaError_t launch(const void* x, const void* codes, const void* lut, const void* xu,
                   const void* qv, void* out, int M, int K, int Kw, int N, int r, int bits,
                   cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const TX* xx = static_cast<const TX*>(x);
  const uint32_t* cc = static_cast<const uint32_t*>(codes);
  const float* ll = static_cast<const float*>(lut);
  const float* uu = static_cast<const float*>(xu);
  const float* vv = static_cast<const float*>(qv);
  TX* oo = static_cast<TX*>(out);
  if (bits == 4) {
    quant_matmul_kernel<TX, 4><<<grid, kThreads, 0, stream>>>(xx, cc, ll, uu, vv, oo, M, K,
                                                               Kw, N, r);
  } else if (bits == 3) {
    quant_matmul_kernel<TX, 3><<<grid, kThreads, 0, stream>>>(xx, cc, ll, uu, vv, oo, M, K,
                                                               Kw, N, r);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x [M, K] (f32 or bf16 by x_dtype 0 / 1), codes uint32 [Kw, N] with
// K <= (32 / bits) * Kw, lut f32 [N, 2^bits], xu f32 [M, r], qv f32 [N, r],
// out [M, N] in x's type; all contiguous.  Returns cudaGetLastError() after
// the launch.
extern "C" int quant_matmul_fwd(const void* x, const void* codes, const void* lut,
                                const void* xu, const void* qv, void* out, int M, int K,
                                int Kw, int N, int r, int bits, int x_dtype, void* stream) {
  using namespace repro_torch;
  if (M <= 0 || N <= 0 || Kw <= 0 || K < 0 || r < 0 || r > kMaxRank ||
      (bits != 3 && bits != 4) || K > (32 / bits) * Kw)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch<float>(x, codes, lut, xu, qv, out, M, K, Kw, N, r, bits, st);
  if (x_dtype == 1)
    return launch<__nv_bfloat16>(x, codes, lut, xu, qv, out, M, K, Kw, N, r, bits, st);
  return cudaErrorInvalidValue;
}
