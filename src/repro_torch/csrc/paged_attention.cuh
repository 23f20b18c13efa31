// The paged (block-table) attention kernel that decode and speculative
// verify share.  Its body lives in paged_verify_attention.cu; the decode
// entry point (paged_decode_attention.cu) launches it with a window of one
// token, so a decode step and a T = 1 verify run the same instructions.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// kv positions per split block: a compile-time constant, never derived from
// T, the slot count or any length (kernels/decode_attention.py SPLIT).
constexpr int kPagedSplit = 64;

// q/o [S, T, H, dh] in q_dtype, k/v pages [n_pages, page_size, KV, dh] in
// kv_dtype (0 = f32, 1 = bf16), block_tables [S, P] and lengths [S] int32.
// Window position t of slot s attends kpos < min(lengths[s] + t, P *
// page_size); a slot of length 0 writes zeros.  work: f32 scratch of at
// least S * T * H * ceil(P * page_size / kPagedSplit) * (dh + 2) floats
// for the splits' partials.  Launches the split kernel, then the combine
// kernel.  Returns cudaErrorInvalidValue for what the kernel does not take
// (a head dim above 256, an unknown dtype pair, too small a workspace), else
// cudaGetLastError() after the launches.
cudaError_t paged_window_attention(const void* q, const void* k_pages, const void* v_pages,
                                   const int* block_tables, const int* lengths, void* o,
                                   float* work, long long work_floats, int S, int T, int H,
                                   int KV, int dh, int page_size, int pages_per_slot,
                                   float scale, int q_dtype, int kv_dtype, cudaStream_t stream);

}  // namespace repro_torch
