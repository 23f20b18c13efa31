// Paged (block-table) KV-cache decode attention for Hopper: one query token
// per slot against that slot's pages.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention.  A decode step is a speculative-verify window of
// one token, so this entry point launches the verify kernel
// (paged_verify_attention.cu, where the design and the bound are described)
// with T = 1: blocks over (slot, kv head, split of kPagedSplit positions),
// each gathering its split's K/V rows through the slot's block-table row by
// cp.async and writing a partial softmax state, then the combine kernel over
// each row's splits in ascending order; the G = H / KV query rows of a head
// share every chunk, a length past the slot's capacity is clamped to it, and
// a slot of length 0 gives exact zeros.  Sharing the kernels keeps a T = 1
// verify bitwise a decode step, as the reference's two Pallas kernels are.

#include "paged_attention.cuh"

// q [S,H,dh], k/v pages [n_pages,page_size,KV,dh], block_tables [S,P] int32,
// lengths [S] int32, o [S,H,dh]; all contiguous.  q and o share q_dtype, the
// pages kv_dtype (0 = f32, 1 = bf16): f32/f32, bf16/bf16 and f32 q over bf16
// pages.  work: f32 scratch of work_floats (paged_attention.cuh).  Returns
// cudaGetLastError() after the launches.
extern "C" int paged_decode_attention_fwd(const void* q, const void* k_pages,
                                          const void* v_pages, const void* block_tables,
                                          const void* lengths, void* o, void* work,
                                          long long work_floats, int S, int H, int KV, int dh,
                                          int page_size, int pages_per_slot, float scale,
                                          int q_dtype, int kv_dtype, void* stream) {
  return repro_torch::paged_window_attention(
      q, k_pages, v_pages, static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), o, static_cast<float*>(work), work_floats, S, 1, H, KV,
      dh, page_size, pages_per_slot, scale, q_dtype, kv_dtype,
      static_cast<cudaStream_t>(stream));
}
