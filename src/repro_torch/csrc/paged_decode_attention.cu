// Paged (block-table) KV-cache decode attention for Hopper: one query token
// per slot against that slot's pages.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention.  A decode step is a speculative-verify window of
// one token, so this entry point launches the verify kernel
// (paged_verify_attention.cu, where the design and the bound are described)
// with T = 1: one CUDA block per (slot, kv head), the slot's kv positions
// gathered through its block-table row in chunks of 32, the G = H / KV query
// rows of the head sharing every chunk, a length past the slot's capacity
// clamped to it, and exact zeros for a slot of length 0.  Sharing the
// kernel keeps a T = 1 verify bitwise a decode step, as the reference's two
// Pallas kernels are.

#include "paged_attention.cuh"

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
  return repro_torch::paged_window_attention(
      q, k_pages, v_pages, static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), o, S, 1, H, KV, dh, page_size, pages_per_slot,
      scale, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream));
}
