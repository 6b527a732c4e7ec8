// K2: decode attention through the paged KV pool, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention (_paged_kernel): K1's function with each K/V row
// read from the pool. Slot b's logical row i lives in page
// page_table[b, i / page_size] at offset i % page_size; the block reads its
// slot's table row itself, where the TPU kernel had the table in scalar
// prefetch. The TPU wrapper transposes both pools to (P, Hkv, ps, D) on
// every call; here the pools are read in place through their strides.
//
// What bounds it on the card: bytes, as K1 (the live K/V rows over
// 3.35 TB/s; about 4.5 FLOP per byte with fp32 pools at rep = 9). The
// kernel body is K1's (decode_attention.cuh), so K2 inherits its verified
// numerics, its live-rows-only reads (keys past a length, outside the
// window and of a dead slot cost nothing, and table entries past the
// length, which point at the sink page, are never read) and its GQA
// sharing of each loaded row across the rep query heads. It also inherits
// K1's weak point: B * Hkv = 32 blocks on 132 SMs at starcoder2-7b's main
// path, so one SM walks a whole slot alone (ROADMAP queue 1, item 16 takes
// K1 and K2 together).
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include "decode_attention.cuh"

// Plain C entry point. q (B, H, D) and out (B, H, D) contiguous; k/v pools
// (P, page_size, Hkv, D) with unit stride on D and stride D on Hkv, their
// page and row strides given in elements; page_table (B, n_blocks) int32
// contiguous, every entry a page of the pool; lengths (B,) int32. Returns
// the CUDA error of the launch (0 on success).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* page_table,
    const void* lengths, void* out, int B, int H, int Hkv, int D, int n_blocks,
    int page_size, long long pool_stride_page, long long pool_stride_row, int window,
    float scale, int q_bf16, int kv_bf16, void* stream) {
  const PagedRows rows{static_cast<const int*>(page_table), n_blocks, page_size,
                       pool_stride_page, pool_stride_row, n_blocks * page_size};
  return static_cast<int>(dispatch_decode(D, q_bf16, kv_bf16, q, k_pool, v_pool, lengths,
                                          out, B, H, Hkv, rows, window, scale,
                                          static_cast<cudaStream_t>(stream)));
}
