// K2: decode attention through the paged KV pool, on Hopper (sm_90a),
// with fp32, bf16 or int8 (codes plus per-row fp32 scale pools) pages.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention (_paged_kernel): one query token per slot at
// position lengths[b] - 1, attending the slot's keys [lo, length) with
// lo = max(0, length - window) under a window, each K/V row read from the
// pool: slot b's logical row i lives in page page_table[b, i / page_size]
// at offset i % page_size. The block reads its slot's table entries
// itself, where the TPU kernel had the table in scalar prefetch; the TPU
// wrapper transposes both pools to (P, Hkv, ps, D) on every call, and here
// the pools are read in place through their strides.
//
// The kernel body is K5's at T = 1 (paged_decode_split.cuh): the key
// range split across the SMs with an in-order combine in the same launch,
// bf16 q over a bf16 or int8 pool at D = 128 on the tensor cores, every
// other mode on fp32 SIMT dots. What bounds it on the card and what the
// design does about it are in that header.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include "paged_decode_split.cuh"

// Plain C entry point. q (B, H, D) and out (B, H, D) contiguous; k/v pools
// (P, page_size, Hkv, D) with unit stride on D and stride D on Hkv, their
// page and row strides given in elements; page_table (B, n_blocks) int32
// contiguous, every entry below a slot's length a page of the pool;
// lengths (B,) int32; kv_type a KvType. With int8 pools, ks/vs
// (P, page_size, Hkv) fp32 have the pools' strides / D (else they are
// unused). The split: splits of split_len keys (a multiple of 64 and of
// page_size), n_splits (<= 64) of them a block's rows can touch, counted
// from the first that holds a key of theirs (the grid's first
// dimension); with more than one, ws holds B * Hkv * n_splits * rep *
// (D + 4) floats and counters B * Hkv ints, zero on entry and on return. tensor_cores picks the tensor-core
// kernel (bf16 q over a bf16 or int8 pool, D = 128; else an error) or the
// SIMT kernel. Returns the CUDA error of the launch (0 on success).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* page_table,
    const void* lengths, void* out, int B, int H, int Hkv, int D, int n_blocks,
    int page_size, long long pool_stride_page, long long pool_stride_row, int window,
    float scale, int q_bf16, int kv_type, const void* ks, const void* vs, int split_len,
    int n_splits, void* ws, void* counters, int tensor_cores, void* stream) {
  if (Hkv < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const SplitParams p = split_params(q, k_pool, v_pool, page_table, lengths, out, 1, H, Hkv,
                                     n_blocks, page_size, pool_stride_page, pool_stride_row,
                                     window, scale, ks, vs, 1, split_len, n_splits, ws,
                                     counters);
  return static_cast<int>(launch_split<PagedRows>(p, B, D, q_bf16, kv_type, tensor_cores,
                                                  static_cast<cudaStream_t>(stream)));
}
