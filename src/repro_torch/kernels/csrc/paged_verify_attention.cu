// K5: multi-query decode attention through the paged KV pool for the
// speculative verify pass, on Hopper (sm_90a), with fp32, bf16 or int8
// (codes plus per-row fp32 scale pools) pages.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// paged_verify_attention (_paged_verify_kernel): each slot carries T query
// lanes (the pending token and the drafts), already written to the pool at
// positions lengths[b] - T + t, and lane t attends keys k_pos <= q_pos
// (and q_pos - k_pos < window when window > 0) through the page table, the
// lanes' own keys read back from the pool in their storage dtype. The TPU
// kernel flattens T * rep rows into the MXU's M dimension and transposes
// both pools on every call; here the pools are read in place through their
// strides, and a block holds up to `lanes` lanes of one (slot, KV head),
// lane-major rows (t, r), loading each K/V tile once for all of them.
//
// The kernel body is K2's (paged_decode_split.cuh, K2 being T = 1): the
// key range split across the SMs with an in-order combine in the same
// launch, bf16 q over a bf16 or int8 pool at D = 128 on the tensor cores
// (T * rep rows padded to wgmma's M = 64), every other mode on fp32 SIMT
// dots. What bounds it on the card and what the design does about it are
// in that header.
//
// Rows with no valid key (lanes with q_pos < 0 when the length is below T,
// or past the capacity under a window) write zeros, as a dead slot does;
// the Pallas kernel averages V there. The engine never reads such lanes.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include "paged_decode_split.cuh"

// Plain C entry point. q (B, T, H, D) and out (B, T, H, D) contiguous; k/v
// pools (P, page_size, Hkv, D) with unit stride on D and stride D on Hkv,
// their page and row strides given in elements; page_table (B, n_blocks)
// int32 contiguous, every entry below a slot's length a page of the pool;
// lengths (B,) int32, counting the T lanes; kv_type a KvType. With int8
// pools, ks/vs (P, page_size, Hkv) fp32 have the pools' strides / D (else
// they are unused). A block holds `lanes` lanes (lanes * H / Hkv rows: at
// most 64 on the tensor cores, max_rows(D) on SIMT). The split: splits of
// split_len keys (a multiple of 64 and of page_size), n_splits (<= 64) of
// them a block's rows can touch, counted from the first that holds a key
// of theirs (the grid's first dimension); with more than one, ws holds
// B * Hkv * ceil(T / lanes) * n_splits * lanes * (H / Hkv) * (D + 4)
// floats and counters B * Hkv * ceil(T / lanes) ints, zero on entry and
// on return.
// tensor_cores picks the tensor-core kernel (bf16 q over a bf16 or int8
// pool, D = 128; else an error) or the SIMT kernel. Returns the CUDA error
// of the launch (0 on success).
extern "C" int paged_verify_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* page_table,
    const void* lengths, void* out, int B, int T, int H, int Hkv, int D, int n_blocks,
    int page_size, long long pool_stride_page, long long pool_stride_row, int window,
    float scale, int q_bf16, int kv_type, const void* ks, const void* vs, int lanes,
    int split_len, int n_splits, void* ws, void* counters, int tensor_cores, void* stream) {
  if (Hkv < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const SplitParams p = split_params(q, k_pool, v_pool, page_table, lengths, out, T, H, Hkv,
                                     n_blocks, page_size, pool_stride_page, pool_stride_row,
                                     window, scale, ks, vs, lanes, split_len, n_splits, ws,
                                     counters);
  return static_cast<int>(launch_split<PagedRows>(p, B, D, q_bf16, kv_type, tensor_cores,
                                                  static_cast<cudaStream_t>(stream)));
}
