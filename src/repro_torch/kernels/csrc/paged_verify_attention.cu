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
// strides and the body is K1's and K2's (decode_attention.cuh, the
// VerifyRows policy): one block per (slot, KV head, group of up to
// max_rows(D) / rep lanes) loads each K/V tile once for all of its rows.
//
// What bounds it on the card: with T = 5 lanes at rep = 9 a block scores 45
// rows against each K/V row, about 22 FLOP per byte of fp32 K/V, so on
// K2's inputs the byte and the fp32 operations bounds meet (about 0.009
// ms each); the dots run on fp32 CUDA cores, as K1's do (M = 45 is no MMA
// shape). It inherits K2's weak point: B * Hkv = 32 blocks on 132 SMs when
// T fits one block, so one SM walks a whole slot (ROADMAP queue 1, item 16).
//
// Rows with no valid key (lanes with q_pos < 0 when the length is below T,
// or past the capacity under a window) write zeros, as a dead slot does;
// the Pallas kernel averages V there. The engine never reads such lanes.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include "decode_attention.cuh"

// Plain C entry point. q (B, T, H, D) and out (B, T, H, D) contiguous; k/v
// pools (P, page_size, Hkv, D) with unit stride on D and stride D on Hkv,
// their page and row strides given in elements; page_table (B, n_blocks)
// int32 contiguous, every entry a page of the pool; lengths (B,) int32,
// counting the T lanes; kv_type a KvType. With int8 pools, ks/vs
// (P, page_size, Hkv) fp32 have the pools' strides / D (else they are
// unused). Returns the CUDA error of the launch (0 on success).
extern "C" int paged_verify_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* page_table,
    const void* lengths, void* out, int B, int T, int H, int Hkv, int D, int n_blocks,
    int page_size, long long pool_stride_page, long long pool_stride_row, int window,
    float scale, int q_bf16, int kv_type, const void* ks, const void* vs, void* stream) {
  if ((D != 64 && D != 128 && D != 256) || T < 1 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = max_rows(D) / (H / Hkv);
  if (lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  VerifyRows rows;
  rows.page_table = static_cast<const int*>(page_table);
  rows.n_blocks = n_blocks;
  rows.page_size = page_size;
  rows.stride_page = pool_stride_page;
  rows.stride_row = pool_stride_row;
  rows.limit = n_blocks * page_size;
  rows.n_q = T;
  rows.lanes = lanes;
  return static_cast<int>(dispatch_decode(
      D, q_bf16, kv_type, q, k_pool, v_pool, lengths, out, B, H, Hkv, rows, window, scale,
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<cudaStream_t>(stream)));
}
