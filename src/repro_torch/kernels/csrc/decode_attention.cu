// K1: decode attention over the serve engine's slot-major KV cache, on
// Hopper (sm_90a), with fp32, bf16 or int8 (codes plus per-row fp32
// scales) K/V.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention (_decode_kernel): one query token per slot at position
// lengths[b] - 1, attending the slot's keys [lo, length) with
// lo = max(0, length - window) under a window. The TPU wrapper transposes
// the cache to (B, Hkv, Sk, D) on every call; here K/V row i of slot b is
// read in place at k + b * kv_stride_b + i * kv_stride_s.
//
// The kernel body is K2's (paged_decode_split.cuh) with the DenseRows
// policy in place of the page table: the key range split across the SMs
// with an in-order combine in the same launch, bf16 q over a bf16 or int8
// cache at D = 128 on the tensor cores, every other mode on fp32 SIMT
// dots. What bounds it on the card and what the design does about it are
// in that header. Its splits are K2's at page size 1, so K1 on a cache
// equals K2 on a pool that holds the same rows, bit for bit.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include "paged_decode_split.cuh"

// Plain C entry point. q (B, H, D) and out (B, H, D) contiguous; k/v
// (B, Sk, Hkv, D) with unit stride on D and stride D on Hkv, their batch and
// position strides given in elements; lengths (B,) int32; kv_type a
// KvType. With int8 K/V, ks/vs (B, Sk, Hkv) fp32 have K/V's strides / D
// (else they are unused). The split: splits of split_len keys (a multiple
// of 64), n_splits (<= 64) of them a block's rows can touch, counted from
// the first that holds a key of theirs (the grid's first dimension); with
// more than one, ws holds B * Hkv * n_splits * rep * (D + 4) floats and
// counters B * Hkv ints, zero on entry and on return. tensor_cores picks
// the tensor-core kernel (bf16 q over a bf16 or int8 cache, D = 128; else
// an error) or the SIMT kernel. Returns the CUDA error of the launch (0 on
// success); the ctypes wrapper raises on non-zero.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int H,
                                       int Hkv, int D, int Sk, long long kv_stride_b,
                                       long long kv_stride_s, int window, float scale,
                                       int q_bf16, int kv_type, const void* ks,
                                       const void* vs, int split_len, int n_splits, void* ws,
                                       void* counters, int tensor_cores, void* stream) {
  if (Hkv < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const SplitParams p = split_params(q, k, v, nullptr, lengths, out, 1, H, Hkv, Sk, 1,
                                     kv_stride_b, kv_stride_s, window, scale, ks, vs, 1,
                                     split_len, n_splits, ws, counters);
  return static_cast<int>(launch_split<DenseRows>(p, B, D, q_bf16, kv_type, tensor_cores,
                                                  static_cast<cudaStream_t>(stream)));
}
