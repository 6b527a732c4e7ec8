// K1: decode attention over the serve engine's slot-major KV cache, on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention (_decode_kernel). The kernel body, what bounds it on the
// card and what its design does about that are in decode_attention.cuh,
// which K2 shares; here K/V row i of slot b is read at
// k + b * kv_stride_b + i * kv_stride_s, in place.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include "decode_attention.cuh"

// Plain C entry point. q (B, H, D) and out (B, H, D) contiguous; k/v
// (B, Sk, Hkv, D) with unit stride on D and stride D on Hkv, their batch and
// position strides given in elements; lengths (B,) int32. Returns the CUDA
// error of the launch (0 on success); the ctypes wrapper raises on non-zero.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int H,
                                       int Hkv, int D, int Sk, long long kv_stride_b,
                                       long long kv_stride_s, int window, float scale,
                                       int q_bf16, int kv_bf16, void* stream) {
  const DenseRows rows{kv_stride_b, kv_stride_s, Sk};
  return static_cast<int>(dispatch_decode(D, q_bf16, kv_bf16, q, k, v, lengths, out, B, H,
                                          Hkv, rows, window, scale,
                                          static_cast<cudaStream_t>(stream)));
}
