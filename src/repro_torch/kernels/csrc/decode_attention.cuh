// The fp32 SIMT tile helpers of the decode and prefill attention kernels
// on Hopper (sm_90a): the split SIMT kernel of K1, K2 and K5
// (paged_decode_split.cuh) and K3's SIMT kernel (paged_prefill_attention.cu)
// are built from them.
//
// Their tile body computes what the Pallas TPU kernels of
// repro/kernels/decode_attention.py compute: fp32 accumulation throughout,
// q scaled in fp32 before the dot, online softmax with running max m
// (starting at -1e30), denominator floored at 1e-30, output in q's dtype.
// In the int8-KV mode K/V are int8 codes with one fp32 scale per (row, KV
// head), and each code is dequantized in fp32 registers (code * scale) as
// its tile goes to shared memory, as the Pallas bodies do
// (decode_attention.py:96-110).
//
// A tile is kTileK = 64 keys over kThreads = 256 threads: the rows go to
// shared memory as fp32 (K rows padded to D + 4 floats, so 16-byte reads
// across keys hit distinct banks); warp w scores rows r = w, w + 8, ...
// with each lane taking two keys and runs each row's online-softmax update
// with warp reductions; thread t accumulates P @ V for four columns. One
// block loads each K/V row of a KV head's GQA group once for all of the
// group's query rows. Any head dim that is a multiple of 8 fits this
// layout, masked by length and never padded: a tile's loads are
// ceil(64 * D / vector / 256) a thread with the last ones masked, and
// where D / 4 does not divide 256 (D = 24, 112, 168) the threads past
// the last whole group of D / 4 sit out the P @ V pass.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 64;               // keys per tile: two per lane
constexpr int kMaxRowsPerThread = 8;     // P @ V pass: rows <= 8 * (1024 / D)
constexpr int kMaxRowsPerWarp = (64 + kWarps - 1) / kWarps;   // score pass
constexpr float kNegInf = -1e30f;

// Query rows one block can hold at head dim D: the score pass's 64 and
// the P @ V pass's kMaxRowsPerThread groups of kThreads / (D / 4) threads.
inline int max_rows(int D) {
  const int pv = kMaxRowsPerThread * (kThreads / (D / 4));
  return pv < kWarps * kMaxRowsPerWarp ? pv : kWarps * kMaxRowsPerWarp;
}

template <typename T> struct Vec16;      // 16 bytes of T
template <> struct Vec16<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec16<__nv_bfloat16> { using type = uint4; static constexpr int n = 8; };
template <> struct Vec16<int8_t> { using type = uint4; static constexpr int n = 16; };
struct Vec8Int8 { using type = uint2; static constexpr int n = 8; };

// The vector a thread loads of a K/V row of D values of T: 16 bytes, or 8
// codes for an int8 row whose D is no multiple of 16 (D = 8, 24, 168), so
// no load crosses a row's end. Every head dim the kernels take is a
// multiple of 8, so a bf16 row is a whole number of 16-byte vectors and
// an fp32 one of float4s.
template <typename T, int D>
using RowVec = typename std::conditional<std::is_same<T, int8_t>::value && D % 16 != 0,
                                         Vec8Int8, Vec16<T>>::type;

__device__ __forceinline__ void to_smem(const float4& x, float* dst) {
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void to_smem(const uint4& x, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// 16 (uint4) or 8 (uint2) int8 codes times their row's scale, in fp32
template <typename V>
__device__ __forceinline__ void dequant_to_smem(const V& x, float s, float* dst) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
  for (int i = 0; i < (int)sizeof(V) / 4; ++i)
    reinterpret_cast<float4*>(dst)[i] =
        make_float4((float)c[4 * i] * s, (float)c[4 * i + 1] * s, (float)c[4 * i + 2] * s,
                    (float)c[4 * i + 3] * s);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float p, const float4& v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// K/V storage of a launch: fp32, bf16, or int8 codes with fp32 row scales.
enum KvType { kKvFloat = 0, kKvBf16 = 1, kKvInt8 = 2 };

}  // namespace
