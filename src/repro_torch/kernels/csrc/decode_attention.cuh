// Decode attention for the serve engine's dense ticks, on Hopper (sm_90a):
// the kernel body of K1 (decode_attention.cu, a slot-major cache), and the
// tile helpers that K2 and K5 (paged_decode_split.cuh) and K3's SIMT
// kernel share with it. Where K/V row i of slot b lives is the `Rows`
// policy's answer (DenseRows below).
//
// Computes what the Pallas TPU kernel repro/kernels/decode_attention.py::
// _decode_kernel computes: one query token per slot with
// a per-slot length. Slot b attends keys [lo, length) with
// lo = max(0, length - window) when window > 0, else 0; its query sits at
// position length - 1. fp32 accumulation throughout, q scaled in fp32
// before the dot, online softmax with running max m (starting at -1e30),
// denominator floored at 1e-30, output in q's dtype. A dead slot
// (length 0) writes exact zeros. In the int8-KV mode (KVT = int8_t) K/V
// are int8 codes with one fp32 scale per (row, KV head), and each code is
// dequantized in fp32 registers (code * scale) as its tile goes to shared
// memory, as the Pallas body does (decode_attention.py:96-110); the scales
// sit at the K/V row's element offset / D, so one row lookup serves both.
//
// What bounds it on the card: bytes. Each key costs 4 * rep * D FLOPs
// against 2 * D * sizeof(KV) bytes (about 4.5 FLOP per byte for fp32 K/V at
// rep = 9), far below the H100's ~295 FLOP/byte ridge, so the least time is
// the live K/V rows over 3.35 TB/s. What the design does about it:
//   * it reads only live rows: keys past a slot's length, outside its
//     window, and every key of a dead slot move no bytes and do no work;
//   * one block per (slot, KV head) loads each K/V row of its group once
//     and serves all `rep` query heads of the group from shared memory, so
//     GQA costs one read of the cache, not rep reads;
//   * it reads the cache in place through its strides with coalesced
//     16-byte loads; the TPU wrapper's transpose to (B, Hkv, Sk, D), which
//     would copy the whole cache on every call, is not carried over.
//   * the next tile's K/V rows are loaded into registers while the current
//     tile computes, so the loads are in flight behind the math.
// Known weak points, left for a later revision (ROADMAP item 16): B * Hkv
// blocks (32 on the starcoder2-7b main path) leave most of the 132 SMs
// idle, so one SM walks a whole long slot alone; and the dot products run
// on fp32 CUDA cores. K2 and K5 carry the split and the tensor-core route
// that answer both (paged_decode_split.cuh).
//
// Per tile of kTileK = 64 keys: (0) the prefetched rows go to shared memory
// as fp32 (K rows padded to D + 4 floats, so 16-byte reads across keys hit
// distinct banks); (1) warp w scores rows r = w, w + 8, ... with each lane
// taking two keys, then runs that row's online-softmax update with warp
// reductions; (2) thread t accumulates P @ V for four columns and rows
// r = t / (D/4) + G*i.

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

// 16 int8 codes times their row's scale, in fp32
__device__ __forceinline__ void dequant_to_smem(const uint4& x, float s, float* dst) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i)
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

// Where K/V row i of slot b starts, in elements from the base pointer:
// base(b) once per block, plus row(b, i) per row (the KV head's column
// offset is added by the kernel). `limit` caps a length at the rows that
// exist, so no length can read past the cache.

// K1: a slot-major cache (B, Sk, Hkv, D) read through its strides.
struct DenseRows {
  long long stride_b, stride_s;
  int limit;                                      // Sk
  __device__ __forceinline__ long long base(int b) const {
    return (long long)b * stride_b;
  }
  __device__ __forceinline__ long long row(int, int i) const {
    return (long long)i * stride_s;
  }
};

// `rows` is __grid_constant__: the load loop reads it through a reference,
// and without the qualifier nvcc fetched its fields with per-thread
// constant loads there, which made the fp32-K/V kernel about 27% slower
// on an H100. `ks`/`vs` are read only when KVT is int8_t.
template <typename QT, typename KVT, int D, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
                        const KVT* __restrict__ v, const int* __restrict__ lengths,
                        QT* __restrict__ out, int H, int rep,
                        const __grid_constant__ Rows rows, int window, float scale,
                        const float* __restrict__ ks, const float* __restrict__ vs) {
  constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  constexpr int DQ = D / 4;                       // float4 columns of a row
  constexpr int KS = D + 4;                       // padded K row: conflict-free
  constexpr int G = kThreads / DQ;                // row groups of the P @ V pass
  constexpr int VN = Vec16<KVT>::n;
  constexpr int kVecPerRow = D / VN;
  constexpr int kLoads = kTileK * kVecPerRow / kThreads;   // per thread, K and V each
  static_assert(kThreads % DQ == 0 && (kTileK * kVecPerRow) % kThreads == 0,
                "unsupported head dim");
  using VecT = typename Vec16<KVT>::type;

  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)b * H + (long long)kvh * rep;
  QT* out_g = out + row0 * D;
  const int n_rows = rep;                         // the block's rows: one run of q and out

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // n_rows x D, pre-scaled
  float* k_s = q_s + n_rows * D;                  // kTileK x KS
  float* v_s = k_s + kTileK * KS;                 // kTileK x D
  float* p_s = v_s + kTileK * D;                  // n_rows x kTileK
  float* a_s = p_s + n_rows * kTileK;             // this tile's rescale per row
  float* l_s = a_s + n_rows;                      // running denominator per row

  // keys [lo, length) are the block's
  const int length = min(lengths[b], rows.limit);
  if (length <= 0) {                              // dead slot: exact zeros
    for (int i = tid; i < rep * D; i += kThreads) store(out_g + i, 0.f);
    return;
  }
  const int lo = (window > 0 && length > window) ? length - window : 0;

  const QT* q_g = q + row0 * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_float(q_g[i]) * scale;
  const KVT* k_g = k + rows.base(b) + (long long)kvh * D;
  const KVT* v_g = v + rows.base(b) + (long long)kvh * D;

  // the next tile's K/V rows, held in registers while this tile computes;
  // rows past the length are zero, so p = 0 never meets stale memory
  VecT k_next[kLoads], v_next[kLoads];
  float ks_next[kQuant ? kLoads : 1], vs_next[kQuant ? kLoads : 1];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int j = i / kVecPerRow, c = (i % kVecPerRow) * VN;
      if (t0 + j < length) {
        const long long row = rows.row(b, t0 + j);
        const long long off = row + c;
        k_next[u] = *reinterpret_cast<const VecT*>(k_g + off);
        v_next[u] = *reinterpret_cast<const VecT*>(v_g + off);
        if constexpr (kQuant) {
          const long long s_off = (rows.base(b) + row) / D + kvh;
          ks_next[u] = __ldg(ks + s_off);
          vs_next[u] = __ldg(vs + s_off);
        }
      } else {
        k_next[u] = VecT{};
        v_next[u] = VecT{};
        if constexpr (kQuant) {
          ks_next[u] = 0.f;
          vs_next[u] = 0.f;
        }
      }
    }
  };

  // running max: held by every lane of the warp that owns the row
  float m_run[kMaxRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) m_run[i] = kNegInf;
  for (int r = tid; r < n_rows; r += kThreads) l_s[r] = 0.f;

  const int cq = tid % DQ, grp = tid / DQ;        // P @ V ownership
  float4 acc[kMaxRowsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerThread; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  load_tile(lo);
  for (int t0 = lo; t0 < length; t0 += kTileK) {
    __syncthreads();                              // last tile's readers are done
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int j = i / kVecPerRow, c = (i % kVecPerRow) * VN;
      if constexpr (kQuant) {
        dequant_to_smem(k_next[u], ks_next[u], k_s + j * KS + c);
        dequant_to_smem(v_next[u], vs_next[u], v_s + j * D + c);
      } else {
        to_smem(k_next[u], k_s + j * KS + c);
        to_smem(v_next[u], v_s + j * D + c);
      }
    }
    __syncthreads();
    if (t0 + kTileK < length) load_tile(t0 + kTileK);   // in flight meanwhile

    // (1) scores and the online-softmax update: warp w owns rows
    // r = w, w + 8, ...; lane owns keys lane and lane + 32
    const float4* k0 = reinterpret_cast<const float4*>(k_s + lane * KS);
    const float4* k1 = reinterpret_cast<const float4*>(k_s + (lane + 32) * KS);
    const bool ok0 = t0 + lane < length, ok1 = t0 + lane + 32 < length;
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= n_rows) break;                     // uniform across the warp
      const float4* qr = reinterpret_cast<const float4*>(q_s + r * D);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int dq = 0; dq < DQ; ++dq) {
        const float4 qv = qr[dq];
        s0 = dot4(qv, k0[dq], s0);
        s1 = dot4(qv, k1[dq], s1);
      }
      s0 = ok0 ? s0 : kNegInf;
      s1 = ok1 ? s1 : kNegInf;
      const float m_old = m_run[i];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float p_sum = warp_sum(p0 + p1);
      p_s[r * kTileK + lane] = p0;
      p_s[r * kTileK + lane + 32] = p1;
      m_run[i] = m_new;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + p_sum;
      }
    }
    __syncthreads();

    // (2) acc = acc * alpha + P @ V for this thread's four columns
    const float4* v4 = reinterpret_cast<const float4*>(v_s);
#pragma unroll
    for (int i = 0; i < kMaxRowsPerThread; ++i) {
      const int r = grp + G * i;
      if (r >= n_rows) break;
      const float alpha = a_s[r];
      float4 a = acc[i];
      a.x *= alpha; a.y *= alpha; a.z *= alpha; a.w *= alpha;
      const float4* pr = reinterpret_cast<const float4*>(p_s + r * kTileK);
#pragma unroll 4
      for (int j4 = 0; j4 < kTileK / 4; ++j4) {
        const float4 p = pr[j4];
        axpy4(p.x, v4[(4 * j4 + 0) * DQ + cq], a);
        axpy4(p.y, v4[(4 * j4 + 1) * DQ + cq], a);
        axpy4(p.z, v4[(4 * j4 + 2) * DQ + cq], a);
        axpy4(p.w, v4[(4 * j4 + 3) * DQ + cq], a);
      }
      acc[i] = a;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kMaxRowsPerThread; ++i) {
    const int r = grp + G * i;
    if (r >= n_rows) break;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    QT* o = out_g + r * D + 4 * cq;
    store(o + 0, acc[i].x * inv);
    store(o + 1, acc[i].y * inv);
    store(o + 2, acc[i].z * inv);
    store(o + 3, acc[i].w * inv);
  }
}

template <typename QT, typename KVT, int D, typename Rows>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* lengths,
                          void* out, int B, int H, int Hkv, Rows rows, int window,
                          float scale, const float* ks, const float* vs,
                          cudaStream_t stream) {
  const int n_rows = H / Hkv;
  const size_t smem = sizeof(float) * ((size_t)n_rows * D + (size_t)kTileK * (D + 4) +
                                       (size_t)kTileK * D + (size_t)n_rows * kTileK +
                                       2 * (size_t)n_rows);
  auto kernel = decode_attention_kernel<QT, KVT, D, Rows>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v),
      static_cast<const int*>(lengths), static_cast<QT*>(out), H, H / Hkv, rows, window,
      scale, ks, vs);
  return cudaGetLastError();
}

// K/V storage of a launch: fp32, bf16, or int8 codes with fp32 row scales.
enum KvType { kKvFloat = 0, kKvBf16 = 1, kKvInt8 = 2 };

// The (q dtype, K/V type, head dim) dispatch of one launch.
template <typename Rows>
cudaError_t dispatch_decode(int D, int q_bf16, int kv_type, const void* q, const void* k,
                            const void* v, const void* lengths, void* out, int B, int H,
                            int Hkv, Rows rows, int window, float scale, const float* ks,
                            const float* vs, cudaStream_t stream) {
#define DECODE_CASE(QT, KVT)                                                              \
  switch (D) {                                                                            \
    case 64: return launch_decode<QT, KVT, 64>(q, k, v, lengths, out, B, H, Hkv, rows,    \
                                               window, scale, ks, vs, stream);            \
    case 128: return launch_decode<QT, KVT, 128>(q, k, v, lengths, out, B, H, Hkv, rows,  \
                                                 window, scale, ks, vs, stream);          \
    case 256: return launch_decode<QT, KVT, 256>(q, k, v, lengths, out, B, H, Hkv, rows,  \
                                                 window, scale, ks, vs, stream);          \
    default: return cudaErrorInvalidValue;                                                \
  }
  if (q_bf16) {
    if (kv_type == kKvBf16) { DECODE_CASE(__nv_bfloat16, __nv_bfloat16) }
    if (kv_type == kKvInt8) { DECODE_CASE(__nv_bfloat16, int8_t) }
    DECODE_CASE(__nv_bfloat16, float)
  }
  if (kv_type == kKvBf16) { DECODE_CASE(float, __nv_bfloat16) }
  if (kv_type == kKvInt8) { DECODE_CASE(float, int8_t) }
  DECODE_CASE(float, float)
#undef DECODE_CASE
}

}  // namespace
