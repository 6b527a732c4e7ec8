// K11: the ternary weight matmul of the paper's CNN inference, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ternary_matmul.py::
// ternary_matmul (_ternary_matmul_kernel), the PIM-adapted kernel of
// DESIGN.md §2. Computes
//   y[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]
// with x (M, K) fp32 or bf16 row-major, q (K, N) int8 codes in {-1, 0, +1}
// row-major (the weight's own layout: K rows of N codes), scale (N,) fp32
// and y (M, N) in x's dtype. The sums are fp32; the scale is applied once
// per output element, and the result is rounded to x's dtype once. Any M,
// N, K >= 1: nothing is padded, every kernel masks its ragged M, N and K
// edges itself (AlexNet's K = 9216 and the classifier's N = 1000 are no
// multiples of a tile, the smoke configs' K = 192 and N = 10 smaller than
// one).
//
// Accumulation. A code is a sign, and the PIM engine accumulates by select,
// negate and add. Here each code is widened exactly (a byte permute and a
// subtraction, no int-to-float conversion) and multiplied: x * (+-1) and
// x * 0 are exact, so for finite x the products are the select's. For a
// non-finite x the product behaves as the plain version's fp32 dot does:
// inf or NaN times a 0 code gives NaN, where a select would skip it.
//
// What bounds it on the card depends on M, and so there are two kernels:
//   * M <= 8 (ternary_gemv_kernel): bytes. Each code byte is read once and
//     feeds at most 2 * 8 FLOPs, far below the H100's ridge; at the main
//     path's batch 1 the least time is the codes over 3.35 TB/s (AlexNet
//     fc0, 9216 x 4096: 37.7 MB, 11.3 us). Each thread streams 16-byte
//     loads of 16 codes of one row, four rows in flight, and keeps 16
//     columns x M rows of fp32 sums in registers; a block's 16 row lanes
//     cover 256 columns and are added in lane order through shared memory.
//     K is split across blocks so that N = 4096 (16 column tiles) fills the
//     132 SMs with about four blocks each instead of 16 blocks; the splits'
//     partial sums meet in an fp32 workspace, and the last block of a
//     column tile to arrive adds them in split order (coded::arrive_last),
//     applies the scale and writes y, so the call is one launch and its
//     result does not depend on the order the blocks ran in.
//   * M > 8 (coded_gemm_kernel, csrc/coded_gemm.cuh, shared with K9):
//     operations in fp32, bytes in bf16 at the CNNs' batch 64. bf16 wgmma
//     on the tensor cores, the codes widened exactly to bf16 as the shared
//     operand (N-major) and x the register operand: bf16 x is one bf16
//     product, as the Pallas kernel's dot of x with codes cast to x's
//     dtype is; fp32 x is split into three bf16 planes (hi + mid + lo ==
//     x), three exact products, fp32 accurate. K is split across blocks
//     where the 64 x 256 output tiles alone would leave SMs idle, the
//     splits meeting in the same in-order last-block combine.
// A 2-bit layout of the codes (4x fewer bytes at M <= 8) is later work.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coded_gemm.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

using coded::store_out;

// Code e (0-3) of a word of four int8 codes, biased by xor 0x80808080 to
// c + 128 a byte, as an exact float: a byte permute puts the biased code in
// the low mantissa byte of 2^23 (0x4B0000bb) and subtracting 2^23 + 128
// leaves c.
__device__ __forceinline__ float code_f32(uint32_t biased, int e) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + e)) - 8388736.f;
}

// ---------------------------------------------------------------------------
// M <= 8: weight streaming, split K
// ---------------------------------------------------------------------------

constexpr int kGemvMaxM = 8;
constexpr int kGemvCols = 16;                        // codes a thread loads: 16 bytes
constexpr int kGemvGroups = 16;                      // threads along N
constexpr int kGemvLanes = kThreads / kGemvGroups;   // rows in flight a block: 16
constexpr int kGemvBN = kGemvGroups * kGemvCols;     // 256 columns a block
constexpr int kGemvUnroll = 4;                       // rows a thread has in flight
// the combine's loads in flight: more raise the kernel's registers and so
// lower its blocks an SM (on an H100, 64 ran the M = 1 rows 20-40% slower,
// coded_gemm_bench A/B)
constexpr int kCombineBatch = 8;
static_assert(kGemvBN == kThreads, "one thread per column in the lane sum");

// the 16 codes at q[off .. off + 15] (columns n .. n + 15): one 16-byte
// load where whole and aligned, else bytes with zeros past N
__device__ __forceinline__ uint4 load_codes16(const int8_t* __restrict__ q, long long off, int n,
                                              int N, int vec) {
  if (vec && n + kGemvCols <= N) return __ldg(reinterpret_cast<const uint4*>(q + off));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kGemvCols; ++e)
    if (n + e < N) w[e >> 2] |= (uint32_t)(uint8_t)q[off + e] << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Block (column tile blockIdx.x, split blockIdx.y): thread (lane r, group g)
// sums rows k_lo + r, + 16, ... of the split for columns g * 16 .. + 15 of
// the tile and M (<= MT) rows of x, in ascending k. The 16 lanes' sums are
// then added in lane order, one x row at a time, through shared memory:
// with one split they are y (scaled, in x's dtype), else the split's
// partial sums in ws (splits, M, N), and the last block of the column tile
// to arrive (counters[blockIdx.x]) adds the splits' sums in split order.
template <typename XT, int MT>
__global__ void __launch_bounds__(kThreads)
ternary_gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, XT* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int M, int N, int K,
                    int rows_per_split, int vec) {
  static_assert(kThreads == 256, "coded::arrive_last's barrier counts 256 threads");
  __shared__ __align__(16) float red[kGemvLanes][kGemvBN + 4];
  __shared__ int last_s;
  const int tid = threadIdx.x, g = tid % kGemvGroups, r = tid / kGemvGroups;
  const int nb = blockIdx.x * kGemvBN, n = nb + g * kGemvCols;
  const int split = blockIdx.y, S = gridDim.y;
  const int k_lo = split * rows_per_split, k_hi = min(K, k_lo + rows_per_split);

  float acc[MT][kGemvCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kGemvCols; ++j) acc[m][j] = 0.f;

  for (int k = k_lo + r; k < k_hi; k += kGemvLanes * kGemvUnroll) {
    uint4 c[kGemvUnroll];
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int kk = k + u * kGemvLanes;
      c[u] = kk < k_hi ? load_codes16(q, (long long)kk * N + n, n, N, vec)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int kk = k + u * kGemvLanes;
      if (kk < k_hi) {
        const uint32_t w[4] = {c[u].x ^ 0x80808080u, c[u].y ^ 0x80808080u,
                               c[u].z ^ 0x80808080u, c[u].w ^ 0x80808080u};
        float f[kGemvCols];
#pragma unroll
        for (int j = 0; j < kGemvCols; ++j) f[j] = code_f32(w[j >> 2], j & 3);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < M) {
            const float xv = to_f32(x[(long long)m * K + kk]);
#pragma unroll
            for (int j = 0; j < kGemvCols; ++j) acc[m][j] = fmaf(xv, f[j], acc[m][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {                                   // the same for the whole block
      __syncthreads();                             // the last row's readers are done
#pragma unroll
      for (int j = 0; j < kGemvCols; j += 4)
        *reinterpret_cast<float4*>(&red[r][g * kGemvCols + j]) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2], acc[m][j + 3]);
      __syncthreads();
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kGemvLanes; ++i) s += red[i][tid];
      const int col = nb + tid;
      if (col < N) {
        if (S == 1)
          store_out(out + (long long)m * N + col, s * scale[col]);
        else
          ws[((long long)split * M + m) * N + col] = s;
      }
    }
  }
  if (S == 1 || !coded::arrive_last(counters + blockIdx.x, S, &last_s)) return;
  // the last block of the tile: every split's sums in split order (from L2:
  // other SMs wrote them), kCombineBatch loads in flight, then the scale
  const int col = nb + tid;
  if (col < N) {
    for (int m = 0; m < M; ++m) {
      float v = 0.f;
      for (int s0 = 0; s0 < S; s0 += kCombineBatch) {
        float part[kCombineBatch];
#pragma unroll
        for (int e = 0; e < kCombineBatch; ++e)
          part[e] = s0 + e < S ? __ldcg(ws + ((long long)(s0 + e) * M + m) * N + col) : 0.f;
#pragma unroll
        for (int e = 0; e < kCombineBatch; ++e)
          if (s0 + e < S) v += part[e];
      }
      store_out(out + (long long)m * N + col, v * scale[col]);
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

template <typename XT>
cudaError_t launch(const XT* x, const int8_t* q, const float* scale, XT* out, float* ws,
                   int* counters, int M, int N, int K, int rows_per_split, int splits,
                   cudaStream_t s) {
  if (M > kGemvMaxM)
    return coded::launch<sizeof(XT) == 4 ? 3 : 1, false>(x, q, scale, out, ws, counters, M, N, K,
                                                         splits, s);
  if (rows_per_split <= 0) return cudaErrorInvalidValue;
  const int S = (K + rows_per_split - 1) / rows_per_split;
  if (S > 1 && (ws == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  const int vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid((N + kGemvBN - 1) / kGemvBN, S);
  if (M == 1)
    ternary_gemv_kernel<XT, 1><<<grid, kThreads, 0, s>>>(x, q, scale, out, ws, counters, M, N,
                                                         K, rows_per_split, vec);
  else if (M == 2)
    ternary_gemv_kernel<XT, 2><<<grid, kThreads, 0, s>>>(x, q, scale, out, ws, counters, M, N,
                                                         K, rows_per_split, vec);
  else if (M <= 4)
    ternary_gemv_kernel<XT, 4><<<grid, kThreads, 0, s>>>(x, q, scale, out, ws, counters, M, N,
                                                         K, rows_per_split, vec);
  else
    ternary_gemv_kernel<XT, 8><<<grid, kThreads, 0, s>>>(x, q, scale, out, ws, counters, M, N,
                                                         K, rows_per_split, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point of K11. x (M, K) contiguous, bf16 when x_bf16 is 1,
// else fp32; q (K, N) int8 contiguous; scale (N,) fp32; out (M, N)
// contiguous in x's dtype; M, N, K >= 1. M <= 8 (the streaming kernel): K
// is split into ceil(K / rows_per_split) parts; with more than one, ws is
// an fp32 workspace of (splits, M, N) and counters one int per 256-column
// tile. M > 8 (the tensor-core kernel): `splits` (1 .. ceil(K / 64)) parts
// of 64-row stages; with more than one, ws holds splits x tiles x 16384
// fp32 and counters one int per 64 x 256 output tile. Counters are zero on
// entry and left zero. One launch; returns its CUDA error (0 on success).
extern "C" int ternary_matmul_launch(const void* x, const void* q, const void* scale, void* out,
                                     void* ws, void* counters, int M, int N, int K,
                                     int rows_per_split, int splits, int x_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  if (x_bf16)
    return static_cast<int>(launch(static_cast<const __nv_bfloat16*>(x), qc, sc,
                                   static_cast<__nv_bfloat16*>(out), w, c, M, N, K,
                                   rows_per_split, splits, s));
  return static_cast<int>(launch(static_cast<const float*>(x), qc, sc, static_cast<float*>(out),
                                 w, c, M, N, K, rows_per_split, splits, s));
}
