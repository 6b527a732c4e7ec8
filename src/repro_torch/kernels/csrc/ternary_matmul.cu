// K11: the ternary weight matmul of the paper's CNN inference, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ternary_matmul.py::
// ternary_matmul (_ternary_matmul_kernel), the PIM-adapted kernel of
// DESIGN.md §2. Computes
//   y[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]
// with x (M, K) fp32 or bf16 row-major, q (K, N) int8 codes in {-1, 0, +1}
// row-major (the weight's own layout: K rows of N codes), scale (N,) fp32
// and y (M, N) in x's dtype. bf16 x is widened to fp32 as it loads; the sums
// are fp32; the scale is applied once per output element, and the result is
// rounded to x's dtype once. Any M, N, K >= 1: nothing is padded, every
// kernel masks its ragged M, N and K edges itself (AlexNet's K = 9216 and
// the classifier's N = 1000 are no multiples of a tile, the smoke
// configs' K = 192 and N = 10 smaller than one).
//
// Accumulation. A code is a sign, and the PIM engine accumulates by select,
// negate and add. Here each code is widened exactly to a float (a byte
// permute and a subtraction, no int-to-float conversion) and fed to an
// fp32 FMA: x * (+-1) and x * 0 are exact, so for finite x the sums carry
// the same bits a select-and-add in the same order would. For a non-finite
// x the FMA behaves as the plain version's fp32 dot does: inf or NaN times a
// 0 code gives NaN, where a select would skip it.
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
//     132 SMs with about four blocks each instead of 16 blocks.
//   * M > 8 (ternary_tile_kernel): operations, 2 * M * K * N FLOPs on the
//     fp32 CUDA cores (TF32 tensor cores would change the fp32 numerics, as
//     for K4's fp32 path): 64 x 64 output tiles over 256 threads, each a
//     4 x 4 block, 16-deep K steps with the codes widened into shared
//     memory and the next step's x and codes loaded into registers while
//     this one computes; also split along K where the tiles alone would
//     leave SMs idle (64 tiles at batch 64 and N = 4096).
// The splits' partial sums meet in an fp32 workspace and a third kernel
// (ternary_splits_kernel) adds them in split order, applies the scale and
// writes y, so the result does not depend on the order the blocks ran in.
// A 2-bit layout of the codes (4x fewer bytes at M <= 8) and tensor cores
// are later work.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// one output element from its fp32 value: the only rounding of the result
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
// partial sums in ws (splits, M, N).
template <typename XT, int MT>
__global__ void __launch_bounds__(kThreads)
ternary_gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, XT* __restrict__ out,
                    float* __restrict__ ws, int M, int N, int K, int rows_per_split,
                    int vec) {
  __shared__ __align__(16) float red[kGemvLanes][kGemvBN + 4];
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
}

// ---------------------------------------------------------------------------
// M > 8: fp32 SIMT tiles, split K where the tiles are few
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16;

__device__ __forceinline__ void load4(const float* p, float (&a)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&a)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  a[0] = lo.x; a[1] = lo.y; a[2] = hi.x; a[3] = hi.y;
}

// Block (column tile blockIdx.x, row tile blockIdx.y, split blockIdx.z):
// a 64 x 64 tile of y, or of the split's partial sums, over the split's
// rows of K in 16-deep steps. Per step a thread loads 4 x values (row a_r,
// k a_c .. + 3: one 16- or 8-byte load where whole and aligned) and 4 codes
// (row b_k, columns b_n .. + 3), zeros past M, N and the split's end.
template <typename XT>
__global__ void __launch_bounds__(kThreads)
ternary_tile_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, XT* __restrict__ out,
                    float* __restrict__ ws, int M, int N, int K, int rows_per_split,
                    int xvec, int qvec) {
  __shared__ __align__(16) float a_s[kBK][kBM + 4];   // x tile, k-major
  __shared__ __align__(16) float b_s[kBK][kBN];       // widened codes

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int split = blockIdx.z, S = gridDim.z;
  const int k_lo = split * rows_per_split, k_hi = min(K, k_lo + rows_per_split);
  const int a_r = tid >> 2, a_c = (tid & 3) * 4;
  const int b_k = tid >> 4, b_n = (tid & 15) * 4;

  float a_reg[4];
  uint32_t b_reg;
  auto load = [&](int k0) {
    const int m = m0 + a_r, k = k0 + a_c;
#pragma unroll
    for (int e = 0; e < 4; ++e) a_reg[e] = 0.f;
    if (m < M) {
      const XT* src = x + (long long)m * K + k;
      if (xvec && k + 4 <= k_hi) {
        load4(src, a_reg);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < k_hi) a_reg[e] = to_f32(src[e]);
      }
    }
    const int kq = k0 + b_k, n = n0 + b_n;
    b_reg = 0u;
    if (kq < k_hi) {
      const int8_t* src = q + (long long)kq * N + n;
      if (qvec && n + 4 <= N) {
        b_reg = *reinterpret_cast<const uint32_t*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) b_reg |= (uint32_t)(uint8_t)src[e] << (8 * e);
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();                              // last step's readers are done
#pragma unroll
    for (int e = 0; e < 4; ++e) a_s[a_c + e][a_r] = a_reg[e];
    const uint32_t bw = b_reg ^ 0x80808080u;
    *reinterpret_cast<float4*>(&b_s[b_k][b_n]) =
        make_float4(code_f32(bw, 0), code_f32(bw, 1), code_f32(bw, 2), code_f32(bw, 3));
    __syncthreads();
    if (k0 + kBK < k_hi) load(k0 + kBK);          // in flight meanwhile
    // this step's 16 products summed apart, then added to the running sum:
    // two-level summation keeps the fp32 error near that of a blocked sum
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float av4[4] = {a.x, a.y, a.z, a.w}, bv4[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av4[i], bv4[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) {
        if (S == 1)
          store_out(out + (long long)m * N + n, acc[i][j] * scale[n]);
        else
          ws[((long long)split * M + m) * N + n] = acc[i][j];
      }
    }
}

// ---------------------------------------------------------------------------
// the splits' partial sums, in split order
// ---------------------------------------------------------------------------

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
ternary_splits_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                      OutT* __restrict__ out, int M, int N, int S) {
  const long long mn = (long long)M * N;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int sp = 0; sp < S; ++sp) s += ws[sp * mn + i];
  store_out(out + i, s * scale[i % N]);
}

template <typename XT>
cudaError_t launch(const XT* x, const int8_t* q, const float* scale, XT* out, float* ws, int M,
                   int N, int K, int rows_per_split, cudaStream_t s) {
  const bool gemv = M <= kGemvMaxM;
  if (rows_per_split <= 0 || (!gemv && rows_per_split % kBK)) return cudaErrorInvalidValue;
  const int splits = (K + rows_per_split - 1) / rows_per_split;
  if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  float* part = splits > 1 ? ws : nullptr;
  if (gemv) {
    const int vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
    const dim3 grid((N + kGemvBN - 1) / kGemvBN, splits);
    if (M == 1)
      ternary_gemv_kernel<XT, 1><<<grid, kThreads, 0, s>>>(x, q, scale, out, part, M, N, K,
                                                           rows_per_split, vec);
    else if (M == 2)
      ternary_gemv_kernel<XT, 2><<<grid, kThreads, 0, s>>>(x, q, scale, out, part, M, N, K,
                                                           rows_per_split, vec);
    else if (M <= 4)
      ternary_gemv_kernel<XT, 4><<<grid, kThreads, 0, s>>>(x, q, scale, out, part, M, N, K,
                                                           rows_per_split, vec);
    else
      ternary_gemv_kernel<XT, 8><<<grid, kThreads, 0, s>>>(x, q, scale, out, part, M, N, K,
                                                           rows_per_split, vec);
  } else {
    // 4 x values a load: 16 bytes (fp32) or 8 (bf16), aligned at every k % 4 == 0
    const int xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(XT)) == 0;
    const int qvec = N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
    ternary_tile_kernel<XT><<<grid, kThreads, 0, s>>>(x, q, scale, out, part, M, N, K,
                                                      rows_per_split, xvec, qvec);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  ternary_splits_kernel<XT><<<(unsigned)((mn + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      ws, scale, out, M, N, splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point of K11. x (M, K) contiguous, bf16 when x_bf16 is 1,
// else fp32; q (K, N) int8 contiguous; scale (N,) fp32; out (M, N)
// contiguous in x's dtype; M, N, K >= 1. K is split into ceil(K /
// rows_per_split) parts (rows_per_split a multiple of 16 when M > 8); with
// more than one, ws is an fp32 workspace of (splits, M, N). Returns the
// CUDA error of the launches (0 on success).
extern "C" int ternary_matmul_launch(const void* x, const void* q, const void* scale, void* out,
                                     void* ws, int M, int N, int K, int rows_per_split,
                                     int x_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  if (x_bf16)
    return static_cast<int>(launch(static_cast<const __nv_bfloat16*>(x), qc, sc,
                                   static_cast<__nv_bfloat16*>(out), w, M, N, K,
                                   rows_per_split, s));
  return static_cast<int>(launch(static_cast<const float*>(x), qc, sc,
                                 static_cast<float*>(out), w, M, N, K, rows_per_split, s));
}
