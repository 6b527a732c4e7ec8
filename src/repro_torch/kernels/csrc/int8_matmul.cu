// K4: weight-only int8 matmul for the serving fast path, on Hopper (sm_90a),
// and K9, its backward with respect to x (end of the file).
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py::int8_matmul
// (_int8_matmul_kernel). Computes
//   y[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]
// with x (M, K) fp32 or bf16 row-major, q (K, N) int8 row-major (the
// weight's own layout: K rows of N codes), scale (N,) fp32 and y (M, N) in
// x's dtype, or in fp32 for bf16 x when asked (the training forward keeps
// its output in fp32, as int8_matmul_vjp does, so that the dscale residual
// stays exact). The int8 tile is widened to x's dtype after it loads (int8
// codes are exact in bf16), the products accumulate in fp32, the scale is
// applied once per output element at the end, and the result is cast to
// the output type once. Full-precision weights never exist in device memory.
// Nothing is padded: every kernel masks ragged M, N and K edges itself;
// K must be a multiple of 16 (every starcoder2 K is a multiple of 128).
//
// What bounds it on the card depends on M, and so there are three kernels:
//   * decode, bf16 x, M <= 8 (int8_gemv_kernel): bytes. The weight is read
//     once (1 byte an element) and each byte feeds at most 2 * 8 FLOPs, far
//     below the H100's ~295 FLOP/byte ridge; the least time is the weight
//     bytes over 3.35 TB/s. On fp32 CUDA cores the 8 FMAs and the widening
//     per byte would cost more than the bytes (a first version ran at 5x
//     the bound), so the products run on the tensor cores: mma m16n8k16
//     with x as A (M <= 8 rows, zero-padded to 16) and the weight as B.
//     Each lane streams 16-byte cp.async copies of one weight row, five
//     16-row steps ahead; the codes are widened exactly to bf16 with a byte
//     permute and a subtraction (no int-to-float conversion) into a
//     warp-private shared tile, and ldmatrix.trans hands out the B
//     fragments. K is split across blocks (up to 32 splits) so that the
//     grid is about three blocks per SM where N allows; the partial
//     sums of a column tile meet in an fp32 workspace, and the last block
//     of the tile to finish (an atomic counter, reset by that block) adds
//     them in split order, so the result does not depend on the order in
//     which blocks ran and the call is one launch.
//   * prefill, bf16 x, M > 8 (int8_wgmma_kernel): operations (about 2 * M
//     FLOPs a weight byte: past the ridge from M ~ 150; at a speculative
//     tick's M = 40, bytes). wgmma with the weight as the register operand
//     (widened exactly in registers by the same byte permute, so no wide
//     copy of the weight is ever stored) and x as the shared one, fed by a
//     producer warpgroup's TMA ring (x tiles of BM x 64 bf16 and weight
//     tiles of 64 x 128 codes, 4 stages, mbarriers); BM = 64, 128, 192 or
//     256 rows of x by the wrapper's rule, and K split across blocks (the
//     decode kernel's in-order combine) when the output tiles alone would
//     not cover the SMs. The design note is above the kernel. N % 16 == 0
//     (TMA).
//   * fp32 x, any M (int8_simt_kernel): fp32 CUDA-core FMAs on 64 x 64
//     tiles. TF32 would change the numerics, so the tensor cores are not
//     used; each output sums k in the same order whatever M is (16-row
//     partial sums added in ascending order), so an engine's batched call
//     and a one-row call give the same bits.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTcMaxSplits = 64;  // the wgmma kernel's K splits at most

// ---------------------------------------------------------------------------
// decode: bf16 x, M <= 8, split K, tensor cores
// ---------------------------------------------------------------------------

constexpr int kMaxM = 8;
constexpr int kGemvWarpN = 32;                    // columns a warp owns
constexpr int kGemvWarps = kThreads / 32;
constexpr int kGemvBN = kGemvWarps * kGemvWarpN;  // 256 columns a block
constexpr int kStages = 6;                        // 16-row steps in flight per warp
constexpr int kTileStride = kGemvWarpN + 8;       // padded bf16 row: conflict-free
constexpr int kMaxRowsPerSplit = 1536;            // x slice of 24.7 KB in smem
// dynamic shared memory: the x slice, then each warp's ring of raw code
// steps (16 rows x 32 bytes), then each warp's widened bf16 tile
constexpr size_t kRingBytes = (size_t)kGemvWarps * kStages * 16 * kGemvWarpN;
constexpr size_t kTileBytes = (size_t)kGemvWarps * 16 * kTileStride * 2;
constexpr size_t kXsBytesMax = (size_t)kMaxM * (kMaxRowsPerSplit + 8) * 2;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// one output element from its fp32 value: the only rounding of the result
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_addr;
using hopper::widen4;

// Computes the output tile as mma m16n8k16 with x as A (its M <= 8 rows
// padded to 16 by zero fragments) and the widened weight as B. Each warp
// owns 32 columns and walks every 16-row step of the block's split: lane l
// copies row l / 2, columns (l % 2) * 16 .. + 15 (16 bytes) with cp.async
// into its warp's ring, kStages - 1 steps ahead (asynchronous copies, so
// the warp's few load scoreboards do not cap how many are in flight);
// widens its own 16 codes into a warp-private bf16 tile; and ldmatrix.trans
// hands out the B fragments. No warp shares an output, so the only
// reduction is across splits.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 3)
int8_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, OutT* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ counters, int M, int N, int K,
                 int rows_per_split, int vec) {
  extern __shared__ __align__(16) unsigned char gemv_smem[];
  __shared__ int last_s;
  const int xs = rows_per_split + 8;                 // padded x row: conflict-free
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* ring = gemv_smem + (size_t)kMaxM * xs * 2 +
                  (size_t)warp * kStages * 16 * kGemvWarpN;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(
      gemv_smem + (size_t)kMaxM * xs * 2 + kRingBytes) + warp * 16 * kTileStride;
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(gemv_smem);   // kMaxM x xs

  const int n0 = blockIdx.x * kGemvBN, split = blockIdx.y, S = gridDim.y;
  const int k_lo = split * rows_per_split;
  const int kr = min(K, k_lo + rows_per_split) - k_lo;   // a multiple of 16
  const int steps = kr / 16;

  const int nw = n0 + warp * kGemvWarpN;             // the warp's columns
  const int ln = nw + (lane & 1) * 16;               // this lane's 16 columns
  const int8_t* src = q + (long long)(k_lo + (lane >> 1)) * N + ln;
  const int slot = lane * 16;                        // this lane's bytes of a step
  // step st's 16 codes into ring stage st % kStages: cp.async where the 16
  // bytes are whole and aligned, else plain loads (ragged N); zeros past N
  auto fetch = [&](int st) {
    if (st >= steps) return;
    uint8_t* dst = ring + (st % kStages) * 16 * kGemvWarpN + slot;
    const int8_t* p = src + (long long)st * 16 * N;
    if (vec && ln + 16 <= N) {
      hopper::cp_async16_zfill(smem_addr(dst), p, true);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int e = 0; e < 16; ++e)
        if (ln + e < N) w[e >> 2] |= (uint32_t)(uint8_t)p[e] << (8 * (e & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  };
#pragma unroll
  for (int d = 0; d < kStages - 1; ++d) {
    fetch(d);
    cp_async_commit();
  }
  // the x slice, 8 bf16 at a time, while the first steps are in flight
  for (int i = tid; i < M * (kr / 8); i += kThreads) {
    const int m = i / (kr / 8), j = (i % (kr / 8)) * 8;
    *reinterpret_cast<uint4*>(x_s + m * xs + j) =
        *reinterpret_cast<const uint4*>(x + (long long)m * K + k_lo + j);
  }
  __syncthreads();                                   // x_s is filled

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  uint4* st_dst = reinterpret_cast<uint4*>(tile + (lane >> 1) * kTileStride +
                                           (lane & 1) * 16);
  // ldmatrix x4: matrix lane / 8 of (k 0-7, k 8-15) x (n +0, n +8)
  const int mi = lane >> 3, ri = lane & 7;
  const uint32_t ld_base =
      smem_addr(tile + (ri + 8 * (mi & 1)) * kTileStride + 8 * (mi >> 1));
  const bool a_live = g < M;
  const __nv_bfloat16* xa = x_s + g * xs + 2 * t;

  for (int st = 0; st < steps; ++st) {
    fetch(st + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();                    // step st has landed
    const uint4 c = *reinterpret_cast<const uint4*>(
        ring + (st % kStages) * 16 * kGemvWarpN + slot);
    const uint2 w0 = widen4(c.x), w1 = widen4(c.y), w2 = widen4(c.z), w3 = widen4(c.w);
    st_dst[0] = make_uint4(w0.x, w0.y, w1.x, w1.y);
    st_dst[1] = make_uint4(w2.x, w2.y, w3.x, w3.y);
    __syncwarp();
    uint32_t b[4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(b[2 * h][0]), "=r"(b[2 * h][1]), "=r"(b[2 * h + 1][0]),
            "=r"(b[2 * h + 1][1])
          : "r"(ld_base + h * 16 * 2));
    }
    uint32_t a[4] = {0u, 0u, 0u, 0u};                 // rows 8-15 stay zero
    if (a_live) {
      a[0] = *reinterpret_cast<const uint32_t*>(xa + st * 16);
      a[2] = *reinterpret_cast<const uint32_t*>(xa + st * 16 + 8);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_bf16(acc[i], a, b[i]);
    __syncwarp();                                     // the tile is read
  }
  cp_async_wait<0>();

  // acc[i][0..1]: row m = g, columns nw + 8 i + 2 t + {0, 1}
  if (S == 1) {
    if (a_live) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nw + 8 * i + 2 * t + e;
          if (n < N) store_out(out + (long long)g * N + n, acc[i][e] * scale[n]);
        }
    }
    return;
  }
  // this split's partial sums, then the tile's arrival count
  if (a_live) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nw + 8 * i + 2 * t + e;
        if (n < N) ws[((long long)split * M + g) * N + n] = acc[i][e];
      }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counters + blockIdx.x, 1) == S - 1;
  __syncthreads();
  if (!last_s) return;
  // the last block adds every split's sums in split order (read from L2:
  // other SMs wrote them), applies the scale and resets the counter; four
  // splits' loads of a thread's 8 outputs are in flight together
  __threadfence();
  constexpr int kPer = kMaxM * kGemvBN / kThreads;   // 8 outputs a thread
  const long long stride = (long long)M * N;         // one split's sums
  float sum[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) sum[r] = 0.f;
  for (int sp0 = 0; sp0 < S; sp0 += 4) {
    float v[4][kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = tid + r * kThreads;
      const int m = i / kGemvBN, col = n0 + i % kGemvBN;
      const bool ok = m < M && col < N;
      const float* p = ws + sp0 * stride + (long long)m * N + col;
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u][r] = (ok && sp0 + u < S) ? __ldcg(p + u * stride) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int r = 0; r < kPer; ++r) sum[r] += v[u][r];
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = tid + r * kThreads;
    const int m = i / kGemvBN, col = n0 + i % kGemvBN;
    if (m < M && col < N) store_out(out + (long long)m * N + col, sum[r] * scale[col]);
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

// ---------------------------------------------------------------------------
// prefill: bf16 x, M > 8, wgmma with a TMA ring
// ---------------------------------------------------------------------------
//
// The block computes a 128-column (n) by BM-row (m) tile of y as its
// transpose, y^T = q^T x^T, so that the int8 weight is wgmma's register
// operand A (widened to bf16 in registers, never stored wide) and x, K-major
// as it lies in memory, is the shared operand B with N = BM. Warps 0-7 are
// two consumer warpgroups, each owning 64 of the 128 columns (one m64nBMk16
// per 16-deep k step); warps 8-11 are the producer warpgroup, one thread of
// which keeps TMA loads of x (BM x 64, bf16) and q (64 x 128, int8) in
// flight through a ring of kTcStages stages, each with a "full" mbarrier
// (the TMA bytes) and an "empty" one (the 256 consumer threads'
// arrivals). setmaxnreg hands the producer's registers to the consumers
// (BM = 256 keeps 128 accumulators a thread). TMA zero-fills rows and
// columns past M, N and K, so only the stores are masked.
//
// A's rows may be any permutation of the block's columns (it only permutes
// y^T's rows): warp w of warpgroup c takes its row g as column 64c + 16w +
// 2g and row g + 8 as the column after it, so each of a thread's A
// registers pairs two codes that sit next to each other in q's rows, and
// one 16-bit shared load of a k row gives both. With the 128-byte swizzle
// those loads are free of bank conflicts.
//
// Split K (gridDim.z > 1, small grids): block z sums k tiles [z * kt / S,
// (z + 1) * kt / S), writes its fp32 partial tile to ws, and the last block
// of the tile to arrive (an atomic counter, reset by that block) adds the
// S partials in split order, as the decode kernel does.

constexpr int kTcBN = 128;                 // output columns a block
constexpr int kTcBK = 64;                  // k rows a stage: 128 bytes of bf16 x
constexpr int kTcStages = 4;
constexpr int kTcConsumers = 256;          // two warpgroups
constexpr int kTcThreads = kTcConsumers + 128;  // and the producer warpgroup
constexpr int kTcQBytes = kTcBK * kTcBN;   // one int8 weight tile

template <int BM>
constexpr size_t tc_smem_bytes() {
  return 1024 + (size_t)kTcStages * (BM * kTcBK * 2 + kTcQBytes) + 2 * kTcStages * 8 + 16;
}

template <int BM>
__device__ __forceinline__ void wgmma_x(float (&d)[BM / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (BM == 64) hopper::wgmma_rs_n64<0>(d, a, desc, 1);
  else if constexpr (BM == 128) hopper::wgmma_rs_n128<0>(d, a, desc, 1);
  else if constexpr (BM == 192) hopper::wgmma_rs_n192<0>(d, a, desc, 1);
  else hopper::wgmma_rs_n256<0>(d, a, desc, 1);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int BM, typename OutT>
__global__ void __launch_bounds__(kTcThreads, 1)
int8_wgmma_kernel(__grid_constant__ const CUtensorMap x_map,
                  __grid_constant__ const CUtensorMap q_map, const float* __restrict__ scale,
                  OutT* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                  int M, int N, int k_tiles) {
  constexpr int kXBytes = BM * kTcBK * 2;
  constexpr int R = BM / 2;                        // accumulators a thread
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tc_smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* xs = smem;                        // kTcStages x tiles
  unsigned char* qs = smem + kTcStages * kXBytes;  // kTcStages weight tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + kTcStages * kTcQBytes);
  uint64_t* empty = full + kTcStages;
  int* last_s = reinterpret_cast<int*>(empty + kTcStages);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kTcBN, m0 = blockIdx.y * BM;
  const int S = gridDim.z, split = blockIdx.z;
  const int kt_lo = (int)((long long)split * k_tiles / S);
  const int nt = (int)((long long)(split + 1) * k_tiles / S) - kt_lo;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kTcConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // registers move from the producer warpgroup (which needs few) to the
  // consumers' accumulators: 128 x 40 + 256 x 232 <= 65,536
  if (warp >= kTcConsumers / 32) {                 // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kTcConsumers) {
      for (int i = 0; i < nt; ++i) {
        const int s = i % kTcStages;
        if (i >= kTcStages) hopper::mbar_wait(empty + s, ((i / kTcStages) - 1) & 1);
        hopper::mbar_expect_tx(full + s, kXBytes + kTcQBytes);
        const int k = (kt_lo + i) * kTcBK;
        hopper::tma_load_2d(xs + s * kXBytes, &x_map, full + s, k, m0);
        hopper::tma_load_2d(qs + s * kTcQBytes, &q_map, full + s, n0, k);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

    const int g = lane >> 2, t = lane & 3;
    // this thread's A rows g and g + 8: block columns nc and nc + 1
    const int nc = (warp >> 2) * 64 + (warp & 3) * 16 + 2 * g;
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;

    for (int i = 0; i < nt; ++i) {
      const int s = i % kTcStages;
      hopper::mbar_wait(full + s, (i / kTcStages) & 1);
      const unsigned char* qt = qs + s * kTcQBytes;
      // k rows 16j + 2t + {0, 1, 8, 9} at columns nc, nc + 1 (one 16-bit load
      // each), interleaved to (k, k + 1) pairs per column and widened exactly
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * j + 2 * t + (e & 1) + 8 * (e >> 1);
          w[e] = *reinterpret_cast<const uint16_t*>(qt + hopper::sw128(r, nc >> 4) + (nc & 15));
        }
        const uint2 lo = widen4(__byte_perm(w[0], w[1], 0x5140));
        const uint2 hi = widen4(__byte_perm(w[2], w[3], 0x5140));
        a[j][0] = lo.x;
        a[j][1] = lo.y;
        a[j][2] = hi.x;
        a[j][3] = hi.y;
      }
      const unsigned char* xt = xs + s * kXBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_x<BM>(acc, a[j], hopper::sw128_desc(xt + 32 * j, 16, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(empty + s);
    }

    // acc[4j + e]: column nc + e / 2, row m0 + 8j + 2t + e % 2
    const int n = n0 + nc;
    if (S == 1) {
      if (n < N) {
        const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const int m = m0 + 8 * j + 2 * t;
          if (m < M) store_pair(out + (long long)m * N + n, acc[4 * j] * s0, acc[4 * j + 2] * s1);
          if (m + 1 < M)
            store_pair(out + (long long)(m + 1) * N + n, acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);
        }
      }
      return;
    }
    // this split's partial tile, then the tile's arrival count (consumers
    // only: named barrier 1 over the 256 consumer threads)
    if (n < N) {
      float* wp = ws + (long long)split * M * N + n;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int m = m0 + 8 * j + 2 * t;
        if (m < M) store_pair(wp + (long long)m * N, acc[4 * j], acc[4 * j + 2]);
        if (m + 1 < M) store_pair(wp + (long long)(m + 1) * N, acc[4 * j + 1], acc[4 * j + 3]);
      }
    }
    __threadfence();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kTcConsumers) : "memory");
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) *last_s = atomicAdd(counters + tile, 1) == S - 1;
    asm volatile("bar.sync 1, %0;\n" ::"n"(kTcConsumers) : "memory");
    if (!*last_s) return;
    __threadfence();
    // the last block adds the splits' partials in split order (from L2: other
    // SMs wrote them), applies the scale and resets the counter
    if (n < N) {
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = 0.f;
      for (int sp = 0; sp < S; ++sp) {
        const float* wp = ws + (long long)sp * M * N + n;
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const int m = m0 + 8 * j + 2 * t;
          if (m < M) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(wp + (long long)m * N));
            acc[4 * j] += v.x;
            acc[4 * j + 2] += v.y;
          }
          if (m + 1 < M) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(wp + (long long)(m + 1) * N));
            acc[4 * j + 1] += v.x;
            acc[4 * j + 3] += v.y;
          }
        }
      }
      const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int m = m0 + 8 * j + 2 * t;
        if (m < M) store_pair(out + (long long)m * N + n, acc[4 * j] * s0, acc[4 * j + 2] * s1);
        if (m + 1 < M)
          store_pair(out + (long long)(m + 1) * N + n, acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);
      }
    }
    if (tid == 0) counters[tile] = 0;
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query so that the library needs no -lcuda; null if missing.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 2D row-major tensor (rows x cols elements of `bytes` each, rows
// `row_bytes` apart) as TMA boxes of box_rows x box_cols with the 128-byte
// swizzle; out-of-bounds elements read as zeros.
bool encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, uint64_t rows,
               uint64_t cols, uint64_t row_bytes, uint32_t box_rows, uint32_t box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, typename OutT>
cudaError_t launch_wgmma(const void* x, const void* q, const void* scale, void* out, void* ws,
                         void* counters, int M, int N, int K, int splits, cudaStream_t s) {
  CUtensorMap x_map, q_map;
  if (!encode_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, K, (uint64_t)K * 2, BM, kTcBK) ||
      !encode_2d(&q_map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, N, N, kTcBK, kTcBN))
    return cudaErrorInvalidValue;
  static const cudaError_t smem_set =
      cudaFuncSetAttribute(int8_wgmma_kernel<BM, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc_smem_bytes<BM>());
  if (smem_set != cudaSuccess) return smem_set;
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + BM - 1) / BM, splits);
  int8_wgmma_kernel<BM, OutT><<<grid, kTcThreads, tc_smem_bytes<BM>(), s>>>(
      x_map, q_map, static_cast<const float*>(scale), static_cast<OutT*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), M, N, (K + kTcBK - 1) / kTcBK);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 x, any M: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kSBM = 64, kSBN = 64, kSBK = 16;

__global__ void __launch_bounds__(kThreads)
int8_simt_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ out, int M, int N,
                 int K, int vec) {
  __shared__ __align__(16) float a_s[kSBK][kSBM + 4];   // x tile, k-major
  __shared__ __align__(16) float b_s[kSBK][kSBN];       // widened weight tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;
  const int a_r = tid >> 2, a_c = (tid & 3) * 4;        // x: one float4 a thread
  const int b_k = tid >> 4, b_n = (tid & 15) * 4;       // weight: 4 codes a thread

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSBK) {
    const int m = m0 + a_r;
    const float4 av = m < M
        ? *reinterpret_cast<const float4*>(x + (long long)m * K + k0 + a_c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    const int n = n0 + b_n;
    const int8_t* src = q + (long long)(k0 + b_k) * N + n;
    uint32_t c = 0u;                              // 4 codes, packed
    if (vec && n + 4 <= N) {
      c = *reinterpret_cast<const uint32_t*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) c |= (uint32_t)(uint8_t)src[e] << (8 * e);
    }
    __syncthreads();                              // last tile's readers are done
    a_s[a_c + 0][a_r] = av.x;
    a_s[a_c + 1][a_r] = av.y;
    a_s[a_c + 2][a_r] = av.z;
    a_s[a_c + 3][a_r] = av.w;
    *reinterpret_cast<float4*>(&b_s[b_k][b_n]) =
        make_float4((float)(int8_t)c, (float)(int8_t)(c >> 8), (float)(int8_t)(c >> 16),
                    (float)(int8_t)(c >> 24));
    __syncthreads();
    // this tile's 16 products summed apart, then added to the running sum:
    // two-level summation keeps the fp32 error near that of a blocked sum
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int k = 0; k < kSBK; ++k) {
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
      if (m < M && n < N) out[(long long)m * N + n] = acc[i][j] * scale[n];
    }
}

template <typename OutT>
cudaError_t launch_bf16(const void* x, const void* q, const void* scale, void* out, void* ws,
                        void* counters, int M, int N, int K, int rows_per_split, int splits,
                        int tile_m, cudaStream_t s) {
  if (M <= kMaxM) {
    if (rows_per_split <= 0 || rows_per_split % 16 || rows_per_split > kMaxRowsPerSplit)
      return cudaErrorInvalidValue;
    const int splits = (K + rows_per_split - 1) / rows_per_split;
    const size_t smem = (size_t)kMaxM * (rows_per_split + 8) * 2 + kRingBytes + kTileBytes;
    // allow the largest split's shared memory, once per process and output type
    static const cudaError_t smem_set = cudaFuncSetAttribute(
        int8_gemv_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kXsBytesMax + kRingBytes + kTileBytes));
    if (smem_set != cudaSuccess) return smem_set;
    const dim3 grid((N + kGemvBN - 1) / kGemvBN, splits);
    int8_gemv_kernel<OutT><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<OutT*>(out),
        static_cast<float*>(ws), static_cast<int*>(counters), M, N, K, rows_per_split,
        N % 16 == 0);
    return cudaGetLastError();
  }
  if (N % 16 != 0 || splits < 1 || splits > kTcMaxSplits || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  switch (tile_m) {
    case 64: return launch_wgmma<64, OutT>(x, q, scale, out, ws, counters, M, N, K, splits, s);
    case 128: return launch_wgmma<128, OutT>(x, q, scale, out, ws, counters, M, N, K, splits, s);
    case 192: return launch_wgmma<192, OutT>(x, q, scale, out, ws, counters, M, N, K, splits, s);
    case 256: return launch_wgmma<256, OutT>(x, q, scale, out, ws, counters, M, N, K, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K9: the backward with respect to x, fp32 dy, CUDA-core FMAs
// ---------------------------------------------------------------------------
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py::int8_matmul_dx
// (_int8_bwd_dx_kernel), the backward of int8_matmul_vjp. Computes
//   dx[m, k] = sum_n (dy[m, n] * scale[n]) * q[k, n]
// with dy (M, N) fp32 row-major (the caller casts the cotangent to fp32, as
// _int8_vjp_bwd does), q (K, N) int8 in the forward's own layout (a dx
// tile's weight rows are contiguous along the contraction axis N), scale
// (N,) fp32, and dx (M, K) in x's dtype (fp32 or bf16), accumulated in fp32.
//
// What bounds it on the card: operations. 2 * M * N * K FLOPs against
// 4 * M * N + K * N bytes read: at M = 4096 training tokens that is
// hundreds of FLOPs a byte, above the H100's ridge, so the least time is
// the FLOPs over the fp32 peak. The operand is fp32, and the tensor cores
// take fp32 only as TF32, which the reference's fp32 dot does not round to;
// so the products run on fp32 CUDA cores, in int8_simt_kernel's shape:
// 64 x 64 dx tiles over 256 threads, each a 4 x 4 block, 16-wide steps
// along N. The scale is folded into the dy tile as it loads (the reference
// folds it into the cotangent in-register), the int8 codes are widened to
// fp32 into shared memory, both tiles are stored N-major so each thread's
// four rows (and four columns) are one 16-byte read, and the next step's
// tiles are loaded into registers while this one computes. Every edge is
// masked by length, so no shape needs padding. Tensor cores (a 3xTF32
// split that keeps fp32 accuracy) and a deeper load pipeline are later
// speed work.

constexpr int kDxBM = 64, kDxBK = 64, kDxBN = 16, kDxPad = 4;

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_dx_kernel(const float* __restrict__ dy, const int8_t* __restrict__ q,
               const float* __restrict__ scale, OutT* __restrict__ dx, int M, int N, int K,
               int vec) {
  __shared__ __align__(16) float a_s[kDxBN][kDxBM + kDxPad];   // dy * scale, n-major
  __shared__ __align__(16) float b_s[kDxBN][kDxBK + kDxPad];   // widened codes, n-major

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kDxBM, k0 = blockIdx.x * kDxBK;
  const int r = tid >> 2, c = (tid & 3) * 4;   // a tile row (m or k) and 4 n of it

  float4 a_reg;                                 // dy[m0 + r][n0 + c .. + 3] * scale
  uint32_t b_reg;                               // q[k0 + r][n0 + c .. + 3], packed
  auto load = [&](int n0) {
    const int n = n0 + c, m = m0 + r, k = k0 + r;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < M) {
      const float* src = dy + (long long)m * N + n;
      if (vec && n + 4 <= N) {
        const float4 u = *reinterpret_cast<const float4*>(src);
        a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) a[e] = src[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N) a[e] *= scale[n + e];
    a_reg = make_float4(a[0], a[1], a[2], a[3]);
    b_reg = 0u;
    if (k < K) {
      const int8_t* src = q + (long long)k * N + n;
      if (vec && n + 4 <= N) {
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

  load(0);
  for (int n0 = 0; n0 < N; n0 += kDxBN) {
    __syncthreads();                            // last step's readers are done
    a_s[c + 0][r] = a_reg.x;
    a_s[c + 1][r] = a_reg.y;
    a_s[c + 2][r] = a_reg.z;
    a_s[c + 3][r] = a_reg.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) b_s[c + e][r] = (float)(int8_t)(b_reg >> (8 * e));
    __syncthreads();
    if (n0 + kDxBN < N) load(n0 + kDxBN);       // in flight meanwhile
    // this step's 16 products summed apart, then added to the running sum,
    // as int8_simt_kernel does
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int n = 0; n < kDxBN; ++n) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[n][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[n][tx * 4]);
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
      const int m = m0 + ty * 4 + i, k = k0 + tx * 4 + j;
      if (m < M && k < K) store_out(dx + (long long)m * K + k, acc[i][j]);
    }
}

}  // namespace

// Plain C entry point of K4. x (M, K) contiguous in x's dtype (x_bf16: bf16,
// else fp32), 16-byte aligned; out (M, N) contiguous, fp32 when out_f32 is 1
// (required for fp32 x), else bf16; q (K, N) int8 contiguous, 16-byte
// aligned; scale (N,) fp32; K % 16 == 0. The bf16 decode kernel (M <= 8)
// splits K into gridDim.y = ceil(K / rows_per_split) blocks per 256-column
// tile and needs ws (splits, M, N) fp32 and counters (one int per column
// tile, zero on entry and left zero) when there is more than one split. The
// bf16 wgmma kernel (M > 8) needs N % 16 == 0 (TMA's 16-byte row stride),
// takes tile_m (64, 128, 192 or 256 rows of x a block) and splits (1-64; K
// tiles of 64 shared out evenly), and with splits > 1 needs ws (splits, M,
// N) fp32 and counters (one int per 128 x tile_m output tile, zero on entry
// and left zero). Returns the CUDA error of the launch (0 on success).
extern "C" int int8_matmul_launch(const void* x, const void* q, const void* scale, void* out,
                                  void* ws, void* counters, int M, int N, int K,
                                  int rows_per_split, int splits, int tile_m, int x_bf16,
                                  int out_f32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 16 != 0 || M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!x_bf16) {
    if (!out_f32) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + kSBN - 1) / kSBN, (M + kSBM - 1) / kSBM);
    int8_simt_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(out), M, N, K, N % 4 == 0);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(
      out_f32 ? launch_bf16<float>(x, q, scale, out, ws, counters, M, N, K, rows_per_split,
                                   splits, tile_m, s)
              : launch_bf16<__nv_bfloat16>(x, q, scale, out, ws, counters, M, N, K,
                                           rows_per_split, splits, tile_m, s));
}

// Plain C entry point of K9. dy (M, N) fp32 contiguous, 16-byte aligned; q
// (K, N) int8 contiguous, 16-byte aligned; scale (N,) fp32; dx (M, K)
// contiguous, bf16 when dx_bf16 is 1, else fp32. Any M, N, K >= 1. Returns
// the CUDA error of the launch (0 on success).
extern "C" int int8_matmul_dx_launch(const void* dy, const void* q, const void* scale,
                                     void* dx, int M, int N, int K, int dx_bf16,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K + kDxBK - 1) / kDxBK, (M + kDxBM - 1) / kDxBM);
  const int vec = N % 4 == 0;
  if (dx_bf16)
    int8_dx_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(dx), M, N, K, vec);
  else
    int8_dx_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(dx), M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}
