// K4: weight-only int8 matmul for the serving fast path, on Hopper (sm_90a),
// and K9, its backward with respect to x (end of the file: the coded GEMM of
// csrc/coded_gemm.cuh, shared with K11).
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
//   * decode, bf16 x, M <= 8 (int8_decode_kernel): bytes. The weight is
//     read once (1 byte an element) and each byte feeds at most 2 * 8
//     FLOPs, far below the H100's ~295 FLOP/byte ridge; the least time is
//     the weight bytes over 3.35 TB/s. On fp32 CUDA cores the 8 FMAs and
//     the widening a byte would cost more than the bytes (a first version
//     ran at 5x the bound), so the products run on the tensor cores as
//     y^T = q^T x^T with the weight as the register operand, widened
//     exactly in registers (a byte permute and a subtraction, no
//     int-to-float conversion), and x^T as the n = 8 operand (no padded
//     rows). What holds such a kernel back is the stream (a split-K
//     kernel before this one, measured part by part, spent 89-97% of its
//     time on its cp.async stream alone): each lane loads its own
//     fragments, 128 contiguous bytes of a row a warp load, straight to
//     registers two steps ahead (no shared memory, no wide tile, no
//     ldmatrix); one block a (128-column tile, band of k rows), equal bands
//     with every block resident, the blocks of a band walking down the
//     same rows of adjacent tiles in step; the sums of a tile's bands meet
//     in an in-order last-block combine, so the result does not depend on
//     the order in which blocks ran and the call is one launch. The design
//     note is above the kernel.
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
//     used (the coded GEMM's three exact bf16 planes could carry it, as they
//     carry K9); each output sums k in the same order whatever M is (16-row
//     partial sums added in ascending order), so an engine's batched call
//     and a one-row call give the same bits.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coded_gemm.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTcMaxSplits = 64;  // the wgmma kernel's K splits at most

// ---------------------------------------------------------------------------
// decode: bf16 x, M <= 8, the weight streamed to registers, tensor cores
// ---------------------------------------------------------------------------
//
// The block computes y^T = q^T x^T for one 128-column tile at a time on
// mma.sync m16n8k16: the weight's codes are A (16 output columns by 16 k
// rows an MMA), x^T is B (16 k rows by M <= 8 rows of x: no padding at M =
// 8). A's rows may be any permutation of the tile's columns, so lane (g, t)
// of a warp owns the tile's columns 16g .. 16g + 15 and takes A's rows g and
// g + 8 of MMA j as columns 16g + 2j and 16g + 2j + 1: the 16 codes it loads
// from each of k rows 2t, 2t + 1, 2t + 8 and 2t + 9 of a 16-row step (four
// 16-byte loads straight from device memory to registers; a warp's load
// covers 4 rows x 128 contiguous bytes) hold its A fragments of all 8 MMAs
// of the step. Each byte pair (k, k + 1) of a column is widened exactly to
// a bf16 pair in registers (a byte permute, hopper::widen4); the weight
// touches no shared memory. x^T's fragment is one 4-byte load of x row g
// each for k 2t, 2t + 1 and 2t + 8, 2t + 9 (from L1: every warp of the grid
// reads x). Lane (g, t) ends holding y[2t, 2t + 1][16g .. 16g + 15] of the
// tile. A warp keeps kDecStages - 1 steps of loads in flight ahead of the
// one it multiplies. (Measured on an H100, the same lanes streaming
// through shared memory, by TMA boxes or by their own cp.async copies, ran
// 1.2-1.5x slower at a decode tick's shapes.) Where N % 16 != 0 (the rows
// are not 16-byte aligned) the lanes load their codes a byte at a time
// instead.
//
// Work: a round is 128 k rows of a tile, one 16-row step for each of the
// block's 8 warps. Block b takes tile b % tiles and band b / tiles of its
// rounds: the wrapper's plan splits each tile's rounds into `bands` equal
// bands of at least 4 rounds, as many as fit with every block resident at
// once (2 blocks an SM), so every block streams the same bytes. The blocks
// of a band start together at the same k row of adjacent tiles and walk
// down in step, so at any time the card reads whole runs of a weight row
// (on an H100, walking each tile's band from another start cost 4-7%). At
// the end the warps add their sums in warp order through shared memory; a
// tile of one band is written out, else each block writes its fp32 partial
// to ws slot b and the last block of the tile to arrive (an atomic
// counter, reset by that block) adds the partials in band order, so the
// result does not depend on the order in which blocks ran and the call is
// one launch.

constexpr int kMaxM = 8;
constexpr int kDecWarps = 8;                        // a round: a step each
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBN = 128;                         // a tile: 8 lanes' 16 columns
constexpr int kDecRound = kDecWarps * 16;           // k rows a round
constexpr int kDecOut = kMaxM * kDecBN;             // a tile's outputs; a partial's floats
constexpr int kDecStages = 3;                       // steps a warp holds in registers
constexpr int kDecBlocksPerSm = 2;                  // resident an SM: the launch bounds
constexpr int kRedStride = 33;                      // the warps' exchange: conflict-free rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of the weight, read once: not kept in L1
__device__ __forceinline__ uint4 ld_stream16(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

using coded::store_out;   // one output element from its fp32 value: its only rounding
using coded::store_pair;

using hopper::widen4;

// One 16-row step's operands of one lane: 16 codes of each of the step's k
// rows 2t, 2t + 1, 2t + 8 and 2t + 9 (the lane's 16 columns) and its x^T
// fragment (x row g at k 2t, 2t + 1 and 2t + 8, 2t + 9).
struct DecStep {
  uint4 w[4];
  uint32_t b[2];
};

// The rest of the block's flush, once the warps' sums are in red (out of
// line: it runs once a block): thread i adds the warps' sums in warp order
// for outputs i + kDecThreads u (row m, column n of tile ct); a tile of
// one band is written out, else the block's partial goes to ws slot blk
// and the last block of the tile to arrive adds the partials of the
// tile's bands in band order (slots ct + band * tiles).
template <typename OutT>
__device__ __noinline__ void dec_flush(const float* red, int* last_s, int ct, int tiles,
                                       int bands, int blk, int M, int N,
                                       const float* __restrict__ scale, OutT* __restrict__ out,
                                       float* __restrict__ ws, int* __restrict__ counters) {
  const int tid = threadIdx.x, n0 = ct * kDecBN;
  for (int u = 0; u < kDecOut / kDecThreads; ++u) {
    const int i = tid + u * kDecThreads, m = i / kDecBN, n = i % kDecBN;
    if (m >= M) continue;
    const int src_lane = 4 * (n >> 4) + (m >> 1);
    const int src_acc = 4 * ((n & 15) >> 1) + 2 * (n & 1) + (m & 1);
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) v += red[(w * 32 + src_acc) * kRedStride + src_lane];
    if (bands == 1) {
      if (n0 + n < N) store_out(out + (long long)m * N + n0 + n, v * scale[n0 + n]);
    } else {
      ws[(long long)blk * kDecOut + i] = v;
    }
  }
  if (bands == 1) {
    __syncthreads();                                   // red is read
    return;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(counters + ct, 1) == bands - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  // the partials from L2 (other SMs wrote them), eight blocks' loads in
  // flight at once; then the scale, and the counter reset
  for (int u = 0; u < kDecOut / kDecThreads; ++u) {
    const int i = tid + u * kDecThreads, m = i / kDecBN, n = i % kDecBN;
    if (m >= M || n0 + n >= N) continue;
    float v = 0.f;
    for (int b0 = 0; b0 < bands; b0 += 8) {
      float part[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        part[e] = b0 + e < bands
                      ? __ldcg(ws + ((long long)(b0 + e) * tiles + ct) * kDecOut + i)
                      : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (b0 + e < bands) v += part[e];
    }
    store_out(out + (long long)m * N + n0 + n, v * scale[n0 + n]);
  }
  if (tid == 0) counters[ct] = 0;
}

template <bool kVec, typename OutT>
__global__ void __launch_bounds__(kDecThreads, kDecBlocksPerSm)
int8_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, OutT* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ counters, int M, int N, int K) {
  constexpr int P = kDecStages;
  __shared__ float red[kDecWarps * 32 * kRedStride];   // (warp, accumulator) rows of lanes
  __shared__ int last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int steps = K / 16, rounds = (K + kDecRound - 1) / kDecRound;
  const int tiles = (N + kDecBN - 1) / kDecBN, bands = gridDim.x / tiles;
  const int blk = blockIdx.x, ct = blk % tiles, band = blk / tiles;
  const int r_lo = band * rounds / bands, r_hi = (band + 1) * rounds / bands;
  const int col = ct * kDecBN + 16 * g;

  // round r's step of this warp into s: zeros for a step past K (a tile's
  // last round may be short), for columns past N and for x's rows past M
  auto load = [&](DecStep& s, int r) {
    if (r >= r_hi) return;
    const int rr = r;                    // the tile's round: in step with the band's other tiles
    const int st = rr * kDecWarps + warp, k0 = st * 16 + 2 * t;
    const int8_t* src = q + (long long)k0 * N + col;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int8_t* row = src + (long long)((e & 1) + 8 * (e >> 1)) * N;
      if constexpr (kVec) {
        s.w[e] = st < steps && col < N ? ld_stream16(row) : make_uint4(0u, 0u, 0u, 0u);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (st < steps)
          for (int c = 0; c < 16; ++c)
            if (col + c < N) v[c >> 2] |= (uint32_t)(uint8_t)row[c] << (8 * (c & 3));
        s.w[e] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    s.b[0] = s.b[1] = 0u;
    if (st < steps && g < M) {
      const __nv_bfloat16* xr = x + (long long)g * K + k0;
      s.b[0] = __ldg(reinterpret_cast<const unsigned int*>(xr));
      s.b[1] = __ldg(reinterpret_cast<const unsigned int*>(xr + 8));
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // MMA j (columns 16g + 2j, + 1) from the codes' 32-bit word j / 2, its
  // bytes 2 (j % 2) and 2 (j % 2) + 1 of each row, interleaved to (k, k + 1)
  // pairs per column
  auto compute = [&](const DecStep& s) {
    const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&s.w[0]);
    const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&s.w[1]);
    const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&s.w[2]);
    const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&s.w[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t sel = h ? 0x7362u : 0x5140u;
        const uint2 lo = widen4(__byte_perm(w0[i], w1[i], sel));   // k 2t, 2t + 1
        const uint2 hi = widen4(__byte_perm(w2[i], w3[i], sel));   // k 2t + 8, 2t + 9
        const uint32_t a[4] = {lo.x, lo.y, hi.x, hi.y};
        mma_bf16(acc[2 * i + h], a, s.b);
      }
    }
  };

  // the end of the block's band: acc[j][e] holds y[2t + e % 2][16g + 2j + e
  // / 2] of the tile; the warps' sums meet in red
  auto flush = [&] {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(warp * 32 + 4 * j + e) * kRedStride + lane] = acc[j][e];
    __syncthreads();
    dec_flush<OutT>(red, &last_s, ct, tiles, bands, blk, M, N, scale, out, ws, counters);
  };

  DecStep stage[P];
#pragma unroll
  for (int p = 0; p < P - 1; ++p) load(stage[p], r_lo + p);
  for (int r0 = r_lo; r0 < r_hi; r0 += P) {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int r = r0 + u;
      if (r >= r_hi) break;                            // uniform across the block
      load(stage[(u + P - 1) % P], r + P - 1);
      compute(stage[u]);
    }
  }
  flush();
}

// The decode kernel's launch: 16-byte loads where N % 16 == 0, byte loads
// otherwise.
template <typename OutT>
cudaError_t launch_decode(const void* x, const void* q, const void* scale, void* out,
                          void* ws, void* counters, int M, int N, int K, int blocks,
                          cudaStream_t s) {
  const long long rounds = (K + kDecRound - 1) / kDecRound;
  const long long tiles = (N + kDecBN - 1) / kDecBN;
  const long long bands = blocks / tiles;
  if (blocks < 1 || blocks % tiles || bands > rounds ||
      (bands > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  auto kernel = N % 16 == 0 ? int8_decode_kernel<true, OutT> : int8_decode_kernel<false, OutT>;
  kernel<<<blocks, kDecThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<OutT*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), M, N, K);
  return cudaGetLastError();
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
// S partials in split order, as the decode kernel adds its blocks'.

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

template <int BM, typename OutT>
cudaError_t launch_wgmma(const void* x, const void* q, const void* scale, void* out, void* ws,
                         void* counters, int M, int N, int K, int splits, cudaStream_t s) {
  CUtensorMap x_map, q_map;
  if (!hopper::encode_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, K, (uint64_t)K * 2, BM,
                         kTcBK) ||
      !hopper::encode_2d(&q_map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, N, N, kTcBK, kTcBN))
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
                        void* counters, int M, int N, int K, int blocks, int splits,
                        int tile_m, cudaStream_t s) {
  if (M <= kMaxM) return launch_decode<OutT>(x, q, scale, out, ws, counters, M, N, K, blocks, s);
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
// K9: the backward with respect to x, on the coded GEMM
// ---------------------------------------------------------------------------
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py::int8_matmul_dx
// (_int8_bwd_dx_kernel), the backward of int8_matmul_vjp. Computes
//   dx[m, k] = sum_n (dy[m, n] * scale[n]) * q[k, n]
// with dy (M, N) fp32 row-major (the caller casts the cotangent to fp32, as
// _int8_vjp_bwd does), q (K, N) int8 in the forward's own layout (a dx
// column's weight row is contiguous along the contraction axis N: K-major
// codes), scale (N,) fp32, and dx (M, K) in x's dtype (fp32 or bf16).
//
// What bounds it on the card: operations. 2 * M * N * K FLOPs against
// 4 * M * N + K * N bytes read: at M = 4096 training tokens that is
// hundreds of FLOPs a byte, above the H100's ridge. The codes are exact in
// bf16, so g = dy * scale (folded in fp32 as the reference folds it) is
// split into three bf16 planes and each product runs on bf16 wgmma:
// coded_gemm.cuh's kernel with dx's K columns as its outputs and N as its
// contraction (the least time is the FLOPs at a third of the bf16 peak).
// One launch; K is split across blocks only where the 64 x 256 dx tiles
// would leave SMs idle.

}  // namespace

// Plain C entry point of K4. x (M, K) contiguous in x's dtype (x_bf16: bf16,
// else fp32), 16-byte aligned; out (M, N) contiguous, fp32 when out_f32 is 1
// (required for fp32 x), else bf16; q (K, N) int8 contiguous, 16-byte
// aligned; scale (N,) fp32; K % 16 == 0. The bf16 decode kernel (M <= 8)
// runs `blocks` blocks, a whole number of bands (at most ceil(K / 128)) of
// ceil(N / 128) tiles, and, with more than one band, needs ws (blocks *
// 1024 fp32) and counters (one int per 128-column tile, zero on entry and
// left zero). The
// bf16 wgmma kernel (M > 8) needs N % 16 == 0 (TMA's 16-byte row stride),
// takes tile_m (64, 128, 192 or 256 rows of x a block) and splits (1-64; K
// tiles of 64 shared out evenly), and with splits > 1 needs ws (splits, M,
// N) fp32 and counters (one int per 128 x tile_m output tile, zero on entry
// and left zero). Returns the CUDA error of the launch (0 on success).
extern "C" int int8_matmul_launch(const void* x, const void* q, const void* scale, void* out,
                                  void* ws, void* counters, int M, int N, int K,
                                  int blocks, int splits, int tile_m, int x_bf16,
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
      out_f32 ? launch_bf16<float>(x, q, scale, out, ws, counters, M, N, K, blocks, splits,
                                   tile_m, s)
              : launch_bf16<__nv_bfloat16>(x, q, scale, out, ws, counters, M, N, K, blocks,
                                           splits, tile_m, s));
}

// Plain C entry point of K9. dy (M, N) fp32 contiguous; q (K, N) int8
// contiguous; scale (N,) fp32; dx (M, K) contiguous, bf16 when dx_bf16 is
// 1, else fp32. Any M, N, K >= 1. `splits` (1 .. ceil(N / 64)) parts of the
// contraction; with more than one, ws holds splits x tiles x 16384 fp32 and
// counters one int per 64 x 256 dx tile (zero on entry, left zero). Returns
// the CUDA error of the launch (0 on success).
extern "C" int int8_matmul_dx_launch(const void* dy, const void* q, const void* scale,
                                     void* dx, void* ws, void* counters, int M, int N, int K,
                                     int splits, int dx_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  // dx's K columns are the coded GEMM's outputs, N its contraction
  return static_cast<int>(
      dx_bf16 ? coded::launch<3, true>(dy, qc, sc, static_cast<__nv_bfloat16*>(dx), w, c, M, K, N,
                                       splits, s)
              : coded::launch<3, true>(dy, qc, sc, static_cast<float*>(dx), w, c, M, K, N,
                                       splits, s));
}
