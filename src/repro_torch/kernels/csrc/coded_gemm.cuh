// The coded GEMM: one Hopper (sm_90a) tensor-core body for the two products
// of an activation with a weight held as int8 codes that run at M > 8 rows:
//   K9  (int8_matmul.cu):    dx[m, k] = sum_n (dy[m, n] * scale[n]) * q[k, n]
//   K11 (ternary_matmul.cu): y[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]
// In this file's terms: out (M, Nout) = A (M, Kc) . codes, contracted over
// Kc, with A the activation (fp32 or bf16, row-major) and the codes int8,
// row-major, either K-major (K9: Nout rows of Kc codes, so A is fp32 dy and
// the per-contraction scale is folded into it, g = dy * scale in fp32 as the
// reference folds it) or N-major (K11: Kc rows of Nout codes; the scale
// multiplies each output column once, after the sum).
//
// What bounds it on the card: operations at K9's training shapes (M = 4096:
// hundreds of FLOPs a byte) and at K11's batch-64 FC layers in fp32; bytes
// for K11 with bf16 x, whose codes are read once. The codes are exact in
// bf16 (|c| <= 127), so each product runs on bf16 wgmma: bf16 A needs one
// product, and fp32 A is split into three bf16 planes (hopper::bf16x3_split,
// hi + mid + lo == x exactly), each multiplied by the same code tile: fp32
// accurate at a third of the bf16 rate, 330 TFLOP/s, against 67 on the CUDA
// cores and 165 for 3xTF32. Every partial sum is fp32.
//
// Shape. A block is 64 rows of A by 256 output columns, over 64-deep stages
// of the contraction. Warps 0-7 are two consumer warpgroups, each owning 128
// of the columns: one wgmma m64n128k16 a plane a 16-deep step, with A from
// registers (each thread loads its fragments of the stage's A tile from
// shared memory, folds the scale and splits them) and the widened codes as
// the shared operand B (K-major for K9, N-major, TB = 1, for K11), so each
// code tile serves all three plane products. Warps 8-11 are the producer
// warpgroup, over a ring of slots (3 of 64 KB for fp32 A, 4 of 56 KB for
// bf16: the A tile, the codes as stored, the widened codes). Warp 8's lane
// 0 is the issuer: once the consumers free a slot it starts the stage's two
// TMA loads, the A tile (64 rows x 64, 128-byte swizzle, zeros past M and
// Kc) on the slot's "full" barrier and the 256 x 64 codes as stored on its
// "loaded" barrier, so every stage's codes take one round trip to memory
// and the ring keeps several in flight. Warps 9-11 (96 threads) are the
// wideners: when a stage's codes land they widen them exactly (a byte
// permute, a subtraction and a byte permute a pair) into bf16 in wgmma's
// 128-byte-swizzle layout, then a proxy fence and an arrival on "full".
// Each barrier arrival is one a warp. setmaxnreg moves registers from the
// producer warpgroup to the consumers, which keep 64 running sums, 64
// partial sums and 48 fragment registers a thread. (Measured on an H100 by
// building the kernel with parts removed, coded_gemm_parts.py: with each
// producer warp loading and widening a whole stage itself, the codes'
// loads and their widening paced the kernel, not the tensor cores.)
//
// Sums. Each stage's products (12 wgmmas for three planes, 4 for one) go
// into a fresh accumulator, which is then added to the running fp32 sum to
// nearest: the tensor cores' own fp32 accumulation rounds toward zero, and
// over a long contraction that bias would show. Every sum runs in a fixed
// order with no atomics on data, so two calls give the same bits.
//
// Split K. Where the output tiles alone would leave SMs idle (K11's 64-row
// batches) the stages are split across blocks (gridDim.z): block z takes
// stages [z * T / S, (z + 1) * T / S), writes its running sums to an fp32
// workspace, and the last block of the tile to arrive (an atomic counter,
// reset by that block) adds the S partials in split order, so the call is
// one launch and its result does not depend on the order in which blocks
// ran. K11's M <= 8 kernel meets its splits through the same arrival
// (arrive_last).
//
// Edges. Any M, Nout, Kc >= 1, masked by length, never padded. TMA loads A
// where its rows lie 16 bytes apart (fp32: Kc % 4 == 0; bf16: Kc % 8 == 0)
// and A is 16-byte aligned; otherwise the wideners fill the same swizzled
// tile with cp.async (fp32, 4 bytes, zero fill) or plain loads (bf16). The
// codes go by TMA where their rows lie 16 bytes apart; else the wideners
// load them in the widest pieces (8, 4 or 1 bytes) that the rows allow.
// Codes and A past the edges are zeros.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

// Internal linkage (the unnamed namespace) for everything here: each
// library that includes the header keeps its own launch-time state (the
// shared-memory attribute set once a kernel), even when two libraries
// with the same instantiations are loaded in one process.
namespace coded {
namespace {

constexpr int kBM = 64;                    // rows of A a block (wgmma's M)
constexpr int kBN = 256;                   // output columns a block
constexpr int kWgN = 128;                  // output columns a consumer warpgroup (wgmma's N)
constexpr int kBK = 64;                    // contraction a stage: 128 bytes of bf16
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128; // and the producer warpgroup
constexpr int kAcc = kWgN / 2;             // accumulators a consumer thread
constexpr int kHalf = 64 * 128;            // a 64-row tile of 128-byte rows
constexpr int kRawBytes = kBN * kBK;       // one code tile as stored: int8
constexpr int kBBytes = kBN * kBK * 2;     // one widened code tile (bf16)
constexpr int kCodeGroups = kBN * kBK / 16;  // 16-code groups a stage
constexpr int kLoadBatch = 4;              // a widener's loads in flight (no TMA)
constexpr int kWideners = 96;              // producer warps 1-3: the codes' widening
// arrivals a phase, one a warp (its lane 0, after __syncwarp): on "full"
// the three widener warps and the issuer's TMA arrival, on "empty" the
// eight consumer warps
constexpr int kFullArrivals = kWideners / 32 + 1;
constexpr int kEmptyArrivals = kConsumers / 32;

// the A tile: fp32 as two 32-column halves of 128-byte rows, bf16 as one
template <int P>
__host__ __device__ constexpr int a_bytes() {
  return kBM * kBK * (P == 3 ? 4 : 2);
}

// ring slots (an A tile, a code tile as stored and the widened code
// tile): 64 KB for fp32 A and 56 KB for bf16, so 3 and 4 fit
template <int P>
__host__ __device__ constexpr int stages() {
  return P == 3 ? 3 : 4;
}

template <int P>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)stages<P>() * (a_bytes<P>() + kRawBytes + kBBytes) +
         3 * stages<P>() * 8 + 16;
}

// one output element from its fp32 value: the only rounding of the result
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The arrival of a split's block at its tile, after each of the block's 256
// first threads (a split kernel's writers: the consumers here, every thread
// of K11's M <= 8 kernel) wrote its part of the block's partial: true in
// the last block of the tile to arrive, which then reads every split's
// partial from L2 (__ldcg) and resets the counter.
__device__ __forceinline__ bool arrive_last(int* counter, int splits, int* flag) {
  __threadfence();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == splits - 1;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// The 16 codes of row `row` at columns col .. col + 15 of a (rows, cols)
// row-major code matrix, loaded `width` bytes at a time (8 or 4 where the
// rows lie that many bytes apart, else 1: rows 16 bytes apart go by TMA);
// zeros past the edges.
__device__ __forceinline__ uint4 load_codes16(const int8_t* __restrict__ q, int row, int col,
                                              int rows, int cols, int width) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row >= rows || col >= cols) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* p = q + (long long)row * cols + col;
  const int cnt = cols - col;
  if (width == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (8 * h < cnt) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + h);
        w[2 * h] = v.x;
        w[2 * h + 1] = v.y;
      }
  } else if (width == 4) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (4 * h < cnt) w[h] = __ldg(reinterpret_cast<const uint32_t*>(p) + h);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (e < cnt) w[e >> 2] |= (uint32_t)(uint8_t)p[e] << (8 * (e & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Four int8 codes (one 32-bit word) as two packed bf16 pairs, exactly: each
// code to an fp32 value by hopper::widen4's byte permute and subtraction,
// then each pair packed from the values' top halves by a byte permute (a
// code's fp32 value has at most 8 significant bits, so its low 16 bits are
// zero) instead of a conversion instruction.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t b = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __float_as_uint(__int_as_float(__byte_perm(b, 0x4B000000u, 0x7440 + e)) -
                           8388736.f);
  return make_uint2(hopper::bf16_pack(f[0], f[1]), hopper::bf16_pack(f[2], f[3]));
}

// Group `item` (16 codes) of a stage's code tile, widened to bf16 into tile
// bt. The groups: K-major (K9), row item / 4 (output column n0 + row), codes
// 16 (item % 4) of the stage's 64; N-major (K11), row item / 16
// (contraction row kc0 + row), output columns 16 (item % 16) of the
// block's 256. The widened tile: K-major, row r holds output column n0 + r,
// its 64 codes in 128 bytes (warpgroup c's rows 128c .. 128c + 127, 16 KB
// apart); N-major, row k holds contraction row kc0 + k, in four 64-column
// blocks of 8 KB, block b holding output columns n0 + 64b .. + 63
// (warpgroup c's blocks 2c and 2c + 1).
template <bool kKMajor>
__device__ __forceinline__ void store_widened(unsigned char* bt, int item, uint4 raw) {
  uint32_t off0, off1;                         // the two 8-code chunks' bytes in the tile
  if constexpr (kKMajor) {
    const int r = item >> 2, c = 2 * (item & 3);
    off0 = hopper::sw128(r, c);
    off1 = hopper::sw128(r, c + 1);
  } else {
    const int k = item >> 4, g = item & 15, c = 2 * (g & 3);
    off0 = (g >> 2) * kHalf + hopper::sw128(k, c);
    off1 = (g >> 2) * kHalf + hopper::sw128(k, c + 1);
  }
  const uint2 w0 = widen4(raw.x), w1 = widen4(raw.y);
  const uint2 w2 = widen4(raw.z), w3 = widen4(raw.w);
  *reinterpret_cast<uint4*>(bt + off0) = make_uint4(w0.x, w0.y, w1.x, w1.y);
  *reinterpret_cast<uint4*>(bt + off1) = make_uint4(w2.x, w2.y, w3.x, w3.y);
}

// A stage's code tile where TMA took it: the raw tile (the groups in
// order, 16 bytes each) widened into bt by the kWideners threads, widener t
// taking groups t, t + kWideners, ...
template <bool kKMajor>
__device__ __forceinline__ void widen_code_tile(unsigned char* bt, const unsigned char* raw,
                                                int t) {
#pragma unroll 4
  for (int item = t; item < kCodeGroups; item += kWideners)
    store_widened<kKMajor>(bt, item, *reinterpret_cast<const uint4*>(raw + 16 * item));
}

// The same where TMA cannot take the codes (rows not 16 bytes apart): the
// wideners load their groups themselves, kLoadBatch in flight each.
template <bool kKMajor>
__device__ __forceinline__ void load_code_tile(unsigned char* bt, const int8_t* __restrict__ q,
                                               int n0, int kc0, int Nout, int Kc, int width,
                                               int t) {
#pragma unroll 1
  for (int b = t; b < kCodeGroups; b += kWideners * kLoadBatch) {
    uint4 raw[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int item = b + u * kWideners;
      raw[u] = item >= kCodeGroups ? make_uint4(0u, 0u, 0u, 0u)
               : kKMajor
                   ? load_codes16(q, n0 + (item >> 2), kc0 + 16 * (item & 3), Nout, Kc, width)
                   : load_codes16(q, kc0 + (item >> 4), n0 + 16 * (item & 15), Kc, Nout, width);
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u)
      if (b + u * kWideners < kCodeGroups) store_widened<kKMajor>(bt, b + u * kWideners, raw[u]);
  }
}

// Byte offset of element (r, c) of the A tile (c < 64; for 4-byte pairs and
// float2 loads c is even): fp32 halves of 32 columns, bf16 one 128-byte row.
template <int P>
__device__ __forceinline__ uint32_t a_offset(int r, int c) {
  if constexpr (P == 3)
    return (c >> 5) * kHalf + hopper::sw128(r, (c & 31) >> 2) + 4 * (c & 3);
  else
    return hopper::sw128(r, c >> 3) + 2 * (c & 7);
}

// The A tile where TMA cannot take it (rows not 16 bytes apart, or A not
// 16-byte aligned), by the kWideners threads in TMA's layout, zeros
// past M and Kc: fp32 by 4-byte cp.async with zero fill, bf16 by plain
// 2-byte loads (its rows may lie at odd 2-byte offsets).
template <int P>
__device__ __forceinline__ void load_a_tile(unsigned char* at, const void* __restrict__ a, int m0,
                                            int kc0, int M, int Kc, int t) {
  for (int e = t; e < kBM * kBK; e += kWideners) {
    const int r = e >> 6, c = e & 63;
    const bool ok = m0 + r < M && kc0 + c < Kc;
    const long long src = ok ? (long long)(m0 + r) * Kc + kc0 + c : 0;
    if constexpr (P == 3) {
      hopper::cp_async4_zfill(hopper::smem_addr(at + a_offset<P>(r, c)),
                              static_cast<const float*>(a) + src, ok);
    } else {
      *reinterpret_cast<uint16_t*>(at + a_offset<P>(r, c)) =
          ok ? static_cast<const uint16_t*>(a)[src] : (uint16_t)0;
    }
  }
  if constexpr (P == 3) {
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
  }
}

// scale[n] and scale[n + 1], zeros past the contraction's end
__device__ __forceinline__ float2 scale_pair(const float* __restrict__ scale, int n, int len) {
  return make_float2(n < len ? __ldg(scale + n) : 0.f, n + 1 < len ? __ldg(scale + n + 1) : 0.f);
}

// A thread's A fragments of one 16-deep step (columns c .. c + 1 and c + 8
// .. c + 9 of rows r and r + 8; wgmma's a0-a3), as P bf16 planes
template <int P, bool kFold>
__device__ __forceinline__ void a_fragments(uint32_t (&f)[P][4], const unsigned char* at, int r,
                                            int c, const float* __restrict__ scale, int kc,
                                            int Kc) {
  if constexpr (P == 3) {
    float2 v[4];
    v[0] = *reinterpret_cast<const float2*>(at + a_offset<P>(r, c));
    v[1] = *reinterpret_cast<const float2*>(at + a_offset<P>(r + 8, c));
    v[2] = *reinterpret_cast<const float2*>(at + a_offset<P>(r, c + 8));
    v[3] = *reinterpret_cast<const float2*>(at + a_offset<P>(r + 8, c + 8));
    if constexpr (kFold) {
      const float2 s0 = scale_pair(scale, kc, Kc), s8 = scale_pair(scale, kc + 8, Kc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 s = e < 2 ? s0 : s8;
        v[e].x *= s.x;
        v[e].y *= s.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h0, m0, l0, h1, m1, l1;
      hopper::bf16x3_split(v[e].x, h0, m0, l0);
      hopper::bf16x3_split(v[e].y, h1, m1, l1);
      f[0][e] = hopper::bf16_pack(h0, h1);
      f[1][e] = hopper::bf16_pack(m0, m1);
      f[2][e] = hopper::bf16_pack(l0, l1);
    }
  } else {
    f[0][0] = *reinterpret_cast<const uint32_t*>(at + a_offset<P>(r, c));
    f[0][1] = *reinterpret_cast<const uint32_t*>(at + a_offset<P>(r + 8, c));
    f[0][2] = *reinterpret_cast<const uint32_t*>(at + a_offset<P>(r, c + 8));
    f[0][3] = *reinterpret_cast<const uint32_t*>(at + a_offset<P>(r + 8, c + 8));
  }
}

// P: planes (3 for fp32 A, 1 for bf16 A). kKMajor: K9's codes and folded
// scale (else K11's N-major codes and output scale). OutT: the output type.
template <int P, bool kKMajor, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
coded_gemm_kernel(__grid_constant__ const CUtensorMap a_map,
                  __grid_constant__ const CUtensorMap q_map, const void* __restrict__ a,
                  const int8_t* __restrict__ q, const float* __restrict__ scale,
                  OutT* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                  int M, int Nout, int Kc, int k_tiles, int a_tma, int q_width) {
  constexpr int kA = a_bytes<P>();
  constexpr int kStages = stages<P>();
  extern __shared__ unsigned char coded_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(coded_smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* a_s = smem;                        // kStages A tiles
  unsigned char* r_s = smem + kStages * kA;         // kStages code tiles as stored
  unsigned char* b_s = r_s + kStages * kRawBytes;   // kStages widened code tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  uint64_t* loaded = empty + kStages;               // the code tile's TMA bytes
  int* last_s = reinterpret_cast<int*>(loaded + kStages);
  const bool q_tma = q_width == 0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int S = gridDim.z, split = blockIdx.z;
  const int kt_lo = (int)((long long)split * k_tiles / S);
  const int nt = (int)((long long)(split + 1) * k_tiles / S) - kt_lo;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, kFullArrivals);
      hopper::mbar_init(empty + s, kEmptyArrivals);
      hopper::mbar_init(loaded + s, 1);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // registers move from the producer warpgroup to the consumers' sums and
  // fragments: 128 x 56 + 256 x 224 <= 65,536
  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp == kConsumers / 32) {
      // the issuer: for each stage, once its slot is free, the TMA loads of
      // the A tile (on "full") and of the codes as stored (on "loaded"),
      // or, where TMA cannot take the codes, the bare signal on "loaded"
      if (lane != 0) return;
      for (int i = 0; i < nt; ++i) {
        const int s = i % kStages, round = i / kStages;
        if (round > 0) hopper::mbar_wait(empty + s, (round - 1) & 1);
        const int kc0 = (kt_lo + i) * kBK;
        unsigned char* at = a_s + s * kA;
        hopper::mbar_expect_tx(full + s, a_tma ? kA : 0);
        if (a_tma) {
          hopper::tma_load_2d(at, &a_map, full + s, kc0, m0);
          if constexpr (P == 3) hopper::tma_load_2d(at + kHalf, &a_map, full + s, kc0 + 32, m0);
        }
        hopper::mbar_expect_tx(loaded + s, q_tma ? kRawBytes : 0);
        if (q_tma) {
          unsigned char* rt = r_s + s * kRawBytes;
          if constexpr (kKMajor) hopper::tma_load_2d(rt, &q_map, loaded + s, kc0, n0);
          else hopper::tma_load_2d(rt, &q_map, loaded + s, n0, kc0);
        }
      }
      return;
    }
    // the wideners: each stage's codes to bf16 once they land (or loaded
    // themselves), and the A tile where TMA cannot take it
    const int t = tid - kConsumers - 32;
    for (int i = 0; i < nt; ++i) {
      const int s = i % kStages, kc0 = (kt_lo + i) * kBK;
      unsigned char* bt = b_s + s * kBBytes;
      hopper::mbar_wait(loaded + s, (i / kStages) & 1);
      if (!a_tma) load_a_tile<P>(a_s + s * kA, a, m0, kc0, M, Kc, t);
      if (q_tma) widen_code_tile<kKMajor>(bt, r_s + s * kRawBytes, t);
      else load_code_tile<kKMajor>(bt, q, n0, kc0, Nout, Kc, q_width, t);
      hopper::fence_proxy_async();                  // the widened codes, before wgmma reads them
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(full + s);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;               // this thread's rows r0 and r0 + 8
  float run[kAcc], part[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) run[e] = part[e] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(full + s, (i / kStages) & 1);
    const unsigned char* at = a_s + s * kA;
    const unsigned char* bt = b_s + s * kBBytes + wg * (kBBytes / 2);
    const int kc0 = (kt_lo + i) * kBK;
    // the stage's four 16-deep steps in two halves: the second half's
    // fragments are loaded and split while the first half's products run
    uint32_t f[4][P][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 2 * h; j < 2 * h + 2; ++j)
        a_fragments<P, kKMajor>(f[j], at, r0, 16 * j + 2 * t, scale, kc0 + 16 * j + 2 * t, Kc);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 2 * h; j < 2 * h + 2; ++j) {
        const uint64_t desc = kKMajor ? hopper::sw128_desc(bt + 32 * j, 16, 1024)
                                      : hopper::sw128_desc(bt + 16 * 128 * j, kHalf, 1024);
#pragma unroll
        for (int p = 0; p < P; ++p)
          hopper::wgmma_rs_n128<kKMajor ? 0 : 1>(part, f[j][p], desc, (j | p) != 0);
      }
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + s);
#pragma unroll
    for (int e = 0; e < kAcc; ++e) run[e] += part[e];
  }

  if (S > 1) {
    // this split's sums, four a thread at a time, thread-interleaved
    // (coalesced 16-byte stores), then the tile's arrival; the last block
    // adds every split's in split order
    const int tiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
    float4* wp = reinterpret_cast<float4*>(ws + ((long long)split * tiles + tile) * (kAcc * kConsumers));
#pragma unroll
    for (int e = 0; e < kAcc; e += 4)
      wp[(e / 4) * kConsumers + tid] = make_float4(run[e], run[e + 1], run[e + 2], run[e + 3]);
    if (!arrive_last(counters + tile, S, last_s)) return;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) run[e] = 0.f;
    for (int sp = 0; sp < S; ++sp) {
      const float4* rp =
          reinterpret_cast<const float4*>(ws + ((long long)sp * tiles + tile) * (kAcc * kConsumers));
#pragma unroll
      for (int e = 0; e < kAcc; e += 4) {
        const float4 v = __ldcg(rp + (e / 4) * kConsumers + tid);
        run[e] += v.x;
        run[e + 1] += v.y;
        run[e + 2] += v.z;
        run[e + 3] += v.w;
      }
    }
    if (tid == 0) counters[tile] = 0;
  }

  // run[4 jj + e]: row m0 + r0 + 8 (e / 2), column n0 + 128 wg + 8 jj + 2t + e % 2
  const bool pairs = (Nout & 1) == 0;
#pragma unroll
  for (int jj = 0; jj < kWgN / 8; ++jj) {
    const int col = n0 + wg * kWgN + 8 * jj + 2 * t;
    if (col >= Nout) continue;
    float s0 = 1.f, s1 = 1.f;
    if constexpr (!kKMajor) {
      s0 = scale[col];
      s1 = col + 1 < Nout ? scale[col + 1] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + 8 * h;
      if (m >= M) continue;
      const float v0 = run[4 * jj + 2 * h] * s0, v1 = run[4 * jj + 2 * h + 1] * s1;
      OutT* p = out + (long long)m * Nout + col;
      if (pairs && col + 1 < Nout) {
        store_pair(p, v0, v1);
      } else {
        store_out(p, v0);
        if (col + 1 < Nout) store_out(p + 1, v1);
      }
    }
  }
}

// The kernel's launch: grid (Nout / 256, M / 64, splits), rounded up; with
// more than one split, ws (splits x tiles x 16384 fp32) and counters (one
// int per 64 x 256 output tile, zero on entry and left zero).
template <int P, bool kKMajor, typename OutT>
cudaError_t launch(const void* a, const int8_t* q, const float* scale, OutT* out, float* ws,
                   int* counters, int M, int Nout, int Kc, int splits, cudaStream_t s) {
  const int k_tiles = (Kc + kBK - 1) / kBK;
  if (M <= 0 || Nout <= 0 || Kc <= 0 || splits < 1 || splits > k_tiles ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  constexpr int kElem = P == 3 ? 4 : 2;
  CUtensorMap a_map;
  memset(&a_map, 0, sizeof(a_map));
  const int a_tma =
      reinterpret_cast<uintptr_t>(a) % 16 == 0 && ((long long)Kc * kElem) % 16 == 0;
  if (a_tma && !hopper::encode_2d(&a_map, a,
                                  P == 3 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                  M, Kc, (uint64_t)Kc * kElem, kBM, 128 / kElem))
    return cudaErrorInvalidValue;
  // the codes: TMA (q_width 0) where their rows lie 16 bytes apart, else
  // the widest loads their row stride allows
  const int row = kKMajor ? Kc : Nout;
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const int q_width = qa % 16 == 0 && row % 16 == 0  ? 0
                      : qa % 8 == 0 && row % 8 == 0  ? 8
                      : qa % 4 == 0 && row % 4 == 0  ? 4
                                                      : 1;
  CUtensorMap q_map;
  memset(&q_map, 0, sizeof(q_map));
  if (q_width == 0 &&
      !(kKMajor ? hopper::encode_2d(&q_map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, Nout, Kc, Kc, kBN,
                                    kBK, CU_TENSOR_MAP_SWIZZLE_NONE)
                : hopper::encode_2d(&q_map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, Kc, Nout, Nout,
                                    kBK, kBN, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  static const cudaError_t smem_set =
      cudaFuncSetAttribute(coded_gemm_kernel<P, kKMajor, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<P>());
  if (smem_set != cudaSuccess) return smem_set;
  const dim3 grid((Nout + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  coded_gemm_kernel<P, kKMajor, OutT><<<grid, kThreads, smem_bytes<P>(), s>>>(
      a_map, q_map, a, q, scale, out, ws, counters, M, Nout, Kc, k_tiles, a_tma, q_width);
  return cudaGetLastError();
}

}  // namespace
}  // namespace coded
