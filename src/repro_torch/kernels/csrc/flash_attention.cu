// K6, K7, K8: flash attention for training, forward with lse and its two
// backward kernels, and K10, the inference flash attention, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels behind repro/kernels/flash_attention.py::
// flash_attention_vjp and flash_attention:
//   K6  _fwd_with_lse         (_flash_kernel with save_lse=True)
//   K7  _flash_vjp_bwd -> dQ  (_flash_bwd_dq_kernel, pallas_call at :337)
//   K8  _flash_vjp_bwd -> dK, dV (_flash_bwd_dkv_kernel, pallas_call at :357)
//   K10 flash_attention       (_flash_kernel without the lse; int8-KV mode)
// q (B, Sq, H, D), k/v (B, Sk, Hkv, D) with rep = H / Hkv, all contiguous
// and read in place (the TPU wrapper's transposes and padding are not
// carried over). Query i and key j form a valid pair when i < Sq, j < Sk,
// i - j >= 0 (causal) and i - j < window (window > 0): the reference's
// _tile_mask, with query i lined up with key i, masked by length instead
// of by padding.
//
// Numerics, as the Pallas bodies: fp32 accumulation, q scaled in fp32
// before every dot, online softmax from m = -1e30, the denominator floored
// at 1e-30, lse = m + log(max(l, 1e-30)) in fp32. p is masked explicitly in
// all three kernels, so a row with no valid key has l = 0: K6 writes zeros
// there (the Pallas body averages V over the masked keys of the tiles it
// visited) and K7/K8 give it no gradient, as the reference's backward does.
//   K6: out = softmax(q k^T * scale) v in q's dtype, lse (B, H, Sq) fp32.
//   K7: p = exp(s - lse), dS = p * (dO v^T - delta), dq = scale * dS k, in
//       q's dtype; delta = rowsum(dO * out) (B, H, Sq) fp32 comes from the
//       caller.
//   K8: dv = sum over the group's rep heads of p^T dO, dk = the same sum of
//       dS^T (scale * q), in k's and v's dtypes.
//
// What bounds them on the card: operations. A valid (query, key) pair costs
// 4 * D FLOPs per head forward, 6 * D in K7 (s, dP, dQ) and 8 * D in K8 (s,
// dP, dV, dK), against one read of each q, k, v, dO row: at starcoder2-7b's
// shapes (S = 2048, causal) that is hundreds of FLOPs per byte, above the
// H100's ridge. The least time for fp32 work is its FLOPs at the 3xTF32
// rate, 495 / 3 = 165 TFLOP/s on the tensor cores (below); for bf16, each
// product at its operands' rate (below).
//
// The 3xTF32 tensor-core kernels: K6 and K10 with fp32 q
// (flash_fwd_tc_kernel: K/V fp32 or int8 codes), K7 and K8 in fp32
// (flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel; the wrapper's route
// "tensor_cores"). Every product runs on the tensor cores in tf32 with
// fp32-accurate results (3xTF32): each fp32 operand x splits into hi =
// tf32(x) (round to nearest, ties away: cvt.rna's rounding) and lo = tf32(x
// - hi), and A B = A_lo B_hi + A_hi B_lo + A_hi B_hi, small terms first,
// about 2^-21 relative a product (plain TF32, hi only, is about 2^-11 and
// misses the fp32 gate). Q, K, V and dO split as their tiles are stored,
// P and dS in registers as they are made. The forward splits K and V once
// a call, in a pre-pass (flash_fwd_split_kernel) into a workspace that
// holds every 32-key tile's planes in their shared-memory layout, read by
// all the query blocks of the KV head: split in the block, every query
// block that sees a tile split it again (up to 144 at starcoder2-7b's
// shapes, 9 query heads x 16 blocks), and the split and its stores were
// half of a block's instructions. int8 K/V are widened to fp32 there (codes
// times their row's scale, the Pallas body's k * ks, v * vs).
//   * Every product on wgmma. S = Q K^T and dP = dO V^T (K8: S^T = K Q^T,
//     dP^T = V dO^T) have K-major operands as the tensors are stored:
//     m64n32k8 from hi/lo planes in shared memory (K6's, K10's and K7's S
//     take Q's hi half from registers, kept for the whole block). tf32
//     wgmma has no transposed operand, so a product over the rows needs
//     its B stored K-major along the rows. The forward's P V stores V
//     transposed as V^T planes (D rows of the tile's keys), in the key
//     order (2t, 2t + 1 at slots t, t + 4 of each k step of 8) that makes
//     S's accumulator fragment P's A fragment, so P stays in registers
//     (m64n64k8, 64 columns of D at a time). The backward's products over
//     the rows (dQ over keys, dV and dK over queries) run as their
//     transposes, dQ^T = K^T dS^T, dV^T = dO^T P, dK^T = (scale Q)^T dS:
//     the side that would need the transposition (K, dO, Q) comes in as
//     the A operand from registers, which may be filled from any layout,
//     and the side made in registers (dS, P^T, dS^T) is written as K-major
//     hi/lo planes for B. (A first design on warp-level mma.sync m16n8k8
//     for every product read each B fragment from shared memory once per
//     warp and ran slower.)
//   * Planes use wgmma's K-major layout with the 128-byte swizzle (rows of
//     32 floats, 1024-byte aligned), so wgmma and the threads' own loads
//     and stores read the same bytes; fp32 hi/lo planes take 8 bytes an
//     element, which sets the tiles: K6/K10 128 query rows (64 a
//     warpgroup) and K7 64 over 32-key tiles, K8 64 keys over 32-query
//     tiles, 193-225 KB a block (the forward double-buffers its K and V^T
//     planes), one block an SM.
//   * The tensor cores' fp32 accumulation rounds toward zero; over the
//     thousands of MMA steps of one output (K8 sums rep heads x Sq
//     queries) that bias reached 1e-4 of the max. Each product over the
//     rows sums a tile's 12 wgmma in a fresh accumulator, and one fp32 add
//     (to nearest) takes it into the running sum (the forward's O = O
//     alpha + P V, its online rescale, 64 columns of D at a time).
//   * Two warpgroups. In the forward each owns 64 query rows from end to
//     end (S, the online softmax with m, l and p in fp32, P V), and the
//     two share the tile's planes, which land by cp.async during the tile
//     before. (A first design split the forward by role, S and the
//     softmax in warpgroup 0 and P V in warpgroup 1: warpgroup 0, one warp
//     a scheduler, was the path and warpgroup 1 waited.) K7 is a pipeline
//     over the key tiles on named barriers: warpgroup 0 stores tile i's K
//     and V (loaded into its registers a tile ahead), computes S and P;
//     warpgroup 1 computes dP and dS, takes K^T into registers and adds
//     K^T dS^T while warpgroup 0 goes on to tile i + 1. K8 splits by
//     product: warpgroup 0 S^T, P^T and dV^T, warpgroup 1 dP^T, dS^T and
//     dK^T, the next query tile loading into registers meanwhile.
//   * Block order: the forward's and K7's grids walk each head's query
//     tiles heaviest first; K8's 1-D grid puts the key tile slowest, so
//     every (batch, KV head) of key tile 0, which the most query rows see
//     under the causal mask, launches first (longest-processing-time
//     order). Tiles outside the causal triangle or the window are never
//     visited.
//   * K8 walks the rep query heads of its group and their tiles inside the
//     block, so the GQA sum stays in registers; where its (key tile, batch,
//     KV head) blocks are fewer than the card's SMs (the smoke configs' B 8
//     x S 64: 16 of them), each head of the group takes a block of its own
//     and the group's last block to finish sums their fp32 partials in head
//     order (dkv_block, dkv_combine; one launch). Every sum is taken in a
//     fixed order, with no atomics on values: two calls give the same bits.
//
// K7 and K8 in bf16 (flash_bwd_dq_bf16_kernel, flash_bwd_dkv_bf16_kernel;
// route "tensor_cores" at every head dim) run on bf16 wgmma with the Pallas
// kernels' numerics (the Pallas bodies upcast bf16 to fp32; S, P, dP and dS
// are fp32): S = Q K^T and dP = dO V^T have bf16 on both sides, so each is
// one bf16 wgmma k16 with exact products and an fp32 sum; S is scaled in
// fp32 after its product (Pallas scales q before it, and dK = scale dS^T Q
// at the end where Pallas multiplies dS^T by scale q: both differ at fp32
// rounding). The products over the rows (dQ += dS K, dV += P^T dO, dK +=
// dS^T Q) have one fp32 operand: P or dS splits into three exact bf16
// planes on its bit pattern (hopper::bf16x3_split, as the coded GEMM
// carries fp32 x), each a bf16 wgmma against the bf16 tile, small terms
// first, into a fresh fp32 accumulator that one add (to nearest) takes into
// the running sum. bf16 wgmma reads a 16-bit B N-major (the transpose bit),
// so K, dO and Q serve those products from the tiles S and dP read K-major:
// no transposed copies. Tiles hold 2 bytes an element (the fp32 planes 8),
// so 64 x 64 tiles fit every head dim: 64 columns for 8-64, 128 for 112 and
// 128, 192 for 168 (S and dP take ceil(D / 16) k steps). K7 is one
// warpgroup over a block's 64 query rows (two blocks an SM); K8 keeps the
// fp32 kernel's grid and group walk with two warpgroups by product. The
// bound of both: 10 and 16 D FLOPs a pair, S and dP at the bf16 rate and
// the three-plane products at a third of it.
//
// fp32 K7 and K8 at head dim 168 (flash_bwd_dq_tc_wide_kernel,
// flash_bwd_dkv_tc_wide_kernel) keep the 3xTF32 kernels' walks, tiles and
// numerics on planes of 192 columns, where hi/lo planes of every operand
// would take 320,000 and 327,936 bytes a block. The operands that enter
// wgmma only as A from registers (K7's Q and dO, K8's K and V) stay one
// plain fp32 plane each, split into their tf32 halves as each chunk of k
// steps is read (221,696 and 229,632 bytes); the products over the rows
// take one 64-row m-tile of D's fragments at a time.
//
// K6 and K10 with bf16 q (flash_fwd_bf16_kernel) run on bf16 wgmma with
// the Pallas body's numerics, as bf16 K7 does: S = Q K^T is one bf16 wgmma
// k16 a step with exact products and an fp32 sum, scaled in fp32 after it;
// P V takes the fp32 P in three exact bf16 planes against the bf16 V tile,
// read N-major. K and V come straight from the tensors as 64-key bf16
// tiles by cp.async: no pre-pass, no workspace, one launch a call. Tiles of
// 2 bytes an element (the fp32 planes take 8) hold 64 keys at every head
// dim. One warpgroup a 64-row block and two blocks an SM, whose phases run
// apart, so one block's softmax overlaps the other's wgmma (two
// warpgroups sharing a block's tiles ran their phases in step, and were
// slower in a trial on an H100), and the softmax makes no mask on the
// tiles that cross no edge. The bound: 8 D FLOPs a pair, S's 2 D at the
// bf16 rate and P V's 2 D at a third of it (three planes).
//
// K10 (the inference flash_attention, with its int8-KV mode) is K6's
// forward without the lse. In the int8-KV mode K and V are int8 codes with
// one fp32 scale per (batch, key, KV head), (B, Sk, Hkv): with fp32 q the
// pre-pass takes the K/V storage type as a template parameter and reads
// 4x fewer K/V bytes than in fp32; with bf16 q the codes are widened
// exactly to bf16 in shared memory (int8 is exact in bf16), each key's K
// scale multiplies its column of S and its V scale P before the planes.
// The math is K6's. With Sq > Sk under a window, a query
// row whose window lies past the last key sees no key and is zeros: the
// Pallas kernel averages V over the masked keys of the tiles it visited
// there, and the JAX wrapper sends such ragged shapes to attention_ref,
// which averages all of V; no model path makes such a row.
//
// Head dims: 64 and 128; the reference's smoke configs' 8, 16 and 24,
// which run the D = 64 kernels on rows read and written at their own width,
// the tiles zero past it; 112 on the D = 128 kernels; 168 on instances of
// its own (see the entry points).
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// Shared memory a block can take (227 KiB of the SM's 256 KiB)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 mul4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

__device__ __forceinline__ bool valid_pair(int i, int j, int Sq, int Sk, int causal,
                                           int window) {
  const int diff = i - j;
  return i < Sq && j < Sk && (!causal || diff >= 0) && (window <= 0 || diff < window);
}

// ---------------------------------------------------------------------------
// K7 and K8 on the tensor cores: fp32 q, k, v and dO through the 3xTF32 split
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;          // two warpgroups (roles) of four warps
constexpr int kDqRows = 64;              // K7: query rows a block, 16 a warp
constexpr int kDqKeys = 32;              // K7: keys a streamed tile
constexpr int kDkvKeys = 64;             // K8: keys a block, 16 a warp
constexpr int kDkvRows = 32;             // K8: query rows a streamed tile

// The columns the planes hold for a head dim of D: D rounded up to 64 (the
// 32-float swizzled blocks; the rows the transposed products put on
// wgmma's M side), zero past D. 192 for D = 168.
__host__ __device__ constexpr int padded_dim(int D) { return (D + 63) / 64 * 64; }

// floats of shared memory past the 1024-byte alignment: K7 holds Q (scaled)
// and dO (64 rows) and K and V (32 rows) as hi and lo planes, the dS planes
// (64 x 32), four exchange tiles (16 x 32) and 128 lse and delta rows; K8
// holds K and V (64 rows) and Q (scaled) and dO (32 rows) as hi and lo
// planes, the P^T and dS^T planes (64 x 32) and 64 lse and delta rows. At
// 192 columns that is 320,000 and 327,936 bytes, over kMaxSmem: the wide
// kernels (head dim 168) keep the operands that only ever enter wgmma from
// registers (K7's Q and dO, K8's K and V) as one plain fp32 plane each,
// split into tf32 halves as they are read, 221,696 and 229,632 bytes.
__host__ __device__ constexpr int dq_smem_floats(int D) { return 384 * D + 2 * 2048 + 2048 + 128; }
__host__ __device__ constexpr int dkv_smem_floats(int D) { return 384 * D + 4 * 2048 + 64; }
__host__ __device__ constexpr int dq_wide_smem_floats(int DP) { return 256 * DP + 3 * 2048 + 128; }
__host__ __device__ constexpr int dkv_wide_smem_floats(int DP) { return 256 * DP + 4 * 2048 + 64; }
static_assert(1024 + 4 * dq_wide_smem_floats(192) <= kMaxSmem, "K7 at 168 fits a block");
static_assert(1024 + 4 * dkv_wide_smem_floats(192) + 16 <= kMaxSmem, "K8 at 168 fits a block");

// Float offset of element (r, c) of a plane of R rows of D floats in
// wgmma's K-major layout with the 128-byte swizzle: D / 32 blocks of R rows
// of 32 floats (128 bytes), block after block, each row's 16-byte chunks
// xor-swizzled by the row mod 8 (the plane starts 1024-byte aligned). The
// threads' own reads and writes use the same offsets: whole rows of 16-byte
// chunks (tile stores) fall on distinct banks, the register fragments'
// scalar reads on at most two ways.
template <int D, int R>
__device__ __forceinline__ int pl(int r, int c) {
  return (c >> 5) * (R * 32) + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

__device__ __forceinline__ void split4(const float4& x, uint4& h, uint4& l) {
  hopper::tf32_split(x.x, h.x, l.x);
  hopper::tf32_split(x.y, h.y, l.y);
  hopper::tf32_split(x.z, h.z, l.z);
  hopper::tf32_split(x.w, h.w, l.w);
}

// Four consecutive elements of a global row as stored (fp32, or int8
// codes), read in one access and widened to fp32 exactly.
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  using type = float4;
};
template <>
struct Raw4<int8_t> {
  using type = uint32_t;
};

template <typename T>
__device__ __forceinline__ typename Raw4<T>::type ld_raw4(const T* p) {
  return *reinterpret_cast<const typename Raw4<T>::type*>(p);
}

__device__ __forceinline__ float4 to_f32x4(const float4& x) { return x; }

__device__ __forceinline__ float4 to_f32x4(uint32_t w) {
  return make_float4((float)(int8_t)w, (float)(int8_t)(w >> 8), (float)(int8_t)(w >> 16),
                     (float)(int8_t)(w >> 24));
}

// Rows [0, R) of a tile read from global memory (row stride gstride, dg
// columns) times `mul` in fp32, rows at or past n_valid and columns at or
// past dg zeros, split into the hi and lo planes: the resident tiles, once
// a block.
template <int D, int R, typename T>
__device__ __forceinline__ void stage_global(float* hi, float* lo, const T* src,
                                             long long gstride, int n_valid, int dg,
                                             float mul) {
  constexpr int C = D / 4;
  for (int idx = threadIdx.x; idx < R * C; idx += kTcThreads) {
    const int r = idx / C, c = idx % C;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid && 4 * c < dg) x = mul4(to_f32x4(ld_raw4(src + r * gstride + 4 * c)), mul);
    uint4 h, l;
    split4(x, h, l);
    const int o = pl<D, R>(r, 4 * c);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// stage_global's tile (fp32) as one plain plane in the same layout, not
// split: the wide kernels' operands that enter wgmma only from registers.
template <int D, int R>
__device__ __forceinline__ void stage_plain(float* dst, const float* src, long long gstride,
                                            int n_valid, int dg, float mul) {
  constexpr int C = D / 4;
  for (int idx = threadIdx.x; idx < R * C; idx += kTcThreads) {
    const int r = idx / C, c = idx % C;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid && 4 * c < dg) x = mul4(ld4(src + r * gstride + 4 * c), mul);
    *reinterpret_cast<float4*>(dst + pl<D, R>(r, 4 * c)) = x;
  }
}

// A streamed 32-row tile of two tensors, held in the registers of the
// kThreads threads that move it (from threadIdx.x % kThreads) between its
// global loads (issued a tile ahead) and its split into the planes.
template <int D, int kThreads>
struct Prefetch {
  static constexpr int kChunks = 32 * (D / 4) / kThreads;     // 16-byte chunks a thread, a tensor
  float4 a[kChunks], b[kChunks];

  // rows [0, 32) of a and b (row stride gstride, dg columns), zeros at and
  // past n_valid and dg
  __device__ __forceinline__ void load(const float* src_a, const float* src_b,
                                       long long gstride, int n_valid, int dg) {
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int idx = threadIdx.x % kThreads + u * kThreads, r = idx / (D / 4), c = idx % (D / 4);
      a[u] = b[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n_valid && 4 * c < dg) {
        a[u] = ld4(src_a + r * gstride + 4 * c);
        b[u] = ld4(src_b + r * gstride + 4 * c);
      }
    }
  }

  // a times mul_a into planes (ah, al), b into (bh, bl)
  __device__ __forceinline__ void store(float* ah, float* al, float mul_a, float* bh,
                                        float* bl) const {
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int idx = threadIdx.x % kThreads + u * kThreads, r = idx / (D / 4), c = idx % (D / 4);
      const int o = pl<D, 32>(r, 4 * c);
      uint4 h, l;
      split4(mul4(a[u], mul_a), h, l);
      *reinterpret_cast<uint4*>(ah + o) = h;
      *reinterpret_cast<uint4*>(al + o) = l;
      split4(b[u], h, l);
      *reinterpret_cast<uint4*>(bh + o) = h;
      *reinterpret_cast<uint4*>(bl + o) = l;
    }
  }
};

// s = A B^T over D for the warpgroup's 64 rows of A and the 32 rows of B,
// both from hi/lo planes (A of 64 rows, B of 32), in 3xTF32 on wgmma
// m64n32k8: each k step of 8 issues A_lo B_hi, A_hi B_lo, A_hi B_hi (small
// terms first), committed as one group and waited for. s[0][j][e] of warp w
// of the warpgroup is (row 16w + g + 8 (e / 2), B row 8j + 2t + e % 2).
template <int D>
__device__ __forceinline__ void dots_wgmma(const float* a_hi, const float* a_lo,
                                           const float* b_hi, const float* b_lo,
                                           float (&s)[1][4][4]) {
  float(&d)[16] = reinterpret_cast<float(&)[16]>(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    // k step kk: 32-float block kk / 4, 32 bytes into its rows per step
    const int a_off = (kk >> 2) * (64 * 32) + (kk & 3) * 8;
    const int b_off = (kk >> 2) * (32 * 32) + (kk & 3) * 8;
    const uint64_t ah = hopper::sw128_desc(a_hi + a_off, 16, 1024);
    const uint64_t al = hopper::sw128_desc(a_lo + a_off, 16, 1024);
    const uint64_t bh = hopper::sw128_desc(b_hi + b_off, 16, 1024);
    const uint64_t bl = hopper::sw128_desc(b_lo + b_off, 16, 1024);
    hopper::wgmma_tf32_ss_n32(d, al, bh, kk > 0);
    hopper::wgmma_tf32_ss_n32(d, ah, bl, 1);
    hopper::wgmma_tf32_ss_n32(d, ah, bh, 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
}

// The hi halves of a warpgroup's A operand, kept in registers for the
// whole block: rows 16w .. 16w + 15 (warp w) of a 64-row tile's hi plane,
// all D columns, as tf32 fragments (wgmma_tf32_rs_n32's layout).
template <int D>
struct RowFrags {
  uint32_t h[D / 8][4];

  __device__ __forceinline__ void load(const float* xh) {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
    const int r = 16 * w + g;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[kk][e] = __float_as_uint(xh[pl<D, 64>(r + 8 * (e & 1), 8 * kk + t + 4 * (e >> 1))]);
  }
};

// dots_wgmma with A's hi half from registers (RowFrags): A_lo B_hi reads
// A's lo plane from shared memory, A_hi B_lo and A_hi B_hi only B's planes.
template <int D>
__device__ __forceinline__ void dots_wgmma_rs(const RowFrags<D>& a, const float* a_lo,
                                              const float* b_hi, const float* b_lo,
                                              float (&s)[1][4][4]) {
  float(&d)[16] = reinterpret_cast<float(&)[16]>(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    // k step kk: 32-float block kk / 4, 32 bytes into its rows per step
    const int a_off = (kk >> 2) * (64 * 32) + (kk & 3) * 8;
    const int b_off = (kk >> 2) * (32 * 32) + (kk & 3) * 8;
    const uint64_t al = hopper::sw128_desc(a_lo + a_off, 16, 1024);
    const uint64_t bh = hopper::sw128_desc(b_hi + b_off, 16, 1024);
    const uint64_t bl = hopper::sw128_desc(b_lo + b_off, 16, 1024);
    hopper::wgmma_tf32_ss_n32(d, al, bh, kk > 0);
    hopper::wgmma_tf32_rs_n32(d, a.h[kk], bl, 1);
    hopper::wgmma_tf32_rs_n32(d, a.h[kk], bh, 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
}

// dots_wgmma over the first D columns (D / 8 k steps) with A, the
// warpgroup's 64 rows, from one plain fp32 plane of DP columns
// (stage_plain): each k step's A fragment is read and split into its tf32
// hi and lo halves in registers (RowFrags' layout), kChunk steps at a time,
// and each chunk's wgmma are waited for before the next chunk's fragments
// take their registers (56 of them at 7 steps). The same products as
// dots_wgmma on planes split as they were stored.
template <int D, int DP>
__device__ __forceinline__ void dots_wgmma_split(const float* a, const float* b_hi,
                                                 const float* b_lo, float (&s)[1][4][4]) {
  constexpr int kSteps = D / 8, kChunk = 7;
  static_assert(kSteps % kChunk == 0, "whole chunks of k steps");
  float(&d)[16] = reinterpret_cast<float(&)[16]>(s);
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int r = 16 * w + g;
#pragma unroll
  for (int c0 = 0; c0 < kSteps; c0 += kChunk) {
    uint32_t h[kChunk][4], l[kChunk][4];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hopper::tf32_split(a[pl<DP, 64>(r + 8 * (e & 1), 8 * (c0 + u) + t + 4 * (e >> 1))],
                           h[u][e], l[u][e]);
    hopper::wgmma_fence();
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int kk = c0 + u;
      const int b_off = (kk >> 2) * (32 * 32) + (kk & 3) * 8;
      const uint64_t bh = hopper::sw128_desc(b_hi + b_off, 16, 1024);
      const uint64_t bl = hopper::sw128_desc(b_lo + b_off, 16, 1024);
      hopper::wgmma_tf32_rs_n32(d, l[u], bh, kk > 0);
      hopper::wgmma_tf32_rs_n32(d, h[u], bl, 1);
      hopper::wgmma_tf32_rs_n32(d, h[u], bh, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    // the chunk's fragments stay unchanged until their wgmma are done
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(h[u][e]), "+r"(l[u][e])::"memory");
  }
  hopper::fence_regs(d);
}

// The transposed products (dQ^T = K^T dS^T, dV^T = dO^T P, dK^T = (scale
// Q)^T dS) on wgmma in 3xTF32, in two steps: load takes X^T's A fragments
// into registers, run multiplies them by B^T. tf32 wgmma reads
// its shared-memory B only K-major, so B^T is the P^T, dS^T or dS planes the
// warpgroups wrote (N rows of 32 k values), and X, a 32-row tile's hi/lo
// planes (k = its 32 rows, m = its D columns), comes in as the A operand
// from registers, which may be filled from any layout: m-tile mt is X's
// columns 64 mt .. + 63, warp w's rows 16w + g (+ 8) of it, its k columns t
// (+ 4) of each k step of 8. load(.., mt0) takes m-tiles mt0 .. mt0 + MT - 1
// (the wide kernels hold one at a time).
template <int D, int MT>
struct TFrags {
  uint32_t h[MT][4][4], l[MT][4][4];

  __device__ __forceinline__ void load(const float* xh, const float* xl, int mt0 = 0) {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int r = 8 * kk + t, d = 64 * (mt0 + mt) + 16 * w + g;
        const int o[4] = {pl<D, 32>(r, d), pl<D, 32>(r, d + 8), pl<D, 32>(r + 4, d),
                          pl<D, 32>(r + 4, d + 8)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[mt][kk][e] = __float_as_uint(xh[o[e]]);
          l[mt][kk][e] = __float_as_uint(xl[o[e]]);
        }
      }
  }

  // acc[mt] += X^T B^T: acc[mt][4j + e] is (m = 64 mt + 16w + g + 8 (e / 2),
  // n = 8j + 2t + e % 2). Each m-tile's 12 wgmma of the tile sum into a fresh
  // accumulator that fp32 adds (to nearest) then add to acc: the tensor
  // cores' own accumulation rounds toward zero, a bias that over the
  // thousands of steps of a long sum (K8: rep heads x Sq queries) reached
  // 1e-4 of the max.
  template <int N>
  __device__ __forceinline__ void run(const float* bh, const float* bl,
                                      float (&acc)[MT][N / 2]) const {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float part[N / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dh = hopper::sw128_desc(bh + 8 * kk, 16, 1024);
        const uint64_t dl = hopper::sw128_desc(bl + 8 * kk, 16, 1024);
        if constexpr (N == 32) {
          hopper::wgmma_tf32_rs_n32(part, l[mt][kk], dh, kk > 0);
          hopper::wgmma_tf32_rs_n32(part, h[mt][kk], dl, 1);
          hopper::wgmma_tf32_rs_n32(part, h[mt][kk], dh, 1);
        } else {
          hopper::wgmma_tf32_rs_n64(part, l[mt][kk], dh, kk > 0);
          hopper::wgmma_tf32_rs_n64(part, h[mt][kk], dl, 1);
          hopper::wgmma_tf32_rs_n64(part, h[mt][kk], dh, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[mt][i] += part[i];
    }
  }
};

// A warp's 16 x 32 accumulator-layout tile (rows r0 + g (+ 8), columns 8j +
// 2t (+ 1)) split into the hi/lo planes of a 32-column tile of R rows, the
// B side of a later TFrags::run.
template <int R>
__device__ __forceinline__ void put_planes(float* hi, float* lo, int r0,
                                           const float (&x)[1][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = pl<32, R>(r0 + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1));
      uint32_t h, l;
      hopper::tf32_split(x[0][j][e], h, l);
      hi[o] = __uint_as_float(h);
      lo[o] = __uint_as_float(l);
    }
}

// A warp's 16 x 32 tile to and from its group's exchange tile, in fragment
// order (value v of lane L at v * 32 + L): both warps of a group hold the
// same (row, key) positions, so each reads its partner's values for its own.
__device__ __forceinline__ void put_tile(float* xs, const float (&x)[1][4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < 16; ++v) xs[v * 32 + lane] = x[0][v / 4][v % 4];
}

__device__ __forceinline__ void get_tile(const float* xs, float (&x)[1][4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < 16; ++v) x[0][v / 4][v % 4] = xs[v * 32 + lane];
}

// The block's shared memory, 1024-byte aligned for the swizzled planes.
__device__ __forceinline__ float* tc_smem(float4* raw) {
  return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                  ~(uintptr_t)1023);
}

// Named barriers (0 is __syncthreads). In K7 warpgroup 0 arrives and
// warpgroup 1 waits on kPlanesReady (a key tile's K and V planes are
// stored) and kPReady (its P is in the exchange tiles; in the bf16 K8, P^T
// is in the exchange tile); warpgroup 1 arrives
// and warpgroup 0 waits on kPlanesFree (warpgroup 1 has read the tile's V
// planes, P, and K as its A fragments). kStored (K7's warpgroup 0) and
// kDsStored (K7's and K8's warpgroup 1) are one warpgroup's own: its
// stores are done before its wgmma reads them.
constexpr int kPlanesReady = 1, kPReady = 2, kPlanesFree = 3, kStored = 4, kDsStored = 5;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One m-tile of an accumulator in the transposed layout (acc[4j + e]: d =
// 64 mt + 16 grp + g + 8 (e / 2), row 8j + 2t + e % 2) times mul, into rows
// [0, n_rows) of a (rows, dg) slice at out, row stride ostride elements.
__device__ __forceinline__ void store_t(float* out, long long ostride, const float (&acc)[32],
                                        int mt, int n_rows, int dg, float mul) {
  const int lane = threadIdx.x & 31, grp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int r = 8 * j + 2 * t + e1;
      if (r >= n_rows) continue;
      float* o = out + r * ostride + 64 * mt + 16 * grp + g;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
        if (64 * mt + 16 * grp + g + 8 * e2 < dg) o[8 * e2] = acc[4 * j + 2 * e2 + e1] * mul;
    }
}

// K7 on the tensor cores: grid (Sq tiles of 64, H, B), heaviest tiles first
// (block x walks query tile nq - 1 - x). The two warpgroups work as a
// pipeline over the 32-key tiles. Warpgroup 0 splits tile i's K and V
// (loaded into its registers during tile i - 1) into their planes,
// computes S = (scale Q) K^T on wgmma and P, and passes P from warp w to
// warp w of warpgroup 1 through their exchange tile. Warpgroup 1 computes
// dP = dO V^T on wgmma and dS = P (dP - delta) into the dS planes, takes
// K^T's A fragments into registers, releases the tile, and adds K^T dS^T
// to dQ^T (the block's 64 rows, all of D) while warpgroup 0 goes on to
// tile i + 1. Shared memory: the block's Q and dO and the tile's K and V
// as hi/lo planes, the dS planes, the exchange tiles, the rows' lse and
// delta.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int dg,
                       int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* q_hi = tc_smem(smem4);
  float* q_lo = q_hi + kDqRows * D;
  float* do_hi = q_lo + kDqRows * D;
  float* do_lo = do_hi + kDqRows * D;
  float* k_hi = do_lo + kDqRows * D;
  float* k_lo = k_hi + kDqKeys * D;
  float* v_hi = k_lo + kDqKeys * D;
  float* v_lo = v_hi + kDqKeys * D;
  float* ds_hi = v_lo + kDqKeys * D;                // 64 rows x 32 keys
  float* ds_lo = ds_hi + kDqRows * kDqKeys;
  float* xs_all = ds_lo + kDqRows * kDqKeys;        // 4 groups x 16 x 32
  float* lse_s = xs_all + 2048;
  float* dl_s = lse_s + kDqRows;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int grp = warp & 3, role = warp >> 2;
  const long long q_row = (long long)H * dg, k_row = (long long)Hkv * dg;
  const int n_q = min(kDqRows, Sq - q0);
  const long long q_off = ((long long)b * Sq + q0) * q_row + (long long)h * dg;

  // key tiles [t_lo, t_lo + n_tiles) of 32: the keys the block's rows can see
  const int q_last = q0 + n_q - 1;
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int key_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int t_lo = key_lo / kDqKeys;
  const int n_tiles = max(0, (key_hi + kDqKeys - 1) / kDqKeys - t_lo);

  stage_global<D, kDqRows>(q_hi, q_lo, q + q_off, q_row, n_q, dg, scale);
  stage_global<D, kDqRows>(do_hi, do_lo, dout + q_off, q_row, n_q, dg, 1.f);
  const long long row_off = ((long long)b * H + h) * Sq + q0;
  if (tid < kDqRows) {
    lse_s[tid] = tid < n_q ? lse[row_off + tid] : 0.f;
    dl_s[tid] = tid < n_q ? delta[row_off + tid] : 0.f;
  }
  hopper::fence_proxy_async();
  __syncthreads();

  float* xs = xs_all + grp * 512;
  const int row = 16 * grp + g;                     // this thread's rows: row, row + 8
  if (role == 0) {
    const float* k_g = k + (long long)b * Sk * k_row + (long long)hk * dg;
    const float* v_g = v + (long long)b * Sk * k_row + (long long)hk * dg;
    Prefetch<D, 128> next;
    RowFrags<D> qa;                                 // (scale Q)'s hi half, for the whole block
    qa.load(q_hi);
    auto fetch = [&](int i) {
      const int k0 = (t_lo + i) * kDqKeys;
      next.load(k_g + k0 * k_row, v_g + k0 * k_row, k_row, Sk - k0, dg);
    };
    if (n_tiles > 0) fetch(0);
    for (int i = 0; i < n_tiles; ++i) {
      if (i > 0) bar_sync(kPlanesFree, kTcThreads);   // warpgroup 1 is done with tile i - 1
      next.store(k_hi, k_lo, 1.f, v_hi, v_lo);
      hopper::fence_proxy_async();
      bar_sync(kStored, 128);
      bar_arrive(kPlanesReady, kTcThreads);
      if (i + 1 < n_tiles) fetch(i + 1);
      const int k0 = (t_lo + i) * kDqKeys;
      float s[1][4][4];
      dots_wgmma_rs<D>(qa, q_lo, k_hi, k_lo, s);      // S
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + 8 * (e >> 1);
          const bool ok =
              valid_pair(q0 + r, k0 + 8 * j + 2 * t + (e & 1), Sq, Sk, causal, window);
          // explicit mask: a row with no valid key has lse ~ -1e30
          s[0][j][e] = ok ? expf(s[0][j][e] - lse_s[r]) : 0.f;
        }
      put_tile(xs, s);                    // P
      bar_arrive(kPReady, kTcThreads);
    }
    return;
  }

  float acc[D / 64][32];                            // dQ^T: D x the block's 64 rows
#pragma unroll
  for (int mt = 0; mt < D / 64; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    bar_sync(kPlanesReady, kTcThreads);
    float s[1][4][4], p[1][4][4];
    dots_wgmma<D>(do_hi, do_lo, v_hi, v_lo, s);     // dP
    TFrags<D, D / 64> kt;                           // K^T, dQ^T's A operand
    kt.load(k_hi, k_lo);
    bar_sync(kPReady, kTcThreads);
    get_tile(xs, p);
    if (i + 1 < n_tiles) bar_arrive(kPlanesFree, kTcThreads);   // V, K and P are read
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[0][j][e] = p[0][j][e] * (s[0][j][e] - dl_s[row + 8 * (e >> 1)]);
    put_planes<kDqRows>(ds_hi, ds_lo, 16 * grp, s);   // dS
    hopper::fence_proxy_async();
    bar_sync(kDsStored, 128);
    kt.template run<64>(ds_hi, ds_lo, acc);         // dQ^T += K^T dS^T
  }

#pragma unroll
  for (int mt = 0; mt < D / 64; ++mt) store_t(dq + q_off, q_row, acc[mt], mt, n_q, dg, scale);
}

// K8's blocks (every K8 kernel): a 1-D grid over units (key tile of 64,
// batch, KV head), key tile slowest, so every (b, hk) of key tile 0 (the
// heaviest under the causal mask) launches first (longest-processing-time
// order). Without a split a block is a unit and walks the rep query heads
// of its group in turn, the GQA sum in its registers. Where that leaves
// SMs idle (fewer units than SMs: the smoke configs' B 8 x S 64 makes 16;
// flash_attention.dkv_split, a function of the shape and the SM count),
// the kernels' kSplit instances give each head of the group a block of
// its own, the unit's rep blocks adjacent, and dkv_combine sums their
// partials (a template flag, so the walk's instance keeps its registers).
struct DkvBlock {
  int unit, k0, b, hk, r0, nh;            // the heads walked: r0 .. r0 + nh - 1 of the group
};

__device__ __forceinline__ DkvBlock dkv_block(int keys, int B, int Hkv, int rep, bool split) {
  const int unit = split ? blockIdx.x / rep : blockIdx.x, n_bh = B * Hkv;
  return {unit, (unit / n_bh) * keys, (unit % n_bh) / Hkv, unit % Hkv,
          split ? (int)(blockIdx.x % rep) : 0, split ? 1 : rep};
}

// The split K8's end, in every thread of the block: its head's partial
// sums x (fp32, in the thread's own register order) go to the head's slice
// of ws in float4s, thread-fastest (coalesced), and the unit's last block
// to arrive (a counter per unit, which it leaves at zero) reads the rep
// slices from L2 and returns true with x their sum, taken in head order:
// the same bits whichever block is last. Every block of a launch maps its
// threads to the accumulators alike, so thread t reads only what thread t
// of each block wrote. One thread fences and counts for the block, after
// the block's barrier (the pattern of a cooperative grid barrier).
template <int N>
__device__ __forceinline__ bool dkv_combine(float (&x)[N], float* __restrict__ ws,
                                            int* __restrict__ counters, const DkvBlock& blk,
                                            int rep) {
  static_assert(N % 4 == 0, "whole float4s a thread");
  constexpr int kSlice = N / 4 * kTcThreads;        // float4s of a head's partials
  __shared__ int last;
  float4* mine = reinterpret_cast<float4*>(ws) + ((long long)blk.unit * rep + blk.r0) * kSlice +
                 threadIdx.x;
#pragma unroll
  for (int v = 0; v < N / 4; ++v)
    mine[v * kTcThreads] = make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counters + blk.unit, 1) == rep - 1;
    if (last) counters[blk.unit] = 0;
    __threadfence();
  }
  __syncthreads();
  if (!last) return false;
  // a head's slice at a time, the thread's N / 4 loads of it in flight together
  const float4* all =
      reinterpret_cast<const float4*>(ws) + (long long)blk.unit * rep * kSlice + threadIdx.x;
  for (int r = 0; r < rep; ++r) {
#pragma unroll
    for (int v = 0; v < N / 4; ++v) {
      const float4 y = __ldcg(all + r * kSlice + v * kTcThreads);
      x[4 * v] = r ? x[4 * v] + y.x : y.x;
      x[4 * v + 1] = r ? x[4 * v + 1] + y.y : y.y;
      x[4 * v + 2] = r ? x[4 * v + 2] + y.z : y.z;
      x[4 * v + 3] = r ? x[4 * v + 3] + y.w : y.w;
    }
  }
  return true;
}

// K8 on the tensor cores, D = 64 or 128: K8's grid (dkv_block).
// Warpgroup 0 computes S^T = K (scale Q)^T and P^T, warpgroup 1 dP^T = V
// dO^T, each on wgmma from the planes; P^T goes into hi/lo planes, from
// which warpgroup 1 takes it for dS^T = P^T (dP^T - delta) and its own
// planes; then warpgroup 0 adds dO^T P to dV^T and warpgroup 1 (scale Q)^T
// dS to dK^T (TFrags), each for all D rows and the block's 64 keys.
// Shared memory: the block's K and V (resident) and the current 32-query
// tile's Q and dO as hi/lo planes, the P^T and dS^T planes, the tile's lse
// and delta rows. The block walks its heads and their query tiles in
// order, dV^T or dK^T in each warpgroup's registers; the next tile loads
// into registers during this tile's math.
template <int D, bool kSplit>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int B, int Sq, int Sk,
                        int H, int Hkv, int dg, int causal, int window, float scale,
                        float* __restrict__ ws, int* __restrict__ counters) {
  extern __shared__ float4 smem4[];
  float* k_hi = tc_smem(smem4);
  float* k_lo = k_hi + kDkvKeys * D;
  float* v_hi = k_lo + kDkvKeys * D;
  float* v_lo = v_hi + kDkvKeys * D;
  float* q_hi = v_lo + kDkvKeys * D;
  float* q_lo = q_hi + kDkvRows * D;
  float* do_hi = q_lo + kDkvRows * D;
  float* do_lo = do_hi + kDkvRows * D;
  float* pt_hi = do_lo + kDkvRows * D;              // 64 keys x 32 queries
  float* pt_lo = pt_hi + kDkvKeys * kDkvRows;
  float* st_hi = pt_lo + kDkvKeys * kDkvRows;
  float* st_lo = st_hi + kDkvKeys * kDkvRows;
  float* lse_s = st_lo + kDkvKeys * kDkvRows;
  float* dl_s = lse_s + kDkvRows;

  const int rep = H / Hkv;
  const DkvBlock blk = dkv_block(kDkvKeys, B, Hkv, rep, kSplit);
  const int k0 = blk.k0, b = blk.b, hk = blk.hk;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int grp = warp & 3, role = warp >> 2;
  const long long q_row = (long long)H * dg, k_row = (long long)Hkv * dg;
  const int n_k = min(kDkvKeys, Sk - k0);
  const long long k_off = ((long long)b * Sk + k0) * k_row + (long long)hk * dg;

  // query tiles [qt_lo, qt_lo + n_qt) of 32 that can see a key of the
  // block, for each of its heads: tile i is head r0 + i / n_qt's tile i % n_qt
  const int k_last = k0 + n_k - 1;
  const int qry_lo = causal ? k0 : 0;
  const int qry_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int qt_lo = qry_lo / kDkvRows;
  const int n_qt = max(0, (qry_hi + kDkvRows - 1) / kDkvRows - qt_lo);
  const int n_tiles = blk.nh * n_qt;
  Prefetch<D, kTcThreads> next;
  float next_row = 0.f;                   // lse (threads 0-31) or delta (32-63) of a query row
  auto fetch = [&](int i) {
    const int h = hk * rep + blk.r0 + i / n_qt, q0 = (qt_lo + i % n_qt) * kDkvRows;
    const long long q_off = ((long long)b * Sq + q0) * q_row + (long long)h * dg;
    next.load(q + q_off, dout + q_off, q_row, Sq - q0, dg);
    if (tid < 2 * kDkvRows) {
      const int r = tid % kDkvRows;
      next_row = q0 + r < Sq
                     ? (tid < kDkvRows ? lse : delta)[((long long)b * H + h) * Sq + q0 + r]
                     : 0.f;
    }
  };
  if (n_tiles > 0) fetch(0);
  stage_global<D, kDkvKeys>(k_hi, k_lo, k + k_off, k_row, n_k, dg, 1.f);
  stage_global<D, kDkvKeys>(v_hi, v_lo, v + k_off, k_row, n_k, dg, 1.f);

  const int key = 16 * grp + g;                     // this thread's keys: key, key + 8
  float acc[D / 64][32];                            // dV^T (role 0) or dK^T (role 1): D x 64 keys
#pragma unroll
  for (int mt = 0; mt < D / 64; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    __syncthreads();                      // the last tile's readers of the planes are done
    next.store(q_hi, q_lo, scale, do_hi, do_lo);
    if (tid < 2 * kDkvRows) lse_s[tid] = next_row;   // lse, then delta
    hopper::fence_proxy_async();          // the planes' stores, before wgmma reads them
    __syncthreads();                      // tile i's planes are ready
    if (i + 1 < n_tiles) fetch(i + 1);
    const int q0 = (qt_lo + i % n_qt) * kDkvRows;

    // transposed scores: rows are the warpgroup's 64 keys, columns the tile's queries
    float s[1][4][4];                     // S^T (role 0) or dP^T (role 1)
    if (role == 0) {
      dots_wgmma<D>(k_hi, k_lo, q_hi, q_lo, s);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = 8 * j + 2 * t + (e & 1);
          const bool ok = valid_pair(q0 + qq, k0 + key + 8 * (e >> 1), Sq, Sk, causal, window);
          s[0][j][e] = ok ? expf(s[0][j][e] - lse_s[qq]) : 0.f;
        }
      put_planes<kDkvKeys>(pt_hi, pt_lo, 16 * grp, s);  // P^T
      hopper::fence_proxy_async();
      __syncthreads();                    // P^T is in its planes
      TFrags<D, D / 64> dot;
      dot.load(do_hi, do_lo);
      dot.template run<64>(pt_hi, pt_lo, acc);      // dV^T += dO^T P
    } else {
      dots_wgmma<D>(v_hi, v_lo, do_hi, do_lo, s);
      __syncthreads();                    // P^T is in its planes
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = pl<32, kDkvKeys>(key + 8 * (e >> 1), 8 * j + 2 * t + (e & 1));
          s[0][j][e] = (pt_hi[o] + pt_lo[o]) * (s[0][j][e] - dl_s[8 * j + 2 * t + (e & 1)]);
        }
      put_planes<kDkvKeys>(st_hi, st_lo, 16 * grp, s);  // dS^T
      hopper::fence_proxy_async();
      bar_sync(kDsStored, 128);           // warpgroup 1's dS^T is in its planes
      TFrags<D, D / 64> qt;
      qt.load(q_hi, q_lo);
      qt.template run<64>(st_hi, st_lo, acc);       // dK^T += (scale Q)^T dS
    }
  }

  if constexpr (kSplit) {
    if (!dkv_combine(reinterpret_cast<float(&)[D / 64 * 32]>(acc), ws, counters, blk, rep)) return;
  }
#pragma unroll
  for (int mt = 0; mt < D / 64; ++mt)
    store_t((role ? dk : dv) + k_off, k_row, acc[mt], mt, n_k, dg, 1.f);
}

// ---------------------------------------------------------------------------
// K7 and K8 at head dim 168 on the tensor cores: the 3xTF32 kernels' walks
// and numerics on planes of 192 columns, the register-only operands plain
// ---------------------------------------------------------------------------

// K7 at D = 168 (planes of DP = 192 columns): flash_bwd_dq_tc_kernel's grid,
// 64-row blocks, 32-key tiles and numerics. Its hi/lo planes would take
// 320,000 bytes here, so Q (scaled) and dO, which enter wgmma only as the
// A operands of S and dP, stay one plain fp32 plane each, split as they
// are read (dots_wgmma_split): 221,696 bytes. The warpgroups work each
// tile in step: all 256 threads store the tile's K and V planes (loaded
// into registers during the tile before); warpgroup 0 computes S = (scale
// Q) K^T and P and passes P through the exchange tiles, warpgroup 1 dP =
// dO V^T and dS = P (dP - delta) into the dS planes; then dQ^T += K^T dS^T,
// its three 64-row m-tiles of D shared out (0 and 2 to warpgroup 0, 1 to
// warpgroup 1), each taking K^T's fragments of one m-tile at a time.
// Registers a thread: the next tile's K and V (48), dQ^T (64), then S
// (16) and a chunk of A fragments (56), or one m-tile's fragments (32) and
// its fresh accumulator (32).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int dg,
                            int causal, int window, float scale) {
  constexpr int DP = padded_dim(D);
  extern __shared__ float4 smem4[];
  float* q_f = tc_smem(smem4);
  float* do_f = q_f + kDqRows * DP;
  float* k_hi = do_f + kDqRows * DP;
  float* k_lo = k_hi + kDqKeys * DP;
  float* v_hi = k_lo + kDqKeys * DP;
  float* v_lo = v_hi + kDqKeys * DP;
  float* ds_hi = v_lo + kDqKeys * DP;               // 64 rows x 32 keys
  float* ds_lo = ds_hi + kDqRows * kDqKeys;
  float* xs_all = ds_lo + kDqRows * kDqKeys;        // 4 groups x 16 x 32
  float* lse_s = xs_all + 2048;
  float* dl_s = lse_s + kDqRows;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int grp = warp & 3, role = warp >> 2;
  const long long q_row = (long long)H * dg, k_row = (long long)Hkv * dg;
  const int n_q = min(kDqRows, Sq - q0);
  const long long q_off = ((long long)b * Sq + q0) * q_row + (long long)h * dg;

  // key tiles [t_lo, t_lo + n_tiles) of 32: the keys the block's rows can see
  const int q_last = q0 + n_q - 1;
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int key_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int t_lo = key_lo / kDqKeys;
  const int n_tiles = max(0, (key_hi + kDqKeys - 1) / kDqKeys - t_lo);

  const float* k_g = k + (long long)b * Sk * k_row + (long long)hk * dg;
  const float* v_g = v + (long long)b * Sk * k_row + (long long)hk * dg;
  Prefetch<DP, kTcThreads> next;
  auto fetch = [&](int i) {
    const int k0 = (t_lo + i) * kDqKeys;
    next.load(k_g + k0 * k_row, v_g + k0 * k_row, k_row, Sk - k0, dg);
  };
  if (n_tiles > 0) fetch(0);
  stage_plain<DP, kDqRows>(q_f, q + q_off, q_row, n_q, dg, scale);
  stage_plain<DP, kDqRows>(do_f, dout + q_off, q_row, n_q, dg, 1.f);
  const long long row_off = ((long long)b * H + h) * Sq + q0;
  if (tid < kDqRows) {
    lse_s[tid] = tid < n_q ? lse[row_off + tid] : 0.f;
    dl_s[tid] = tid < n_q ? delta[row_off + tid] : 0.f;
  }

  float* xs = xs_all + grp * 512;
  const int row = 16 * grp + g;                     // this thread's rows: row, row + 8
  const int n_mt = role == 0 ? 2 : 1;               // dQ^T's m-tiles here: 2x (role 0) or 1
  float acc[2][32];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    __syncthreads();                      // the last tile's readers of the planes are done
    next.store(k_hi, k_lo, 1.f, v_hi, v_lo);
    hopper::fence_proxy_async();          // the planes' stores, before wgmma reads them
    __syncthreads();                      // tile i's K and V planes are ready
    if (i + 1 < n_tiles) fetch(i + 1);
    const int k0 = (t_lo + i) * kDqKeys;
    float s[1][4][4];
    if (role == 0) {
      dots_wgmma_split<D, DP>(q_f, k_hi, k_lo, s);   // S
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + 8 * (e >> 1);
          const bool ok =
              valid_pair(q0 + r, k0 + 8 * j + 2 * t + (e & 1), Sq, Sk, causal, window);
          // explicit mask: a row with no valid key has lse ~ -1e30
          s[0][j][e] = ok ? expf(s[0][j][e] - lse_s[r]) : 0.f;
        }
      put_tile(xs, s);                    // P
      bar_arrive(kPReady, kTcThreads);
    } else {
      dots_wgmma_split<D, DP>(do_f, v_hi, v_lo, s);  // dP
      float p[1][4][4];
      bar_sync(kPReady, kTcThreads);
      get_tile(xs, p);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[0][j][e] = p[0][j][e] * (s[0][j][e] - dl_s[row + 8 * (e >> 1)]);
      put_planes<kDqRows>(ds_hi, ds_lo, 16 * grp, s);   // dS
    }
    hopper::fence_proxy_async();
    __syncthreads();                      // dS is in its planes
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (x >= n_mt) break;
      TFrags<DP, 1> kt;                   // K^T's m-tile, dQ^T's A operand
      kt.load(k_hi, k_lo, role == 0 ? 2 * x : 1);
      kt.template run<64>(ds_hi, ds_lo, reinterpret_cast<float(&)[1][32]>(acc[x]));
    }
  }

#pragma unroll
  for (int x = 0; x < 2; ++x)
    if (x < n_mt)
      store_t(dq + q_off, q_row, acc[x], role == 0 ? 2 * x : 1, n_q, dg, scale);
}

// K8 at D = 168 (planes of DP = 192 columns): K8's grid (dkv_block) and
// flash_bwd_dkv_tc_kernel's roles, 32-query tiles and numerics. Its hi/lo
// planes would take 327,936 bytes here, so K and V, which enter wgmma only
// as the A operands of S^T and dP^T, stay one plain fp32 plane each (64
// keys), split as they are read (dots_wgmma_split): 229,632 bytes. Each
// tile's Q and dO are loaded into registers before the tile's first
// barrier (no tile ahead: registers), split and stored; the products over
// the queries take dO^T's or Q^T's fragments one m-tile at a time.
// Registers a thread: dV^T or dK^T (96), then S^T (16) and a chunk of A
// fragments (56), or one m-tile's fragments (32) and its fresh accumulator
// (32); the tile's Q and dO (48) while dV^T or dK^T alone is live.
template <int D, bool kSplit>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int B, int Sq,
                             int Sk, int H, int Hkv, int dg, int causal, int window, float scale,
                             float* __restrict__ ws, int* __restrict__ counters) {
  constexpr int DP = padded_dim(D), MT = DP / 64;
  extern __shared__ float4 smem4[];
  float* k_f = tc_smem(smem4);
  float* v_f = k_f + kDkvKeys * DP;
  float* q_hi = v_f + kDkvKeys * DP;
  float* q_lo = q_hi + kDkvRows * DP;
  float* do_hi = q_lo + kDkvRows * DP;
  float* do_lo = do_hi + kDkvRows * DP;
  float* pt_hi = do_lo + kDkvRows * DP;             // 64 keys x 32 queries
  float* pt_lo = pt_hi + kDkvKeys * kDkvRows;
  float* st_hi = pt_lo + kDkvKeys * kDkvRows;
  float* st_lo = st_hi + kDkvKeys * kDkvRows;
  float* lse_s = st_lo + kDkvKeys * kDkvRows;
  float* dl_s = lse_s + kDkvRows;

  const int rep = H / Hkv;
  const DkvBlock blk = dkv_block(kDkvKeys, B, Hkv, rep, kSplit);
  const int k0 = blk.k0, b = blk.b, hk = blk.hk;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int grp = warp & 3, role = warp >> 2;
  const long long q_row = (long long)H * dg, k_row = (long long)Hkv * dg;
  const int n_k = min(kDkvKeys, Sk - k0);
  const long long k_off = ((long long)b * Sk + k0) * k_row + (long long)hk * dg;

  // query tiles [qt_lo, qt_lo + n_qt) of 32 that can see a key of the
  // block, for each of its heads: tile i is head r0 + i / n_qt's tile i % n_qt
  const int k_last = k0 + n_k - 1;
  const int qry_lo = causal ? k0 : 0;
  const int qry_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int qt_lo = qry_lo / kDkvRows;
  const int n_qt = max(0, (qry_hi + kDkvRows - 1) / kDkvRows - qt_lo);
  const int n_tiles = blk.nh * n_qt;
  stage_plain<DP, kDkvKeys>(k_f, k + k_off, k_row, n_k, dg, 1.f);
  stage_plain<DP, kDkvKeys>(v_f, v + k_off, k_row, n_k, dg, 1.f);

  const int key = 16 * grp + g;                     // this thread's keys: key, key + 8
  float acc[MT][32];                                // dV^T (role 0) or dK^T (role 1): DP x 64 keys
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int h = hk * rep + blk.r0 + i / n_qt, q0 = (qt_lo + i % n_qt) * kDkvRows;
    const long long q_off = ((long long)b * Sq + q0) * q_row + (long long)h * dg;
    Prefetch<DP, kTcThreads> cur;
    cur.load(q + q_off, dout + q_off, q_row, Sq - q0, dg);
    float row_in = 0.f;                   // lse (threads 0-31) or delta (32-63) of a query row
    if (tid < 2 * kDkvRows) {
      const int r = tid % kDkvRows;
      row_in = q0 + r < Sq ? (tid < kDkvRows ? lse : delta)[((long long)b * H + h) * Sq + q0 + r]
                           : 0.f;
    }
    __syncthreads();                      // the last tile's readers of the planes are done
    cur.store(q_hi, q_lo, scale, do_hi, do_lo);
    if (tid < 2 * kDkvRows) lse_s[tid] = row_in;     // lse, then delta
    hopper::fence_proxy_async();          // the planes' stores, before wgmma reads them
    __syncthreads();                      // tile i's planes are ready

    // transposed scores: rows are the warpgroup's 64 keys, columns the tile's queries
    float s[1][4][4];                     // S^T (role 0) or dP^T (role 1)
    if (role == 0) {
      dots_wgmma_split<D, DP>(k_f, q_hi, q_lo, s);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = 8 * j + 2 * t + (e & 1);
          const bool ok = valid_pair(q0 + qq, k0 + key + 8 * (e >> 1), Sq, Sk, causal, window);
          s[0][j][e] = ok ? expf(s[0][j][e] - lse_s[qq]) : 0.f;
        }
      put_planes<kDkvKeys>(pt_hi, pt_lo, 16 * grp, s);  // P^T
      hopper::fence_proxy_async();
      __syncthreads();                    // P^T is in its planes
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        TFrags<DP, 1> dot;
        dot.load(do_hi, do_lo, mt);
        // dV^T += dO^T P
        dot.template run<64>(pt_hi, pt_lo, reinterpret_cast<float(&)[1][32]>(acc[mt]));
      }
    } else {
      dots_wgmma_split<D, DP>(v_f, do_hi, do_lo, s);
      __syncthreads();                    // P^T is in its planes
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = pl<32, kDkvKeys>(key + 8 * (e >> 1), 8 * j + 2 * t + (e & 1));
          s[0][j][e] = (pt_hi[o] + pt_lo[o]) * (s[0][j][e] - dl_s[8 * j + 2 * t + (e & 1)]);
        }
      put_planes<kDkvKeys>(st_hi, st_lo, 16 * grp, s);  // dS^T
      hopper::fence_proxy_async();
      bar_sync(kDsStored, 128);           // warpgroup 1's dS^T is in its planes
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        TFrags<DP, 1> qt;
        qt.load(q_hi, q_lo, mt);
        // dK^T += (scale Q)^T dS
        qt.template run<64>(st_hi, st_lo, reinterpret_cast<float(&)[1][32]>(acc[mt]));
      }
    }
  }

  if constexpr (kSplit) {
    if (!dkv_combine(reinterpret_cast<float(&)[MT * 32]>(acc), ws, counters, blk, rep)) return;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_t((role ? dk : dv) + k_off, k_row, acc[mt], mt, n_k, dg, 1.f);
}

// ---------------------------------------------------------------------------
// K6 and K10 on the tensor cores with fp32 q: the 3xTF32 split
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;            // query rows a block: 64 a warpgroup, 16 a warp
constexpr int kFwdKeys = 32;             // keys a streamed tile

// floats of shared memory past the 1024-byte alignment: Q's lo planes (two
// warpgroups x 64 rows, scaled) and `stages` buffers of a tile's
// kFwdPlanes planes (each 128 x the padded dim, as Q's planes). Q's hi
// planes pass through the last buffer on their way into registers.
__host__ __device__ constexpr int fwd_smem_floats(int D, int stages) {
  return (1 + stages) * 128 * padded_dim(D);
}

// The forward's buffers of tile planes: two (tile i + 1 lands during tile
// i) where they fit beside Q, else one (D = 168: 295,936 bytes with two,
// 197,632 with one), refilled after both warpgroups are done with it.
__host__ __device__ constexpr int fwd_stages(int D) {
  return 1024 + 4 * fwd_smem_floats(D, 2) <= kMaxSmem ? 2 : 1;
}

// The slot of key kk (0-31) of a tile in the V^T planes: within each k step
// of 8, slot t holds key 2t and slot t + 4 key 2t + 1, so that S's
// accumulator fragment (columns 2t, 2t + 1) is P's tf32 A fragment (k t,
// t + 4) as it stands.
__device__ __forceinline__ int vt_slot(int kk) {
  return (kk & ~7) | ((kk & 1) << 2) | ((kk & 7) >> 1);
}

// The forward's K and V planes, split once per call by
// flash_fwd_split_kernel into a workspace that every query block of the
// KV head reads: for each (batch, KV head, 32-key tile) kFwdPlanes planes
// of 32 x D floats, K hi and lo (32 rows of D, pl<D, 32>) and V^T hi and lo
// (D rows of 32 slots, pl<32, D>, key kk at slot vt_slot(kk)), keys at and
// past Sk zeros. Their bytes are those of the forward's shared-memory
// tiles, so a block copies a tile's planes as they lie.
constexpr int kFwdPlanes = 4;

// Keys [0, 32) of a tile of K and V as stored (fp32, or int8 codes times
// their row's fp32 scale: k_scale / v_scale, stride sstride), rows at and
// past n_valid zeros, widened to fp32, split and stored into the tile's
// planes (see kFwdPlanes) at `planes`. Thread x moves key x % 32's 4-column
// chunks x / 32 + 8u of K and of V, so a warp's scalar V^T stores (one
// column, 32 keys) fill one 128-byte row.
template <typename T, int D>
__device__ __forceinline__ void split_tile(const T* k_g, const T* v_g, long long gstride,
                                           int n_valid, int dg, const float* k_scale,
                                           const float* v_scale, long long sstride,
                                           float* planes) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  constexpr int kPlane = kFwdKeys * D;
  const int key = threadIdx.x & 31, w = threadIdx.x >> 5, slot = vt_slot(key);
  const bool ok = key < n_valid;
  float ks = 1.f, vs = 1.f;
  if constexpr (kScaled) {
    ks = ok ? k_scale[key * sstride] : 0.f;
    vs = ok ? v_scale[key * sstride] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < D / 32; ++u) {
    const int c = 4 * (w + 8 * u);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (ok && c < dg) {
      x = mul4(to_f32x4(ld_raw4(k_g + key * gstride + c)), ks);
      y = mul4(to_f32x4(ld_raw4(v_g + key * gstride + c)), vs);
    }
    uint4 h, l;
    split4(x, h, l);
    const int o = pl<D, 32>(key, c);
    *reinterpret_cast<uint4*>(planes + o) = h;
    *reinterpret_cast<uint4*>(planes + kPlane + o) = l;
    split4(y, h, l);
    const uint32_t hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ot = 2 * kPlane + pl<32, D>(c + e, slot);
      planes[ot] = __uint_as_float(hs[e]);
      planes[kPlane + ot] = __uint_as_float(ls[e]);
    }
  }
}

// The pre-pass of K6 and K10 with fp32 q: one block of 256 threads a
// (batch, KV head, 32-key tile), tile fastest, into the workspace `ws`.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_split_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                       float* __restrict__ ws, int Sk, int Hkv, int dg) {
  const int n_kt = (Sk + kFwdKeys - 1) / kFwdKeys;
  const int bh = blockIdx.x / n_kt, k0 = (blockIdx.x % n_kt) * kFwdKeys;
  const int b = bh / Hkv, hk = bh % Hkv;
  const long long k_row = (long long)Hkv * dg;
  const long long off = ((long long)b * Sk + k0) * k_row + (long long)hk * dg;
  const long long s0 = ((long long)b * Sk + k0) * Hkv + hk;
  split_tile<T, D>(k + off, v + off, k_row, Sk - k0, dg, k_scale ? k_scale + s0 : nullptr,
                   v_scale ? v_scale + s0 : nullptr, Hkv,
                   ws + (long long)blockIdx.x * kFwdPlanes * kFwdKeys * D);
}

// P's hi and lo halves as the tf32 A fragments of P V's four k steps: P is
// the warp's 16 rows x 32 keys in S's accumulator layout, and k step j's
// a0..a3 are P's (row g, key 8j + 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t
// + 1), the slots t and t + 4 of the V^T planes (vt_slot).
struct PFrags {
  uint32_t h[4][4], l[4][4];

  __device__ __forceinline__ void split(const float (&p)[1][4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x[4] = {p[0][j][0], p[0][j][2], p[0][j][1], p[0][j][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) hopper::tf32_split(x[e], h[j][e], l[j][e]);
    }
  }

  // Keeps the registers live and unchanged up to here: a wgmma that reads
  // them as its A operand may read them until it completes, so call after
  // its wgmma_wait.
  __device__ __forceinline__ void hold() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(h[j][e]), "+r"(l[j][e])::"memory");
  }
};

// part = P V for N (64 or 32) columns of D over one key tile, on wgmma
// m64nNk8 in 3xTF32 from zero, V^T's N rows of those columns from its
// hi/lo planes; waited for. part[4j + e] is (row g + 8 (e / 2), column 8j +
// 2t + e % 2) of the N.
template <int N>
__device__ __forceinline__ void pv_wgmma(const PFrags& p, const float* vt_hi,
                                         const float* vt_lo, float (&part)[N / 2]) {
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t dh = hopper::sw128_desc(vt_hi + 8 * j, 16, 1024);
    const uint64_t dl = hopper::sw128_desc(vt_lo + 8 * j, 16, 1024);
    if constexpr (N == 64) {
      hopper::wgmma_tf32_rs_n64(part, p.l[j], dh, j > 0);
      hopper::wgmma_tf32_rs_n64(part, p.h[j], dl, 1);
      hopper::wgmma_tf32_rs_n64(part, p.h[j], dh, 1);
    } else {
      hopper::wgmma_tf32_rs_n32(part, p.l[j], dh, j > 0);
      hopper::wgmma_tf32_rs_n32(part, p.h[j], dl, 1);
      hopper::wgmma_tf32_rs_n32(part, p.h[j], dh, 1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(part);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// K6 (kSaveLse) and K10 with fp32 q: grid (Sq tiles of 128, H, B),
// heaviest tiles first (block x walks query tile nq - 1 - x), after
// flash_fwd_split_kernel has split K and V into the workspace `ws`. Each warpgroup owns 64 of the
// block's rows from end to end; the two share the 32-key tiles that the
// block's rows can see, whose planes land by cp.async in one of two
// buffers during the tile before. Tile i: S = (scale Q) K^T on wgmma (Q's
// hi half in registers for the whole block, its lo half from its plane),
// the online softmax (m, l and p in fp32, p masked explicitly on the tiles
// that cross an edge), and P V on wgmma with P split in registers, 64
// columns of D at a time, each in a fresh accumulator taken into O = O
// alpha + P V in fp32. One barrier a tile: tile i + 1 has landed and tile
// i's planes are read. A warpgroup skips the math of a tile none of its
// rows can see (a no-op in exact arithmetic: alpha = 1, p = 0). At the end
// out = O / max(l, 1e-30), and K6's lse = m + log max(l, 1e-30).
//
// D is the head dim the kernel serves (64, 128 or 168); the planes hold DP
// = padded_dim(D) columns, zero past D. S runs D / 8 k steps, so 168 = 21
// x 8 reads no padding; P V runs in N = 64 column blocks where 64 divides
// D, else in blocks of 32 (the last of 168's six holds one 8-column group
// of the head), and O keeps the D / 8 column groups the head has, which
// at 168 leaves (Q's hi half 84, O 84, P's halves 32, a block 16) room in
// the 255 registers a thread of a 256-thread block can take. With
// fwd_stages(D) == 1 the tile planes have one buffer, refilled after the
// tile's math.
template <int D, bool kSaveLse>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ ws,
                    float* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                    int Hkv, int dg, int causal, int window, float scale) {
  constexpr int DP = padded_dim(D);
  constexpr int kStages = fwd_stages(D);
  constexpr int kPvN = D % 64 == 0 ? 64 : 32;      // P V's column block
  constexpr int kGroups = D / 8;                    // O's 8-column groups
  constexpr int kPlane = kFwdKeys * DP;             // floats of one plane
  constexpr int kTile = kFwdPlanes * kPlane;        // floats of a tile's planes
  extern __shared__ float4 smem4[];
  float* q_lo_all = tc_smem(smem4);                 // warpgroup r's 64 rows at 64 r DP
  float* kv_all = q_lo_all + kFwdRows * DP;         // buffer u at u kTile
  float* q_hi_all = kv_all + (kStages - 1) * kTile; // the last buffer, before the first tile

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int wg = warp >> 2;
  const long long q_row = (long long)H * dg;
  const int n_q = min(kFwdRows, Sq - q0);

  // key tiles [t_lo, t_lo + n_tiles) of 32: the keys the block's rows can see
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int key_hi = causal ? min(Sk, q0 + n_q) : Sk;
  const int t_lo = key_lo / kFwdKeys;
  const int n_tiles = max(0, (key_hi + kFwdKeys - 1) / kFwdKeys - t_lo);
  // this warpgroup's rows [r0, r_last] (none when r0 >= Sq) and this
  // thread's: r0 + row, r0 + row + 8
  const int r0 = q0 + 64 * wg, r_last = min(r0 + 63, Sq - 1);
  const int row = 16 * (warp & 3) + g;

  // the (batch, KV head)'s tiles in the workspace
  const float* ws_bh =
      ws + ((long long)b * Hkv + hk) * ((Sk + kFwdKeys - 1) / kFwdKeys) * kTile;
  // tile i's planes into buffer i % kStages, 16 bytes a thread a step;
  // committed
  auto fetch = [&](int i) {
    const float* src = ws_bh + (long long)(t_lo + i) * kTile;
    const uint32_t dst = hopper::smem_addr(kv_all + (i % kStages) * kTile);
#pragma unroll
    for (int p = 0; p < kFwdPlanes; ++p) {
#pragma unroll
      for (int j = 0; j < kPlane / 4 / kTcThreads; ++j) {
        const int x = p * kPlane + 4 * (tid + j * kTcThreads);
        hopper::cp_async16_zfill(dst + 4 * x, src + x, true);
      }
    }
    hopper::cp_async_commit();
  };

  if (kStages == 2 && n_tiles > 0) fetch(0);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    stage_global<DP, 64>(q_hi_all + 64 * r * DP, q_lo_all + 64 * r * DP,
                         q + ((long long)b * Sq + q0 + 64 * r) * q_row + (long long)h * dg, q_row,
                         n_q - 64 * r, dg, scale);
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
  RowFrags<D> qa;                                   // (scale Q)'s hi half, for the whole block
  qa.load(q_hi_all + 64 * wg * DP);
  __syncthreads();                                  // the last buffer is free
  if (kStages == 1 && n_tiles > 0) {
    fetch(0);
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncthreads();
  }
  const float* q_lo = q_lo_all + 64 * wg * DP;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[4 * kGroups];                           // O: the warp's 16 rows, all of D
#pragma unroll
  for (int x = 0; x < 4 * kGroups; ++x) acc[x] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    // its buffer's last reader, tile i - 1, is done
    if (kStages == 2 && i + 1 < n_tiles) fetch(i + 1);
    const int k0 = (t_lo + i) * kFwdKeys;
    const float* kb = kv_all + (i % kStages) * kTile;
    const bool seen = r0 <= r_last && (!causal || k0 <= r_last) &&
                      (window <= 0 || k0 + kFwdKeys - 1 > r0 - window);
    float s[1][4][4];
    if (seen) {
      dots_wgmma_rs<D>(qa, q_lo, kb, kb + kPlane, s);   // S
      // every pair of the tile is valid for these rows unless it crosses an edge
      const bool edge = r0 + 64 > Sq || k0 + kFwdKeys > Sk ||
                        (causal && k0 + kFwdKeys - 1 > r0) ||
                        (window > 0 && r0 + 63 - k0 >= window);
      uint32_t ok = 0xffffu;
      if (edge) {
        ok = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (valid_pair(r0 + row + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), Sq, Sk,
                           causal, window))
              ok |= 1u << (4 * j + e);
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((ok >> (4 * j + e)) & 1u) mx[e >> 1] = fmaxf(mx[e >> 1], s[0][j][e]);
      float m_new[2], sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // explicit mask: a row with no valid key yet has m = -1e30
          const float p = (ok >> (4 * j + e)) & 1u ? expf(s[0][j][e] - m_new[e >> 1]) : 0.f;
          s[0][j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        alpha[r] = expf(m[r] - m_new[r]);
        l[r] = l[r] * alpha[r] + sum[r];
        m[r] = m_new[r];
      }
      PFrags pf;
      pf.split(s);
      const float* vt = kb + 2 * kPlane;
#pragma unroll
      for (int c = 0; c < (D + kPvN - 1) / kPvN; ++c) {
        float part[kPvN / 2];
        pv_wgmma<kPvN>(pf, vt + kPvN * c * kFwdKeys, vt + kPlane + kPvN * c * kFwdKeys, part);
        // column group jg = c kPvN / 8 + j of the head: acc[4 jg + e]
#pragma unroll
        for (int j = 0; j < kPvN / 8; ++j) {
          const int jg = c * (kPvN / 8) + j;
          if (jg < kGroups) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[4 * jg + e] = fmaf(acc[4 * jg + e], e & 2 ? alpha[1] : alpha[0], part[4 * j + e]);
          }
        }
      }
      pf.hold();
    }
    if (kStages == 1) {
      __syncthreads();                    // tile i's planes are read
      if (i + 1 < n_tiles) fetch(i + 1);
    }
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();          // tile i + 1's planes, before wgmma reads them
    __syncthreads();                      // tile i + 1 has landed, tile i's planes are read
  }

  // acc[4jg + e]: row + 8 (e / 2), column 8jg + 2t + e % 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + row + 8 * r;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    if constexpr (kSaveLse) {
      if (t == 0) lse[((long long)b * H + h) * Sq + qi] = m[r] + logf(den);
    }
    float* o = out + ((long long)b * Sq + qi) * q_row + (long long)h * dg + 2 * t;
#pragma unroll
    for (int jg = 0; jg < kGroups; ++jg)
      if (8 * jg + 2 * t < dg)
        st2(o + 8 * jg, acc[4 * jg + 2 * r] / den, acc[4 * jg + 2 * r + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// K7 and K8 on the tensor cores in bf16: bf16 wgmma, P and dS in three exact
// bf16 planes
// ---------------------------------------------------------------------------

constexpr int kBfTile = 64;              // K7: query rows a block and keys a tile;
                                         // K8: keys a block and query rows a tile
constexpr int kBfHalf = 64 * 128;        // bytes of one 64-column block of a 64-row bf16 tile

// bytes of a 64-row bf16 tile of padded_dim(DH) columns
__host__ __device__ constexpr int bf_tile_bytes(int DH) { return kBfTile * padded_dim(DH) * 2; }

// K7's buffers of K and V tiles: two (tile i + 1 lands during tile i) where
// two blocks of 128 threads still fit an SM, else one (DH = 168: 148,480
// bytes a block with two, 99,328 with one), refilled once the block is done
// with it; the other block on the SM covers the copy.
__host__ __device__ constexpr int dq_bf16_smem(int DH, int stages) {
  return 1024 + (2 + 2 * stages) * bf_tile_bytes(DH);
}
__host__ __device__ constexpr int dq_bf16_stages(int DH) {
  return 2 * dq_bf16_smem(DH, 2) <= kMaxSmem ? 2 : 1;
}

// K8: the block's K and V, the P^T exchange tile (64 x 64 fp32), then two
// stages of a query tile's Q and dO and its 64 lse and 64 delta rows (1 KB)
constexpr int kBfXchg = kBfTile * kBfTile * 4;
__host__ __device__ constexpr int dkv_bf16_stage(int DH) { return 2 * bf_tile_bytes(DH) + 1024; }
__host__ __device__ constexpr int dkv_bf16_smem(int DH) {
  return 1024 + 2 * bf_tile_bytes(DH) + kBfXchg + 2 * dkv_bf16_stage(DH);
}

// Byte offset of the 16-byte chunk holding columns 8c .. 8c + 7 of row r of
// a 64-row bf16 tile: 64-column blocks of 8 KB, each with the 128-byte
// swizzle (K3's layout), which wgmma reads K-major (the operands of S and
// dP, whose depth is the head dim) and N-major (the B of the products over
// the rows, whose depth is the tile's rows).
__device__ __forceinline__ uint32_t bf_chunk(int r, int c) {
  return (uint32_t)((c >> 3) * kBfHalf) + hopper::sw128(r, c & 7);
}

// Rows [0, 64) of a bf16 tile (global row r at src + r * gstride elements,
// its first dg columns) into a padded_dim(DH)-column tile by cp.async,
// 16 bytes a copy, rows at or past n_valid and columns at or past dg zero
// filled; committed by the caller.
template <int DH, int kThreads>
__device__ __forceinline__ void bf_fetch_tile(unsigned char* dst, const __nv_bfloat16* src,
                                              long long gstride, int n_valid, int dg, int tid) {
  constexpr int C = padded_dim(DH) / 8;
#pragma unroll
  for (int u = 0; u < kBfTile * C / kThreads; ++u) {
    const int idx = tid + u * kThreads, r = idx / C, c = idx % C;
    const bool ok = r < n_valid && 8 * c < dg;
    hopper::cp_async16_zfill(hopper::smem_addr(dst + bf_chunk(r, c)),
                             ok ? src + r * gstride + 8 * c : src, ok);
  }
}

// s = A B^T over the head's columns for the warpgroup's 64 rows of tile A
// and the 64 rows of tile B: wgmma m64n64k16 in ceil(DH / 16) k steps
// (bf16 products are exact, the sum fp32). s[4j + e] of warp w is (row 16w
// + g + 8 (e / 2), B row 8j + 2t + e % 2). The caller fences, commits and
// waits.
template <int DH>
__device__ __forceinline__ void bf_dots(float (&s)[32], const unsigned char* a,
                                        const unsigned char* b) {
#pragma unroll
  for (int j = 0; j < (DH + 15) / 16; ++j) {
    const uint32_t off = (j >> 2) * kBfHalf + (j & 3) * 32;
    hopper::wgmma_ss_n64(s, hopper::sw128_desc(a + off, 16, 1024),
                         hopper::sw128_desc(b + off, 16, 1024), j > 0);
  }
}

// A warp's 16 x 64 fp32 tile in s's layout (P, dS, P^T or dS^T) as the A
// fragments of the four 16-deep k steps of a product over its 64 columns,
// in three exact bf16 planes (hopper::bf16x3_split on the bit pattern: hi +
// mid + lo == x), so that against a bf16 B three bf16 products carry fp32 x
// without loss. f[kk][p] is k step kk's fragment of plane p (0 hi, 1 mid, 2
// lo): a0 (row g, columns 16kk + 2t, + 1), a1 (row g + 8), a2 (columns + 8),
// a3 (row g + 8, columns + 8), each pair low column first; s's values
// 4j + e at j = 2kk + (register / 2), e = 2 (register % 2) + (0, 1).
struct Planes3 {
  uint32_t f[4][3][4];

  // kFinite: every x is finite (the forward's p), so the split needs no
  // non-finite case (hopper::bf16x3_split_finite; that case's test slowed
  // the forward's tile loop in a trial on an H100)
  template <bool kFinite = false>
  __device__ __forceinline__ void split(const float (&x)[32]) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      uint32_t h0, m0, l0, h1, m1, l1;
      if constexpr (kFinite) {
        hopper::bf16x3_split_finite(x[i], h0, m0, l0);
        hopper::bf16x3_split_finite(x[i + 1], h1, m1, l1);
      } else {
        hopper::bf16x3_split(x[i], h0, m0, l0);
        hopper::bf16x3_split(x[i + 1], h1, m1, l1);
      }
      const int kk = i >> 3, reg = ((i >> 2) & 1) * 2 + ((i & 3) >> 1);
      f[kk][0][reg] = hopper::bf16_pack(h0, h1);
      f[kk][1][reg] = hopper::bf16_pack(m0, m1);
      f[kk][2][reg] = hopper::bf16_pack(l0, l1);
    }
  }

  // Keeps the registers live and unchanged up to here: call after the last
  // wgmma_wait of the products that read them.
  __device__ __forceinline__ void hold() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[kk][p][e])::"memory");
  }
};

// acc += X B over the tile's 64 rows of B: X the warpgroup's 64 x 64 fp32
// tile in three planes, B a 64-row bf16 tile read N-major (its rows are the
// depth, its padded_dim(DH) columns the output's), in 64-column blocks of
// the output. Each block's 12 wgmma m64n64k16 (four k steps x lo, mid, hi:
// small terms first) sum in a fresh accumulator, which one fp32 add (to
// nearest) takes into acc: the tensor cores' own accumulation rounds toward
// zero. acc[32c + 4j + e] is (row 16w + g + 8 (e / 2), column 64c + 8j + 2t
// + e % 2). (Blocks of 128 columns, m64n128k16, measured no faster in K7 at
// D 128 on an H100.)
template <int DH>
__device__ __forceinline__ void bf_rows_product(float (&acc)[padded_dim(DH) / 2],
                                                const Planes3& x, const unsigned char* b) {
  float part[32];
#pragma unroll
  for (int c = 0; c < padded_dim(DH) / 64; ++c) {
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc = hopper::sw128_desc(b + c * kBfHalf + kk * 16 * 128, kBfHalf, 1024);
#pragma unroll
      for (int p = 2; p >= 0; --p)
        hopper::wgmma_rs_n64<1>(part, x.f[kk][p], desc, kk > 0 || p < 2);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * c + i] += part[i];
  }
}

// acc times mul in bf16 into rows [0, n_rows) of 64 rows of a (rows, dg)
// slice at out (row stride ostride elements): this thread's rows r0 and
// r0 + 8 and its column pairs 64c + 8j + 2t, those under dg.
template <int DH>
__device__ __forceinline__ void bf_store_rows(__nv_bfloat16* out, long long ostride, int r0,
                                              int n_rows, int dg, int t,
                                              const float (&acc)[padded_dim(DH) / 2], float mul) {
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int r = r0 + 8 * e2;
    if (r >= n_rows) continue;
    __nv_bfloat16* o = out + r * ostride + 2 * t;
#pragma unroll
    for (int c = 0; c < padded_dim(DH) / 64; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * c + 8 * j + 2 * t < dg)
          st2(o + 64 * c + 8 * j, acc[32 * c + 4 * j + 2 * e2] * mul,
              acc[32 * c + 4 * j + 2 * e2 + 1] * mul);
  }
}

// K7 in bf16: grid (Sq tiles of 64, H, B), heaviest tiles first, one
// warpgroup a block (two blocks an SM). The block's Q and dO tiles stay in
// shared memory; the 64-key tiles of K and V that its rows can see land by
// cp.async (tile i + 1 during tile i where dq_bf16_stages is 2). Tile i:
// S = Q K^T and dP = dO V^T on bf16 wgmma (one commit group), then in fp32
// p = exp(scale S - lse), masked explicitly, and dS = p (dP - delta); dS
// in three planes; dQ += dS K (K read N-major: no transposed copy). At the
// end dq = scale dQ in bf16. DH is the kernel's head dim (64, 128, 168),
// dg the tensors' (the tiles zero past it).
template <int DH>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
                         int Sk, int H, int Hkv, int dg, int causal, int window, float scale) {
  constexpr int kTileB = bf_tile_bytes(DH);
  constexpr int kStages = dq_bf16_stages(DH);
  extern __shared__ float4 smem4[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(tc_smem(smem4));
  unsigned char* do_s = q_s + kTileB;
  unsigned char* kv_s = do_s + kTileB;              // stage u: K at 2u kTileB, V after it

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBfTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const long long q_row = (long long)H * dg, k_row = (long long)Hkv * dg;
  const int n_q = min(kBfTile, Sq - q0);
  const long long q_off = ((long long)b * Sq + q0) * q_row + (long long)h * dg;

  // key tiles [t_lo, t_lo + n_tiles) of 64: the keys the block's rows can see
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int key_hi = causal ? min(Sk, q0 + n_q) : Sk;
  const int t_lo = key_lo / kBfTile;
  const int n_tiles = max(0, (key_hi + kBfTile - 1) / kBfTile - t_lo);
  const __nv_bfloat16* k_g = k + (long long)b * Sk * k_row + (long long)hk * dg;
  const __nv_bfloat16* v_g = v + (long long)b * Sk * k_row + (long long)hk * dg;
  auto fetch = [&](int i) {
    const int k0 = (t_lo + i) * kBfTile;
    unsigned char* st = kv_s + (i % kStages) * 2 * kTileB;
    bf_fetch_tile<DH, 128>(st, k_g + k0 * k_row, k_row, Sk - k0, dg, tid);
    bf_fetch_tile<DH, 128>(st + kTileB, v_g + k0 * k_row, k_row, Sk - k0, dg, tid);
  };
  bf_fetch_tile<DH, 128>(q_s, q + q_off, q_row, n_q, dg, tid);
  bf_fetch_tile<DH, 128>(do_s, dout + q_off, q_row, n_q, dg, tid);
  if (n_tiles > 0) fetch(0);
  hopper::cp_async_commit();

  const int row = 16 * warp + g;                    // this thread's rows: row, row + 8
  const long long row_off = ((long long)b * H + h) * Sq + q0;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool in = row + 8 * e < n_q;
    lse_r[e] = in ? lse[row_off + row + 8 * e] : 0.f;
    dl_r[e] = in ? delta[row_off + row + 8 * e] : 0.f;
  }

  float acc[padded_dim(DH) / 2];                    // dQ: the warp's 16 rows, all columns
#pragma unroll
  for (int i = 0; i < padded_dim(DH) / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    if constexpr (kStages == 2) {
      if (i + 1 < n_tiles) fetch(i + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();                   // tile i (and Q, dO) landed
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::fence_proxy_async();                    // the copies, before wgmma reads them
    __syncthreads();
    const unsigned char* k_t = kv_s + (i % kStages) * 2 * kTileB;
    const int k0 = (t_lo + i) * kBfTile;
    float s[32], dp[32];
    hopper::wgmma_fence();
    bf_dots<DH>(s, q_s, k_t);                       // S
    bf_dots<DH>(dp, do_s, k_t + kTileB);            // dP
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int rr = (x & 3) >> 1;
      const bool ok = valid_pair(q0 + row + 8 * rr, k0 + 8 * (x >> 2) + 2 * t + (x & 1), Sq, Sk,
                                 causal, window);
      // explicit mask: a row with no valid key has lse ~ -1e30
      const float p = ok ? expf(s[x] * scale - lse_r[rr]) : 0.f;
      s[x] = p * (dp[x] - dl_r[rr]);                // dS
    }
    Planes3 ds;
    ds.split(s);
    bf_rows_product<DH>(acc, ds, k_t);              // dQ += dS K
    ds.hold();
    __syncthreads();                                // the stage's K and V are read
    if constexpr (kStages == 1) {
      if (i + 1 < n_tiles) {
        fetch(i + 1);
        hopper::cp_async_commit();
      }
    }
  }
  bf_store_rows<DH>(dq + q_off, q_row, row, n_q, dg, t, acc, scale);
}

// K8 in bf16: the fp32 kernels' grid (dkv_block; 64-row query tiles), so
// at the training shapes, B 2 x S 2048 with 4 KV heads, 256 blocks walk
// their groups over 132 SMs in longest-first order, about two even waves,
// and a shape of fewer units than SMs splits its groups' heads over blocks
// (dkv_combine). Two warpgroups by product, each over the
// block's 64 keys: warpgroup 0 computes S^T = K Q^T and P^T, hands P^T to
// warpgroup 1 through an fp32 exchange tile in fragment order (a named
// barrier), and adds P^T dO to dV; warpgroup 1 computes dP^T = V dO^T
// meanwhile, then dS^T = P^T (dP^T - delta) and adds dS^T Q to dK (Q and
// dO read N-major: no transposed copies). dK = scale dK at the end; both
// in bf16.
template <int DH, bool kSplit>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int B, int Sq, int Sk, int H, int Hkv,
                          int dg, int causal, int window, float scale,
                          float* __restrict__ ws, int* __restrict__ counters) {
  constexpr int kTileB = bf_tile_bytes(DH);
  constexpr int kStage = dkv_bf16_stage(DH);
  extern __shared__ float4 smem4[];
  unsigned char* k_s = reinterpret_cast<unsigned char*>(tc_smem(smem4));
  unsigned char* v_s = k_s + kTileB;
  float* xchg = reinterpret_cast<float*>(v_s + kTileB);   // P^T, warpgroup 0 to 1
  unsigned char* stages = v_s + kTileB + kBfXchg;   // stage u: Q, dO, lse and delta rows

  const int rep = H / Hkv;
  const DkvBlock blk = dkv_block(kBfTile, B, Hkv, rep, kSplit);
  const int k0 = blk.k0, b = blk.b, hk = blk.hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = tid & 3;
  const int role = warp >> 2;
  const long long q_row = (long long)H * dg, k_row = (long long)Hkv * dg;
  const int n_k = min(kBfTile, Sk - k0);
  const long long k_off = ((long long)b * Sk + k0) * k_row + (long long)hk * dg;

  // query tiles [qt_lo, qt_lo + n_qt) of 64 that can see a key of the
  // block, for each of its heads: tile i is head r0 + i / n_qt's tile i % n_qt
  const int k_last = k0 + n_k - 1;
  const int qry_lo = causal ? k0 : 0;
  const int qry_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int qt_lo = qry_lo / kBfTile;
  const int n_qt = max(0, (qry_hi + kBfTile - 1) / kBfTile - qt_lo);
  const int n_tiles = blk.nh * n_qt;
  auto fetch = [&](int i) {
    const int h = hk * rep + blk.r0 + i / n_qt, q0 = (qt_lo + i % n_qt) * kBfTile;
    const long long q_off = ((long long)b * Sq + q0) * q_row + (long long)h * dg;
    unsigned char* st = stages + (i & 1) * kStage;
    bf_fetch_tile<DH, kTcThreads>(st, q + q_off, q_row, Sq - q0, dg, tid);
    bf_fetch_tile<DH, kTcThreads>(st + kTileB, dout + q_off, q_row, Sq - q0, dg, tid);
    if (tid < 2 * kBfTile) {                        // lse rows, then delta rows
      const int r = tid % kBfTile;
      const bool ok = q0 + r < Sq;
      const float* src = (tid < kBfTile ? lse : delta) + ((long long)b * H + h) * Sq + q0;
      hopper::cp_async4_zfill(
          hopper::smem_addr(reinterpret_cast<float*>(st + 2 * kTileB) + tid), ok ? src + r : src,
          ok);
    }
  };
  bf_fetch_tile<DH, kTcThreads>(k_s, k + k_off, k_row, n_k, dg, tid);
  bf_fetch_tile<DH, kTcThreads>(v_s, v + k_off, k_row, n_k, dg, tid);
  if (n_tiles > 0) fetch(0);
  hopper::cp_async_commit();

  const int key = 16 * (warp & 3) + g;              // this thread's keys: key, key + 8
  float acc[padded_dim(DH) / 2];                    // dV (role 0) or dK (role 1): 16 keys a warp
#pragma unroll
  for (int i = 0; i < padded_dim(DH) / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) fetch(i + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();                     // tile i (and K, V) landed
    hopper::fence_proxy_async();
    __syncthreads();
    const unsigned char* q_t = stages + (i & 1) * kStage;
    const unsigned char* do_t = q_t + kTileB;
    const float* lse_s = reinterpret_cast<const float*>(q_t + 2 * kTileB);
    const float* dl_s = lse_s + kBfTile;
    const int q0 = (qt_lo + i % n_qt) * kBfTile;
    // transposed scores: rows are the block's keys, columns the tile's
    // queries; x: this thread's (key, query) pair of the warp's 16 x 64
    float s[32];
    float* xs = xchg + (warp & 3) * 1024;           // warp w of each warpgroup: the same pairs
    Planes3 xt;
    if (role == 0) {
      hopper::wgmma_fence();
      bf_dots<DH>(s, k_s, q_t);                     // S^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int qq = 8 * (x >> 2) + 2 * t + (x & 1);
        const bool ok =
            valid_pair(q0 + qq, k0 + key + 8 * ((x & 3) >> 1), Sq, Sk, causal, window);
        s[x] = ok ? expf(s[x] * scale - lse_s[qq]) : 0.f;   // P^T
        xs[x * 32 + lane] = s[x];
      }
      bar_arrive(kPReady, kTcThreads);
      xt.split(s);
      bf_rows_product<DH>(acc, xt, do_t);           // dV += P^T dO
    } else {
      hopper::wgmma_fence();
      bf_dots<DH>(s, v_s, do_t);                    // dP^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      bar_sync(kPReady, kTcThreads);                // warpgroup 0's P^T is in the exchange
#pragma unroll
      for (int x = 0; x < 32; ++x)
        s[x] = xs[x * 32 + lane] * (s[x] - dl_s[8 * (x >> 2) + 2 * t + (x & 1)]);   // dS^T
      xt.split(s);
      bf_rows_product<DH>(acc, xt, q_t);            // dK += dS^T Q
    }
    xt.hold();
    __syncthreads();                                // the stage and the exchange are read
  }
  if constexpr (kSplit) {
    if (!dkv_combine(acc, ws, counters, blk, rep)) return;
  }
  bf_store_rows<DH>((role ? dk : dv) + k_off, k_row, key, n_k, dg, t, acc, role ? scale : 1.f);
}

// ---------------------------------------------------------------------------
// K6 and K10 with bf16 q on the tensor cores: bf16 wgmma, P in three exact
// bf16 planes, one launch a call
// ---------------------------------------------------------------------------

// K and V as stored: bf16, or int8 codes (K10's int8-KV mode)
template <bool kInt8Kv>
using FwdKv = std::conditional_t<kInt8Kv, int8_t, __nv_bfloat16>;

// Bytes of shared memory of the bf16 forward's block: Q's 64-row tile and
// `stages` stages of a 64-key K and V tile, all bf16 tiles of
// bf_tile_bytes(DH); in the int8-KV mode besides, one buffer of the raw
// codes of K and V (64 rows of padded_dim(DH) bytes each: one tile's bytes
// for the two) and each stage's 64 K and 64 V scales.
__host__ __device__ constexpr int fwd_bf16_smem(int DH, bool int8, int stages) {
  return 1024 + (1 + 2 * stages + (int8 ? 1 : 0)) * bf_tile_bytes(DH) +
         (int8 ? stages * 2 * kBfTile * 4 : 0);
}

// Its stages: two (tile i + 1 lands during tile i) where two blocks of 128
// threads still fit an SM, else one (DH = 168: 123,904 bytes a block with
// two, 74,752 with one; 99,840 with int8 codes), refilled once the block is
// done with it; the other block on the SM covers the copy.
__host__ __device__ constexpr int fwd_bf16_stages(int DH, bool int8) {
  return 2 * fwd_bf16_smem(DH, int8, 2) <= kMaxSmem ? 2 : 1;
}
static_assert(2 * fwd_bf16_smem(168, true, fwd_bf16_stages(168, true)) <= kMaxSmem,
              "two blocks of the bf16 forward fit an SM at 168");

// O = O alpha + P V over one 64-key tile: P the warpgroup's 64 x 64 fp32
// tile in three planes, V the stage's tile read N-major (its rows are the
// depth), in 64-column blocks of the head. Each block's 12 wgmma m64n64k16
// (four k steps x lo, mid, hi: small terms first) sum in a fresh
// accumulator, which one fp32 fma a value (to nearest) takes into O, alpha
// = a0 for the thread's row g and a1 for g + 8: the tensor cores' own
// accumulation rounds toward zero. acc[32c + 4j + e] is (row 16w + g + 8
// (e / 2), column 64c + 8j + 2t + e % 2), for the DH columns of the head
// only (168: not the last block's 24 zero columns). (At D 128 on an H100
// neither issuing both blocks before the first wait, in accumulators of
// their own, nor one block of 128 columns, m64n128k16, was faster.)
template <int DH>
__device__ __forceinline__ void pv_bf16(float (&acc)[DH / 2], const Planes3& x,
                                        const unsigned char* v, float a0, float a1) {
  float part[32];
#pragma unroll
  for (int c = 0; c < padded_dim(DH) / 64; ++c) {
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc = hopper::sw128_desc(v + c * kBfHalf + kk * 16 * 128, kBfHalf, 1024);
#pragma unroll
      for (int p = 2; p >= 0; --p)
        hopper::wgmma_rs_n64<1>(part, x.f[kk][p], desc, kk > 0 || p < 2);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (32 * c + i < DH / 2)
        acc[32 * c + i] = fmaf(acc[32 * c + i], i & 2 ? a1 : a0, part[i]);
  }
}

// K6 (kSaveLse) and K10 with bf16 q: grid (Sq tiles of 64, H, B), heaviest
// tiles first (block x walks query tile nq - 1 - x), one warpgroup a block
// over its 64 query rows, two blocks an SM, which run their tiles' phases
// independently: one block's softmax overlaps the other's wgmma. The 64-key
// tiles of K and V that the block's rows can see come straight from the
// tensors by cp.async (tile i + 1 during tile i where fwd_bf16_stages is 2):
// no pre-pass, no workspace. Tile i: S = Q K^T on bf16 wgmma m64n64k16 in
// ceil(DH / 16) k steps from the stored tiles (bf16 products are exact, the
// sum fp32), then scaled in fp32 (Pallas scales q before the product: the
// two differ at fp32 rounding); the online softmax in fp32 (m from -1e30,
// p masked explicitly on the tiles that cross an edge, l summed from the
// fp32 p, alpha = exp(m - m_new)); P V with P split into three exact bf16
// planes (hi + mid + lo == p) against the V tile read N-major (pv_bf16).
// One block barrier a tile (two with one stage): tile i has landed and
// every thread is done with tile i - 1. At the end out = O / max(l, 1e-30)
// in bf16, and K6's lse = m + log max(l, 1e-30): a row with no valid key is
// zeros with lse -1e30 + log(1e-30).
//
// int8 K/V (kInt8Kv, K10): the codes land as they lie (16 bytes a copy on
// the 128-column instance, whose rows of 112 and 128 codes are 16-byte
// aligned, 8 on the others: rows of 8, 24 and 168 codes are 8-byte
// aligned) in one buffer, with the stage's K and V scales, and each thread
// widens the chunks it copied, exactly (hopper::widen4), into the stage's
// bf16 tiles before the tile's barrier, after which it copies the next
// tile's codes over them. (16-byte copies at D 128 were faster than 8-byte
// ones in a trial on an H100; widening tile i + 1 while tile i's P V ran on
// the tensor cores gained little there and is not kept.) Each key's
// scale multiplies its fp32 column of S together with the softmax scale
// (Pallas: scale q · (codes ks)), and p times the key's V scale is split
// into the planes (l sums the unscaled p).
//
// DH is the kernel's head dim (64, 128, 168), dg the tensors' (the tiles
// zero past it): 8, 16, 24 and 64 run the 64-column instance, 112 and 128
// the 128-column one, 168 its own on 192 columns (S in 11 k steps over
// 176). A thread holds O (DH / 2 floats: 84 at 168), S's 32, P's three
// planes (48 registers) and P V's block in flight (32).
template <int DH, bool kInt8Kv, bool kSaveLse>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const FwdKv<kInt8Kv>* __restrict__ k,
                      const FwdKv<kInt8Kv>* __restrict__ v, const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int dg, int causal,
                      int window, float scale) {
  constexpr int DP = padded_dim(DH);
  constexpr int kTileB = bf_tile_bytes(DH);
  constexpr int kStages = fwd_bf16_stages(DH, kInt8Kv);
  // int8: bytes of codes a copy and copies a tile row
  constexpr int kRaw = DH == 128 ? 16 : 8, CR = DP / kRaw;
  extern __shared__ float4 smem4[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(tc_smem(smem4));
  unsigned char* kv_s = q_s + kTileB;               // stage u: K at 2u kTileB, V after it
  unsigned char* raw_s = kv_s + 2 * kStages * kTileB;   // int8: K's codes, then V's
  float* sc_s = reinterpret_cast<float*>(raw_s + kTileB);   // int8: stage u's 64 ks, 64 vs

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBfTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const long long q_row = (long long)H * dg, k_row = (long long)Hkv * dg;
  const int n_q = min(kBfTile, Sq - q0);

  // key tiles [t_lo, t_lo + n_tiles) of 64: the keys the block's rows can
  // see (each tile some row's)
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int key_hi = causal ? min(Sk, q0 + n_q) : Sk;
  const int t_lo = key_lo / kBfTile;
  const int n_tiles = max(0, (key_hi + kBfTile - 1) / kBfTile - t_lo);
  const int row = 16 * warp + g;                    // this thread's rows: row, row + 8

  const FwdKv<kInt8Kv>* k_g = k + (long long)b * Sk * k_row + (long long)hk * dg;
  const FwdKv<kInt8Kv>* v_g = v + (long long)b * Sk * k_row + (long long)hk * dg;
  // tile i's K and V (int8: codes and scales) into stage i % kStages;
  // committed by the caller
  auto fetch = [&](int i) {
    const int k0 = (t_lo + i) * kBfTile, st = i % kStages;
    if constexpr (kInt8Kv) {
#pragma unroll
      for (int u = 0; u < kBfTile * CR / 128; ++u) {
        const int idx = tid + u * 128, r = idx / CR, c = idx % CR;
        const bool ok = r < Sk - k0 && kRaw * c < dg;
        const long long off = ok ? (long long)(k0 + r) * k_row + kRaw * c : 0;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const uint32_t dst = hopper::smem_addr(raw_s + (kv * kBfTile + r) * DP + kRaw * c);
          if constexpr (kRaw == 16) {
            hopper::cp_async16_zfill(dst, (kv ? v_g : k_g) + off, ok);
          } else {
            hopper::cp_async8_zfill(dst, (kv ? v_g : k_g) + off, ok);
          }
        }
      }
      // K scales, then V scales
      const int r = tid % kBfTile;
      const bool ok = k0 + r < Sk;
      const float* src = (tid < kBfTile ? k_scale : v_scale) + (long long)b * Sk * Hkv + hk;
      hopper::cp_async4_zfill(hopper::smem_addr(sc_s + st * 2 * kBfTile + tid),
                              src + (ok ? (long long)(k0 + r) * Hkv : 0), ok);
    } else {
      unsigned char* kt = kv_s + st * 2 * kTileB;
      bf_fetch_tile<DH, 128>(kt, k_g + k0 * k_row, k_row, Sk - k0, dg, tid);
      bf_fetch_tile<DH, 128>(kt + kTileB, v_g + k0 * k_row, k_row, Sk - k0, dg, tid);
    }
  };
  // int8: this thread's own code chunks of tile i (as fetch copied them,
  // landed) to bf16, exactly, into stage i % kStages's swizzled tiles
  auto widen = [&](int i) {
    unsigned char* kt = kv_s + (i % kStages) * 2 * kTileB;
#pragma unroll
    for (int u = 0; u < kBfTile * CR / 128; ++u) {
      const int idx = tid + u * 128, r = idx / CR, c = idx % CR;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const unsigned char* src = raw_s + (kv * kBfTile + r) * DP + kRaw * c;
        // 8 codes at a time into the 16-byte chunk of their 8 columns
#pragma unroll
        for (int h = 0; h < kRaw / 8; ++h) {
          const uint2 w = *reinterpret_cast<const uint2*>(src + 8 * h);
          const uint2 lo = hopper::widen4(w.x), hi = hopper::widen4(w.y);
          *reinterpret_cast<uint4*>(kt + kv * kTileB + bf_chunk(r, kRaw / 8 * c + h)) =
              make_uint4(lo.x, lo.y, hi.x, hi.y);
        }
      }
    }
  };
  bf_fetch_tile<DH, 128>(q_s, q + ((long long)b * Sq + q0) * q_row + (long long)h * dg, q_row,
                         n_q, dg, tid);
  if (n_tiles > 0) fetch(0);
  hopper::cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DH / 2];                                // O: the warp's 16 rows, the head's columns
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) acc[x] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    unsigned char* k_t = kv_s + st * 2 * kTileB;
    hopper::cp_async_wait<0>();                     // tile i (and Q) landed
    if (kInt8Kv) widen(i);
    hopper::fence_proxy_async();                    // the tiles, before wgmma reads them
    __syncthreads();                                // tile i is in, tile i - 1 is read
    if (kStages == 2 && i + 1 < n_tiles) {
      fetch(i + 1);
      hopper::cp_async_commit();
    }
    const int k0 = (t_lo + i) * kBfTile;
    float s[32];
    hopper::wgmma_fence();
    bf_dots<DH>(s, q_s, k_t);                       // S = Q K^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    const float* ks = sc_s + st * 2 * kBfTile;      // int8: the keys' K scales, then V's
    // every pair of the tile is valid for these rows unless it crosses an edge
    const bool edge = q0 + kBfTile > Sq || k0 + kBfTile > Sk ||
                      (causal && k0 + kBfTile - 1 > q0) ||
                      (window > 0 && q0 + kBfTile - 1 - k0 >= window);
    float alpha[2];
    // the online softmax over the tile, s[x] (row row + 8 ((x & 3) / 2),
    // key 8 (x / 4) + 2t + x % 2) to p; on a tile that crosses an edge
    // (kEdge) p is masked explicitly (a row with no valid key yet has m =
    // -1e30), elsewhere every pair is valid and no mask is made
    auto softmax = [&](auto edge_tag) {
      constexpr bool kEdge = decltype(edge_tag)::value;
      uint32_t ok = 0xffffffffu;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int key = 8 * (x >> 2) + 2 * t + (x & 1), rr = (x & 3) >> 1;
        s[x] *= kInt8Kv ? scale * ks[key] : scale;
        if constexpr (kEdge) {
          if (!valid_pair(q0 + row + 8 * rr, k0 + key, Sq, Sk, causal, window))
            ok &= ~(1u << x);
          if ((ok >> x) & 1u) mx[rr] = fmaxf(mx[rr], s[x]);
        } else {
          mx[rr] = fmaxf(mx[rr], s[x]);
        }
      }
      float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
      }
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int rr = (x & 3) >> 1;
        const float p = !kEdge || ((ok >> x) & 1u) ? expf(s[x] - m_new[rr]) : 0.f;
        sum[rr] += p;
        s[x] = kInt8Kv ? p * ks[kBfTile + 8 * (x >> 2) + 2 * t + (x & 1)] : p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        alpha[r] = expf(m[r] - m_new[r]);
        l[r] = l[r] * alpha[r] + sum[r];
        m[r] = m_new[r];
      }
    };
    if (edge) {
      softmax(std::true_type{});
    } else {
      softmax(std::false_type{});
    }
    Planes3 pp;
    pp.split<true>(s);
    pv_bf16<DH>(acc, pp, k_t + kTileB, alpha[0], alpha[1]);   // O = O alpha + P V
    pp.hold();
    if (kStages == 1 && i + 1 < n_tiles) {
      __syncthreads();                              // the stage is read
      fetch(i + 1);
      hopper::cp_async_commit();
    }
  }

  // acc[4jg + e]: row + 8 (e / 2), column 8jg + 2t + e % 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row + 8 * r;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    if constexpr (kSaveLse) {
      if (t == 0) lse[((long long)b * H + h) * Sq + qi] = m[r] + logf(den);
    }
    __nv_bfloat16* o = out + ((long long)b * Sq + qi) * q_row + (long long)h * dg + 2 * t;
#pragma unroll
    for (int jg = 0; jg < DH / 8; ++jg)
      if (8 * jg + 2 * t < dg)
        st2(o + 8 * jg, acc[4 * jg + 2 * r] / den, acc[4 * jg + 2 * r + 1] / den);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// K6 (KVT = float, kSaveLse) and K10 (KVT = float or int8_t, no lse) with
// fp32 q: the split pre-pass into ws, then the forward. D is the kernels'
// head dim (64, 128 or 168), dg the tensors' (dg <= D; see the entry points)
template <typename KVT, int D, bool kSaveLse>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* k_scale,
                       const void* v_scale, void* out, void* lse, void* ws, int B, int Sq,
                       int Sk, int H, int Hkv, int dg, int causal, int window, float scale,
                       cudaStream_t stream) {
  const long long tiles = (long long)B * Hkv * ((Sk + kFwdKeys - 1) / kFwdKeys);
  if (tiles > 0x7fffffffll) return cudaErrorInvalidValue;
  flash_fwd_split_kernel<KVT, padded_dim(D)><<<(unsigned)tiles, kTcThreads, 0, stream>>>(
      static_cast<const KVT*>(k), static_cast<const KVT*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<float*>(ws), Sk, Hkv, dg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = 1024 + sizeof(float) * fwd_smem_floats(D, fwd_stages(D));
  auto kernel = flash_fwd_tc_kernel<D, kSaveLse>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kFwdRows - 1) / kFwdRows, H, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(ws), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, dg, causal, window, scale);
  return cudaGetLastError();
}

// K6 (kSaveLse) and K10 with bf16 q: one launch, no workspace. DH is the
// kernel's head dim (64, 128 or 168), dg the tensors'.
template <int DH, bool kInt8Kv, bool kSaveLse>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, void* out, void* lse, int B, int Sq, int Sk,
                            int H, int Hkv, int dg, int causal, int window, float scale,
                            cudaStream_t stream) {
  const size_t smem = fwd_bf16_smem(DH, kInt8Kv, fwd_bf16_stages(DH, kInt8Kv));
  auto kernel = flash_fwd_bf16_kernel<DH, kInt8Kv, kSaveLse>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBfTile - 1) / kBfTile, H, B);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const FwdKv<kInt8Kv>*>(k),
      static_cast<const FwdKv<kInt8Kv>*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, dg, causal, window, scale);
  return cudaGetLastError();
}

// K10 in each (q, K/V) mode: fp32 q over fp32 K/V or int8 codes (3xTF32,
// through ws), bf16 q over bf16 K/V or int8 codes (the bf16 kernel)
template <typename QT, int D>
cudaError_t launch_infer(const void* q, const void* k, const void* v, const void* k_scale,
                         const void* v_scale, void* out, void* ws, int B, int Sq, int Sk,
                         int H, int Hkv, int dg, int causal, int window, float scale,
                         int kv_int8, cudaStream_t stream) {
  if constexpr (std::is_same<QT, __nv_bfloat16>::value) {
    if (kv_int8)
      return launch_fwd_bf16<D, true, false>(q, k, v, k_scale, v_scale, out, nullptr, B, Sq, Sk,
                                             H, Hkv, dg, causal, window, scale, stream);
    return launch_fwd_bf16<D, false, false>(q, k, v, nullptr, nullptr, out, nullptr, B, Sq, Sk,
                                            H, Hkv, dg, causal, window, scale, stream);
  } else {
    if (kv_int8)
      return launch_fwd<int8_t, D, false>(q, k, v, k_scale, v_scale, out, nullptr, ws, B, Sq,
                                          Sk, H, Hkv, dg, causal, window, scale, stream);
    return launch_fwd<float, D, false>(q, k, v, nullptr, nullptr, out, nullptr, ws, B, Sq, Sk,
                                       H, Hkv, dg, causal, window, scale, stream);
  }
}

// The fp32 tensor-core backward: the D = 64 and 128 kernels, and the wide
// ones at 168 (their planes' bytes: dq_smem_floats). K8 takes the split
// flag, its workspace and counters (dkv_block, dkv_combine; unread without
// a split).
template <int D>
auto dq_tc_kernel() {
  if constexpr (D % 64 != 0) {
    return flash_bwd_dq_tc_wide_kernel<D>;
  } else {
    return flash_bwd_dq_tc_kernel<D>;
  }
}

template <int D, bool kSplit>
auto dkv_tc_kernel() {
  if constexpr (D % 64 != 0) {
    return flash_bwd_dkv_tc_wide_kernel<D, kSplit>;
  } else {
    return flash_bwd_dkv_tc_kernel<D, kSplit>;
  }
}

template <int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
                         int H, int Hkv, int dg, int causal, int window, float scale,
                         cudaStream_t stream) {
  constexpr bool kWide = D % 64 != 0;
  const size_t smem =
      1024 + sizeof(float) * (kWide ? dq_wide_smem_floats(padded_dim(D)) : dq_smem_floats(D));
  auto kernel = dq_tc_kernel<D>();
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kDqRows - 1) / kDqRows, H, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), Sq, Sk, H, Hkv, dg, causal,
      window, scale);
  return cudaGetLastError();
}

// K8's grid: units (key tiles x B x Hkv) blocks, times rep with a split
inline long long dkv_blocks(int keys, int B, int Sk, int H, int Hkv, int split) {
  return (long long)((Sk + keys - 1) / keys) * B * Hkv * (split ? H / Hkv : 1);
}

template <int D>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                          int Sk, int H, int Hkv, int dg, int causal, int window, float scale,
                          int split, void* ws, void* counters, cudaStream_t stream) {
  constexpr bool kWide = D % 64 != 0;
  const size_t smem =
      1024 + sizeof(float) * (kWide ? dkv_wide_smem_floats(padded_dim(D)) : dkv_smem_floats(D));
  auto kernel = split ? dkv_tc_kernel<D, true>() : dkv_tc_kernel<D, false>();
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = dkv_blocks(kDkvKeys, B, Sk, H, Hkv, split);
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), B, Sq,
      Sk, H, Hkv, dg, causal, window, scale, static_cast<float*>(ws),
      static_cast<int*>(counters));
  return cudaGetLastError();
}

// The bf16 tensor-core backward at every kernel head dim (64, 128, 168).
template <int DH>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
                           int H, int Hkv, int dg, int causal, int window, float scale,
                           cudaStream_t stream) {
  const size_t smem = dq_bf16_smem(DH, dq_bf16_stages(DH));
  auto kernel = flash_bwd_dq_bf16_kernel<DH>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBfTile - 1) / kBfTile, H, B);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, Hkv, dg, causal, window, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                            int Sk, int H, int Hkv, int dg, int causal, int window, float scale,
                            int split, void* ws, void* counters, cudaStream_t stream) {
  const size_t smem = dkv_bf16_smem(DH);
  auto kernel =
      split ? flash_bwd_dkv_bf16_kernel<DH, true> : flash_bwd_dkv_bf16_kernel<DH, false>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = dkv_blocks(kBfTile, B, Sk, H, Hkv, split);
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, Sq, Sk, H, Hkv, dg,
      causal, window, scale, static_cast<float*>(ws), static_cast<int*>(counters));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points. q, dout, out and dq (B, Sq, H, D); k, v, dk and dv
// (B, Sk, Hkv, D), all contiguous and of one dtype (fp32, or bf16 when
// `bf16` is 1); lse and delta (B, H, Sq) fp32 contiguous. H % Hkv == 0, D in
// {8, 16, 24, 64, 112, 128, 168}. causal is 0 or 1; window <= 0 means no
// window. The fp32 forward's ws is an fp32 workspace of B * Hkv * ceil(Sk
// / 32) * kFwdPlanes * 32 * padded_dim(max(D, 64)) floats, 16-byte aligned;
// the bf16 forward (one launch) takes none and ignores ws. K8's
// split is 0 or 1 (flash_attention.dkv_split); with 1, ws is an fp32
// workspace of units * (H / Hkv) * 2 * 64 * padded_dim(max(D, 64)) floats,
// 16-byte aligned, and counters units int32 zeros, units = ceil(Sk / 64) *
// B * Hkv, which the call leaves at zero. Each returns the CUDA error of its launches (0
// on success).
//
// The head dims under 64 (the reference's smoke configs: 8, 16, 24) run
// the D = 64 kernels with dg = D, and 112 (kimi-k2's and zamba2's) the D =
// 128 kernels: the tensors' rows are read and written at their own width,
// and the tiles in shared memory (and the forward's workspace planes) are
// zero past column dg. The zero columns add exact zeros to S, dP and the
// products over the rows, and the outputs' columns past dg are not stored,
// so the values are those of a D-wide kernel. The transposed backward
// products put D on wgmma's 64-row M side, which is why 64 and not 32 is
// the floor; the work is that of D = 64 (8x the pairs' FLOPs at D = 8), a
// simple route for the small configs. 168 (gemma3-27b's) has kernels of
// its own on tiles of 192 columns: the fp32 forward (21 k steps of 8, one
// buffer of tile planes), the bf16 forward and backward (11 k steps of 16
// in S), and the fp32 backward with its register-only operands in plain
// fp32 planes (the wide kernels).

#define FLASH_DISPATCH(CALL, T)                                                   \
  switch (D) {                                                                    \
    case 8:                                                                       \
    case 16:                                                                      \
    case 24:                                                                      \
    case 64:                                                                      \
      return static_cast<int>(CALL(T, 64));                                       \
    case 112:                                                                     \
    case 128:                                                                     \
      return static_cast<int>(CALL(T, 128));                                      \
    case 168:                                                                     \
      return static_cast<int>(CALL(T, 168));                                      \
  }                                                                               \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* out, void* lse, void* ws, int B, int Sq,
                                          int Sk, int H, int Hkv, int D, int causal,
                                          int window, float scale, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(T, DIM)                                                                           \
  launch_fwd<T, DIM, true>(q, k, v, nullptr, nullptr, out, lse, ws, B, Sq, Sk, H, Hkv, D,     \
                           causal, window, scale, s)
#define FWD_BF(T, DIM)                                                                        \
  launch_fwd_bf16<DIM, false, true>(q, k, v, nullptr, nullptr, out, lse, B, Sq, Sk, H, Hkv, D, \
                                    causal, window, scale, s)
  if (bf16) {
    FLASH_DISPATCH(FWD_BF, __nv_bfloat16)
  }
  FLASH_DISPATCH(FWD, float)
#undef FWD
#undef FWD_BF
}

// K10. q and out (B, Sq, H, D) fp32, or bf16 when `bf16` is 1; k, v (B, Sk,
// Hkv, D) in q's dtype, or int8 codes when kv_int8 is 1 with k_scale and
// v_scale (B, Sk, Hkv) fp32 contiguous (ignored otherwise). The shape rules
// are K6's.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale, void* out,
                                      void* ws, int B, int Sq, int Sk, int H, int Hkv, int D,
                                      int causal, int window, float scale, int bf16,
                                      int kv_int8, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define INFER(T, DIM)                                                                        \
  launch_infer<T, DIM>(q, k, v, k_scale, v_scale, out, ws, B, Sq, Sk, H, Hkv, D, causal,     \
                       window, scale, kv_int8, s)
  if (bf16) {
    FLASH_DISPATCH(INFER, __nv_bfloat16)
  }
  FLASH_DISPATCH(INFER, float)
#undef INFER
}

// K7 and K8 run one kernel for each dtype and head dim: the bf16 one (bf16
// wgmma, three planes of P and dS) or the fp32 one (3xTF32).
#define BWD_DISPATCH(TC, BF)                                                       \
  if (bf16) {                                                                     \
    FLASH_DISPATCH(BF, __nv_bfloat16)                                             \
  }                                                                               \
  FLASH_DISPATCH(TC, float)

extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dq, int B, int Sq,
                                             int Sk, int H, int Hkv, int D, int causal,
                                             int window, float scale, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ_TC(T, DIM)                                                                     \
  launch_dq_tc<DIM>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, window,  \
                    scale, s)
#define DQ_BF(T, DIM)                                                                     \
  launch_dq_bf16<DIM>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, D, causal, window, \
                      scale, s)
  BWD_DISPATCH(DQ_TC, DQ_BF)
#undef DQ_TC
#undef DQ_BF
}

extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dk, void* dv, int B,
                                              int Sq, int Sk, int H, int Hkv, int D,
                                              int causal, int window, float scale, int bf16,
                                              int split, void* ws, void* counters,
                                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split && (H == Hkv || ws == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define DKV_TC(T, DIM)                                                                      \
  launch_dkv_tc<DIM>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal,       \
                     window, scale, split, ws, counters, s)
#define DKV_BF(T, DIM)                                                                      \
  launch_dkv_bf16<DIM>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, D, causal,     \
                       window, scale, split, ws, counters, s)
  BWD_DISPATCH(DKV_TC, DKV_BF)
#undef DKV_TC
#undef DKV_BF
}

#undef BWD_DISPATCH
#undef FLASH_DISPATCH
