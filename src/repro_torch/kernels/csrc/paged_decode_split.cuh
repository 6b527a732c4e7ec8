// Decode attention split across the SMs, on Hopper (sm_90a): the kernel
// body of K1 (decode_attention.cu, a slot-major cache), K2
// (paged_decode_attention.cu, one query lane per slot through the page
// table) and K5 (paged_verify_attention.cu, T query lanes per slot for the
// speculative verify pass). K2 is K5 at T = 1, and K1 is K2 with another
// row policy, so the three share every line here: lane t of slot b sits at
// q_pos = lengths[b] - T + t and attends keys
// [max(0, q_pos + 1 - window), min(q_pos + 1, cap)) (no lower bound without
// a window), cap = n_blocks * page_size. Where key i of slot b lies is the
// row policy's answer: PagedRows reads the page table (key i lives in page
// page_table[b, i / page_size] at row i % page_size), DenseRows the
// cache's strides (b * stride_b + i * stride_s, with page_size 1 and
// n_blocks = Sk, so cap = Sk). Each entry point instantiates its own
// policy only. The window starts at the unclamped length, as the Pallas
// kernels start it, also where a length runs past cap.
//
// Computes what the Pallas TPU kernels repro/kernels/decode_attention.py::
// _decode_kernel, ::_paged_kernel and ::_paged_verify_kernel compute:
// online-softmax
// attention from m = -1e30, the denominator floored at 1e-30, output in
// q's dtype; a dead slot, and a row with no valid key, write exact zeros
// (the Pallas verify kernel averages V there; the engine never reads such
// rows). int8 caches hold codes with one fp32 scale per row and KV head,
// at the row's element offset / D (either policy).
//
// What bounds it on the card: bytes (the live K/V rows over 3.35 TB/s;
// each key costs 4 * rows * D FLOPs against 2 * D * sizeof(KV) bytes). The
// TPU kernels walk a slot's keys in order in the grid's last dimension;
// one block per (slot, KV head) on the card leaves 100 of the 132 SMs
// idle at 8 slots and 4 KV heads, one SM walking a whole long slot. What
// this design does:
//   * the key range is split across blocks: the grid is (split, KV head x
//     lane group, slot). Split boundaries are fixed absolute key
//     positions, multiples of split_len (a multiple of the 64-key tile and
//     of page_size: 1 for K1), chosen by the wrapper's planner from the
//     shapes and the window alone, so no host read of the lengths plans
//     the grid. The
//     grid's split index counts from the first split that holds a key of
//     the block's rows (the window's start, else key 0), so a window costs
//     no empty blocks; a block past its rows' last key exits at once and
//     moves no byte;
//   * each split writes its fp32 partial (m, l, acc[rows, D]) to a
//     workspace, and the last block of a (slot, KV head, lane group) to
//     arrive (an atomic counter, reset by that block) merges the splits in
//     split order in the same launch. A block whose rows' keys lie in one
//     split alone writes its output directly and touches no workspace;
//   * live rows only: keys past a row's bound, outside the window or in a
//     dead slot move no bytes, and table entries past the length, which
//     point at the sink page, are never read. K1 reads the slot-major
//     cache in place through its strides (no transpose to the TPU kernel's
//     (B, Hkv, Sk, D) layout). One block loads each K/V
//     tile once for all rows of its KV head's GQA group and lanes;
//   * bf16 q over a bf16 or int8 cache at D = 128 runs on the tensor cores
//     (split_tc_kernel): one warpgroup holds the block's rows padded to
//     wgmma's M = 64 (rep = 9 for K1 and K2, T * rep = 45 for K5 at T = 5),
//     S = Q K^T by wgmma m64n64k16 from shared memory, O += P V by wgmma
//     m64n128k16 with P in registers, K/V tiles (through the row policy)
//     into a four-stage cp.async ring with zero fill. int8 codes are widened
//     exactly (|c| <= 127 is exact in bf16); the softmax scale and the K
//     scale multiply the fp32 score, the V scale is folded into P before P
//     is rounded to bf16 (the one rounding the fp32 plain version does not
//     make), as K3's tensor-core kernel does; the softmax runs in log2
//     units. Padding rows and keys outside a row's range are masked on the
//     fp32 score before the row max; padding rows write nothing;
//   * every other mode (fp32 q, an fp32 cache, any head dim but 128) runs
//     split_simt_kernel: decode_attention.cuh's tile body (fp32 SIMT dots,
//     q pre-scaled in fp32, expf) with the split and the combine, at every
//     head dim of the reference's configs (8, 16, 24, 64, 112, 128, 168,
//     256): columns past D are never loaded or stored, the tile's last
//     loads and the threads past the P @ V pass's last whole group of D / 4
//     are masked in registers, and the tensors hold no zero columns. With no window, its lane
//     t of K5 equals K2 at length q_pos + 1 bit for bit: the splits and
//     tiles start at the same keys, a key past a row's bound adds p = 0
//     with alpha = 1, a split past it adds a zero partial with weight 0,
//     and a one-split row's combine multiplies by exactly 1.
// The splits depend on the shapes and the window alone, so K1 over a
// dense cache and K2 over a pool of pages of 16 that holds the same rows
// split, walk and merge the same keys in the same order: equal bit for
// bit in every mode.

#pragma once

#include "decode_attention.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxSplits = 64;            // the combine's weights fit the freed tiles

// One launch of either kernel; __grid_constant__, so the fields are read
// from the parameter space, not copied per thread.
struct SplitParams {
  const void* q;                          // (B, T, H, D)
  const void* k;                          // (P, page_size, Hkv, D); K1 (B, Sk, Hkv, D)
  const void* v;
  const int* page_table;                  // (B, n_blocks); K1: none
  const int* lengths;                     // (B,), counting the T lanes
  void* out;                              // (B, T, H, D) in q's dtype
  const float* ks;                        // int8: K/V's shape without D
  const float* vs;
  float* ws;                              // partials: unit x n_splits x rows_cap x (D + 4)
  int* counters;                          // one per unit, zero between launches
  long long stride_page, stride_row;      // in elements (K1: a slot's, a key's)
  int T, H, Hkv, rep, n_blocks, page_size, cap;
  int lanes, groups;                      // lanes a block, lane groups a slot
  int split_len;
  int n_splits;                           // the grid's splits: a unit's partial slots
  int window;
  float scale;
};

// What a block (grid split j of lane group grp of KV head kvh of slot b)
// holds: rows (t_lo + r / rep, head kvh * rep + r % rep), r < n_rows, and
// keys [k0, k1) of split s_first + j; the block's rows see keys in splits
// [s_first, s_first + n_act), whose partials sit in slots [0, n_act).
struct SplitBlock {
  int t_lo, n_rows, q_first, s_first, n_act, k0, k1, unit;
};

__device__ __forceinline__ SplitBlock split_block(const SplitParams& p, int b, int kvh, int grp,
                                                  int j) {
  SplitBlock k;
  k.t_lo = grp * p.lanes;
  const int nl = min(p.lanes, p.T - k.t_lo);
  k.n_rows = nl * p.rep;
  const int len = p.lengths[b];                   // unclamped: it places q
  k.q_first = len - p.T + k.t_lo;                 // the block's first lane's q_pos
  // the union of the lanes' ranges: the first lane's start, the last's end
  const int hi = len > 0 ? min(k.q_first + nl, p.cap) : 0;
  const int lo = p.window > 0 ? max(0, k.q_first + 1 - p.window) : 0;
  if (hi > lo) {
    k.s_first = lo / p.split_len;
    k.n_act = (hi - 1) / p.split_len - k.s_first + 1;
  } else {
    k.s_first = 0;
    k.n_act = 0;
  }
  const int s = k.s_first + j;
  k.k0 = max(s * p.split_len, lo);
  k.k1 = min((s + 1) * p.split_len, hi);
  k.unit = (b * p.Hkv + kvh) * p.groups + grp;
  return k;
}

// Element offset of row r of the block in q and out.
__device__ __forceinline__ long long split_row_off(const SplitParams& p, int b, int kvh,
                                                   const SplitBlock& k, int r, int D) {
  return (((long long)b * p.T + k.t_lo + r / p.rep) * p.H + (long long)kvh * p.rep + r % p.rep) *
         D;
}

// Row r's keys [lo, hi), within the block's split.
__device__ __forceinline__ void split_row_keys(const SplitParams& p, const SplitBlock& k, int r,
                                               int& lo, int& hi) {
  const int q_pos = k.q_first + r / p.rep;
  lo = p.window > 0 ? max(0, q_pos + 1 - p.window) : 0;
  hi = min(min(q_pos + 1, p.cap), k.k1);
}

// Element offset of key i's row (KV head 0) for slot b: through the page
// table (K2, K5), or through a slot-major cache's strides (K1).
struct PagedRows {
  __device__ __forceinline__ static long long row(const SplitParams& p, int b, int i) {
    const int page = __ldg(p.page_table + (long long)b * p.n_blocks + i / p.page_size);
    return (long long)page * p.stride_page + (long long)(i % p.page_size) * p.stride_row;
  }
};

struct DenseRows {
  __device__ __forceinline__ static long long row(const SplitParams& p, int b, int i) {
    return (long long)b * p.stride_page + (long long)i * p.stride_row;
  }
};

template <typename QT>
__device__ __forceinline__ void split_zero_rows(const SplitParams& p, int b, int kvh,
                                                const SplitBlock& k, int D, int nt) {
  QT* out = static_cast<QT*>(p.out);
  for (int i = threadIdx.x; i < k.n_rows * D; i += nt)
    store(out + split_row_off(p, b, kvh, k, i / D, D) + i % D, 0.f);
}

// The last block's merge of the unit's n_act partials, in split order:
// weights f_j = exp(m_j - max m) (exp2 for scores in log2 units), then
// l = sum f_j l_j and out = (sum f_j acc_j) / max(l, 1e-30), both summed
// with fmaf from zero in split order. `scratch` holds rows_cap * (n_act +
// 1) floats of shared memory. The partials were written by other SMs, so
// they are read from L2 (__ldcg), kBatch splits of two outputs a thread
// in flight at once: one block merges the whole unit, and loads issued
// one after another would leave it waiting on L2 for each.
constexpr int kBatch = 8;

template <typename QT, int D, int NT, bool kLog2>
__device__ void split_combine(const SplitParams& p, int b, int kvh, const SplitBlock& k,
                              float* scratch) {
  constexpr int DQ = D / 4;
  const int rows_cap = p.lanes * p.rep;
  const long long slab = (long long)rows_cap * (D + 4);
  const float* base = p.ws + (long long)k.unit * p.n_splits * slab;
  const int n = k.n_act;
  float* inv_s = scratch + rows_cap * n;
  for (int r = threadIdx.x; r < k.n_rows; r += NT) {
    const float* ml = base + (long long)rows_cap * D + 4 * r;
    float m_max = kNegInf;
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float m[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) m[u] = j0 + u < n ? __ldcg(ml + (j0 + u) * slab) : kNegInf;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) m_max = fmaxf(m_max, m[u]);
    }
    float l = 0.f;
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float2 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        x[u] = j0 + u < n ? __ldcg(reinterpret_cast<const float2*>(ml + (j0 + u) * slab))
                          : make_float2(kNegInf, 0.f);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u >= n) break;
        const float d = x[u].x - m_max;
        const float f = kLog2 ? exp2f(d) : expf(d);
        scratch[r * n + j0 + u] = f;
        l = fmaf(f, x[u].y, l);
      }
    }
    inv_s[r] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  QT* out = static_cast<QT*>(p.out);
  const int items = k.n_rows * DQ;                // (row, 4 columns) outputs
  for (int i0 = threadIdx.x; i0 < items; i0 += 2 * NT) {
    float4 a[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) a[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float4 x[2][kBatch];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + e * NT;
        const float* src = base + (long long)(i / DQ) * D + (i % DQ) * 4;
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          x[e][u] = i < items && j0 + u < n
                        ? __ldcg(reinterpret_cast<const float4*>(src + (j0 + u) * slab))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = (i0 + e * NT) / DQ;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (j0 + u >= n) break;
          const float f = i0 + e * NT < items ? scratch[r * n + j0 + u] : 0.f;
          a[e].x = fmaf(f, x[e][u].x, a[e].x);
          a[e].y = fmaf(f, x[e][u].y, a[e].y);
          a[e].z = fmaf(f, x[e][u].z, a[e].z);
          a[e].w = fmaf(f, x[e][u].w, a[e].w);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = i0 + e * NT;
      if (i >= items) break;
      const int r = i / DQ;
      const float inv = inv_s[r];
      QT* o = out + split_row_off(p, b, kvh, k, r, D) + (i % DQ) * 4;
      store(o + 0, a[e].x * inv);
      store(o + 1, a[e].y * inv);
      store(o + 2, a[e].z * inv);
      store(o + 3, a[e].w * inv);
    }
  }
}

// After a block wrote its partial: one arrival on the unit's counter.
// True in the last block to arrive, which then merges (and resets the
// counter to zero for the next launch).
__device__ __forceinline__ bool split_arrive_last(const SplitParams& p, const SplitBlock& k) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.counters + k.unit, 1) == k.n_act - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------------------
// SIMT: every mode; decode_attention.cuh's tile body over one split
// ---------------------------------------------------------------------------

template <typename QT, typename KVT, int D, typename Rows>
__global__ void __launch_bounds__(kThreads)
split_simt_kernel(const __grid_constant__ SplitParams p) {
  constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  constexpr int DQ = D / 4;                       // float4 columns of a row
  constexpr int KS = D + 4;                       // padded K row: conflict-free
  constexpr int G = kThreads / DQ;                // row groups of the P @ V pass
  using RV = RowVec<KVT, D>;
  constexpr int VN = RV::n;
  constexpr int kVecPerRow = D / VN;
  constexpr int kVecs = kTileK * kVecPerRow;      // a tile's vectors, K and V each
  constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;   // per thread; the last masked
  static_assert(D % 8 == 0 && D % VN == 0 && DQ <= kThreads, "unsupported head dim");
  using VecT = typename RV::type;

  const int j = blockIdx.x, kvh = blockIdx.y / p.groups, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const SplitBlock blk = split_block(p, b, kvh, blockIdx.y % p.groups, j);
  if (blk.n_act == 0) {                           // no row has a key: exact zeros
    if (j == 0) split_zero_rows<QT>(p, b, kvh, blk, D, kThreads);
    return;
  }
  if (j >= blk.n_act) return;
  const int n_rows = blk.n_rows;
  const QT* q = static_cast<const QT*>(p.q);
  QT* out = static_cast<QT*>(p.out);

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // n_rows x D, pre-scaled
  float* k_s = q_s + n_rows * D;                  // kTileK x KS
  float* v_s = k_s + kTileK * KS;                 // kTileK x D
  float* p_s = v_s + kTileK * D;                  // n_rows x kTileK
  float* a_s = p_s + n_rows * kTileK;             // this tile's rescale per row
  float* l_s = a_s + n_rows;                      // running denominator per row

  for (int i = tid; i < n_rows * D; i += kThreads)
    q_s[i] = to_float(q[split_row_off(p, b, kvh, blk, i / D, D) + i % D]) * p.scale;
  const KVT* k_g = static_cast<const KVT*>(p.k) + (long long)kvh * D;
  const KVT* v_g = static_cast<const KVT*>(p.v) + (long long)kvh * D;
  const int k0 = blk.k0, k1 = blk.k1;

  // the next tile's K/V rows, held in registers while this tile computes;
  // rows past the split's end are zero, so p = 0 never meets stale memory
  VecT k_next[kLoads], v_next[kLoads];
  float ks_next[kQuant ? kLoads : 1], vs_next[kQuant ? kLoads : 1];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int j = i / kVecPerRow, c = (i % kVecPerRow) * VN;
      if (i < kVecs && t0 + j < k1) {
        const long long row = Rows::row(p, b, t0 + j);
        k_next[u] = *reinterpret_cast<const VecT*>(k_g + row + c);
        v_next[u] = *reinterpret_cast<const VecT*>(v_g + row + c);
        if constexpr (kQuant) {
          ks_next[u] = __ldg(p.ks + row / D + kvh);
          vs_next[u] = __ldg(p.vs + row / D + kvh);
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

  // P @ V ownership: columns 4 cq.. of rows rg, rg + G, ...; a thread past
  // the last whole group (D / 4 not dividing kThreads) owns no row
  const int cq = tid % DQ, rg = tid < G * DQ ? tid / DQ : kThreads;
  float4 acc[kMaxRowsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerThread; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  load_tile(k0);
  for (int t0 = k0; t0 < k1; t0 += kTileK) {
    __syncthreads();                              // last tile's readers are done
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int j = i / kVecPerRow, c = (i % kVecPerRow) * VN;
      if (i >= kVecs) break;
      if constexpr (kQuant) {
        dequant_to_smem(k_next[u], ks_next[u], k_s + j * KS + c);
        dequant_to_smem(v_next[u], vs_next[u], v_s + j * D + c);
      } else {
        to_smem(k_next[u], k_s + j * KS + c);
        to_smem(v_next[u], v_s + j * D + c);
      }
    }
    __syncthreads();
    if (t0 + kTileK < k1) load_tile(t0 + kTileK);   // in flight meanwhile

    // (1) scores and the online-softmax update: warp w owns rows
    // r = w, w + 8, ...; lane owns keys t0 + lane and t0 + lane + 32
    const float4* kr0 = reinterpret_cast<const float4*>(k_s + lane * KS);
    const float4* kr1 = reinterpret_cast<const float4*>(k_s + (lane + 32) * KS);
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= n_rows) break;                     // uniform across the warp
      int lo_r, hi_r;
      split_row_keys(p, blk, r, lo_r, hi_r);
      const bool ok0 = t0 + lane >= lo_r && t0 + lane < hi_r;
      const bool ok1 = t0 + lane + 32 >= lo_r && t0 + lane + 32 < hi_r;
      const float4* qr = reinterpret_cast<const float4*>(q_s + r * D);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int dq = 0; dq < DQ; ++dq) {
        const float4 qv = qr[dq];
        s0 = dot4(qv, kr0[dq], s0);
        s1 = dot4(qv, kr1[dq], s1);
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
      const int r = rg + G * i;
      if (r >= n_rows) break;
      const float alpha = a_s[r];
      float4 a = acc[i];
      a.x *= alpha; a.y *= alpha; a.z *= alpha; a.w *= alpha;
      const float4* pr = reinterpret_cast<const float4*>(p_s + r * kTileK);
#pragma unroll 4
      for (int j4 = 0; j4 < kTileK / 4; ++j4) {
        const float4 pv = pr[j4];
        axpy4(pv.x, v4[(4 * j4 + 0) * DQ + cq], a);
        axpy4(pv.y, v4[(4 * j4 + 1) * DQ + cq], a);
        axpy4(pv.z, v4[(4 * j4 + 2) * DQ + cq], a);
        axpy4(pv.w, v4[(4 * j4 + 3) * DQ + cq], a);
      }
      acc[i] = a;
    }
  }
  __syncthreads();

  if (blk.n_act == 1) {                           // the rows' only split: the output
#pragma unroll
    for (int i = 0; i < kMaxRowsPerThread; ++i) {
      const int r = rg + G * i;
      if (r >= n_rows) break;
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      QT* o = out + split_row_off(p, b, kvh, blk, r, D) + 4 * cq;
      store(o + 0, acc[i].x * inv);
      store(o + 1, acc[i].y * inv);
      store(o + 2, acc[i].z * inv);
      store(o + 3, acc[i].w * inv);
    }
    return;
  }

  // this split's partial: acc rows, then (m, l) per row
  const int rows_cap = p.lanes * p.rep;
  float* part = p.ws + ((long long)blk.unit * p.n_splits + j) * rows_cap * (D + 4);
#pragma unroll
  for (int i = 0; i < kMaxRowsPerThread; ++i) {
    const int r = rg + G * i;
    if (r >= n_rows) break;
    *reinterpret_cast<float4*>(part + r * D + 4 * cq) = acc[i];
  }
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= n_rows) break;
    if (lane == 0) {
      part[rows_cap * D + 4 * r] = m_run[i];
      part[rows_cap * D + 4 * r + 1] = l_s[r];
    }
  }
  if (!split_arrive_last(p, blk)) return;
  split_combine<QT, D, kThreads, false>(p, b, kvh, blk, k_s);
  if (tid == 0) p.counters[blk.unit] = 0;
}

template <typename QT, typename KVT, int D, typename Rows>
cudaError_t launch_split_simt(const SplitParams& p, int B, cudaStream_t stream) {
  const int rows = p.lanes * p.rep;
  if (rows > max_rows(D)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)rows * D + (size_t)kTileK * (D + 4) +
                                       (size_t)kTileK * D + (size_t)rows * kTileK + 2 * (size_t)rows);
  auto kernel = split_simt_kernel<QT, KVT, D, Rows>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(p.n_splits, p.Hkv * p.groups, B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor cores: bf16 q over a bf16 or int8 cache, D = 128
// ---------------------------------------------------------------------------

constexpr int kSpD = 128;
constexpr int kSpRows = 64;                       // wgmma's M: the block's rows, padded
constexpr int kSpThreads = 128;                   // one warpgroup
constexpr int kSpKeys = 64;                       // keys a tile
constexpr int kSpStages = 4;                      // the cp.async ring
constexpr int kSpHalf = 64 * 128;                 // one 64-column half of a 64-row bf16 tile
constexpr int kSpTile = 2 * kSpHalf;              // a 64 x 128 bf16 tile (Q, K or V)
constexpr int kSpRaw = kSpKeys * kSpD;            // a 64 x 128 tile of int8 codes
constexpr float kSpLog2e = 1.4426950408889634f;

// Shared memory of the tensor-core kernel: Q, then (int8) the widened K
// and V tiles, then the ring's stages: bf16 K and V tiles, or int8 codes as
// they landed with their K and V scales. 1024-aligned for the swizzle.
template <bool kInt8>
struct SpLayout {
  static constexpr int kStage = kInt8 ? 2 * kSpRaw + 1024 : 2 * kSpTile;
  static constexpr int kWide = kInt8 ? 2 * kSpTile : 0;
  static constexpr size_t kBytes = 1024 + kSpTile + kWide + (size_t)kSpStages * kStage;
};

// Byte offset of the 16-byte chunk holding columns 8c..8c+7 (c in 0-15) of
// row r of a 64-row bf16 tile of 128 columns: two 64-column halves of 8 KB,
// each with the 128-byte swizzle, the layout wgmma reads both K-major (Q,
// K) and N-major (V).
__device__ __forceinline__ uint32_t sp_chunk(int r, int c) {
  return (uint32_t)((c >> 3) * kSpHalf) + hopper::sw128(r, c & 7);
}

template <bool kInt8, typename Rows>
__global__ void __launch_bounds__(kSpThreads, 1)
split_tc_kernel(const __grid_constant__ SplitParams p) {
  using Lay = SpLayout<kInt8>;
  extern __shared__ unsigned char sp_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sp_smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* q_s = smem;
  unsigned char* wide = smem + kSpTile;
  unsigned char* stage0 = wide + Lay::kWide;
  auto stage = [&](int st) { return stage0 + st * Lay::kStage; };
  auto k_tile = [&](int st) { return kInt8 ? wide : stage(st); };
  auto v_tile = [&](int st) { return kInt8 ? wide + kSpTile : stage(st) + kSpTile; };
  auto scales = [&](int st) { return reinterpret_cast<float*>(stage(st) + 2 * kSpRaw); };

  const int j = blockIdx.x, kvh = blockIdx.y / p.groups, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const SplitBlock blk = split_block(p, b, kvh, blockIdx.y % p.groups, j);
  if (blk.n_act == 0) {                           // no row has a key: exact zeros
    if (j == 0) split_zero_rows<__nv_bfloat16>(p, b, kvh, blk, kSpD, kSpThreads);
    return;
  }
  if (j >= blk.n_act) return;
  const int n_rows = blk.n_rows, k0 = blk.k0, k1 = blk.k1;
  const int n_tiles = (k1 - k0 + kSpKeys - 1) / kSpKeys;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);

  // tile i's rows into stage st with cp.async, zeros past the split's
  // end: bf16 rows straight into the swizzled tiles, int8 rows as they lie
  // (each thread widens the chunks it copied, after they land) with their
  // scales
  auto fetch = [&](int i, int st) {
    const int kt0 = k0 + i * kSpKeys;
    if constexpr (kInt8) {
      const int8_t* kp8 = static_cast<const int8_t*>(p.k) + kvh * kSpD;
      const int8_t* vp8 = static_cast<const int8_t*>(p.v) + kvh * kSpD;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = tid + u * kSpThreads, r = idx >> 3, c = idx & 7;
        const bool ok = kt0 + r < k1;
        const long long row = ok ? Rows::row(p, b, kt0 + r) : 0;
        hopper::cp_async16_zfill(hopper::smem_addr(stage(st) + r * kSpD + c * 16),
                                 kp8 + row + c * 16, ok);
        hopper::cp_async16_zfill(hopper::smem_addr(stage(st) + kSpRaw + r * kSpD + c * 16),
                                 vp8 + row + c * 16, ok);
      }
      const int r = tid & (kSpKeys - 1);
      const bool ok = kt0 + r < k1;
      const long long s_off = ok ? Rows::row(p, b, kt0 + r) / kSpD + kvh : 0;
      hopper::cp_async4_zfill(hopper::smem_addr(scales(st) + tid),
                              (tid < kSpKeys ? p.ks : p.vs) + s_off, ok);
    } else {
      const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + kvh * kSpD;
      const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + kvh * kSpD;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = tid + u * kSpThreads, r = idx >> 4, c = idx & 15;
        const bool ok = kt0 + r < k1;
        const long long row = ok ? Rows::row(p, b, kt0 + r) : 0;
        hopper::cp_async16_zfill(hopper::smem_addr(k_tile(st) + sp_chunk(r, c)),
                                 kb + row + c * 8, ok);
        hopper::cp_async16_zfill(hopper::smem_addr(v_tile(st) + sp_chunk(r, c)),
                                 vb + row + c * 8, ok);
      }
    }
  };

  // Q: the block's rows, zeros in the padding rows
#pragma unroll
  for (int u = 0; u < kSpRows * 16 / kSpThreads; ++u) {
    const int idx = tid + u * kSpThreads, r = idx >> 4, c = idx & 15;
    const bool ok = r < n_rows;
    hopper::cp_async16_zfill(hopper::smem_addr(q_s + sp_chunk(r, c)),
                             q + (ok ? split_row_off(p, b, kvh, blk, r, kSpD) : 0) + c * 8, ok);
  }
#pragma unroll
  for (int i = 0; i < kSpStages - 1; ++i) {       // group 0 holds Q too
    if (i < n_tiles) fetch(i, i);
    hopper::cp_async_commit();
  }

  // this thread's rows (g and g + 8 of its warp's 16) and their keys
  const int g = lane >> 2, t = lane & 3;
  int row[2], lo[2], hi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    row[e] = warp * 16 + g + 8 * e;
    split_row_keys(p, blk, row[e], lo[e], hi[e]);
    if (row[e] >= n_rows) hi[e] = lo[e];          // padding: no key
  }
  const float c_log2 = p.scale * kSpLog2e;        // scores in log2 units
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float s_acc[32], o_acc[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) o_acc[i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kSpStages;
    if (i + kSpStages - 1 < n_tiles) fetch(i + kSpStages - 1, (i + kSpStages - 1) % kSpStages);
    hopper::cp_async_commit();
    hopper::cp_async_wait<kSpStages - 1>();       // tile i (and Q) landed
    if constexpr (kInt8) {
      // this thread's own 16-code chunks (row r, codes 16c..16c+15 of K and
      // of V, as fetch copied them) to bf16, exactly, into the swizzled
      // tiles: two 8-value chunks each
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = tid + (u & 3) * kSpThreads, r = idx >> 3, c = idx & 7;
        const uint4 w = *reinterpret_cast<const uint4*>(stage(st) + (u < 4 ? 0 : kSpRaw) +
                                                        r * kSpD + c * 16);
        unsigned char* dst = u < 4 ? wide : wide + kSpTile;
        const uint2 a = hopper::widen4(w.x), bb = hopper::widen4(w.y);
        const uint2 e = hopper::widen4(w.z), f = hopper::widen4(w.w);
        *reinterpret_cast<uint4*>(dst + sp_chunk(r, 2 * c)) = make_uint4(a.x, a.y, bb.x, bb.y);
        *reinterpret_cast<uint4*>(dst + sp_chunk(r, 2 * c + 1)) = make_uint4(e.x, e.y, f.x, f.y);
      }
    }
    hopper::fence_proxy_async();
    __syncthreads();

    const int kt0 = k0 + i * kSpKeys;
    // S = Q K^T over D in 16-deep steps (two 64-column halves)
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSpD / 16; ++j) {
      const uint32_t off = (j >> 2) * kSpHalf + (j & 3) * 32;
      hopper::wgmma_ss_n64(s_acc, hopper::sw128_desc(q_s + off, 16, 1024),
                           hopper::sw128_desc(k_tile(st) + off, 16, 1024), j > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s_acc);

    // online softmax in log2 units; s_acc[4j + e]: row row[e / 2], key
    // kt0 + 8j + 2t + e % 2. int8 tiles scale the score by the key's scale
    // and P by the value's
    const float* sc = scales(st);
    float pv[32];
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int e = x & 3, key = 8 * (x >> 2) + 2 * t + (e & 1), kp = kt0 + key;
      const int rr = e >> 1;
      const bool ok = kp >= lo[rr] && kp < hi[rr];
      const float sv = s_acc[x] * (kInt8 ? sc[key] * c_log2 : c_log2);
      pv[x] = ok ? sv : kNegInf;
      m_new[rr] = fmaxf(m_new[rr], pv[x]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      m_new[rr] = fmaxf(m_new[rr], __shfl_xor_sync(0xffffffffu, m_new[rr], 1));
      m_new[rr] = fmaxf(m_new[rr], __shfl_xor_sync(0xffffffffu, m_new[rr], 2));
      alpha[rr] = exp2f(m_run[rr] - m_new[rr]);
      m_run[rr] = m_new[rr];
    }
    uint32_t a[4][4];
#pragma unroll
    for (int x = 0; x < 32; x += 2) {
      const int rr = (x & 3) >> 1, key = 8 * (x >> 2) + 2 * t;
      float p0 = pv[x] > kNegInf ? exp2f(pv[x] - m_new[rr]) : 0.f;
      float p1 = pv[x + 1] > kNegInf ? exp2f(pv[x + 1] - m_new[rr]) : 0.f;
      sum[rr] += p0 + p1;
      if (kInt8) {
        p0 *= sc[kSpKeys + key];
        p1 *= sc[kSpKeys + key + 1];
      }
      const __nv_bfloat162 pp = __floats2bfloat162_rn(p0, p1);
      // key group jj = x / 4 of 8: k step jj / 2, register (jj % 2) * 2 + rr
      a[x >> 3][((x >> 2) & 1) * 2 + rr] = *reinterpret_cast<const uint32_t*>(&pp);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
      l_run[rr] = l_run[rr] * alpha[rr] + sum[rr];
    }
#pragma unroll
    for (int x = 0; x < 64; ++x) o_acc[x] *= alpha[(x & 3) >> 1];

    // O += P V over the tile's keys in 16-deep steps (V N-major: its
    // 64-column halves 8 KB apart, 8-key groups 1 KB apart)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSpKeys / 16; ++kk)
      hopper::wgmma_rs_n128<1>(o_acc, a[kk],
                               hopper::sw128_desc(v_tile(st) + kk * 16 * 128, kSpHalf, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o_acc);
    __syncthreads();                              // stage st and the wide tiles are free
  }
  hopper::cp_async_wait<0>();                     // no copy in flight at exit

  if (blk.n_act == 1) {                           // the rows' only split: the output
    const float inv[2] = {1.f / fmaxf(l_run[0], 1e-30f), 1.f / fmaxf(l_run[1], 1e-30f)};
#pragma unroll
    for (int x = 0; x < 64; x += 2) {
      const int rr = (x & 3) >> 1, col = 8 * (x >> 2) + 2 * t;
      if (row[rr] < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(out + split_row_off(p, b, kvh, blk, row[rr], kSpD) +
                                           col) =
            __floats2bfloat162_rn(o_acc[x] * inv[rr], o_acc[x + 1] * inv[rr]);
    }
    return;
  }

  // this split's partial: acc rows, then (m, l) per row (log2 units)
  const int rows_cap = p.lanes * p.rep;
  float* part = p.ws + ((long long)blk.unit * p.n_splits + j) * rows_cap * (kSpD + 4);
#pragma unroll
  for (int x = 0; x < 64; x += 2) {
    const int rr = (x & 3) >> 1, col = 8 * (x >> 2) + 2 * t;
    if (row[rr] < n_rows)
      *reinterpret_cast<float2*>(part + row[rr] * kSpD + col) = make_float2(o_acc[x], o_acc[x + 1]);
  }
  if (t == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      if (row[rr] < n_rows) {
        part[rows_cap * kSpD + 4 * row[rr]] = m_run[rr];
        part[rows_cap * kSpD + 4 * row[rr] + 1] = l_run[rr];
      }
  }
  if (!split_arrive_last(p, blk)) return;
  split_combine<__nv_bfloat16, kSpD, kSpThreads, true>(p, b, kvh, blk,
                                                       reinterpret_cast<float*>(stage0));
  if (tid == 0) p.counters[blk.unit] = 0;
}

template <bool kInt8, typename Rows>
cudaError_t launch_split_tc(const SplitParams& p, int B, cudaStream_t stream) {
  if (p.lanes * p.rep > kSpRows) return cudaErrorInvalidValue;
  const size_t smem = SpLayout<kInt8>::kBytes;
  auto kernel = split_tc_kernel<kInt8, Rows>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.n_splits, p.Hkv * p.groups, B), kSpThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The launch's parameters from an entry point's arguments (pointers as
// the wrappers pass them; H a multiple of Hkv, checked by the caller). K1
// passes no table, page_size 1, n_blocks = Sk and its slot and key
// strides.
inline SplitParams split_params(const void* q, const void* k_pool, const void* v_pool,
                                const void* page_table, const void* lengths, void* out, int T,
                                int H, int Hkv, int n_blocks, int page_size,
                                long long stride_page, long long stride_row, int window,
                                float scale, const void* ks, const void* vs, int lanes,
                                int split_len, int n_splits, void* ws, void* counters) {
  SplitParams p;
  p.q = q;
  p.k = k_pool;
  p.v = v_pool;
  p.page_table = static_cast<const int*>(page_table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.stride_page = stride_page;
  p.stride_row = stride_row;
  p.T = T;
  p.H = H;
  p.Hkv = Hkv;
  p.rep = H / Hkv;
  p.n_blocks = n_blocks;
  p.page_size = page_size;
  p.cap = n_blocks * page_size;
  p.lanes = lanes;
  p.groups = lanes > 0 ? (T + lanes - 1) / lanes : 0;
  p.split_len = split_len;
  p.n_splits = n_splits;
  p.window = window;
  p.scale = scale;
  return p;
}

// One launch with row policy Rows: the tensor-core kernel when asked for
// (bf16 q over a bf16 or int8 cache at D = 128, else an error: the
// wrapper's route decides), the SIMT kernel otherwise.
template <typename Rows>
cudaError_t launch_split(const SplitParams& p, int B, int D, int q_bf16, int kv_type,
                                int tensor_cores, cudaStream_t stream) {
  if (B < 1 || p.T < 1 || p.Hkv < 1 || p.rep < 1 || p.lanes < 1 || p.n_splits < 1 ||
      p.n_splits > kMaxSplits || p.split_len < 1 || p.groups * p.lanes < p.T ||
      (p.n_splits > 1 && (p.ws == nullptr || p.counters == nullptr)))
    return cudaErrorInvalidValue;
  if (tensor_cores) {
    if (!q_bf16 || D != kSpD) return cudaErrorInvalidValue;
    if (kv_type == kKvBf16) return launch_split_tc<false, Rows>(p, B, stream);
    if (kv_type == kKvInt8) return launch_split_tc<true, Rows>(p, B, stream);
    return cudaErrorInvalidValue;
  }
#define SPLIT_CASE(QT, KVT)                                                               \
  switch (D) {                                                                            \
    case 8: return launch_split_simt<QT, KVT, 8, Rows>(p, B, stream);                     \
    case 16: return launch_split_simt<QT, KVT, 16, Rows>(p, B, stream);                   \
    case 24: return launch_split_simt<QT, KVT, 24, Rows>(p, B, stream);                   \
    case 64: return launch_split_simt<QT, KVT, 64, Rows>(p, B, stream);                   \
    case 112: return launch_split_simt<QT, KVT, 112, Rows>(p, B, stream);                 \
    case 128: return launch_split_simt<QT, KVT, 128, Rows>(p, B, stream);                 \
    case 168: return launch_split_simt<QT, KVT, 168, Rows>(p, B, stream);                 \
    case 256: return launch_split_simt<QT, KVT, 256, Rows>(p, B, stream);                 \
    default: return cudaErrorInvalidValue;                                                \
  }
  if (q_bf16) {
    if (kv_type == kKvBf16) { SPLIT_CASE(__nv_bfloat16, __nv_bfloat16) }
    if (kv_type == kKvInt8) { SPLIT_CASE(__nv_bfloat16, int8_t) }
    SPLIT_CASE(__nv_bfloat16, float)
  }
  if (kv_type == kKvBf16) { SPLIT_CASE(float, __nv_bfloat16) }
  if (kv_type == kKvInt8) { SPLIT_CASE(float, int8_t) }
  SPLIT_CASE(float, float)
#undef SPLIT_CASE
}

}  // namespace
