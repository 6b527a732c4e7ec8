// K3: chunked-prefill attention through the paged KV pool, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// paged_prefill_attention (_paged_prefill_kernel). Row b of the batch
// carries a chunk of C query tokens at absolute positions start_b + t; the
// first len_b are live. Query token t of row b attends
//   * the cached prefix [0, start_b), read from the pool in its storage
//     dtype through page_table[b, kp / page_size] (decode numerics), and
//   * its own chunk's keys k_rel <= t, k_rel < len_b, read from the
//     full-precision k_new / v_new in q's dtype (dense-prefill numerics;
//     the pool also holds the chunk, but in storage dtype, and is never
//     read there),
// both limited by the window (q_abs - k_abs < window when window > 0). One
// loop walks the absolute key positions kp of both parts, so the mask is
// the XLA paged_extend mask: kp <= q_abs, kp < start + len, window. fp32
// accumulation, q scaled in fp32 before the dot, online softmax from
// m = -1e30, denominator floored at 1e-30, output in q's dtype. A padding
// token t >= len_b of a live row attends every key below start_b + len_b
// that its window reaches, as the Pallas kernel's padding rows do (an MoE
// block ranks its routes together with the live tokens'); every row of a
// dead row (len_b = 0), and a row no key reaches, writes exact zeros.
// In the int8-KV mode the pool holds int8 codes with one fp32 scale per
// (page, row, KV head) in ks/vs, at the pool row's element offset / D; the
// SIMT kernel dequantizes each cached key and value in fp32 registers (code
// * scale) as it loads, as the Pallas body does (flash_attention.py:459-477).
// The chunk's own K/V stay in q's dtype.
//
// Two kernels, chosen by the wrapper from the dtypes and the head dim (no
// fallback either way): bf16 q over a bf16 or int8 pool at D = 112, 128
// or 168 runs paged_prefill_tc_kernel on the tensor cores; fp32 q, an fp32
// pool or any other head dim runs paged_prefill_kernel, fp32 SIMT dots, since TF32
// would change the fp32 numerics. The SIMT kernel takes every head dim of
// the reference's configs (8, 16, 24, 64, 112, 128, 168), masked by
// length and never padded: a tile's last loads, and the threads past the
// P @ V pass's last whole group of D / 4 (D = 24, 112, 168), are masked
// in registers.
//
// What bounds it on the card: operations. Each (query, key) pair costs
// 4 * D FLOPs per head, and every K/V row a block loads serves all of its
// query rows. The SIMT kernel:
//   * a grid over (row b, KV head, tile of T chunk tokens): the T * rep = 72
//     query rows of a tile share each K/V row the block loads, and
//     B * Hkv * ceil(C / T) blocks fill the card (1,024 at B = 8, C = 256);
//   * the chunk keys are a loop over 64-key tiles that stops at the causal
//     limit of the tile's last live token, not one block of the whole
//     chunk: C can be the whole suffix of a prompt, far beyond shared
//     memory;
//   * only the pages the prefix needs are read ([window start, start)), in
//     place through the pool's strides; the TPU wrapper's transposes of the
//     pools and its padding of C are not carried over;
//   * query rows flatten (token, rep) row-major, so a tile holds whole
//     tokens and row r decodes as token r / rep, head r % rep.
// The tensor-core kernel (D = 128; 112 and 168 on tiles of 128 and 192
// columns, zero past D in shared memory only, below):
//   * a block is 128 consecutive chunk tokens of one q head, two warpgroups
//     of 64 rows. Rows of one head, not the (token, head) packing above:
//     each row's causal and window limits are then its token, with no
//     division by rep, every block's output rows are whole 256-byte rows
//     of one head, and the 9-fold re-read of a KV head's tiles by the 9
//     heads of its group comes from the 50 MB L2 (the two layouts walk
//     the same number of (64-row, 64-key) tile pairs);
//   * S = Q K^T by wgmma m64n64k16 from shared memory (8 steps over D),
//     O += P V by wgmma m64n128k16 with P in registers as the A operand and
//     V N-major from shared memory; tiles are 64-row halves of 64 columns
//     with the 128-byte swizzle wgmma reads;
//   * K/V tiles of 64 keys (the cached prefix, then the chunk) come in
//     through a two-stage cp.async ring, 16 bytes a copy with zero fill
//     past the tile's last key, rows found through the page table (its
//     entries cached in shared memory); bf16 rows land in the swizzled
//     tiles, int8 rows as they lie, and each thread widens the chunks it
//     copied, exactly, into the swizzled tiles;
//   * int8 numerics: the codes are exact in bf16, so they enter the MMAs
//     unscaled; the softmax scale and the per-key K scale multiply the fp32
//     score, and the per-key V scale is folded into P before P is rounded
//     to bf16 (the
//     one rounding the fp32 reference does not make: 2^-9 relative a
//     term); chunk keys and bf16 pools use a scale of 1;
//   * the online softmax runs in log2 units with exp2, m from -1e30, the
//     denominator floored at 1e-30, rows at or past the length exact
//     zeros; O / l goes out in bf16 through shared memory in whole rows.
// Known weak points (ROADMAP item 18): both warpgroups wait at three
// block barriers a tile, so the softmax does not overlap the MMAs, and the
// fp32-pool mode stays on fp32 CUDA cores.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include "decode_attention.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 72;                 // query rows a block holds: T * rep
constexpr int kRowsPerWarp = (kRows + kWarps - 1) / kWarps;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const QT* __restrict__ q, const QT* __restrict__ k_new,
                     const QT* __restrict__ v_new, const KVT* __restrict__ k_pool,
                     const KVT* __restrict__ v_pool, const int* __restrict__ page_table,
                     const int* __restrict__ starts, const int* __restrict__ lens,
                     QT* __restrict__ out, int C, int H, int Hkv, int n_blocks,
                     int page_size, long long stride_page, long long stride_row,
                     int tokens, int window, float scale, const float* __restrict__ ks,
                     const float* __restrict__ vs) {
  constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  constexpr int DQ = D / 4;                       // 4-element columns of a row
  constexpr int KS = D + 4;                       // padded K row: conflict-free
  constexpr int G = kThreads / DQ;                // row groups of the P @ V pass
  constexpr int kRowsPerThread = (kRows + G - 1) / G;
  constexpr int kVecs = kTileK * DQ;              // a tile's 4-value vectors, K and V each
  constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;   // per thread; the last masked
  static_assert(D % 8 == 0 && DQ <= kThreads, "unsupported head dim");

  const int rep = H / Hkv;
  const int R = tokens * rep;                     // <= kRows
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // R x D, pre-scaled
  float* k_s = q_s + R * D;                       // kTileK x KS
  float* v_s = k_s + kTileK * KS;                 // kTileK x D
  float* p_s = v_s + kTileK * D;                  // R x kTileK
  float* a_s = p_s + R * kTileK;                  // this tile's rescale per row
  float* l_s = a_s + R;                           // running denominator per row

  const int b = blockIdx.x, kvh = blockIdx.y, t0 = blockIdx.z * tokens;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // no start can read table entries past n_blocks, no len past the chunk
  const int start = min(max(starts[b], 0), n_blocks * page_size);
  const int ln = min(lens[b], C);
  // output row r of this tile: token t0 + r / rep, head kvh * rep + r % rep
  auto row_off = [&](int r) {
    return (((long long)b * C + t0 + r / rep) * H + (long long)kvh * rep + r % rep) * D;
  };
  const int r_end = min(R, (C - t0) * rep);       // rows of tokens inside the chunk
  if (ln <= 0) {                                  // a dead row: exact zeros
    for (int i = tid; i < r_end * D; i += kThreads) store(out + row_off(i / D) + i % D, 0.f);
    return;
  }

  for (int i = tid; i < R * DQ; i += kThreads) {
    const int r = i / DQ, c = (i % DQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < r_end) x = load4(q + row_off(r) + c);
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *reinterpret_cast<float4*>(q_s + r * D + c) = x;
  }
  for (int r = tid; r < R; r += kThreads) l_s[r] = 0.f;

  // absolute key positions [kp_lo, kp_end): the cached prefix below start,
  // then the chunk up to the tile's last live token (all of the row's keys
  // once the tile holds a padding token)
  const int kp_end = start + min(ln, t0 + tokens);
  const int kp_lo = window > 0 ? max(0, start + t0 - window + 1) : 0;
  const KVT* kp_g = k_pool + (long long)kvh * D;
  const KVT* vp_g = v_pool + (long long)kvh * D;
  const long long chunk_row = (long long)Hkv * D;
  const QT* kc_g = k_new + (long long)b * C * chunk_row + (long long)kvh * D;
  const QT* vc_g = v_new + (long long)b * C * chunk_row + (long long)kvh * D;

  float m_run[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) m_run[i] = kNegInf;
  // P @ V ownership: columns 4 cq.. of rows grp, grp + G, ...; a thread
  // past the last whole group (D / 4 not dividing kThreads) owns no row
  const int cq = tid % DQ, grp = tid < G * DQ ? tid / DQ : kThreads;
  float4 acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt0 = kp_lo; kt0 < kp_end; kt0 += kTileK) {
    // (0) this tile's K/V rows, all loads issued before any store; keys
    // past kp_end are zero, so p = 0 never meets stale memory
    float4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int kp = kt0 + i / DQ, c = (i % DQ) * 4;
      if (i >= kVecs) {
        kr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vr[u] = kr[u];
      } else if (kp < start) {
        const int page = __ldg(page_table + (long long)b * n_blocks + kp / page_size);
        const long long row =
            (long long)page * stride_page + (long long)(kp % page_size) * stride_row;
        kr[u] = load4(kp_g + row + c);
        vr[u] = load4(vp_g + row + c);
        if constexpr (kQuant) {
          const long long s_off = row / D + kvh;
          kr[u] = scale4(kr[u], __ldg(ks + s_off));
          vr[u] = scale4(vr[u], __ldg(vs + s_off));
        }
      } else if (kp < kp_end) {
        const long long off = (long long)(kp - start) * chunk_row + c;
        kr[u] = load4(kc_g + off);
        vr[u] = load4(vc_g + off);
      } else {
        kr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vr[u] = kr[u];
      }
    }
    __syncthreads();                              // last tile's readers are done
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int j = i / DQ, c = (i % DQ) * 4;
      if (i >= kVecs) break;
      *reinterpret_cast<float4*>(k_s + j * KS + c) = kr[u];
      *reinterpret_cast<float4*>(v_s + j * D + c) = vr[u];
    }
    __syncthreads();

    // (1) scores: warp w owns rows r = w, w + 8, ...; lane owns keys
    // kt0 + lane and kt0 + lane + 32; each K value loaded serves every row
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    const float4* k0 = reinterpret_cast<const float4*>(k_s + lane * KS);
    const float4* k1 = reinterpret_cast<const float4*>(k_s + (lane + 32) * KS);
    const float4* q4 = reinterpret_cast<const float4*>(q_s);
#pragma unroll 2
    for (int dq = 0; dq < DQ; ++dq) {
      const float4 ka = k0[dq], kb = k1[dq];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        if (r < R) {                              // uniform across the warp
          const float4 qv = q4[r * DQ + dq];
          s[i][0] = dot4(qv, ka, s[i][0]);
          s[i][1] = dot4(qv, kb, s[i][1]);
        }
      }
    }
    // the online-softmax update of each owned row, with warp reductions
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= R) break;
      const int q_abs = start + t0 + r / rep;
      const int ka = kt0 + lane, kb = ka + 32;
      const bool valid0 = ka < kp_end && ka <= q_abs && (window <= 0 || q_abs - ka < window);
      const bool valid1 = kb < kp_end && kb <= q_abs && (window <= 0 || q_abs - kb < window);
      const float s0 = valid0 ? s[i][0] : kNegInf;
      const float s1 = valid1 ? s[i][1] : kNegInf;
      const float m_old = m_run[i];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = valid0 ? expf(s0 - m_new) : 0.f;
      const float p1 = valid1 ? expf(s1 - m_new) : 0.f;
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
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = grp + G * i;
      if (r >= R) break;
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

  // rows no key reaches have l = 0 and acc = 0: exact zeros
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = grp + G * i;
    if (r >= r_end) break;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    QT* o = out + row_off(r) + 4 * cq;
    store(o + 0, acc[i].x * inv);
    store(o + 1, acc[i].y * inv);
    store(o + 2, acc[i].z * inv);
    store(o + 3, acc[i].w * inv);
  }
}

template <typename QT, typename KVT, int D>
cudaError_t launch_prefill(const void* q, const void* k_new, const void* v_new,
                           const void* k_pool, const void* v_pool, const void* page_table,
                           const void* starts, const void* lens, void* out, int B, int C,
                           int H, int Hkv, int n_blocks, int page_size, long long stride_page,
                           long long stride_row, int window, float scale,
                           const float* ks, const float* vs, cudaStream_t stream) {
  const int rep = H / Hkv;
  const int tokens = kRows / rep;
  const int rows = tokens * rep;
  const size_t smem = sizeof(float) * ((size_t)rows * D + (size_t)kTileK * (D + 4) +
                                       (size_t)kTileK * D + (size_t)rows * kTileK +
                                       2 * (size_t)rows);
  auto kernel = paged_prefill_kernel<QT, KVT, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, Hkv, (C + tokens - 1) / tokens);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(k_new), static_cast<const QT*>(v_new),
      static_cast<const KVT*>(k_pool), static_cast<const KVT*>(v_pool),
      static_cast<const int*>(page_table), static_cast<const int*>(starts),
      static_cast<const int*>(lens), static_cast<QT*>(out), C, H, Hkv, n_blocks, page_size,
      stride_page, stride_row, tokens, window, scale, ks, vs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor cores: bf16 q over a bf16 or int8 pool, D = 112, 128 and 168
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;                     // query rows a block: two warpgroups
constexpr int kTcKeys = 64;                      // keys a tile
constexpr int kTcThreads = 256;
constexpr int kTcHalf = 64 * 128;                // one 64-column block of a 64-row bf16 tile
constexpr float kLog2e = 1.4426950408889634f;

// The tiles' columns for a head dim of DG: DG rounded up to whole
// 64-column blocks of the 128-byte swizzle (128 for 112, 192 for 168),
// zero past DG in shared memory only; the tensors are read and written at
// DG.
__host__ __device__ constexpr int tc_cols(int DG) { return (DG + 63) / 64 * 64; }
// Q: two warpgroups x the column blocks
__host__ __device__ constexpr int tc_q_bytes(int DG) { return kTcRows * tc_cols(DG) * 2; }
// a K or V tile in bf16
__host__ __device__ constexpr int tc_tile_bytes(int DG) { return kTcKeys * tc_cols(DG) * 2; }
// a K or V tile of int8 codes as it landed (rows of tc_cols bytes)
__host__ __device__ constexpr int tc_raw_bytes(int DG) { return kTcKeys * tc_cols(DG); }
// a stage: K, V, raw K, raw V, the K and V scales; 1024-aligned
__host__ __device__ constexpr int tc_stage_bytes(int DG) {
  return (2 * tc_tile_bytes(DG) + 2 * tc_raw_bytes(DG) + 2 * kTcKeys * 4 + 1023) / 1024 * 1024;
}
// page-table entries a row can hold in shared memory beside two stages:
// 16384 at 112 and 128 (199,680 bytes in all); 8192 at 168, whose Q and
// stages take 199,680 bytes before the table (232,448 with it). The
// wrapper raises above it (paged_prefill_attention.tc_max_pages).
__host__ __device__ constexpr int tc_max_pages(int DG) { return DG > 128 ? 8192 : 16384; }

template <int DG>
inline size_t tc_smem_bytes(int n_blocks) {
  return 1024 + tc_q_bytes(DG) + 2 * (size_t)tc_stage_bytes(DG) + 4 * (size_t)n_blocks;
}

// Byte offset of the 16-byte chunk holding columns 8c..8c+7 of row r of a
// 64-row bf16 tile: 64-column blocks of 8 KB, each with the 128-byte
// swizzle, the layout wgmma reads both K-major (Q, K) and N-major (V).
__device__ __forceinline__ uint32_t tc_chunk(int r, int c) {
  return (uint32_t)((c >> 3) * kTcHalf) + hopper::sw128(r, c & 7);
}

// DG is the head dim (112, 128 or 168); the tiles hold DP = tc_cols(DG)
// columns. S runs ceil(DG / 16) k steps of 16 (7 at 112, 8 at 128, 11 at
// 168, whose last step reads columns 160-175, zero past 167); P V runs
// m64nDPk16 (n128, or n192 at 168) and the columns past DG are not
// stored. The columns past DG of the K and V tiles are zeroed once, before
// the first tile, and never written again (the copies and the int8
// widening touch only the head's columns); Q's by the copy's zero fill.
template <bool kInt8, int DG>
__global__ void __launch_bounds__(kTcThreads, 1)
paged_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_new,
                        const __nv_bfloat16* __restrict__ v_new, const void* __restrict__ k_pool,
                        const void* __restrict__ v_pool, const int* __restrict__ page_table,
                        const int* __restrict__ starts, const int* __restrict__ lens,
                        __nv_bfloat16* __restrict__ out, int C, int H, int Hkv, int n_blocks,
                        int page_size, long long stride_page, long long stride_row, int window,
                        float scale, const float* __restrict__ ks,
                        const float* __restrict__ vs) {
  constexpr int DP = tc_cols(DG);
  constexpr int kBlocks = DP / 64;                            // 64-column blocks
  constexpr int kChunks = DG / 8;                             // the head's 16-byte chunks a row
  constexpr int kTile = tc_tile_bytes(DG), kRaw = tc_raw_bytes(DG);
  constexpr int kStage = tc_stage_bytes(DG);
  // int8 rows land in 16-byte copies where DG allows, else 8-byte ones
  // (168 codes: 8-byte aligned rows)
  constexpr int kRawCopy = DG % 16 == 0 ? 16 : 8;
  constexpr int kRawChunks = DG / kRawCopy;
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tc_smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* q_s = smem;                                  // also the output staging
  unsigned char* stage0 = smem + tc_q_bytes(DG);
  int* pt_s = reinterpret_cast<int*>(stage0 + 2 * kStage);    // the prefix's page entries
  // a stage: K tile, V tile (bf16, swizzled), raw K, raw V (int8), K and V scales
  auto k_tile = [&](int st) { return stage0 + st * kStage; };
  auto v_tile = [&](int st) { return stage0 + st * kStage + kTile; };
  auto raw_k = [&](int st) { return stage0 + st * kStage + 2 * kTile; };
  auto raw_v = [&](int st) { return stage0 + st * kStage + 2 * kTile + kRaw; };
  auto scales = [&](int st) {
    return reinterpret_cast<float*>(stage0 + st * kStage + 2 * kTile + 2 * kRaw);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * kTcRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int start = min(max(starts[b], 0), n_blocks * page_size);
  const int ln = min(lens[b], C);
  const long long q_row = (long long)H * DG;                  // q / out token stride
  const __nv_bfloat16* q_b = q + ((long long)b * C * H + h) * DG;
  __nv_bfloat16* out_b = out + ((long long)b * C * H + h) * DG;
  const int r_end = min(kTcRows, C - t0);                     // rows inside the chunk
  if (ln <= 0) {                                              // a dead row: exact zeros
    for (int i = tid; i < r_end * kChunks; i += kTcThreads)
      *reinterpret_cast<uint4*>(out_b + (t0 + i / kChunks) * q_row + (i % kChunks) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  // key walk: the cached prefix [kp_lo, start) in 64-key tiles, then the
  // chunk [ck_lo, kp_end) in 64-key tiles up to the block's last live token
  // (every chunk key once the block holds a padding token)
  const int kp_lo = window > 0 ? max(0, start + t0 - window + 1) : 0;
  const int kp_end = start + min(ln, t0 + kTcRows);
  const int n_pre = kp_lo < start ? (start - kp_lo + kTcKeys - 1) / kTcKeys : 0;
  const int ck_lo = max(kp_lo, start);
  const int n_tiles = n_pre + (kp_end - ck_lo + kTcKeys - 1) / kTcKeys;
  const int pg_lo = kp_lo / page_size;
  for (int i = tid; i < (start + page_size - 1) / page_size - pg_lo; i += kTcThreads)
    pt_s[i] = page_table[(long long)b * n_blocks + pg_lo + i];
  // the padding columns of both stages' K and V tiles
  if constexpr (DP / 8 > kChunks) {
    constexpr int kPad = DP / 8 - kChunks;                    // chunks a row
    for (int i = tid; i < 4 * kTcKeys * kPad; i += kTcThreads) {
      const int tile = i / (kTcKeys * kPad), j = i % (kTcKeys * kPad);
      *reinterpret_cast<uint4*>(stage0 + (tile >> 1) * kStage + (tile & 1) * kTile +
                                tc_chunk(j / kPad, kChunks + j % kPad)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();

  const long long chunk_row = (long long)Hkv * DG;
  const __nv_bfloat16* kc = k_new + (long long)b * C * chunk_row + (long long)kvh * DG;
  const __nv_bfloat16* vc = v_new + (long long)b * C * chunk_row + (long long)kvh * DG;
  auto tile_span = [&](int i, int& kt0, int& kt_end) {
    if (i < n_pre) {
      kt0 = kp_lo + i * kTcKeys;
      kt_end = min(kt0 + kTcKeys, start);
    } else {
      kt0 = ck_lo + (i - n_pre) * kTcKeys;
      kt_end = min(kt0 + kTcKeys, kp_end);
    }
  };
  // element offset of cached key kp's row (its KV head's first element);
  // a shift for the usual power-of-two page sizes
  const int ps_shift = (page_size & (page_size - 1)) == 0 ? __ffs(page_size) - 1 : -1;
  auto pool_row = [&](int kp) {
    const int pg = ps_shift >= 0 ? kp >> ps_shift : kp / page_size;
    return (long long)pt_s[pg - pg_lo] * stride_page +
           (long long)(kp - pg * page_size) * stride_row;
  };
  // tile i's rows into stage st with cp.async, zeros past its last key:
  // bf16 rows straight into the swizzled tiles, int8 rows as they lie
  // (each thread widens the chunks it copied, after they land) with their
  // scales
  auto fetch = [&](int i, int st) {
    int kt0, kt_end;
    tile_span(i, kt0, kt_end);
    if (kInt8 && i < n_pre) {
      const int8_t* kp8 = static_cast<const int8_t*>(k_pool) + kvh * DG;
      const int8_t* vp8 = static_cast<const int8_t*>(v_pool) + kvh * DG;
#pragma unroll
      for (int u = 0; u < (kTcKeys * kRawChunks + kTcThreads - 1) / kTcThreads; ++u) {
        const int idx = tid + u * kTcThreads, r = idx / kRawChunks, c = idx % kRawChunks;
        if (idx >= kTcKeys * kRawChunks) break;
        const int kp = kt0 + r;
        const bool ok = kp < kt_end;
        const long long row = ok ? pool_row(kp) : 0;
        const uint32_t dk = hopper::smem_addr(raw_k(st) + r * DP + c * kRawCopy);
        const uint32_t dv = hopper::smem_addr(raw_v(st) + r * DP + c * kRawCopy);
        if constexpr (kRawCopy == 16) {
          hopper::cp_async16_zfill(dk, kp8 + row + c * 16, ok);
          hopper::cp_async16_zfill(dv, vp8 + row + c * 16, ok);
        } else {
          hopper::cp_async8_zfill(dk, kp8 + row + c * 8, ok);
          hopper::cp_async8_zfill(dv, vp8 + row + c * 8, ok);
        }
      }
      if (tid < 2 * kTcKeys) {
        const int r = tid & (kTcKeys - 1), kp = kt0 + r;
        const bool ok = kp < kt_end;
        const long long s_off = ok ? pool_row(kp) / DG + kvh : 0;
        hopper::cp_async4_zfill(hopper::smem_addr(scales(st) + tid),
                                (tid < kTcKeys ? ks : vs) + s_off, ok);
      }
      return;
    }
#pragma unroll
    for (int u = 0; u < (kTcKeys * kChunks + kTcThreads - 1) / kTcThreads; ++u) {
      const int idx = tid + u * kTcThreads, r = idx / kChunks, c = idx % kChunks;
      if (idx >= kTcKeys * kChunks) break;
      const int kp = kt0 + r;
      const bool ok = kp < kt_end;
      const __nv_bfloat16 *ksrc = kc, *vsrc = vc;
      if (ok) {
        if (i < n_pre) {
          const long long row = pool_row(kp) + kvh * DG;
          ksrc = static_cast<const __nv_bfloat16*>(k_pool) + row;
          vsrc = static_cast<const __nv_bfloat16*>(v_pool) + row;
        } else {
          ksrc = kc + (long long)(kp - start) * chunk_row;
          vsrc = vc + (long long)(kp - start) * chunk_row;
        }
      }
      hopper::cp_async16_zfill(hopper::smem_addr(k_tile(st) + tc_chunk(r, c)), ksrc + c * 8, ok);
      hopper::cp_async16_zfill(hopper::smem_addr(v_tile(st) + tc_chunk(r, c)), vsrc + c * 8, ok);
    }
  };

  // Q: 128 rows of head h, zeros past the chunk and past DG
#pragma unroll
  for (int u = 0; u < kTcRows * (DP / 8) / kTcThreads; ++u) {
    const int idx = tid + u * kTcThreads, r = idx / (DP / 8), c = idx % (DP / 8);
    const bool ok = t0 + r < C && c < kChunks;
    hopper::cp_async16_zfill(
        hopper::smem_addr(q_s + (r >> 6) * (kBlocks * kTcHalf) + tc_chunk(r & 63, c)),
        q_b + (ok ? (t0 + r) * q_row + c * 8 : 0), ok);
  }
  fetch(0, 0);
  hopper::cp_async_commit();

  // this thread's rows of the warpgroup's 64 (g and g + 8 of its warp)
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int row_a = wg * 64 + (warp & 3) * 16 + g;             // block row; row_a + 8 too
  // a row past the chunk sees no key; a padding row of the chunk sees the
  // row's keys, which kt_end bounds at start + len
  int q_abs[2];
  bool live[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    q_abs[e] = start + t0 + row_a + 8 * e;
    live[e] = t0 + row_a + 8 * e < C;
  }
  const float c_log2 = scale * kLog2e;                         // scores in log2 units
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float s_acc[32], o_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
  const unsigned char* q_wg = q_s + wg * (kBlocks * kTcHalf);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    if (i + 1 < n_tiles) fetch(i + 1, st ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();                                // tile i (and Q) landed
    const bool widen = kInt8 && i < n_pre;
    if (widen) {
      // this thread's own code chunks (row r, codes kRawCopy c.. of K and
      // of V, as fetch copied them) to bf16, exactly, into the swizzled
      // tiles: 8-value chunks
#pragma unroll
      for (int u = 0; u < (kTcKeys * kRawChunks + kTcThreads - 1) / kTcThreads; ++u) {
        const int idx = tid + u * kTcThreads, r = idx / kRawChunks, c = idx % kRawChunks;
        if (idx >= kTcKeys * kRawChunks) break;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const unsigned char* src = (kv ? raw_v(st) : raw_k(st)) + r * DP + c * kRawCopy;
          unsigned char* dst = kv ? v_tile(st) : k_tile(st);
          if constexpr (kRawCopy == 16) {
            const uint4 w = *reinterpret_cast<const uint4*>(src);
            const uint2 a = hopper::widen4(w.x), bb = hopper::widen4(w.y);
            const uint2 e = hopper::widen4(w.z), f = hopper::widen4(w.w);
            *reinterpret_cast<uint4*>(dst + tc_chunk(r, 2 * c)) = make_uint4(a.x, a.y, bb.x, bb.y);
            *reinterpret_cast<uint4*>(dst + tc_chunk(r, 2 * c + 1)) =
                make_uint4(e.x, e.y, f.x, f.y);
          } else {
            const uint2 w = *reinterpret_cast<const uint2*>(src);
            const uint2 a = hopper::widen4(w.x), bb = hopper::widen4(w.y);
            *reinterpret_cast<uint4*>(dst + tc_chunk(r, c)) = make_uint4(a.x, a.y, bb.x, bb.y);
          }
        }
      }
    }
    hopper::fence_proxy_async();
    __syncthreads();

    int kt0, kt_end;
    tile_span(i, kt0, kt_end);
    // S = Q K^T over DG in 16-deep steps (the 64-column blocks in turn)
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < (DG + 15) / 16; ++j) {
      const uint32_t off = (j >> 2) * kTcHalf + (j & 3) * 32;
      hopper::wgmma_ss_n64(s_acc, hopper::sw128_desc(q_wg + off, 16, 1024),
                           hopper::sw128_desc(k_tile(st) + off, 16, 1024), j > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s_acc);

    // online softmax in log2 units; s_acc[4j + e]: row row_a + 8 (e / 2),
    // key kt0 + 8j + 2t + e % 2. int8 tiles scale the score by the key's
    // scale and P by the value's; bf16 tiles by 1
    const float* sc = scales(st);
    float p[32];
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int e = x & 3, key = 8 * (x >> 2) + 2 * t + (e & 1), kp = kt0 + key;
      const int rr = e >> 1;
      const bool ok = live[rr] && kp < kt_end && kp <= q_abs[rr] &&
                      (window <= 0 || q_abs[rr] - kp < window);
      const float s = s_acc[x] * (widen ? sc[key] * c_log2 : c_log2);
      p[x] = ok ? s : kNegInf;
      m_new[rr] = fmaxf(m_new[rr], p[x]);
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
      float p0 = p[x] > kNegInf ? exp2f(p[x] - m_new[rr]) : 0.f;
      float p1 = p[x + 1] > kNegInf ? exp2f(p[x + 1] - m_new[rr]) : 0.f;
      sum[rr] += p0 + p1;
      if (widen) {
        p0 *= sc[kTcKeys + key];
        p1 *= sc[kTcKeys + key + 1];
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
    for (int x = 0; x < DP / 2; ++x) o_acc[x] *= alpha[(x & 3) >> 1];

    // O += P V over the tile's keys in 16-deep steps (V N-major: its
    // 64-column blocks 8 KB apart, 8-key groups 1 KB apart)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint64_t vd = hopper::sw128_desc(v_tile(st) + kk * 16 * 128, kTcHalf, 1024);
      if constexpr (DP == 128)
        hopper::wgmma_rs_n128<1>(o_acc, a[kk], vd, 1);
      else
        hopper::wgmma_rs_n192<1>(o_acc, a[kk], vd, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o_acc);
    __syncthreads();                                           // stage st is free again
  }

  // O / l in bf16 through the warpgroup's own Q tile (rows of DP columns,
  // 16-byte chunks swizzled by row), then the head's DG columns of each
  // row to global memory; rows no key reaches have l = 0 and O = 0: exact
  // zeros
  unsigned char* o_s = q_s + wg * (kBlocks * kTcHalf);
  const float inv[2] = {1.f / fmaxf(l_run[0], 1e-30f), 1.f / fmaxf(l_run[1], 1e-30f)};
  const int r_wg = (warp & 3) * 16 + g;
#pragma unroll
  for (int x = 0; x < DP / 2; x += 2) {
    const int rr = (x & 3) >> 1, r = r_wg + 8 * rr, col = 8 * (x >> 2) + 2 * t;
    const __nv_bfloat162 v = __floats2bfloat162_rn(o_acc[x] * inv[rr], o_acc[x + 1] * inv[rr]);
    *reinterpret_cast<__nv_bfloat162*>(o_s + r * (2 * DP) + (((col >> 3) ^ (r & 7)) << 4) +
                                       (col & 7) * 2) = v;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const int wt = tid & 127;
#pragma unroll
  for (int u = 0; u < (64 * kChunks + 127) / 128; ++u) {
    const int idx = wt + u * 128, r = idx / kChunks, c = idx % kChunks, row = wg * 64 + r;
    if (idx < 64 * kChunks && row < r_end)
      *reinterpret_cast<uint4*>(out_b + (t0 + row) * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * (2 * DP) + ((c ^ (r & 7)) << 4));
  }
}

template <bool kInt8, int DG>
cudaError_t launch_prefill_tc(const void* q, const void* k_new, const void* v_new,
                              const void* k_pool, const void* v_pool, const void* page_table,
                              const void* starts, const void* lens, void* out, int B, int C,
                              int H, int Hkv, int n_blocks, int page_size, long long stride_page,
                              long long stride_row, int window, float scale, const float* ks,
                              const float* vs, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<DG>(n_blocks);
  auto kernel = paged_prefill_tc_kernel<kInt8, DG>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kTcRows - 1) / kTcRows, H, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), k_pool, v_pool,
      static_cast<const int*>(page_table), static_cast<const int*>(starts),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), C, H, Hkv, n_blocks,
      page_size, stride_page, stride_row, window, scale, ks, vs);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point of the SIMT kernel, which takes fp32 or bf16 q over
// any pool (bf16 q over a bf16 or int8 pool is the tensor-core kernel's at
// D = 112, 128 and 168; the wrapper routes it there). q (B, C, H, D),
// k_new/v_new (B, C, Hkv, D) in q's dtype and out (B, C, H, D), all
// contiguous; k/v pools (P, page_size, Hkv, D) with unit stride on D and
// stride D on Hkv, their page and row strides given in elements;
// page_table (B, n_blocks) int32 contiguous; starts and lens (B,) int32;
// kv_type a KvType. With int8 pools, ks/vs (P, page_size, Hkv) fp32 have
// the pools' strides / D (else they are unused). H / Hkv <= 72 and D in
// {8, 16, 24, 64, 112, 128, 168}. Returns the CUDA error of the launch (0
// on success).
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* page_table, const void* starts, const void* lens,
    void* out, int B, int C, int H, int Hkv, int D, int n_blocks, int page_size,
    long long pool_stride_page, long long pool_stride_row, int window, float scale,
    int q_bf16, int kv_type, const void* ks, const void* vs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
#define PREFILL_D(QT, KVT, DD)                                                            \
    case DD: return static_cast<int>(launch_prefill<QT, KVT, DD>(                         \
        q, k_new, v_new, k_pool, v_pool, page_table, starts, lens, out, B, C, H, Hkv,     \
        n_blocks, page_size, pool_stride_page, pool_stride_row, window, scale, ksf, vsf,  \
        s));
#define PREFILL_CASE(QT, KVT)                                                             \
  switch (D) {                                                                            \
    PREFILL_D(QT, KVT, 8) PREFILL_D(QT, KVT, 16) PREFILL_D(QT, KVT, 24)                   \
    PREFILL_D(QT, KVT, 64) PREFILL_D(QT, KVT, 112) PREFILL_D(QT, KVT, 128)                \
    PREFILL_D(QT, KVT, 168)                                                               \
    default: return static_cast<int>(cudaErrorInvalidValue);                              \
  }
  if (q_bf16) {
    if (kv_type == kKvBf16) { PREFILL_CASE(__nv_bfloat16, __nv_bfloat16) }
    if (kv_type == kKvInt8) { PREFILL_CASE(__nv_bfloat16, int8_t) }
    PREFILL_CASE(__nv_bfloat16, float)
  }
  if (kv_type == kKvBf16) { PREFILL_CASE(float, __nv_bfloat16) }
  if (kv_type == kKvInt8) { PREFILL_CASE(float, int8_t) }
  PREFILL_CASE(float, float)
#undef PREFILL_CASE
#undef PREFILL_D
}


// Plain C entry point of the tensor-core kernel: bf16 q, k_new, v_new and
// out as for paged_prefill_attention_launch, a bf16 or int8 pool (kv_type),
// D = 112, 128 or 168, any H / Hkv; the table's entries of one row must fit
// in shared memory beside the tiles (n_blocks <= tc_max_pages(D): 16384,
// 8192 at 168). Returns the CUDA error of the launch (0 on success).
extern "C" int paged_prefill_attention_tc_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* page_table, const void* starts, const void* lens,
    void* out, int B, int C, int H, int Hkv, int D, int n_blocks, int page_size,
    long long pool_stride_page, long long pool_stride_row, int window, float scale,
    int kv_type, const void* ks, const void* vs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((D != 112 && D != 128 && D != 168) || n_blocks > tc_max_pages(D) || H % Hkv != 0 ||
      (kv_type != kKvBf16 && kv_type != kKvInt8))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = kv_type == kKvInt8;
  const float* ksf = int8 ? static_cast<const float*>(ks) : nullptr;
  const float* vsf = int8 ? static_cast<const float*>(vs) : nullptr;
#define PREFILL_TC(I8, DG)                                                                    \
  launch_prefill_tc<I8, DG>(q, k_new, v_new, k_pool, v_pool, page_table, starts, lens, out, B, \
                            C, H, Hkv, n_blocks, page_size, pool_stride_page, pool_stride_row, \
                            window, scale, ksf, vsf, s)
  cudaError_t err;
  if (D == 112)
    err = int8 ? PREFILL_TC(true, 112) : PREFILL_TC(false, 112);
  else if (D == 128)
    err = int8 ? PREFILL_TC(true, 128) : PREFILL_TC(false, 128);
  else
    err = int8 ? PREFILL_TC(true, 168) : PREFILL_TC(false, 168);
#undef PREFILL_TC
  return static_cast<int>(err);
}
