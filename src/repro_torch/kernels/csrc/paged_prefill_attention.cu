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
// m = -1e30, denominator floored at 1e-30, output in q's dtype. Rows at or
// past len_b, and every row of a dead row (len_b = 0), write exact zeros.
//
// What bounds it on the card: operations. Each (query, key) pair costs
// 4 * D FLOPs per head; a block of T tokens x rep heads reuses every K/V
// row it loads T * rep times, so at starcoder2-7b's shapes (rep = 9,
// T = 8, D = 128) it does about 72 FLOP per byte of fp32 pool read, and a
// chunk's quadratic term adds more: the least time is the pairs' FLOPs over
// the fp32 peak. What the design does about it:
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
// Known weak point: the dots run on fp32 CUDA cores (the pool is fp32 on
// the main path and the reference is fp32), with one block per SM for its
// 120 KB of shared memory; tensor cores (wgmma, TMA) are later work.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include "decode_attention.cuh"

namespace {

constexpr int kRows = 72;                 // query rows a block holds: T * rep
constexpr int kRowsPerWarp = (kRows + kWarps - 1) / kWarps;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
                     int tokens, int window, float scale) {
  constexpr int DQ = D / 4;                       // 4-element columns of a row
  constexpr int KS = D + 4;                       // padded K row: conflict-free
  constexpr int G = kThreads / DQ;                // row groups of the P @ V pass
  constexpr int kRowsPerThread = (kRows + G - 1) / G;
  constexpr int kLoads = kTileK * DQ / kThreads;  // per thread, K and V each
  static_assert(kThreads % DQ == 0 && (kTileK * DQ) % kThreads == 0,
                "unsupported head dim");

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
  if (t0 >= ln) {                                 // no live token: exact zeros
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
  // then the chunk up to the tile's last live token
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
  const int cq = tid % DQ, grp = tid / DQ;        // P @ V ownership
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
      if (kp < start) {
        const int page = __ldg(page_table + (long long)b * n_blocks + kp / page_size);
        const long long off =
            (long long)page * stride_page + (long long)(kp % page_size) * stride_row + c;
        kr[u] = load4(kp_g + off);
        vr[u] = load4(vp_g + off);
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
      const int q_rel = t0 + r / rep;
      const int q_abs = start + q_rel;
      const bool live = q_rel < ln;
      const int ka = kt0 + lane, kb = ka + 32;
      const bool valid0 = live && ka <= q_abs && (window <= 0 || q_abs - ka < window);
      const bool valid1 = live && kb <= q_abs && (window <= 0 || q_abs - kb < window);
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

  // rows with no live key (past len) have l = 0 and acc = 0: exact zeros
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
                           cudaStream_t stream) {
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
      stride_page, stride_row, tokens, window, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point. q (B, C, H, D), k_new/v_new (B, C, Hkv, D) in q's
// dtype and out (B, C, H, D), all contiguous; k/v pools (P, page_size, Hkv,
// D) with unit stride on D and stride D on Hkv, their page and row strides
// given in elements; page_table (B, n_blocks) int32 contiguous; starts and
// lens (B,) int32. H / Hkv <= 72 and D in {64, 128}. Returns the CUDA error
// of the launch (0 on success).
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* page_table, const void* starts, const void* lens,
    void* out, int B, int C, int H, int Hkv, int D, int n_blocks, int page_size,
    long long pool_stride_page, long long pool_stride_row, int window, float scale,
    int q_bf16, int kv_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PREFILL_CASE(QT, KVT)                                                             \
  switch (D) {                                                                            \
    case 64: return static_cast<int>(launch_prefill<QT, KVT, 64>(                         \
        q, k_new, v_new, k_pool, v_pool, page_table, starts, lens, out, B, C, H, Hkv,     \
        n_blocks, page_size, pool_stride_page, pool_stride_row, window, scale, s));       \
    case 128: return static_cast<int>(launch_prefill<QT, KVT, 128>(                       \
        q, k_new, v_new, k_pool, v_pool, page_table, starts, lens, out, B, C, H, Hkv,     \
        n_blocks, page_size, pool_stride_page, pool_stride_row, window, scale, s));       \
    default: return static_cast<int>(cudaErrorInvalidValue);                              \
  }
  if (q_bf16) {
    if (kv_bf16) { PREFILL_CASE(__nv_bfloat16, __nv_bfloat16) }
    PREFILL_CASE(__nv_bfloat16, float)
  }
  if (kv_bf16) { PREFILL_CASE(float, __nv_bfloat16) }
  PREFILL_CASE(float, float)
#undef PREFILL_CASE
}
