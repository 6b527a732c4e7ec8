// K6, K7, K8: flash attention for training, forward with lse and its two
// backward kernels, and K10, the inference flash attention, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels behind repro/kernels/flash_attention.py::
// flash_attention_vjp and flash_attention:
//   K6  _fwd_with_lse         (_flash_kernel with save_lse=True)
//   K7  _flash_vjp_bwd -> dQ  (_flash_bwd_dq_kernel)
//   K8  _flash_vjp_bwd -> dK, dV (_flash_bwd_dkv_kernel)
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
// What bounds it on the card: operations. A valid (query, key) pair costs
// 4 * D FLOPs per head forward, 6 * D in K7 (s, dP, dQ) and 8 * D in K8 (s,
// dP, dV, dK), against one read of each q, k, v, dO row: at starcoder2-7b's
// shapes (S = 2048, causal) that is hundreds of FLOPs per byte, above the
// H100's ridge, so the least time is the pairs' FLOPs over the fp32 (or
// bf16) peak. What the design does about it:
//   * 64 x 64 tiles, 256 threads, each thread a 4 x 4 block of scores and
//     4 rows x D/16 columns of the accumulator in registers, so each value
//     read from shared memory serves 4 FMAs;
//   * tiles outside the causal triangle or the window are never visited:
//     the key loop (K6, K7) and the query loop (K8) run only over the range
//     the tile's rows can see;
//   * K8 gives each block one (batch, KV head, key tile) and walks the rep
//     query heads of the group and their query tiles inside the block, so
//     the GQA sum stays in registers: no atomics, a deterministic result,
//     and no per-query-head fp32 dK/dV in device memory (the TPU kernel
//     writes (B, H, Sk, D) fp32 and sums outside);
//   * rows that shared memory reads across threads (K rows in the score
//     pass) are padded to D + 4 floats, so 16-byte reads hit distinct banks.
// Known weak point: the dots run on fp32 CUDA cores with no overlap of
// loads and math (one block per SM for K7 and K8, two for K6); wgmma, TMA
// and a load pipeline are later work.
//
// K10 (the inference flash_attention, with its int8-KV mode) is the same
// forward body without the lse: flash_fwd_kernel takes the K/V storage
// type and the lse switch as template parameters. In the int8-KV mode K and
// V are int8 codes with one fp32 scale per (batch, key, KV head), (B, Sk,
// Hkv); the tile loads widen each code to fp32 and multiply it by its
// row's scale (the Pallas body's k * ks, v * vs), where the fp mode only
// converts. The bound and the math are K6's; the int8 codes move 4x (2x)
// fewer K/V bytes than fp32 (bf16). With Sq > Sk under a window, a query
// row whose window lies past the last key sees no key and is zeros: the
// Pallas kernel averages V over the masked keys of the tiles it visited
// there, and the JAX wrapper sends such ragged shapes to attention_ref,
// which averages all of V; no model path makes such a row.
//
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C entry point, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // query rows and keys per tile
constexpr int kPS = kTile + 16;      // row stride of a 64 x 64 P or dS tile
constexpr float kNegInf = -1e30f;

// floats of a 64-row tile of stride D + 4 whose space a P or dS tile
// (stride kPS) takes over once it is read
__host__ __device__ constexpr int shared_tile(int D) { return kTile * (D + 4 > kPS ? D + 4 : kPS); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4& x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float4 mul4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// eight consecutive elements of a global row, in fp32
__device__ __forceinline__ void ld8(const float* p, float4& a, float4& b) {
  a = ld4(p);
  b = ld4(p + 4);
}

__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float4& a, float4& b) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 x0 = __bfloat1622float2(h[0]), x1 = __bfloat1622float2(h[1]);
  const float2 x2 = __bfloat1622float2(h[2]), x3 = __bfloat1622float2(h[3]);
  a = make_float4(x0.x, x0.y, x1.x, x1.y);
  b = make_float4(x2.x, x2.y, x3.x, x3.y);
}

// eight int8 codes, widened exactly
__device__ __forceinline__ void ld8(const int8_t* p, float4& a, float4& b) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  a = make_float4((float)(int8_t)u.x, (float)(int8_t)(u.x >> 8), (float)(int8_t)(u.x >> 16),
                  (float)(int8_t)(u.x >> 24));
  b = make_float4((float)(int8_t)u.y, (float)(int8_t)(u.y >> 8), (float)(int8_t)(u.y >> 16),
                  (float)(int8_t)(u.y >> 24));
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, const float4& x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, const float4& x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float comp(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// max / sum over the 16 lanes of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool valid_pair(int i, int j, int Sq, int Sk, int causal,
                                           int window) {
  const int diff = i - j;
  return i < Sq && j < Sk && (!causal || diff >= 0) && (window <= 0 || diff < window);
}

// Rows [0, 64) of a tile into shared memory with row stride `stride`
// floats, times `mul`: global row r at src + r * gstride (elements); rows
// at or past n_valid are zeros, so p = 0 never meets stale memory. With
// `row_scale` (int8 codes), row r is also multiplied by row_scale[r *
// sstride], its fp32 scale.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          long long gstride, int n_valid, float mul,
                                          const float* row_scale = nullptr,
                                          int sstride = 0) {
  constexpr int C8 = D / 8;
  for (int idx = threadIdx.x; idx < kTile * C8; idx += kThreads) {
    const int r = idx / C8, c = (idx % C8) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r < n_valid) {
      ld8(src + r * gstride + c, a, b);
      const float f = row_scale ? mul * row_scale[(long long)r * sstride] : mul;
      a = mul4(a, f);
      b = mul4(b, f);
    }
    st4(dst + r * stride + c, a);
    st4(dst + r * stride + c + 4, b);
  }
}

// 64 per-row floats (lse or delta) of rows [r0, r0 + n_valid), else 0
__device__ __forceinline__ void load_rows(float* dst, const float* src, int n_valid) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) dst[r] = r < n_valid ? src[r] : 0.f;
}

// The score pass: s[i][j] = A[ty + 16 i] . B[tx + 16 j] over D. A's rows
// are shared by the 16 lanes of a row group (broadcast reads); B's rows
// differ per lane, so B's stride is D + 4.
template <int D>
__device__ __forceinline__ void dots(const float* a_s, int a_stride, const float* b_s,
                                     int ty, int tx, float (&s)[4][4]) {
  constexpr int BS = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(a_s + (ty + 16 * i) * a_stride + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(b_s + (tx + 16 * j) * BS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
  }
}

// The product pass: acc[i][c] += sum_kk P[ty + 16 i][kk] * V[kk][4 tx + 64 c
// .. + 3] over the tile's 64 kk, P with row stride kPS, V with `v_stride`.
template <int D>
__device__ __forceinline__ void pv(const float* p_s, const float* v_s, int v_stride, int ty,
                                   int tx, float4 (&acc)[4][D / 64]) {
  constexpr int CJ = D / 64;
#pragma unroll 2
  for (int kk = 0; kk < kTile; kk += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ld4(p_s + (ty + 16 * i) * kPS + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float4 vv = ld4(v_s + (kk + u) * v_stride + 4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) axpy4(comp(p[i], u), vv, acc[i][c]);
      }
    }
  }
}

// K6 and K10: grid (Sq tiles, H, B). Block x walks query tile nq - 1 - x,
// so the causal triangle's longest rows start first. Shared memory: Q (64 x
// D, scaled), K (64 x (D + 4)), V (64 x D); P reuses K's space once the
// scores are taken. k_scale and v_scale (B, Sk, Hkv) are the int8-KV
// mode's row scales, null otherwise.
template <typename QT, typename KVT, int D, bool kSaveLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
                 const KVT* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, QT* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int causal,
                 int window, float scale) {
  constexpr int KS = D + 4, CJ = D / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kTile * D;
  float* v_s = k_s + shared_tile(D);
  float* p_s = k_s;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long q_row = (long long)H * D, k_row = (long long)Hkv * D;
  const int n_q = min(kTile, Sq - q0);
  load_tile<QT, D>(q_s, D, q + ((long long)b * Sq + q0) * q_row + (long long)h * D, q_row,
                   n_q, scale);
  const KVT* k_g = k + (long long)b * Sk * k_row + (long long)hk * D;
  const KVT* v_g = v + (long long)b * Sk * k_row + (long long)hk * D;
  const long long s_off = (long long)b * Sk * Hkv + hk;   // row 0's scale

  const int q_last = q0 + n_q - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;

  float m[4], l[4];
  float4 acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();                      // the last tile's P and V readers are done
    const int n_k = min(kTile, Sk - k0);
    load_tile<KVT, D>(k_s, KS, k_g + k0 * k_row, k_row, n_k, 1.f,
                      k_scale ? k_scale + s_off + (long long)k0 * Hkv : nullptr, Hkv);
    load_tile<KVT, D>(v_s, D, v_g + k0 * k_row, k_row, n_k, 1.f,
                      v_scale ? v_scale + s_off + (long long)k0 * Hkv : nullptr, Hkv);
    __syncthreads();
    float s[4][4];
    dots<D>(q_s, D, k_s, ty, tx, s);
    __syncthreads();                      // every score is taken: P may overwrite K
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = valid_pair(qi, k0 + tx + 16 * j, Sq, Sk, causal, window);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * kPS + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] = mul4(acc[i][c], alpha);
    }
    __syncthreads();
    pv<D>(p_s, v_s, D, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) break;
    const float den = fmaxf(l[i], 1e-30f);
    QT* o = out + ((long long)b * Sq + qi) * q_row + (long long)h * D + 4 * tx;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const float4 a = acc[i][c];
      st4(o + 64 * c, make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
    if constexpr (kSaveLse) {
      if (tx == 0) lse[((long long)b * H + h) * Sq + qi] = m[i] + logf(den);
    }
  }
}

// K7: grid (Sq tiles, H, B), heaviest tiles first as in K6. Shared memory:
// Q (scaled) and dO (64 x D), K and V (64 x (D + 4)), the rows' lse and
// delta; dS reuses V's space once dP is taken.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H,
                    int Hkv, int causal, int window, float scale) {
  constexpr int KS = D + 4, CJ = D / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTile * D;
  float* k_s = do_s + kTile * D;
  float* v_s = k_s + kTile * KS;
  float* lse_s = v_s + shared_tile(D);
  float* dl_s = lse_s + kTile;
  float* ds_s = v_s;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long q_row = (long long)H * D, k_row = (long long)Hkv * D;
  const int n_q = min(kTile, Sq - q0);
  const long long q_off = ((long long)b * Sq + q0) * q_row + (long long)h * D;
  load_tile<T, D>(q_s, D, q + q_off, q_row, n_q, scale);
  load_tile<T, D>(do_s, D, dout + q_off, q_row, n_q, 1.f);
  const long long row_off = ((long long)b * H + h) * Sq + q0;
  load_rows(lse_s, lse + row_off, n_q);
  load_rows(dl_s, delta + row_off, n_q);
  const T* k_g = k + (long long)b * Sk * k_row + (long long)hk * D;
  const T* v_g = v + (long long)b * Sk * k_row + (long long)hk * D;

  const int q_last = q0 + n_q - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;

  float4 acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();                      // the last tile's dS and K readers are done
    const int n_k = min(kTile, Sk - k0);
    load_tile<T, D>(k_s, KS, k_g + k0 * k_row, k_row, n_k, 1.f);
    load_tile<T, D>(v_s, KS, v_g + k0 * k_row, k_row, n_k, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<D>(q_s, D, k_s, ty, tx, s);
    dots<D>(do_s, D, v_s, ty, tx, dp);
    __syncthreads();                      // every dP is taken: dS may overwrite V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float lse_r = lse_s[r], dl_r = dl_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = valid_pair(q0 + r, k0 + tx + 16 * j, Sq, Sk, causal, window);
        // explicit mask: a row with no valid key has lse ~ -1e30
        const float p = ok ? expf(s[i][j] - lse_r) : 0.f;
        ds_s[r * kPS + tx + 16 * j] = p * (dp[i][j] - dl_r);
      }
    }
    __syncthreads();
    pv<D>(ds_s, k_s, KS, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) break;
    T* o = dq + ((long long)b * Sq + qi) * q_row + (long long)h * D + 4 * tx;
#pragma unroll
    for (int c = 0; c < CJ; ++c) st4(o + 64 * c, mul4(acc[i][c], scale));
  }
}

// K8: grid (Sk tiles, Hkv, B). Shared memory: K and V (64 x D), Q (scaled)
// and dO (64 x (D + 4)), P^T and dS^T (64 x kPS), the query rows' lse and
// delta. Each thread holds 4 key rows x D/16 columns of dK and of dV.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                     int causal, int window, float scale) {
  constexpr int QS = D + 4, CJ = D / 64;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kTile * D;
  float* q_s = v_s + kTile * D;
  float* do_s = q_s + kTile * QS;
  float* pt_s = do_s + kTile * QS;
  float* dst_s = pt_s + kTile * kPS;
  float* lse_s = dst_s + kTile * kPS;
  float* dl_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y, b = blockIdx.z, rep = H / Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long q_row = (long long)H * D, k_row = (long long)Hkv * D;
  const int n_k = min(kTile, Sk - k0);
  const long long k_off = ((long long)b * Sk + k0) * k_row + (long long)hk * D;
  load_tile<T, D>(k_s, D, k + k_off, k_row, n_k, 1.f);
  load_tile<T, D>(v_s, D, v + k_off, k_row, n_k, 1.f);

  // queries that can see a key of [k0, k0 + n_k)
  const int k_last = k0 + n_k - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window) : Sq;

  float4 dk_acc[4][CJ], dv_acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      dk_acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv_acc[i][c] = dk_acc[i][c];
    }

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    for (int q0 = (q_lo / kTile) * kTile; q0 < q_hi; q0 += kTile) {
      __syncthreads();                    // the last tile's readers are done
      const int n_q = min(kTile, Sq - q0);
      const long long q_off = ((long long)b * Sq + q0) * q_row + (long long)h * D;
      load_tile<T, D>(q_s, QS, q + q_off, q_row, n_q, scale);
      load_tile<T, D>(do_s, QS, dout + q_off, q_row, n_q, 1.f);
      const long long row_off = ((long long)b * H + h) * Sq + q0;
      load_rows(lse_s, lse + row_off, n_q);
      load_rows(dl_s, delta + row_off, n_q);
      __syncthreads();
      // transposed scores: rows are keys ty + 16 i, columns queries tx + 16 j
      float s[4][4], dp[4][4];
      dots<D>(k_s, D, q_s, ty, tx, s);
      dots<D>(v_s, D, do_s, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qq = tx + 16 * j;
          const bool ok = valid_pair(q0 + qq, k0 + kk, Sq, Sk, causal, window);
          const float p = ok ? expf(s[i][j] - lse_s[qq]) : 0.f;
          pt_s[kk * kPS + qq] = p;
          dst_s[kk * kPS + qq] = p * (dp[i][j] - dl_s[qq]);
        }
      }
      __syncthreads();
      pv<D>(pt_s, do_s, QS, ty, tx, dv_acc);      // dV += P^T dO
      pv<D>(dst_s, q_s, QS, ty, tx, dk_acc);      // dK += dS^T (scale * Q)
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = ty + 16 * i;
    if (kk >= n_k) break;
    const long long off = ((long long)b * Sk + k0 + kk) * k_row + (long long)hk * D + 4 * tx;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      st4(dk + off + 64 * c, dk_acc[i][c]);
      st4(dv + off + 64 * c, dv_acc[i][c]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// K6 (KVT = QT, kSaveLse) and K10 (KVT = QT or int8_t, no lse)
template <typename QT, typename KVT, int D, bool kSaveLse>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* k_scale,
                       const void* v_scale, void* out, void* lse, int B, int Sq, int Sk,
                       int H, int Hkv, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kTile * D * 2 + shared_tile(D));
  auto kernel = flash_fwd_kernel<QT, KVT, D, kSaveLse>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<QT*>(out), static_cast<float*>(lse), Sq, Sk, H, Hkv, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename QT, int D>
cudaError_t launch_infer(const void* q, const void* k, const void* v, const void* k_scale,
                         const void* v_scale, void* out, int B, int Sq, int Sk, int H,
                         int Hkv, int causal, int window, float scale, int kv_int8,
                         cudaStream_t stream) {
  if (kv_int8)
    return launch_fwd<QT, int8_t, D, false>(q, k, v, k_scale, v_scale, out, nullptr, B, Sq,
                                            Sk, H, Hkv, causal, window, scale, stream);
  return launch_fwd<QT, QT, D, false>(q, k, v, nullptr, nullptr, out, nullptr, B, Sq, Sk, H,
                                      Hkv, causal, window, scale, stream);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
                      int H, int Hkv, int causal, int window, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kTile * D * 2 + (size_t)kTile * (D + 4) +
                                       shared_tile(D) + 2 * kTile);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), Sq, Sk, H, Hkv, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                       int Sk, int H, int Hkv, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kTile * D * 2 + (size_t)kTile * (D + 4) * 2 +
                                       (size_t)kTile * kPS * 2 + 2 * kTile);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + kTile - 1) / kTile, Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H,
      Hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points. q, dout, out and dq (B, Sq, H, D); k, v, dk and dv
// (B, Sk, Hkv, D), all contiguous and of one dtype (fp32, or bf16 when
// `bf16` is 1); lse and delta (B, H, Sq) fp32 contiguous. H % Hkv == 0, D in
// {64, 128}. causal is 0 or 1; window <= 0 means no window. Each returns
// the CUDA error of its launch (0 on success).
#define FLASH_DISPATCH(CALL)                                                      \
  if (bf16) {                                                                     \
    if (D == 64) return static_cast<int>(CALL(__nv_bfloat16, 64));                \
    if (D == 128) return static_cast<int>(CALL(__nv_bfloat16, 128));              \
  } else {                                                                        \
    if (D == 64) return static_cast<int>(CALL(float, 64));                        \
    if (D == 128) return static_cast<int>(CALL(float, 128));                      \
  }                                                                               \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* out, void* lse, int B, int Sq, int Sk, int H,
                                          int Hkv, int D, int causal, int window, float scale,
                                          int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(T, DIM)                                                                      \
  launch_fwd<T, T, DIM, true>(q, k, v, nullptr, nullptr, out, lse, B, Sq, Sk, H, Hkv, causal, \
                              window, scale, s)
  FLASH_DISPATCH(FWD)
#undef FWD
}

// K10. q and out (B, Sq, H, D) fp32, or bf16 when `bf16` is 1; k, v (B, Sk,
// Hkv, D) in q's dtype, or int8 codes when kv_int8 is 1 with k_scale and
// v_scale (B, Sk, Hkv) fp32 contiguous (ignored otherwise). The shape rules
// are K6's.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale, void* out,
                                      int B, int Sq, int Sk, int H, int Hkv, int D,
                                      int causal, int window, float scale, int bf16,
                                      int kv_int8, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define INFER(T, DIM)                                                                      \
  launch_infer<T, DIM>(q, k, v, k_scale, v_scale, out, B, Sq, Sk, H, Hkv, causal, window, \
                       scale, kv_int8, s)
  FLASH_DISPATCH(INFER)
#undef INFER
}

extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dq, int B, int Sq,
                                             int Sk, int H, int Hkv, int D, int causal,
                                             int window, float scale, int bf16,
                                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, DIM)                                                                        \
  launch_dq<T, DIM>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal, window, scale, \
                    s)
  FLASH_DISPATCH(DQ)
#undef DQ
}

extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dk, void* dv, int B,
                                              int Sq, int Sk, int H, int Hkv, int D,
                                              int causal, int window, float scale, int bf16,
                                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(T, DIM)                                                                    \
  launch_dkv<T, DIM>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal, window, \
                     scale, s)
  FLASH_DISPATCH(DKV)
#undef DKV
}

#undef FLASH_DISPATCH
