// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel `_kernel_body` in
// pytorch_distributed_tpu/ops/paged_attention.py (launched by
// `_paged_kernel_call`). It computes what that kernel computes: W queries
// per batch row at absolute positions lengths[b] + j attend the row's KV
// cache, which lives in a page pool [P1, page_size, Hkv, D] and is
// addressed through the row's page table [B, n]. Masking is causal
// (qpos >= kpos) plus an optional sliding window (qpos - kpos < window);
// the softmax is an online one with an f32 carry (m, l, acc) and the
// finite -1e30 mask value; GQA maps query head hq to kv head
// hq / (Hq / Hkv). The probabilities are rounded to the pool's type before
// the P.V product, as the Pallas kernel does.
//
// What bounds it on an H100: bytes. Every live key and value is read once
// and takes 2 * D flops per query row, far below the ~295 flops per byte
// the tensor cores need before they, not HBM, are the limit. The bytes a
// call must move are about
//     sum_b live_keys_b * Hkv * D * 2 (K and V) * sizeof(T)
// plus q and out, and the bound is those bytes over 3.35 TB/s.
//
// What the design does about it:
//  * one CTA per (row, kv head) computes all G * W query rows that share
//    that kv head, so each page is read from HBM once per kv head, not
//    once per query head;
//  * the CTA walks only the keys the row can see: it stops at
//    min(lengths[b] + W, n * page_size) (later pages are fully masked, and
//    the clamp to n keeps rows with stale lengths in bounds) and, with a
//    window, starts at the window's first key (earlier pages are wiped by
//    alpha = exp(-1e30 - m) = 0 in the Pallas kernel);
//  * keys are streamed in chunks of KC with 16-byte loads, and the next
//    chunk's loads are issued into registers before the current chunk is
//    computed, so the HBM latency of one chunk overlaps the arithmetic of
//    the previous one. The sequential page loop replaces the TPU grid's
//    "arbitrary" page dimension, and each CTA reads its own page-table
//    entries in place of the TPU's scalar prefetch.
// Tensor cores, TMA and a split over the key axis are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;  // G * W query rows per CTA
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// round a probability to the pool's type, as the Pallas kernel's
// p.astype(v.dtype) does, and come back to f32 for the accumulation
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
struct Cfg {
  static constexpr int kVecElems = 16 / sizeof(T);       // per 16-byte load
  static constexpr int kVecPerRow = D / kVecElems;       // per key row
  static constexpr int kChunkBytes = 16384;              // K bytes per chunk
  static constexpr int KC0 = kChunkBytes / (D * (int)sizeof(T));
  static constexpr int KC = KC0 < 32 ? 32 : KC0;         // keys per chunk
  static constexpr int kKeysPerLane = KC / 32;
  static constexpr int kVecPerThread = KC * kVecPerRow / kThreads;
  static_assert(D % kVecElems == 0, "D must fill 16-byte vectors");
  static_assert(KC % 32 == 0, "chunk must be whole warps of keys");
  static_assert((KC * kVecPerRow) % kThreads == 0, "chunk load split");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,         // [B, W, Hq, D]
                    const T* __restrict__ k_pages,   // [P1, ps, Hkv, D]
                    const T* __restrict__ v_pages,   // [P1, ps, Hkv, D]
                    const int32_t* __restrict__ tables,   // [B, n]
                    const int32_t* __restrict__ lengths,  // [B]
                    T* __restrict__ out,              // [B, W, Hq, D]
                    int W, int Hq, int Hkv, int ps, int n, float scale,
                    int window) {
  using C = Cfg<T, D>;
  constexpr int KC = C::KC;
  const int h = blockIdx.x;   // kv head
  const int b = blockIdx.y;   // batch row
  const int G = Hq / Hkv;
  const int R = G * W;        // query rows of this CTA, r = w * G + g
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                       // [R][D]
  float* acc_s = q_s + R * D;              // [R][D]
  float* k_s = acc_s + R * D;              // [KC][D + 1] (padded: no bank
                                           //  conflicts when lanes = keys)
  float* v_s = k_s + KC * (D + 1);         // [KC][D]
  float* p_s = v_s + KC * D;               // [R][KC]
  float* m_s = p_s + R * KC;               // [R]
  float* l_s = m_s + R;                    // [R]
  float* alpha_s = l_s + R;                // [R]

  const int len = lengths[b];
  const int limit = n * ps;
  int end = len + W;
  if (end > limit) end = limit;
  int start = 0;
  if (window > 0) {
    start = len - window + 1;
    if (start < 0) start = 0;
  }
  if (start > end) start = end;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int w = r / G, g = r % G;
    q_s[i] = to_f32(q[(((size_t)b * W + w) * Hq + h * G + g) * D + d]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int32_t* table = tables + (size_t)b * n;
  const size_t row_stride = (size_t)Hkv * D;  // elements between keys
  uint4 kreg[C::kVecPerThread];
  uint4 vreg[C::kVecPerThread];

  // issue the 16-byte loads of the chunk starting at key c0 (keys past
  // `end` are zero-filled: their logits are masked and their values are
  // multiplied by an exact 0)
  auto load_chunk = [&](int c0) {
#pragma unroll
    for (int i = 0; i < C::kVecPerThread; ++i) {
      const int vi = tid + i * kThreads;
      const int key = vi / C::kVecPerRow;
      const int col = (vi % C::kVecPerRow) * C::kVecElems;
      const int kpos = c0 + key;
      if (kpos < end) {
        const size_t frame = (size_t)table[kpos / ps];
        const size_t off =
            (frame * ps + kpos % ps) * row_stride + (size_t)h * D + col;
        kreg[i] = *reinterpret_cast<const uint4*>(k_pages + off);
        vreg[i] = *reinterpret_cast<const uint4*>(v_pages + off);
      } else {
        kreg[i] = make_uint4(0, 0, 0, 0);
        vreg[i] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  if (start < end) load_chunk(start);
  for (int c0 = start; c0 < end; c0 += KC) {
    // registers -> f32 shared tiles
#pragma unroll
    for (int i = 0; i < C::kVecPerThread; ++i) {
      const int vi = tid + i * kThreads;
      const int key = vi / C::kVecPerRow;
      const int col = (vi % C::kVecPerRow) * C::kVecElems;
      const T* kv = reinterpret_cast<const T*>(&kreg[i]);
      const T* vv = reinterpret_cast<const T*>(&vreg[i]);
#pragma unroll
      for (int e = 0; e < C::kVecElems; ++e) {
        k_s[key * (D + 1) + col + e] = to_f32(kv[e]);
        v_s[key * D + col + e] = to_f32(vv[e]);
      }
    }
    __syncthreads();
    // the next chunk's loads fly while this chunk is computed
    if (c0 + KC < end) load_chunk(c0 + KC);

    // scores and the online-softmax update: warp w owns rows w, w+4, ...
    for (int r = warp; r < R; r += kWarps) {
      const int qpos = len + r / G;
      const float* qr = q_s + r * D;
      float s[C::kKeysPerLane];
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < C::kKeysPerLane; ++j) {
        const int key = lane + 32 * j;
        const float* kr = k_s + key * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        const int kpos = c0 + key;
        bool keep = kpos < end && qpos >= kpos;
        if (window > 0) keep = keep && (qpos - kpos < window);
        s[j] = keep ? dot * scale : kNegInf;
        m_cur = fmaxf(m_cur, s[j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < C::kKeysPerLane; ++j) {
        const float p = expf(s[j] - m_new);
        psum += p;
        p_s[r * KC + lane + 32 * j] = round_to(p, T());
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * alpha[r] + sum_j p[r][j] * v[j][d]
    for (int d = tid; d < D; d += kThreads) {
      for (int r = 0; r < R; ++r) {
        const float* pr = p_s + r * KC;
        float a = 0.f;
#pragma unroll 8
        for (int j = 0; j < KC; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
        acc_s[r * D + d] = acc_s[r * D + d] * alpha_s[r] + a;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int w = r / G, g = r % G;
    const float l = l_s[r];
    const float o = acc_s[i] / (l > 0.f ? l : 1.f);
    store(out + (((size_t)b * W + w) * Hq + h * G + g) * D + d, o);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int32_t* tables,
           const int32_t* lengths, void* out, int B, int W, int Hq, int Hkv,
           int ps, int n, float scale, int window, cudaStream_t stream) {
  using C = Cfg<T, D>;
  const int R = (Hq / Hkv) * W;
  const size_t smem = sizeof(float) *
      ((size_t)2 * R * D + (size_t)C::KC * (D + 1) + (size_t)C::KC * D +
       (size_t)R * C::KC + 3 * (size_t)R);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out), W, Hq,
      Hkv, ps, n, scale, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int32_t* tables, const int32_t* lengths, void* out,
               int B, int W, int Hq, int Hkv, int ps, int n, float scale,
               int window, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, tables, lengths, out, B, W, Hq, Hkv, ps,
                           n, scale, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, tables, lengths, out, B, W, Hq, Hkv,
                            ps, n, scale, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, tables, lengths, out, B, W, Hq, Hkv,
                            ps, n, scale, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Head dims the kernel is instantiated for, and its row limit per CTA.
int paged_attention_max_rows() { return kMaxRows; }
int paged_attention_supports_head_dim(int D) {
  return D == 64 || D == 128 || D == 256;
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success):
// the launch's own error, checked with cudaGetLastError right after it.
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* tables,
                        const void* lengths, void* out, int B, int W, int Hq,
                        int Hkv, int D, int ps, int n, float scale,
                        int window, int dtype, void* stream) {
  if (B < 1 || W < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      (Hq / Hkv) * W > kMaxRows || ps < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* l = static_cast<const int32_t*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, t, l, out, B, W,
                                     Hq, Hkv, ps, n, scale, window, s);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k_pages, v_pages, t, l, out, B, W, Hq,
                             Hkv, ps, n, scale, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
