// Flash attention for Hopper (sm_90a): forward, dq and dkv kernels, bound to
// Python with ctypes (pytorch_distributed_tpu_torch/ops/flash_attention.py
// wires them into one torch.autograd.Function).
//
// Replaces the three Pallas TPU kernels of
// pytorch_distributed_tpu/ops/flash_attention.py:
//   flash_fwd  <- `_fwd_kernel` (launched by `_flash_forward`)
//   flash_dq   <- `_dq_kernel`  (launched by `_flash_bwd`)
//   flash_dkv  <- `_dkv_kernel` (launched by `_flash_bwd`)
// and computes what they compute. q is [B, S, Hq, D], k and v are
// [B, T, Hkv, D] (any strides with a contiguous head_dim), query head hq
// reads kv head hq / (Hq / Hkv). Scores are s = q.k * scale in f32, plus an
// optional additive [B, T] f32 bias row (built from a key mask), then the
// packed-sequence mask (segment ids differ -> -1e30) and the causal mask
// (top-left aligned: query row i sees key j iff i >= j -> else -1e30). The
// finite -1e30 keeps a fully masked row finite, as in the Pallas kernels.
// Keys past T in a ragged last tile are -inf, so they weigh exactly 0. The
// rounding points of the Pallas kernels are kept: the forward rounds P to
// the input type before P.V, dq rounds dS before dS.K, dkv rounds dS before
// dS^T.Q but forms dV = P^T.dO with P in f32 (the Pallas kernel casts dO to
// f32 first). The forward writes lse = m + log(l) per row, [B, Hq, S] f32;
// the backward kernels recompute P = exp(s - lse) from it, and take
// delta = rowsum(dO * O) precomputed by the wrapper, as the TPU code does.
//
// What bounds them on an H100, at GPT-2-medium's training shapes (bf16,
// B=8, S=T=1024, 16 heads, head_dim 64, causal: 67.2 M live (query, key)
// pairs):
//   fwd:  bytes  q, k, v, o = 67 MB          -> 20 us at 3.35 TB/s;
//         flops  4 * D * pairs  = 17.2 G     -> 17 us at 989 TFLOP/s
//   dq:   bytes  q, k, v, dO, dq = 84 MB     -> 25 us;  flops 25.8 G -> 26 us
//   dkv:  bytes  q, k, v, dO, dk, dv = 101 MB-> 30 us;  flops 34.4 G -> 35 us
// so all three sit near the ridge: a fast version needs the tensor cores.
//
// What this design does (a simple, correct first version):
//  * fwd and dq: one CTA per (batch, q head, 64-row q tile) walks the key
//    tiles itself with the online-softmax carry (m, l, acc) in registers, in
//    place of the TPU grid's sequential "arbitrary" key axis. With causal it
//    stops at the tile that holds its last row's diagonal, so masked tiles
//    are never loaded; q tiles are issued longest-first.
//  * dkv: one CTA per (batch, KV head, 64-row key tile) loops over the q
//    heads of its GQA group and over the q tiles that can see its keys, and
//    writes dK and dV straight in the [B, T, Hkv, D] shape. Each CTA owns its
//    tile, so there are no atomics and no per-q-head output to sum outside.
//  * Tiles are 64 x 64, staged in shared memory as f32 (rows padded to
//    D + 1 floats, so the score loops read without bank conflicts) from
//    16-byte global loads; 256 threads each own a 4 x 4 block of scores and
//    4 rows x D/16 columns of the output accumulators. Products run on the
//    CUDA cores in f32, which holds f32 inputs to f32 accuracy and bf16
//    inputs to the TPU kernels' rounding points exactly.
// Tensor-core products (mma / wgmma), TMA loads and double buffering are the
// next redesign; this version is far from its bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the launch description, shared with Python (ops/flash_attention.py builds
// the same layout with ctypes and checks flash_params_size())
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;
  float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  const float* bias;   // [B, T] or null
  const int32_t* seg;  // [B, S] or null
  int64_t q_stride[3];   // batch, position, head (elements)
  int64_t k_stride[3];
  int64_t v_stride[3];
  int64_t do_stride[3];
  int32_t B, S, T, Hq, Hkv, D, causal, dtype;
  float scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // query rows and key rows per tile
constexpr int kLDP = kTile + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// round to the input type, as the Pallas kernels' .astype(dtype) does
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [row0, row0 + 64) of head h of batch b into dst[64][D + 1] as
// f32; rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          const int64_t* st, int b, int h,
                                          int row0, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  const T* base = static_cast<const T*>(src) + (int64_t)b * st[0] +
                  (int64_t)h * st[2];
  for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float vals[kVec];
    if (row0 + r < n) {
      load16(base + (int64_t)(row0 + r) * st[1] + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * (D + 1) + c + e] = vals[e];
  }
}

// the masked, scaled score of query qi and key kj (kj < T)
__device__ __forceinline__ float masked_score(const FlashParams& p, float dot,
                                              float bias, int qseg, int kseg,
                                              int qi, int kj) {
  float x = dot * p.scale;
  if (p.bias) x += bias;
  if (p.seg && qseg != kseg) x = kNegInf;
  if (p.causal && qi < kj) x = kNegInf;
  return x;
}

// the key tiles a q tile starting at q0 must visit: all of them, or with
// causal those up to its last row's diagonal
__device__ __forceinline__ int key_end(const FlashParams& p, int q0) {
  int end = p.T;
  if (p.causal) {
    const int last = min(q0 + kTile, p.S) - 1;
    end = min(end, last + 1);
  }
  return end;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashParams p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [64][LD]
  float* k_s = q_s + kTile * LD;      // [64][LD]
  float* v_s = k_s + kTile * LD;      // [64][LD]
  float* p_s = v_s + kTile * LD;      // [64][kLDP]
  float* bias_s = p_s + kTile * kLDP; // [64]
  int* kseg_s = reinterpret_cast<int*>(bias_s + kTile);  // [64]

  const int n_qt = (p.S + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kTile;  // longest first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  load_tile<T, D>(q_s, p.q, p.q_stride, b, hq, q0, p.S);
  int qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    qseg[i] = (p.seg && qi < p.S) ? p.seg[(int64_t)b * p.S + qi] : 0;
  }
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int end = key_end(p, q0);
  for (int k0 = 0; k0 < end; k0 += kTile) {
    __syncthreads();  // the previous tile's k_s / v_s / p_s reads are done
    load_tile<T, D>(k_s, p.k, p.k_stride, b, hk, k0, p.T);
    load_tile<T, D>(v_s, p.v, p.v_stride, b, hk, k0, p.T);
    if (tid < kTile) {
      const int kj = k0 + tid;
      bias_s[tid] = (p.bias && kj < p.T) ? p.bias[(int64_t)b * p.T + kj] : 0.f;
      kseg_s[tid] = (p.seg && kj < p.T) ? p.seg[(int64_t)b * p.S + kj] : 0;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        s[i][j] = kj < p.T ? masked_score(p, s[i][j], bias_s[c], qseg[i],
                                          kseg_s[c], qi, kj)
                           : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new);
        sum += pv;
        p_s[(4 * ty + i) * kLDP + tx + 16 * j] = round_to(pv, T());
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pp[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pp[i] = p_s[(4 * ty + i) * kLDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = v_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pp[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.S) continue;
    const float safe = l[i] > 0.f ? l[i] : 1.f;
    T* orow = static_cast<T*>(p.out) + (((int64_t)b * p.S + qi) * p.Hq + hq) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(orow + tx + 16 * j, acc[i][j] / safe);
    if (tx == 0)
      p.lse[((int64_t)b * p.Hq + hq) * p.S + qi] = m[i] + logf(safe);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(FlashParams p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [64][LD]
  float* do_s = q_s + kTile * LD;      // [64][LD]
  float* k_s = do_s + kTile * LD;      // [64][LD]
  float* v_s = k_s + kTile * LD;       // [64][LD]
  float* ds_s = v_s + kTile * LD;      // [64][kLDP]
  float* bias_s = ds_s + kTile * kLDP; // [64]
  int* kseg_s = reinterpret_cast<int*>(bias_s + kTile);

  const int n_qt = (p.S + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kTile;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  load_tile<T, D>(q_s, p.q, p.q_stride, b, hq, q0, p.S);
  load_tile<T, D>(do_s, p.dout, p.do_stride, b, hq, q0, p.S);
  int qseg[4];
  float lse[4], delta[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    const bool in = qi < p.S;
    const int64_t row = ((int64_t)b * p.Hq + hq) * p.S + qi;
    qseg[i] = (p.seg && in) ? p.seg[(int64_t)b * p.S + qi] : 0;
    lse[i] = in ? p.lse[row] : 0.f;
    delta[i] = in ? p.delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int end = key_end(p, q0);
  for (int k0 = 0; k0 < end; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(k_s, p.k, p.k_stride, b, hk, k0, p.T);
    load_tile<T, D>(v_s, p.v, p.v_stride, b, hk, k0, p.T);
    if (tid < kTile) {
      const int kj = k0 + tid;
      bias_s[tid] = (p.bias && kj < p.T) ? p.bias[(int64_t)b * p.T + kj] : 0.f;
      kseg_s[tid] = (p.seg && kj < p.T) ? p.seg[(int64_t)b * p.S + kj] : 0;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = q_s[(4 * ty + i) * LD + d];
        g[i] = do_s[(4 * ty + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = k_s[(tx + 16 * j) * LD + d];
        vv[j] = v_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        float pv = 0.f;
        if (kj < p.T)
          pv = expf(masked_score(p, s[i][j], bias_s[c], qseg[i], kseg_s[c],
                                 qi, kj) - lse[i]);
        const float ds = pv * (dp[i][j] - delta[i]) * p.scale;
        ds_s[(4 * ty + i) * kLDP + c] = round_to(ds, T());
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dd[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dd[i] = ds_s[(4 * ty + i) * kLDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dd[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.S) continue;
    T* row = static_cast<T*>(p.dq) + (((int64_t)b * p.S + qi) * p.Hq + hq) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(row + tx + 16 * j, acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(FlashParams p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                    // [64 keys][LD]
  float* v_s = k_s + kTile * LD;        // [64 keys][LD]
  float* q_s = v_s + kTile * LD;        // [64 queries][LD]
  float* do_s = q_s + kTile * LD;       // [64 queries][LD]
  float* pt_s = do_s + kTile * LD;      // [64 keys][kLDP]: P^T in f32
  float* dst_s = pt_s + kTile * kLDP;   // [64 keys][kLDP]: dS^T, rounded
  float* lse_s = dst_s + kTile * kLDP;  // [64 queries]
  float* delta_s = lse_s + kTile;       // [64 queries]
  int* qseg_s = reinterpret_cast<int*>(delta_s + kTile);

  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  load_tile<T, D>(k_s, p.k, p.k_stride, b, hk, k0, p.T);
  load_tile<T, D>(v_s, p.v, p.v_stride, b, hk, k0, p.T);
  float kbias[4];
  int kseg[4];
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * ty + i;
    const bool in = kj < p.T;
    kbias[i] = (p.bias && in) ? p.bias[(int64_t)b * p.T + kj] : 0.f;
    kseg[i] = (p.seg && in) ? p.seg[(int64_t)b * p.S + kj] : 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  const int n_qt = (p.S + kTile - 1) / kTile;
  // with causal, the first q tile whose last row reaches this tile's keys
  const int qt0 = p.causal ? min(k0 / kTile, n_qt) : 0;
  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous q tile's reads are done
      load_tile<T, D>(q_s, p.q, p.q_stride, b, hq, q0, p.S);
      load_tile<T, D>(do_s, p.dout, p.do_stride, b, hq, q0, p.S);
      if (tid < kTile) {
        const int qi = q0 + tid;
        const bool in = qi < p.S;
        const int64_t row = ((int64_t)b * p.Hq + hq) * p.S + qi;
        lse_s[tid] = in ? p.lse[row] : 0.f;
        delta_s[tid] = in ? p.delta[row] : 0.f;
        qseg_s[tid] = (p.seg && in) ? p.seg[(int64_t)b * p.S + qi] : 0;
      }
      __syncthreads();

      // transposed tiles: rows are this thread's keys, columns queries
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4], a[4], gg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = k_s[(4 * ty + i) * LD + d];
          vv[i] = v_s[(4 * ty + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = q_s[(tx + 16 * j) * LD + d];
          gg[j] = do_s[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kk[i], a[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], gg[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int qi = q0 + r;
          float pv = 0.f;
          if (qi < p.S && kj < p.T)
            pv = expf(masked_score(p, st[i][j], kbias[i], qseg_s[r], kseg[i],
                                   qi, kj) - lse_s[r]);
          const float ds = pv * (dpt[i][j] - delta_s[r]) * p.scale;
          pt_s[(4 * ty + i) * kLDP + r] = pv;
          dst_s[(4 * ty + i) * kLDP + r] = round_to(ds, T());
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pp[4], dd[4], gg[NJ], a[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pp[i] = pt_s[(4 * ty + i) * kLDP + r];
          dd[i] = dst_s[(4 * ty + i) * kLDP + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          gg[j] = do_s[r * LD + tx + 16 * j];
          a[j] = q_s[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[i][j] = fmaf(pp[i], gg[j], dv[i][j]);
            dk[i][j] = fmaf(dd[i], a[j], dk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * ty + i;
    if (kj >= p.T) continue;
    const int64_t off = (((int64_t)b * p.T + kj) * p.Hkv + hk) * D;
    T* dkr = static_cast<T*>(p.dk) + off;
    T* dvr = static_cast<T*>(p.dv) + off;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store(dkr + tx + 16 * j, dk[i][j]);
      store(dvr + tx + 16 * j, dv[i][j]);
    }
  }
}

// shared memory of each kernel, in floats
constexpr size_t fwd_smem(int D) {
  return (size_t)3 * kTile * (D + 1) + (size_t)kTile * kLDP + 2 * kTile;
}
constexpr size_t dq_smem(int D) {
  return (size_t)4 * kTile * (D + 1) + (size_t)kTile * kLDP + 2 * kTile;
}
constexpr size_t dkv_smem(int D) {
  return (size_t)4 * kTile * (D + 1) + (size_t)2 * kTile * kLDP + 3 * kTile;
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem_floats, dim3 grid, const FlashParams& p,
           cudaStream_t stream) {
  const int bytes = (int)(smem_floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int run(Which which, const FlashParams& p, cudaStream_t s) {
  const dim3 q_grid((p.S + kTile - 1) / kTile, p.Hq, p.B);
  switch (which) {
    case kFwd:
      return launch(flash_fwd_kernel<T, D>, fwd_smem(D), q_grid, p, s);
    case kDq:
      return launch(flash_dq_kernel<T, D>, dq_smem(D), q_grid, p, s);
    case kDkv:
      return launch(flash_dkv_kernel<T, D>, dkv_smem(D),
                    dim3((p.T + kTile - 1) / kTile, p.Hkv, p.B), p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run_d(Which which, const FlashParams& p, cudaStream_t s) {
  switch (p.D) {
    case 16: return run<T, 16>(which, p, s);
    case 32: return run<T, 32>(which, p, s);
    case 64: return run<T, 64>(which, p, s);
    case 128: return run<T, 128>(which, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(Which which, const FlashParams* p, void* stream) {
  if (p->B < 1 || p->S < 1 || p->T < 1 || p->Hkv < 1 || p->Hq < p->Hkv ||
      p->Hq % p->Hkv != 0 || p->Hq > 65535 || p->B > 65535)
    return (int)cudaErrorInvalidValue;
  if (p->seg && p->S != p->T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 1) return run_d<__nv_bfloat16>(which, *p, s);
  if (p->dtype == 0) return run_d<float>(which, *p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_supports_head_dim(int D) {
  return D == 16 || D == 32 || D == 64 || D == 128;
}
int flash_params_size() { return (int)sizeof(FlashParams); }

// Each returns a cudaError_t (0 = success): the launch's own error, read
// with cudaGetLastError right after it. dtype: 0 = float32, 1 = bfloat16.
int flash_fwd(const FlashParams* p, void* stream) {
  return dispatch(kFwd, p, stream);
}
int flash_dq(const FlashParams* p, void* stream) {
  return dispatch(kDq, p, stream);
}
int flash_dkv(const FlashParams* p, void* stream) {
  return dispatch(kDkv, p, stream);
}

}  // extern "C"
