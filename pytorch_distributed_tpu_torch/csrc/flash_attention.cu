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
// What the designs do:
//  * fwd and dq: one CTA per (batch, q head, q tile) walks the key tiles
//    itself, in place of the TPU grid's sequential "arbitrary" key axis
//    (fwd with the online-softmax carry (m, l, acc) in registers). With
//    causal it stops at the tile that holds its last row's diagonal, so
//    masked tiles are never loaded; q tiles are issued longest-first.
//  * dkv: one CTA per (batch, KV head, 64-row key tile) loops over the q
//    heads of its GQA group and over the q tiles that can see its keys, and
//    writes dK and dV straight in the [B, T, Hkv, D] shape. Each CTA owns its
//    tile, so there are no atomics and no per-q-head output to sum outside,
//    and two launches on the same inputs give the same bits.
//  * bf16 and fp16 inputs (flash_fwd_kernel_tc, flash_dq_kernel_tc,
//    flash_dkv_kernel_tc, each instantiated for both) run every product on
//    the tensor cores: mma.sync m16n8k16, bf16 or fp16 in, f32 accumulate,
//    operands read from shared memory with ldmatrix (.trans where a product
//    needs V, K, Q or dO with the key or query axis as its depth). Tiles
//    stay in the input type in shared memory, rows padded by 16 bytes so
//    that the 8 rows one ldmatrix reads fall in 8 different bank groups, and stream through a two-stage ring of cp.async
//    16-byte copies, so the next tile's load overlaps this tile's products.
//    Four warps own 16 rows each: query rows in fwd and dq (Q, and dO in
//    dq, kept as A fragments across the key loop), key rows in dkv (K and V
//    resident in shared memory). Each 64-row streamed tile is computed 64
//    (fwd), 32 (dq) or 16 (dkv) columns at a time, which keeps the kernels
//    within 168, 128 and 168 registers without spills at D <= 64: three,
//    four and three CTAs per SM, whose extra warps hide the latency of the
//    mma chains. Scores, P and dS stay in registers in f32; the accumulator
//    layout of S = Q.K^T (or S^T = K.Q^T) is the A-fragment layout of the
//    next product, so P (fwd) and dS (dq, dkv), rounded to the input type
//    there (the Pallas rounding points), and P^T feed O += P.V, dQ += dS.K,
//    dK += dS^T.Q and dV += P^T.dO without a trip through shared memory.
//    The forward's online softmax runs on that fragment in log2 units
//    (P = 2^(s log2(e) - m), one ex2 per score): a row's scores sit in the
//    4 lanes of a quad, so its max and sum are two shuffles; key tiles no
//    mask can reach are only scaled, and with causal a warp skips those
//    wholly past its rows. dV keeps P in f32 as the Pallas kernel does:
//    P = hi + lo with hi = E(P), lo = E(P - hi), two products (one more
//    per tile), which holds P to about 2^-16 of itself in bf16 and, in
//    fp16, to about 2^-22 of itself or 2^-25 absolute (split2). fp16's
//    range is not widened anywhere: scores, the -1e30 sentinel, the bias,
//    lse and delta stay f32 in registers, and a dS, dQ, dK or dV past
//    65504 (a loss scaled too far) rounds to inf, as the plain version's
//    casts do, for the loss scaler to see.
//    Head dim 128 halves dq's and dkv's streamed tile (32 rows) and runs at
//    the occupancy its registers allow (two CTAs per SM for the forward).
//  * f32 inputs: the first version. 64 x 64 tiles staged in shared memory
//    as f32 (rows padded to D + 1 floats, so the score loops read without
//    bank conflicts) from 16-byte global loads; 256 threads each own a
//    4 x 4 block of scores and 4 rows x D/16 columns of the output
//    accumulators; products on the CUDA cores in f32, which holds f32
//    inputs to f32 accuracy (TF32 would not).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// the keys a q tile of `rows` rows starting at q0 must visit: all of them,
// or with causal those up to its last row's diagonal
__device__ __forceinline__ int key_end(const FlashParams& p, int q0,
                                       int rows = kTile) {
  int end = p.T;
  if (p.causal) {
    const int last = min(q0 + rows, p.S) - 1;
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
        p_s[(4 * ty + i) * kLDP + tx + 16 * j] = pv;
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
        ds_s[(4 * ty + i) * kLDP + c] = ds;
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
          dst_s[(4 * ty + i) * kLDP + r] = ds;
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

// --------------------------------------------------------------------------
// bf16 and fp16 forward, dq and dkv on the tensor cores (E: the element
// type, bf16 or f16; the structs' sizes hold for either, both 2 bytes)
// --------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // four warps, 16 rows each
constexpr int kStages = 2;       // depth of the cp.async ring
// cp.async, ldmatrix, mma.sync, acc_to_a, ex2, quad_max/sum: mma_sm90.cuh

// x = hi + lo with hi = E(x), lo = E(x - hi). For P in [0, 1]: bf16 (8
// mantissa bits, f32's exponent range) holds P to about 2^-16 of itself;
// fp16 (11 bits) to about 2^-22 of itself down to lo's subnormal step
// 2^-24, so a P below about 2^-3 (where x - hi drops under fp16's least
// normal, 2^-14) is held to 2^-25 absolute, and one below 2^-25 reads 0.
template <typename E>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const typename Elem<E>::Pair h = Elem<E>::pack(x0, x1);
  const float2 f = Elem<E>::unpack(h);
  hi = as_u32(h);
  lo = pack2<E>(x0 - f.x, x1 - f.y);
}

template <typename E>
__device__ __forceinline__ const E* head_ptr(const void* base,
                                             const int64_t* st, int b,
                                             int h) {
  return static_cast<const E*>(base) + (int64_t)b * st[0] +
         (int64_t)h * st[2];
}

// two f32 -> two E at row[0..1] (an f32 past fp16's range stores inf)
template <typename E>
__device__ __forceinline__ void store2(E* row, float x0, float x1) {
  *reinterpret_cast<typename Elem<E>::Pair*>(row) = Elem<E>::pack(x0, x1);
}

// Issue the copies of rows [row0, row0 + ROWS) of one head (row stride rs
// elements) into dst[ROWS][D + 8]; rows at or past n are zero-filled. The
// 16-byte pad per row puts the 8 rows of an ldmatrix in 8 bank groups.
template <int D, int ROWS, typename E>
__device__ __forceinline__ void copy_rows_async(E* dst, const E* base,
                                                int64_t rs, int row0, int n) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = row0 + r < n;
    cp_async16(dst + r * (D + 8) + c,
               in ? base + (int64_t)(row0 + r) * rs + c : base, in);
  }
}
// src[row0 .. row0 + rows) (4-byte entries) into dst, zero past n
__device__ __forceinline__ void copy_words_async(void* dst, const void* src,
                                                 int row0, int rows, int n) {
  for (int i = threadIdx.x; i < rows; i += kTcThreads) {
    const bool in = row0 + i < n;
    cp_async4(static_cast<uint32_t*>(dst) + i,
              in ? static_cast<const uint32_t*>(src) + row0 + i : src, in);
  }
}

// P = exp(masked score - lse) of query qi and key kj, or 0 past S or T;
// the masks in masked_score's order. Tile-wide flags skip tests that
// cannot fire: `diag`, the tile may hold keys past some of its queries;
// `edge`, it may hold rows past S or keys past T.
__device__ __forceinline__ float tc_prob(const FlashParams& p, float dot,
                                         float bias, int qseg, int kseg,
                                         int qi, int kj, float lse,
                                         bool diag, bool edge) {
  if (edge && (kj >= p.T || qi >= p.S)) return 0.f;
  float x = dot * p.scale;
  if (p.bias) x += bias;
  if (p.seg && qseg != kseg) x = kNegInf;
  if (diag && qi < kj) x = kNegInf;
  return __expf(x - lse);
}

constexpr float kLn2 = 0.6931471805599453f;

// the forward's masked score of query qi and key kj in log2 units (s
// log2(e), so that P = 2^(s - m) is one ex2): masked_score's masks with
// the same finite -1e30 sentinel (a bias-masked score is clamped to it,
// as -1e30 + s rounds to it in natural units), and -inf for keys past T
// (they weigh exactly 0); `diag` and `edge` as above
__device__ __forceinline__ float tc_score2(const FlashParams& p, float dot,
                                           float bias, int qseg, int kseg,
                                           int qi, int kj, bool diag,
                                           bool edge) {
  if (edge && kj >= p.T) return -INFINITY;
  float x = dot * p.scale;
  if (p.bias) x = fmaxf((x + bias) * kLog2e, kNegInf);
  else x *= kLog2e;
  if (p.seg && qseg != kseg) x = kNegInf;
  if (diag && qi < kj) x = kNegInf;
  return x;
}


// forward: one CTA per (q tile of 64 rows, batch x q head); warp w owns
// rows 16w..16w+15, loads them once as A fragments and keeps them across
// the key loop. K, V and the key tile's bias and segment words stream
// through the cp.async ring, BN keys per tile: S = Q K^T on the tensor
// cores, masked (a tile that no mask can reach is only scaled), then the
// online softmax on the 16 x BN score fragment in log2 units (each lane
// holds two rows, g and g + 8, spread over its quad), and P rounded to
// E straight into the A fragments of O += P V. l sums the unrounded P.
// With causal, a warp skips a tile whose keys all lie past its rows.
// ldmatrix addresses are 32-bit shared-window offsets with the lane's part
// computed once. Up to D = 64 this fits 168 registers without spills,
// three CTAs per SM (on an H100 at the training shapes 0.117 ms; 32-key
// steps at four CTAs spill, at three they took 0.121 ms; PERF.md).
template <int D>
struct FwdTc {
  static constexpr int BM = 64;
  static constexpr int BN = 64;
  static constexpr int CTAS = D <= 64 ? 3 : 2;  // per SM, for ptxas
  static constexpr int LDS = D + 8;
  static constexpr size_t smem =
      (size_t)BM * LDS * sizeof(bf16)                 // Q
      + (size_t)kStages * 2 * BN * LDS * sizeof(bf16) // ring: K, V
      + (size_t)kStages * 2 * BN * 4;                 // ring: bias, kseg
};

template <typename E, int D>
__global__ void __launch_bounds__(kTcThreads, FwdTc<D>::CTAS)
    flash_fwd_kernel_tc(FlashParams p) {
  using C = FwdTc<D>;
  constexpr int BM = C::BM, BN = C::BN, LDS = C::LDS;
  constexpr int KD = D / 16;   // depth steps over head_dim (S)
  constexpr int NB = BN / 8;   // key column tiles of S
  constexpr int KB = BN / 16;  // depth steps over keys (O)
  constexpr int ND = D / 8;    // head_dim column tiles of O
  constexpr int ROW = LDS * 2; // bytes per shared row
  extern __shared__ __align__(16) unsigned char tc_smem[];
  E* q_s = reinterpret_cast<E*>(tc_smem);  // [BM][LDS]
  E* kv_s = q_s + BM * LDS;                   // [stage][K, V][BN][LDS]
  float* bias_s = reinterpret_cast<float*>(kv_s + kStages * 2 * BN * LDS);
  int* kseg_s = reinterpret_cast<int*>(bias_s + kStages * BN);

  const int n_qt = (p.S + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BM;  // longest first
  const int hq = blockIdx.x % p.Hq, b = blockIdx.x / p.Hq;
  const int hk = hq / (p.Hq / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, r8 = lane % 8;  // ldmatrix: matrix, row
  // this lane's ldmatrix row address within a K tile (two 8-key blocks
  // by two 8-column blocks) and within a V tile read transposed
  const uint32_t k_lane = (r8 + (mi >> 1) * 8) * ROW + (mi & 1) * 16;
  const uint32_t v_lane = (r8 + (mi & 1) * 8) * ROW + (mi >> 1) * 16;
  const uint32_t kv_u32 = smem_u32(kv_s);

  const E* kb = head_ptr<E>(p.k, p.k_stride, b, hk);
  const E* vb = head_ptr<E>(p.v, p.v_stride, b, hk);
  const float* bias_row = p.bias ? p.bias + (int64_t)b * p.T : nullptr;
  const int* seg_row = p.seg ? p.seg + (int64_t)b * p.S : nullptr;
  auto load_keys = [&](int stage, int k0) {
    E* ks = kv_s + stage * 2 * BN * LDS;
    copy_rows_async<D, BN>(ks, kb, p.k_stride[1], k0, p.T);
    copy_rows_async<D, BN>(ks + BN * LDS, vb, p.v_stride[1], k0, p.T);
    if (bias_row)
      copy_words_async(bias_s + stage * BN, bias_row, k0, BN, p.T);
    if (seg_row)
      copy_words_async(kseg_s + stage * BN, seg_row, k0, BN, p.T);
  };

  const int n_kt = (key_end(p, q0, BM) + BN - 1) / BN;
  copy_rows_async<D, BM>(q_s, head_ptr<E>(p.q, p.q_stride, b, hq),
                         p.q_stride[1], q0, p.S);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_keys(s, s * BN);
    cp_async_commit();
  }

  // this thread's two query rows: qi[0] = g, qi[1] = g + 8 of its warp's
  int qi[2], qseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + warp * 16 + g + 8 * h;
    qseg[h] = (seg_row && qi[h] < p.S) ? seg_row[qi[h]] : 0;
  }
  const int warp_last = q0 + warp * 16 + 15;  // the warp's last row
  const float scale2 = p.scale * kLog2e;

  cp_async_wait<kStages - 2>();  // Q and the first key tile
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * LDS + kk * 16 +
                        (lane >> 4) * 8);
  // the online-softmax carry of rows g and g + 8, m in log2 units; l is
  // this lane's share of the row sum (its quad's columns), summed over the
  // quad at the end
  float acc[ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    if (it > 0) {
      cp_async_wait<kStages - 2>();  // key tile `it` has landed
      __syncthreads();  // ... for every thread; tile it-1's stage is free
    }
    if (it + kStages - 1 < n_kt)
      load_keys((it + kStages - 1) % kStages, (it + kStages - 1) * BN);
    cp_async_commit();

    const int st = it % kStages;
    const int k0 = it * BN;
    const bool diag = p.causal && k0 + BN - 1 > q0;
    if (diag && k0 > warp_last) continue;  // every score masked
    const bool edge = k0 + BN > p.T;
    const uint32_t k_addr = kv_u32 + st * 2 * BN * ROW;
    const uint32_t v_addr = k_addr + BN * ROW;
    const float* bias_t = bias_s + st * BN;
    const int* kseg_t = kseg_s + st * BN;

    // S = Q K^T, 16 rows x BN keys per warp
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, k_addr + k_lane + np * 16 * ROW + kk * 32);
        mma<E>(s[2 * np], qf[kk], bk[0], bk[1]);
        mma<E>(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scores in log2 units, masked where a mask can reach
    if (diag || edge || bias_row || seg_row) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, c = j * 8 + 2 * t + (e & 1);
          s[j][e] = tc_score2(p, s[j][e], bias_row ? bias_t[c] : 0.f,
                              qseg[h], seg_row ? kseg_t[c] : 0, qi[h],
                              k0 + c, diag, edge);
        }
    } else {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    }

    // the new running max of each row; alpha rescales what came before
    float m_new[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m_new[e / 2] = fmaxf(m_new[e / 2], s[j][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = quad_max(m_new[h]);
      alpha[h] = ex2(m[h] - m_new[h]);
      m[h] = m_new[h];
      l[h] *= alpha[h];
    }

    // P = 2^(s - m): summed unrounded into l, rounded to E as the A
    // fragments of O += P V (the Pallas kernel's p.astype(v.dtype))
    uint32_t pf[KB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = ex2(s[j][e] - m[e / 2]);
        l[e / 2] += pv[e];
      }
      acc_to_a<E>(pf[j / 2], j, pv[0], pv[1], pv[2], pv[3]);
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, v_addr + v_lane + kk * 16 * ROW + np * 32);
        mma<E>(acc[2 * np], pf[kk], bv[0], bv[1]);
        mma<E>(acc[2 * np + 1], pf[kk], bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  E* out = static_cast<E*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]);  // every lane: the shuffle is warp-wide
    if (qi[h] >= p.S) continue;
    const float safe = sum > 0.f ? sum : 1.f;
    E* row = out + (((int64_t)b * p.S + qi[h]) * p.Hq + hq) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store2(row + j * 8 + 2 * t, acc[j][2 * h] / safe,
             acc[j][2 * h + 1] / safe);
    // lse = m + log(l) in natural units; the -1e30 sentinel of a row
    // without a visible key stays itself, as in the Pallas kernel
    if (t == 0)
      p.lse[((int64_t)b * p.Hq + hq) * p.S + qi[h]] =
          (m[h] > kNegInf ? m[h] * kLn2 : kNegInf) + logf(safe);
  }
}

// dq: one CTA per (q tile of 64 rows, batch x q head); warp w owns rows
// 16w..16w+15. BN keys per streamed tile (32 at D = 128, for registers),
// taken SUB keys at a time, so S and dP of 16 x SUB stay small. Up to
// D = 64 that fits 128 registers without spills: four CTAs per SM (on an
// H100 at the training shapes 0.18 ms, where 64-key steps took 242
// registers, two CTAs and 0.29 ms; PERF.md).
template <int D>
struct DqTc {
  static constexpr int BM = 64;
  static constexpr int BN = D <= 64 ? 64 : 32;
  static constexpr int SUB = 32;
  static constexpr int CTAS = D <= 64 ? 4 : 1;  // per SM, for ptxas
  static constexpr int LDS = D + 8;
  static constexpr size_t smem =
      (size_t)2 * BM * LDS * sizeof(bf16)             // Q, dO
      + (size_t)kStages * 2 * BN * LDS * sizeof(bf16) // ring: K, V
      + (size_t)kStages * 2 * BN * 4;                 // ring: bias, kseg
};

template <typename E, int D>
__global__ void __launch_bounds__(kTcThreads, DqTc<D>::CTAS)
    flash_dq_kernel_tc(FlashParams p) {
  using C = DqTc<D>;
  constexpr int BM = C::BM, BN = C::BN, SUB = C::SUB, LDS = C::LDS;
  constexpr int KD = D / 16;   // depth steps over head_dim (S, dP)
  constexpr int NB = SUB / 8;  // key column tiles of S and dP
  constexpr int KB = SUB / 16; // depth steps over keys (dQ)
  constexpr int ND = D / 8;    // head_dim column tiles of dQ
  extern __shared__ __align__(16) unsigned char tc_smem[];
  E* q_s = reinterpret_cast<E*>(tc_smem);      // [BM][LDS]
  E* do_s = q_s + BM * LDS;                       // [BM][LDS]
  E* kv_s = do_s + BM * LDS;  // [stage][K, V][BN][LDS]
  float* bias_s = reinterpret_cast<float*>(kv_s + kStages * 2 * BN * LDS);
  int* kseg_s = reinterpret_cast<int*>(bias_s + kStages * BN);

  const int n_qt = (p.S + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BM;  // longest first
  const int hq = blockIdx.x % p.Hq, b = blockIdx.x / p.Hq;
  const int hk = hq / (p.Hq / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, r8 = lane % 8;  // ldmatrix: matrix, row

  const E* kb = head_ptr<E>(p.k, p.k_stride, b, hk);
  const E* vb = head_ptr<E>(p.v, p.v_stride, b, hk);
  const float* bias_row = p.bias ? p.bias + (int64_t)b * p.T : nullptr;
  const int* seg_row = p.seg ? p.seg + (int64_t)b * p.S : nullptr;
  auto load_keys = [&](int stage, int k0) {
    E* ks = kv_s + stage * 2 * BN * LDS;
    copy_rows_async<D, BN>(ks, kb, p.k_stride[1], k0, p.T);
    copy_rows_async<D, BN>(ks + BN * LDS, vb, p.v_stride[1], k0, p.T);
    if (bias_row)
      copy_words_async(bias_s + stage * BN, bias_row, k0, BN, p.T);
    if (seg_row)
      copy_words_async(kseg_s + stage * BN, seg_row, k0, BN, p.T);
  };

  const int n_kt = (key_end(p, q0, BM) + BN - 1) / BN;
  copy_rows_async<D, BM>(q_s, head_ptr<E>(p.q, p.q_stride, b, hq),
                         p.q_stride[1], q0, p.S);
  copy_rows_async<D, BM>(do_s, head_ptr<E>(p.dout, p.do_stride, b, hq),
                         p.do_stride[1], q0, p.S);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_keys(s, s * BN);
    cp_async_commit();
  }

  // this thread's two query rows: qi[0] = g, qi[1] = g + 8 of its warp's
  int qi[2], qseg[2];
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + warp * 16 + g + 8 * h;
    const bool in = qi[h] < p.S;
    const int64_t row = ((int64_t)b * p.Hq + hq) * p.S + qi[h];
    lse[h] = in ? p.lse[row] : 0.f;
    delta[h] = in ? p.delta[row] : 0.f;
    qseg[h] = (seg_row && in) ? seg_row[qi[h]] : 0;
  }

  cp_async_wait<kStages - 2>();  // Q, dO and the first key tile
  __syncthreads();
  uint32_t qf[KD][4], dof[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int off =
        (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(qf[kk], q_s + off);
    ldsm_x4(dof[kk], do_s + off);
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    if (it > 0) {
      cp_async_wait<kStages - 2>();  // key tile `it` has landed
      __syncthreads();  // ... for every thread; tile it-1's stage is free
    }
    if (it + kStages - 1 < n_kt)
      load_keys((it + kStages - 1) % kStages, (it + kStages - 1) * BN);
    cp_async_commit();

    const int st = it % kStages;
#pragma unroll 1
    for (int c0 = 0; c0 < BN; c0 += SUB) {
      const E* k_s = kv_s + st * 2 * BN * LDS + c0 * LDS;
      const E* v_s = k_s + BN * LDS;
      const float* bias_t = bias_s + st * BN + c0;
      const int* kseg_t = kseg_s + st * BN + c0;
      const int k0 = it * BN + c0;
      const bool diag = p.causal && k0 + SUB - 1 > q0;
      const bool edge = k0 + SUB > p.T || q0 + BM > p.S;

      // S = Q K^T and dP = dO V^T, 16 rows x SUB keys per warp
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          const int off = (np * 16 + r8 + (mi >> 1) * 8) * LDS + kk * 16 +
                          (mi & 1) * 8;
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, k_s + off);
          ldsm_x4(bv, v_s + off);
          mma<E>(s[2 * np], qf[kk], bk[0], bk[1]);
          mma<E>(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          mma<E>(dp[2 * np], dof[kk], bv[0], bv[1]);
          mma<E>(dp[2 * np + 1], dof[kk], bv[2], bv[3]);
        }
      }

      // dS = P (dP - delta) scale, rounded to E: the A fragments of dQ
      uint32_t dsf[KB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, c = j * 8 + 2 * t + (e & 1);
          const float pv = tc_prob(p, s[j][e], bias_row ? bias_t[c] : 0.f,
                                   qseg[h], seg_row ? kseg_t[c] : 0, qi[h],
                                   k0 + c, lse[h], diag, edge);
          ds[e] = pv * (dp[j][e] - delta[h]) * p.scale;
        }
        acc_to_a<E>(dsf[j / 2], j, ds[0], ds[1], ds[2], ds[3]);
      }

      // dQ += dS K
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4_t(bk, k_s + (kk * 16 + r8 + (mi & 1) * 8) * LDS +
                            np * 16 + (mi >> 1) * 8);
          mma<E>(acc[2 * np], dsf[kk], bk[0], bk[1]);
          mma<E>(acc[2 * np + 1], dsf[kk], bk[2], bk[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  E* dq = static_cast<E*>(p.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qi[h] >= p.S) continue;
    E* row = dq + (((int64_t)b * p.S + qi[h]) * p.Hq + hq) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store2(row + j * 8 + 2 * t, acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// dkv: one CTA per (key tile of 64 rows, batch x kv head); warp w owns keys
// 16w..16w+15. BM queries per streamed tile (32 at D = 128), taken SUB
// queries at a time. dK and dV hold 2 x 16 x D f32 per warp, so SUB = 16
// is what fits three CTAs per SM (<= 168 registers) without spills up to
// D = 64 (H100, training shapes: 0.27 ms, where 64-query steps took 218
// registers, two CTAs and 0.34 ms; four CTAs spill).
template <int D>
struct DkvTc {
  static constexpr int BN = 64;
  static constexpr int BM = D <= 64 ? 64 : 32;
  static constexpr int SUB = 16;
  static constexpr int CTAS = D <= 64 ? 3 : 1;  // per SM, for ptxas
  static constexpr int LDS = D + 8;
  static constexpr size_t smem =
      (size_t)2 * BN * LDS * sizeof(bf16)             // K, V
      + (size_t)kStages * 2 * BM * LDS * sizeof(bf16) // ring: Q, dO
      + (size_t)kStages * 3 * BM * 4                  // ring: lse, delta, qseg
      + (size_t)2 * BN * 4;                           // key bias, kseg
};

template <typename E, int D>
__global__ void __launch_bounds__(kTcThreads, DkvTc<D>::CTAS)
    flash_dkv_kernel_tc(FlashParams p) {
  using C = DkvTc<D>;
  constexpr int BN = C::BN, BM = C::BM, SUB = C::SUB, LDS = C::LDS;
  constexpr int KD = D / 16;   // depth steps over head_dim (S^T, dP^T)
  constexpr int NQ = SUB / 8;  // query column tiles of S^T and dP^T
  constexpr int KQ = SUB / 16; // depth steps over queries (dK, dV)
  constexpr int ND = D / 8;    // head_dim column tiles of dK and dV
  extern __shared__ __align__(16) unsigned char tc_smem[];
  E* k_s = reinterpret_cast<E*>(tc_smem);  // [BN][LDS]
  E* v_s = k_s + BN * LDS;                    // [BN][LDS]
  E* qd_s = v_s + BN * LDS;                   // [stage][Q, dO][BM][LDS]
  float* row_s = reinterpret_cast<float*>(qd_s + kStages * 2 * BM * LDS);
  // row_s: [stage][lse, delta, qseg][BM]
  float* kbias_s = row_s + kStages * 3 * BM;                // [BN]
  int* kseg_s = reinterpret_cast<int*>(kbias_s + BN);       // [BN]

  const int hk = blockIdx.x % p.Hkv, b = blockIdx.x / p.Hkv;
  const int k0 = blockIdx.y * BN;  // with causal, tile 0 has the most work
  const int G = p.Hq / p.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, r8 = lane % 8;

  const int n_qt = (p.S + BM - 1) / BM;
  // with causal, the first q tile whose rows reach this tile's keys
  const int qt0 = p.causal ? min(k0 / BM, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_it = G * per_head;
  const int* seg_row = p.seg ? p.seg + (int64_t)b * p.S : nullptr;
  auto load_queries = [&](int stage, int i) {
    const int hq = hk * G + i / per_head;
    const int q0 = (qt0 + i % per_head) * BM;
    E* qs = qd_s + stage * 2 * BM * LDS;
    copy_rows_async<D, BM>(qs, head_ptr<E>(p.q, p.q_stride, b, hq),
                           p.q_stride[1], q0, p.S);
    copy_rows_async<D, BM>(qs + BM * LDS,
                           head_ptr<E>(p.dout, p.do_stride, b, hq),
                           p.do_stride[1], q0, p.S);
    float* rs = row_s + stage * 3 * BM;
    const int64_t row = ((int64_t)b * p.Hq + hq) * p.S;
    copy_words_async(rs, p.lse + row, q0, BM, p.S);
    copy_words_async(rs + BM, p.delta + row, q0, BM, p.S);
    if (seg_row) copy_words_async(rs + 2 * BM, seg_row, q0, BM, p.S);
  };

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (n_it > 0) {
    copy_rows_async<D, BN>(k_s, head_ptr<E>(p.k, p.k_stride, b, hk),
                           p.k_stride[1], k0, p.T);
    copy_rows_async<D, BN>(v_s, head_ptr<E>(p.v, p.v_stride, b, hk),
                           p.v_stride[1], k0, p.T);
    if (p.bias) copy_words_async(kbias_s, p.bias + (int64_t)b * p.T, k0, BN,
                                 p.T);
    if (seg_row) copy_words_async(kseg_s, seg_row, k0, BN, p.T);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_it) load_queries(s, s);
      cp_async_commit();
    }
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();  // q tile `it` (and K, V) has landed
    __syncthreads();  // ... for every thread; tile it-1's stage is free
    if (it + kStages - 1 < n_it)
      load_queries((it + kStages - 1) % kStages, it + kStages - 1);
    cp_async_commit();

    const int st = it % kStages;
    const int q_tile = (qt0 + it % per_head) * BM;
#pragma unroll 1
    for (int c0 = 0; c0 < BM; c0 += SUB) {
      const E* q_s = qd_s + st * 2 * BM * LDS + c0 * LDS;
      const E* do_s = q_s + BM * LDS;
      const float* lse_s = row_s + st * 3 * BM + c0;
      const float* delta_s = lse_s + BM;
      const int* qseg_s = reinterpret_cast<const int*>(delta_s + BM);
      const int q0 = q_tile + c0;
      const bool diag = p.causal && k0 + BN - 1 > q0;
      const bool edge = k0 + BN > p.T || q0 + SUB > p.S;

      // S^T = K Q^T and dP^T = V dO^T, 16 keys x SUB queries per warp
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        const int aoff =
            (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(ka, k_s + aoff);
        ldsm_x4(va, v_s + aoff);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          const int off = (np * 16 + r8 + (mi >> 1) * 8) * LDS + kk * 16 +
                          (mi & 1) * 8;
          uint32_t bq[4], bd[4];
          ldsm_x4(bq, q_s + off);
          ldsm_x4(bd, do_s + off);
          mma<E>(s[2 * np], ka, bq[0], bq[1]);
          mma<E>(s[2 * np + 1], ka, bq[2], bq[3]);
          mma<E>(dp[2 * np], va, bd[0], bd[1]);
          mma<E>(dp[2 * np + 1], va, bd[2], bd[3]);
        }
      }

      // P^T (f32, as hi + lo) and dS^T (rounded to E): the A fragments
      // of dV and dK
      uint32_t ph[KQ][4], pl[KQ][4], dsf[KQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float pv[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, c = j * 8 + 2 * t + (e & 1);
          const int kj = k0 + warp * 16 + g + 8 * h;
          pv[e] = tc_prob(p, s[j][e], p.bias ? kbias_s[kj - k0] : 0.f,
                          seg_row ? qseg_s[c] : 0,
                          seg_row ? kseg_s[kj - k0] : 0, q0 + c, kj,
                          lse_s[c], diag, edge);
          ds[e] = pv[e] * (dp[j][e] - delta_s[c]) * p.scale;
        }
        const int r = (j % 2) * 2;
        split2<E>(pv[0], pv[1], ph[j / 2][r], pl[j / 2][r]);
        split2<E>(pv[2], pv[3], ph[j / 2][r + 1], pl[j / 2][r + 1]);
        acc_to_a<E>(dsf[j / 2], j, ds[0], ds[1], ds[2], ds[3]);
      }

      // dV += P^T dO (hi, then lo) and dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          const int off = (kk * 16 + r8 + (mi & 1) * 8) * LDS + np * 16 +
                          (mi >> 1) * 8;
          uint32_t bd[4], bq[4];
          ldsm_x4_t(bd, do_s + off);
          mma<E>(dv[2 * np], ph[kk], bd[0], bd[1]);
          mma<E>(dv[2 * np + 1], ph[kk], bd[2], bd[3]);
          mma<E>(dv[2 * np], pl[kk], bd[0], bd[1]);
          mma<E>(dv[2 * np + 1], pl[kk], bd[2], bd[3]);
          ldsm_x4_t(bq, q_s + off);
          mma<E>(dk[2 * np], dsf[kk], bq[0], bq[1]);
          mma<E>(dk[2 * np + 1], dsf[kk], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = k0 + warp * 16 + g + 8 * h;
    if (kj >= p.T) continue;
    const int64_t off = (((int64_t)b * p.T + kj) * p.Hkv + hk) * D;
    E* dkr = static_cast<E*>(p.dk) + off;
    E* dvr = static_cast<E*>(p.dv) + off;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      store2(dkr + j * 8 + 2 * t, dk[j][2 * h], dk[j][2 * h + 1]);
      store2(dvr + j * 8 + 2 * t, dv[j][2 * h], dv[j][2 * h + 1]);
    }
  }
}

// --------------------------------------------------------------------------
// launch
// --------------------------------------------------------------------------

// shared memory of each CUDA-core kernel, in floats
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
int launch(Kernel kernel, int threads, size_t bytes, dim3 grid,
           const FlashParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// f32 inputs: the CUDA-core kernels; bf16 and fp16: the tensor-core
// kernels. No other route (the CUDA-core kernels have no fp16 form).
template <typename T, int D>
int run(Which which, const FlashParams& p, cudaStream_t s) {
  constexpr bool tc =
      std::is_same<T, bf16>::value || std::is_same<T, f16>::value;
  const dim3 q_grid((p.S + kTile - 1) / kTile, p.Hq, p.B);
  const dim3 kv_grid((p.T + kTile - 1) / kTile, p.Hkv, p.B);
  constexpr size_t F = sizeof(float);
  switch (which) {
    case kFwd:
      if constexpr (tc) {
        constexpr int BM = FwdTc<D>::BM;
        return launch(flash_fwd_kernel_tc<T, D>, kTcThreads, FwdTc<D>::smem,
                      dim3(p.B * p.Hq, (p.S + BM - 1) / BM), p, s);
      } else {
        return launch(flash_fwd_kernel<T, D>, kThreads, fwd_smem(D) * F,
                      q_grid, p, s);
      }
    case kDq:
      if constexpr (tc) {
        constexpr int BM = DqTc<D>::BM;
        return launch(flash_dq_kernel_tc<T, D>, kTcThreads, DqTc<D>::smem,
                      dim3(p.B * p.Hq, (p.S + BM - 1) / BM), p, s);
      } else {
        return launch(flash_dq_kernel<T, D>, kThreads, dq_smem(D) * F, q_grid,
                      p, s);
      }
    case kDkv:
      if constexpr (tc) {
        constexpr int BN = DkvTc<D>::BN;
        return launch(flash_dkv_kernel_tc<T, D>, kTcThreads, DkvTc<D>::smem,
                      dim3(p.B * p.Hkv, (p.T + BN - 1) / BN), p, s);
      } else {
        return launch(flash_dkv_kernel<T, D>, kThreads, dkv_smem(D) * F,
                      kv_grid, p, s);
      }
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
      p->Hq % p->Hkv != 0 || p->Hq > 65535 || p->B > 65535 ||
      (int64_t)p->B * p->Hq > 0x7fffffff ||
      (p->S + kTile - 1) / kTile > 65535 || (p->T + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  if (p->seg && p->S != p->T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 2) return run_d<f16>(which, *p, s);
  if (p->dtype == 1) return run_d<bf16>(which, *p, s);
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
// with cudaGetLastError right after it. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16.
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
