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
// the P.V product, as the Pallas kernel does; a row with l = 0 reads 0.
//
// What bounds it on an H100: bytes. Every live key and value is read once
// and takes 4 * D flops per query row, far below the ~295 flops per byte
// the tensor cores need before they, not HBM, are the limit. The bytes a
// call must move are about
//     sum_b live_keys_b * Hkv * D * 2 (K and V) * sizeof(T)
// plus q and out, and the bound is those bytes over 3.35 TB/s (at
// Llama-3-8B's decode tick, 25.8 MB: 7.7 us).
//
// What the design does about it (flash-decoding):
//  * a split over the key axis fills the card: the grid is
//    (Hkv x m-tiles, B, splits); CTA (h, b, s) walks the keys of pages
//    [s * pps, (s + 1) * pps) of row b that the row can see, clipped to
//    [window start, min(lengths[b] + W, n * page_size)), for the 16 query
//    rows of its m-tile (G * W rows per kv head, padded to 16), so each
//    page is read from HBM once per kv head (once per m-tile when
//    G * W > 16). pps comes from the wrapper, from B, Hkv and n only (never
//    from lengths: no host sync, capturable in a CUDA graph). A CTA whose
//    split the row cannot see returns at once. Each CTA writes its partial
//    (m, l, acc) in f32 to a workspace; paged_combine_kernel merges the
//    splits of a row in split order, out = sum_s 2^(m_s - M) acc_s /
//    sum_s 2^(m_s - M) l_s with M = max_s m_s: deterministic, no atomics.
//    The weight is what wipes a split in which a query row saw no visible
//    key (m_s = -1e30 with l_s > 0, e.g. W > 1 with a split boundary just
//    past lengths[b]), as alpha = 0 wipes such pages in the Pallas kernel.
//  * bf16 (paged_decode_kernel_tc) stays bf16: K/V tiles of 64 keys go
//    through a three-stage cp.async ring of 16-byte copies into rows padded
//    by 16 bytes (ldmatrix without bank conflicts); copies at or past the
//    split's last visible key are zero-filled without a read, so the null
//    page stays unobservable. Each CTA reads its split's page-table entries
//    into shared memory once. The four warps take 16 keys of each tile
//    each: S = Q K^T on the tensor cores (mma.sync m16n8k16 from ldmatrix;
//    Q as A fragments), in log2 units; the online softmax on the score
//    fragment (quad shuffles, P = one ex2); P rounded to bf16 in registers
//    as the A operand of O += P V, with V through ldmatrix.trans. The four
//    warps' carries merge in shared memory at the end. Up to D = 128 the
//    Q fragments stay in registers; at D = 256 they are re-read from
//    shared memory per tile, so that acc (128 floats a lane) fits without
//    spills at one CTA per SM. __launch_bounds__: three CTAs per SM at
//    D = 64, two at 128, one at 256, as shared memory allows.
//  * f32 (paged_decode_kernel<float>) keeps CUDA-core products (the f32
//    limit, 1e-5, is below TF32's precision) over the same split and
//    combine: chunks of keys staged in shared memory as f32 from 16-byte
//    loads issued a chunk ahead, one CTA for all G * W rows of a kv head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;            // G * W query rows per kv head
constexpr int kMaxPagesPerSplit = 1024;  // page-table slice in shared memory
constexpr float kNegInf = -1e30f;

struct PagedParams {
  const void* q;            // [B, W, Hq, D]
  const void* k;            // [P1, ps, Hkv, D]
  const void* v;            // [P1, ps, Hkv, D]
  const int32_t* tables;    // [B, n]
  const int32_t* lengths;   // [B]
  void* out;                // [B, W, Hq, D]
  float* part_acc;          // [B, Hkv, splits, R, D]
  float* part_ml;           // [B, Hkv, splits, R, 2]: m, l
  int B, W, Hq, Hkv, G, R, D, ps, n, pps, splits, window;
  float scale;
};

// the keys [lo, hi) that split `s` of a row with `len` cached tokens
// walks: its pages' keys, cut to what the row's queries can see
struct KeyRange {
  int lo, hi;
};
__device__ __forceinline__ KeyRange split_range(const PagedParams& p, int len,
                                                int s) {
  // stale lengths of inactive rows can run past the (bucket-sliced) table
  const int end = min(len + p.W, p.n * p.ps);
  const int start = p.window > 0 ? max(len - p.window + 1, 0) : 0;
  const int first = s * p.pps * p.ps;
  const int last = min((s + 1) * p.pps, p.n) * p.ps;
  return {max(first, start), min(last, end)};
}

__device__ __forceinline__ size_t part_row(const PagedParams& p, int b, int h,
                                           int s, int r) {
  return (((size_t)b * p.Hkv + h) * p.splits + s) * p.R + r;
}

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------

template <int D>
struct DecodeTc {
  static constexpr int KC = 64;      // keys per ring stage, 16 per warp
  static constexpr int kStages = 3;  // depth of the cp.async ring
  static constexpr int LDS = D + 8;  // padded shared row (elements)
  static constexpr int RS = D + 8;   // padded f32 row of the warp merge
  static constexpr int CTAS = D <= 64 ? 3 : (D <= 128 ? 2 : 1);
  static constexpr bool kQRegs = D <= 128;
  static constexpr size_t ring_bytes =
      (size_t)kStages * 2 * KC * LDS * sizeof(bf16);
  static_assert((size_t)kWarps * 16 * RS * 4 + 2 * kWarps * 16 * 4 <=
                    ring_bytes,
                "the warp merge reuses the ring");
  static_assert((KC * (D / 8)) % kThreads == 0, "stage copies per thread");
  static size_t smem(int pps) {
    return (size_t)16 * LDS * sizeof(bf16) + ring_bytes + (size_t)pps * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, DecodeTc<D>::CTAS)
    paged_decode_kernel_tc(PagedParams p) {
  using C = DecodeTc<D>;
  constexpr int KC = C::KC, NS = C::kStages, LDS = C::LDS, RS = C::RS;
  constexpr int KD = D / 16;     // depth steps over head_dim (S = Q K^T)
  constexpr int ND = D / 8;      // head_dim column tiles of O
  constexpr int ROW = LDS * 2;   // bytes per shared row
  constexpr int kChunks = D / 8; // 16-byte copies per key row
  const int mtiles = (p.R + 15) / 16;
  const int h = blockIdx.x / mtiles, mt = blockIdx.x % mtiles;
  const int b = blockIdx.y, split = blockIdx.z;
  const int len = p.lengths[b];
  const KeyRange kr = split_range(p, len, split);
  if (kr.lo >= kr.hi) return;  // nothing visible: the combine skips it

  extern __shared__ __align__(16) unsigned char pa_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(pa_smem);       // [16][LDS]
  bf16* ring = q_s + 16 * LDS;                        // [NS][K, V][KC][LDS]
  int* table_s = reinterpret_cast<int*>(ring + NS * 2 * KC * LDS);  // [pps]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, r8 = lane % 8;  // ldmatrix: matrix, row

  // the split's page-table entries, once
  const int page0 = split * p.pps;
  const int npages = min(p.pps, p.n - page0);
  for (int i = tid; i < npages; i += kThreads)
    table_s[i] = p.tables[(size_t)b * p.n + page0 + i];

  // this m-tile's 16 query rows r = w * G + g (zero past R)
  const bf16* qb = static_cast<const bf16*>(p.q);
  for (int i = tid; i < 16 * kChunks; i += kThreads) {
    const int row = i / kChunks, c = (i % kChunks) * 8;
    const int r = mt * 16 + row;
    const bool in = r < p.R;
    const bf16* src =
        in ? qb + (((size_t)b * p.W + r / p.G) * p.Hq + h * p.G + r % p.G) *
                          D + c
           : qb;
    cp_async16(q_s + row * LDS + c, src, in);
  }
  __syncthreads();  // table_s

  const bf16* kbase = static_cast<const bf16*>(p.k);
  const bf16* vbase = static_cast<const bf16*>(p.v);
  const size_t key_stride = (size_t)p.Hkv * D;
  // keys [c0, c0 + KC) into ring stage `stage`, zero past kr.hi
  auto load_stage = [&](int stage, int c0) {
    bf16* ks = ring + stage * 2 * KC * LDS;
    bf16* vs = ks + KC * LDS;
#pragma unroll
    for (int j = 0; j < KC * kChunks / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int key = i / kChunks, c = (i % kChunks) * 8;
      const int kpos = c0 + key;
      const bool in = kpos < kr.hi;
      size_t off = 0;
      if (in) {
        const int pg = kpos / p.ps;
        off = ((size_t)table_s[pg - page0] * p.ps + (kpos - pg * p.ps)) *
                  key_stride +
              (size_t)h * D + c;
      }
      cp_async16(ks + key * LDS + c, kbase + off, in);
      cp_async16(vs + key * LDS + c, vbase + off, in);
    }
  };

  const int nchunks = (kr.hi - kr.lo + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nchunks) load_stage(s, kr.lo + s * KC);
    cp_async_commit();
  }

  // this lane's two query rows, g and g + 8 of the tile: their positions
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    qpos[hh] = len + (mt * 16 + g + 8 * hh) / p.G;
  const float scale2 = p.scale * kLog2e;
  const uint32_t q_lane =
      smem_u32(q_s) + (lane & 15) * ROW + (lane >> 4) * 16;
  // this lane's ldmatrix row address within a warp's 16 keys of K (two
  // 8-key blocks by two 8-column blocks) and of V read transposed
  const uint32_t k_lane = (r8 + (mi >> 1) * 8) * ROW + (mi & 1) * 16;
  const uint32_t v_lane = (r8 + (mi & 1) * 8) * ROW + (mi >> 1) * 16;
  const uint32_t ring_u32 = smem_u32(ring);

  cp_async_wait<NS - 2>();  // Q and the first tile
  __syncthreads();
  uint32_t qf[C::kQRegs ? KD : 1][4];
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], q_lane + kk * 32);
  }
  // the online-softmax carry of rows g and g + 8, m in log2 units; l is
  // this lane's share of the row sum (its quad's columns)
  float acc[ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < nchunks; ++it) {
    if (it > 0) {
      cp_async_wait<NS - 2>();  // tile `it` has landed
      __syncthreads();  // ... for every thread; tile it-1's stage is free
    }
    if (it + NS - 1 < nchunks)
      load_stage((it + NS - 1) % NS, kr.lo + (it + NS - 1) * KC);
    cp_async_commit();

    const int kw0 = kr.lo + it * KC + warp * 16;  // this warp's 16 keys
    if (kw0 >= kr.hi) continue;
    const uint32_t k_addr =
        ring_u32 + (it % NS) * 2 * KC * ROW + warp * 16 * ROW;
    const uint32_t v_addr = k_addr + KC * ROW;

    // S = Q K^T: 16 rows x 16 keys
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, k_addr + k_lane + kk * 32);
      if constexpr (C::kQRegs) {
        mma<bf16>(s[0], qf[kk], bk[0], bk[1]);
        mma<bf16>(s[1], qf[kk], bk[2], bk[3]);
      } else {
        uint32_t a[4];
        ldsm_x4(a, q_lane + kk * 32);
        mma<bf16>(s[0], a, bk[0], bk[1]);
        mma<bf16>(s[1], a, bk[2], bk[3]);
      }
    }

    // in log2 units; keys the row cannot see take the finite sentinel,
    // keys past the split's range -inf (they weigh exactly 0)
    float m_new[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e / 2, kpos = kw0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale2;
        if (kpos >= kr.hi)
          x = -INFINITY;
        else if (qpos[hh] < kpos ||
                 (p.window > 0 && qpos[hh] - kpos >= p.window))
          x = kNegInf;
        s[j][e] = x;
        m_new[hh] = fmaxf(m_new[hh], x);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_new[hh] = quad_max(m_new[hh]);
      alpha[hh] = ex2(m[hh] - m_new[hh]);
      m[hh] = m_new[hh];
      l[hh] *= alpha[hh];
    }

    // P = 2^(s - m): summed unrounded into l, rounded to bf16 as the A
    // fragment of O += P V (the Pallas kernel's p.astype(v.dtype))
    uint32_t pf[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = ex2(s[j][e] - m[e / 2]);
        l[e / 2] += pv[e];
      }
      acc_to_a<bf16>(pf, j, pv[0], pv[1], pv[2], pv[3]);
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int np = 0; np < ND / 2; ++np) {
      uint32_t bv[4];
      ldsm_x4_t(bv, v_addr + v_lane + np * 32);
      mma<bf16>(acc[2 * np], pf, bv[0], bv[1]);
      mma<bf16>(acc[2 * np + 1], pf, bv[2], bv[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the merge reuses it

  // merge the four warps' carries: each rescales to the CTA's row max M and
  // leaves its acc in shared memory; the sum runs in warp order
  float* red = reinterpret_cast<float*>(ring);   // [kWarps][16][RS]
  float* m_w = red + kWarps * 16 * RS;           // [kWarps][16]
  float* l_w = m_w + kWarps * 16;                // [kWarps][16]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float sum = quad_sum(l[hh]);
    if (t == 0) {
      m_w[warp * 16 + g + 8 * hh] = m[hh];
      l_w[warp * 16 + g + 8 * hh] = sum;
    }
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = g + 8 * hh;
    float M = m_w[row];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, m_w[w * 16 + row]);
    const float f = ex2(m[hh] - M);
    float* dst = red + (warp * 16 + row) * RS + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(acc[j][2 * hh] * f, acc[j][2 * hh + 1] * f);
  }
  __syncthreads();
  for (int i = tid; i < 16 * D; i += kThreads) {
    const int row = i / D, d = i % D;
    const int r = mt * 16 + row;
    if (r >= p.R) break;  // rows are in order: the rest are padding
    float sum = red[row * RS + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[(w * 16 + row) * RS + d];
    p.part_acc[part_row(p, b, h, split, r) * D + d] = sum;
  }
  if (tid < 16 && mt * 16 + tid < p.R) {
    float M = m_w[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, m_w[w * 16 + tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      L += l_w[w * 16 + tid] * ex2(m_w[w * 16 + tid] - M);
    float* ml = p.part_ml + part_row(p, b, h, split, mt * 16 + tid) * 2;
    ml[0] = M;
    ml[1] = L;
  }
}

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------

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
  static size_t smem(int R) {
    return sizeof(float) * ((size_t)2 * R * D + (size_t)KC * (D + 1) +
                            (size_t)KC * D + (size_t)R * KC + 3 * (size_t)R);
  }
};

// one CTA per (kv head, row, split) for all R = G * W query rows; its
// partial (m in natural units) goes to the workspace
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(PagedParams p) {
  using C = Cfg<T, D>;
  constexpr int KC = C::KC;
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = p.G, R = p.R;
  const int len = p.lengths[b];
  const KeyRange kr = split_range(p, len, split);
  if (kr.lo >= kr.hi) return;  // nothing visible: the combine skips it
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

  const T* q = static_cast<const T*>(p.q);
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int w = r / G, g = r % G;
    q_s[i] = q[(((size_t)b * p.W + w) * p.Hq + h * G + g) * D + d];
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int32_t* table = p.tables + (size_t)b * p.n;
  const T* k_pages = static_cast<const T*>(p.k);
  const T* v_pages = static_cast<const T*>(p.v);
  const size_t row_stride = (size_t)p.Hkv * D;  // elements between keys
  uint4 kreg[C::kVecPerThread];
  uint4 vreg[C::kVecPerThread];

  // issue the 16-byte loads of the chunk starting at key c0 (keys past
  // kr.hi are zero-filled and weigh exactly 0)
  auto load_chunk = [&](int c0) {
#pragma unroll
    for (int i = 0; i < C::kVecPerThread; ++i) {
      const int vi = tid + i * kThreads;
      const int key = vi / C::kVecPerRow;
      const int col = (vi % C::kVecPerRow) * C::kVecElems;
      const int kpos = c0 + key;
      if (kpos < kr.hi) {
        const size_t frame = (size_t)table[kpos / p.ps];
        const size_t off =
            (frame * p.ps + kpos % p.ps) * row_stride + (size_t)h * D + col;
        kreg[i] = *reinterpret_cast<const uint4*>(k_pages + off);
        vreg[i] = *reinterpret_cast<const uint4*>(v_pages + off);
      } else {
        kreg[i] = make_uint4(0, 0, 0, 0);
        vreg[i] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  load_chunk(kr.lo);
  for (int c0 = kr.lo; c0 < kr.hi; c0 += KC) {
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
        k_s[key * (D + 1) + col + e] = kv[e];
        v_s[key * D + col + e] = vv[e];
      }
    }
    __syncthreads();
    // the next chunk's loads fly while this chunk is computed
    if (c0 + KC < kr.hi) load_chunk(c0 + KC);

    // scores and the online-softmax update: warp w owns rows w, w+4, ...
    for (int r = warp; r < R; r += kWarps) {
      const int qpos = len + r / G;
      const float* qr = q_s + r * D;
      float s[C::kKeysPerLane];
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < C::kKeysPerLane; ++j) {
        const int key = lane + 32 * j;
        const float* krow = k_s + key * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], krow[d], dot);
        const int kpos = c0 + key;
        bool keep = qpos >= kpos;
        if (p.window > 0) keep = keep && (qpos - kpos < p.window);
        s[j] = kpos >= kr.hi ? -INFINITY : (keep ? dot * p.scale : kNegInf);
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
        const float pj = expf(s[j] - m_new);
        psum += pj;
        p_s[r * KC + lane + 32 * j] = pj;
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

  for (int i = tid; i < R * D; i += kThreads)
    p.part_acc[part_row(p, b, h, split, i / D) * D + i % D] = acc_s[i];
  for (int r = tid; r < R; r += kThreads) {
    float* ml = p.part_ml + part_row(p, b, h, split, r) * 2;
    ml[0] = m_s[r];
    ml[1] = l_s[r];
  }
}

// --------------------------------------------------------------------------
// the combine: one CTA per (query row, kv head, batch row), one thread per
// head_dim column
// --------------------------------------------------------------------------

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// m in log2 units for bf16 (the tensor-core kernel), natural for f32
template <typename T>
__global__ void __launch_bounds__(256) paged_combine_kernel(PagedParams p) {
  constexpr bool kLog2 = !std::is_same<T, float>::value;
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x;
  const int len = p.lengths[b];
  float M = -INFINITY;
  for (int s = 0; s < p.splits; ++s) {
    const KeyRange kr = split_range(p, len, s);
    if (kr.lo < kr.hi) M = fmaxf(M, p.part_ml[part_row(p, b, h, s, r) * 2]);
  }
  float acc = 0.f, L = 0.f;
  for (int s = 0; s < p.splits; ++s) {   // in split order: deterministic
    const KeyRange kr = split_range(p, len, s);
    if (kr.lo >= kr.hi) continue;
    const size_t pr = part_row(p, b, h, s, r);
    const float dm = p.part_ml[pr * 2] - M;
    const float w = kLog2 ? exp2f(dm) : expf(dm);
    L = fmaf(w, p.part_ml[pr * 2 + 1], L);
    acc = fmaf(w, p.part_acc[pr * p.D + d], acc);
  }
  T* out = static_cast<T*>(p.out);
  const int wq = r / p.G, g = r % p.G;
  store(out + (((size_t)b * p.W + wq) * p.Hq + h * p.G + g) * p.D + d,
        acc / (L > 0.f ? L : 1.f));
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           const PagedParams& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int run(const PagedParams& p, cudaStream_t stream) {
  int err;
  if constexpr (std::is_same<T, bf16>::value) {
    const int mtiles = (p.R + 15) / 16;
    err = launch(paged_decode_kernel_tc<D>,
                 dim3(p.Hkv * mtiles, p.B, p.splits), kThreads,
                 DecodeTc<D>::smem(p.pps), p, stream);
  } else {
    err = launch(paged_decode_kernel<T, D>, dim3(p.Hkv, p.B, p.splits),
                 kThreads, Cfg<T, D>::smem(p.R), p, stream);
  }
  if (err != 0) return err;
  return launch(paged_combine_kernel<T>, dim3(p.R, p.Hkv, p.B), D, 0, p,
                stream);
}

template <typename T>
int dispatch_d(const PagedParams& p, cudaStream_t stream) {
  switch (p.D) {
    case 64: return run<T, 64>(p, stream);
    case 128: return run<T, 128>(p, stream);
    case 256: return run<T, 256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int num_splits(int n, int pps) { return (n + pps - 1) / pps; }

}  // namespace

extern "C" {

// Head dims the kernel is instantiated for, and its row limit per kv head.
int paged_attention_max_rows() { return kMaxRows; }
int paged_attention_supports_head_dim(int D) {
  return D == 64 || D == 128 || D == 256;
}

// f32 entries of the workspace a call needs: each split's partial
// (acc [R][D], m, l) per (row, kv head)
int64_t paged_attention_workspace_floats(int B, int W, int Hq, int Hkv, int D,
                                         int n, int pages_per_split) {
  if (Hkv < 1 || pages_per_split < 1) return 0;
  const int64_t R = (int64_t)(Hq / Hkv) * W;
  return (int64_t)B * Hkv * num_splits(n, pages_per_split) * R * (D + 2);
}

// dtype: 0 = float32, 1 = bfloat16. `workspace` holds
// paged_attention_workspace_floats(...) f32 entries. Launches the split
// kernel and the combine on `stream`; returns a cudaError_t (0 = success):
// each launch's own error, checked with cudaGetLastError right after it.
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* tables,
                        const void* lengths, void* out, void* workspace,
                        int B, int W, int Hq, int Hkv, int D, int ps, int n,
                        int pages_per_split, float scale, int window,
                        int dtype, void* stream) {
  if (B < 1 || W < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      (Hq / Hkv) * W > kMaxRows || ps < 1 || n < 1 || pages_per_split < 1 ||
      pages_per_split > kMaxPagesPerSplit || B > 65535 ||
      num_splits(n, pages_per_split) > 65535)
    return (int)cudaErrorInvalidValue;
  PagedParams p;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.tables = static_cast<const int32_t*>(tables);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.out = out;
  p.B = B;
  p.W = W;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.R = p.G * W;
  p.D = D;
  p.ps = ps;
  p.n = n;
  p.pps = pages_per_split;
  p.splits = num_splits(n, pages_per_split);
  p.window = window;
  p.scale = scale;
  p.part_acc = static_cast<float*>(workspace);
  p.part_ml = p.part_acc + (size_t)B * Hkv * p.splits * p.R * D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch_d<bf16>(p, s);
  if (dtype == 0) return dispatch_d<float>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
