// Tensor-core and async-copy helpers shared by the port's 16-bit kernels
// (flash_attention.cu, paged_attention.cu): 16-byte cp.async copies into
// shared memory, ldmatrix, mma.sync m16n8k16 (bf16 or fp16 in, f32
// accumulate), the packing of an accumulator into the next product's A
// fragment, ex2 and the quad reductions that an m16n8 accumulator's rows
// need. The products and packs take the element type E (bf16 or f16) as a
// template argument: the two mma.sync forms share one fragment layout, and
// ldmatrix moves 16-bit words whatever they hold. Plain inline PTX for
// sm_90a; ops/kernel_build.py hashes this header into the name of every
// library built from csrc/, so an edit rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

// the two 16-bit element types: a pair of them in one register, from two
// f32 (round to nearest even; an f32 past fp16's range becomes inf, never
// a clamped finite value) and back
template <typename E>
struct Elem;
template <>
struct Elem<bf16> {
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ Pair pack(float x0, float x1) {
    return __floats2bfloat162_rn(x0, x1);
  }
  static __device__ __forceinline__ float2 unpack(Pair v) {
    return __bfloat1622float2(v);
  }
};
template <>
struct Elem<f16> {
  using Pair = __half2;
  static __device__ __forceinline__ Pair pack(float x0, float x1) {
    return __floats2half2_rn(x0, x1);
  }
  static __device__ __forceinline__ float2 unpack(Pair v) {
    return __half22float2(v);
  }
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in (src is
// then never read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 16-bit matrices from shared memory: lanes 8i..8i+7 give the
// row addresses of matrix i, register i holds matrix i (.trans: transposed);
// the address is a shared-window byte address (smem_u32) or a pointer
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
template <typename E>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const E* ptr) {
  ldsm_x4(r, smem_u32(ptr));
}
template <typename E>
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const E* ptr) {
  ldsm_x4_t(r, smem_u32(ptr));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], E (bf16 or fp16) in, f32
// accumulate. Fragments (g = lane / 4, t = lane % 4): a = {(g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}; b = {(k 2t..2t+1, n g),
// (k 2t+8.., n g)}; c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}
template <typename E>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<E, f16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same<E, bf16>::value, "bf16 or fp16 only");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <typename P>
__device__ __forceinline__ uint32_t as_u32(P v) {
  static_assert(sizeof(P) == 4, "a register of two 16-bit elements");
  return *reinterpret_cast<uint32_t*>(&v);
}
// two f32 -> one register of two E (x0 in the low half)
template <typename E>
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  return as_u32(Elem<E>::pack(x0, x1));
}

// The accumulator of an m16n8 product over columns 8j..8j+7 is, two
// column tiles at a time, the A fragment of a product whose depth is
// those columns: tile j fills registers 2 (j % 2) and 2 (j % 2) + 1 of
// depth step j / 2.
template <typename E>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], int j, float c0,
                                         float c1, float c2, float c3) {
  a[(j % 2) * 2] = pack2<E>(c0, c1);
  a[(j % 2) * 2 + 1] = pack2<E>(c2, c3);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the 4 lanes of a quad: the lanes that hold one row of
// an m16n8 accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
