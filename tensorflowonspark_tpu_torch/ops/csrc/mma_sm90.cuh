// Warp-level tensor-core building blocks shared by the 16-bit flash kernels
// (flash_fwd.cu, flash_bwd.cu), for bf16 and fp16 alike: cp.async copies
// into shared memory, ldmatrix, mma.sync m16n8k16 (16-bit operands, f32
// accumulators) and the hi/lo split that carries an f32 operand into it
// with two 16-bit halves.
//
// Which split a second product takes.  p (the softmax probabilities, at
// most 1) enters as a hi/lo pair of the kernel's own type: bf16 keeps ~16
// significant bits of it, fp16 ~22 while p >= 2^-3 and an absolute error
// of at most 2^-25 below that, where the lo half (and, under 2^-14, the hi
// half) falls into fp16's subnormals: against out or dv, whose terms are
// p times a value of the input, that is under the f32 plain version's own
// summation noise.  ds (the score gradient) has no such bound: it scales
// with g, and a loss's gradients reach the attention at 1e-5 and below,
// where fp16 keeps only a few bits or none.  So ds always enters as a bf16
// hi/lo pair (f32's exponent range, ~16 bits); in the fp16 kernels the
// other operand of its products (K for dq, Q for dk) is widened exactly
// into a bf16 hi/lo pair in registers (an fp16 value has 11 significant
// bits: bf16 holds 8, and the 3-4 left over fit the lo half), and the
// product takes three bf16 MMAs, hi*hi + hi*lo + lo*hi (lo*lo is under
// 2^-16 of the term).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace sm90 {

using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only; zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i of lane (g = lane/4, t = lane%4) gets its row g,
// columns 2t and 2t+1 (.trans: column g, rows 2t and 2t+1).
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] b[16x8], T (bf16 or fp16) in, f32 accumulate.
// Fragments, with g = lane/4 and t = lane%4: a0..a3 hold A rows g, g+8,
// g, g+8 at columns (2t, 2t+1) + 0, 0, 8, 8; b0, b1 hold B column g at rows
// (2t, 2t+1) + 0, 8; c0..c3 hold C rows g, g, g+8, g+8 at columns 2t,
// 2t+1, 2t, 2t+1.
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  if constexpr (std::is_same_v<T, f16>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same_v<T, bf16>, "bf16 or fp16 operands");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two f32 rounded to a T pair in one register, x0 in the low half, and
// back.
template <typename T>
__device__ __forceinline__ unsigned pack2(float x0, float x1) {
  if constexpr (std::is_same_v<T, f16>) {
    __half2 h = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<unsigned*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<unsigned*>(&h);
  }
}

template <typename T>
__device__ __forceinline__ float2 unpack2(unsigned u) {
  if constexpr (std::is_same_v<T, f16>) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  } else {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
}

// (x0, x1) as a T hi/lo pair, x0 in the low halves: hi = T(x),
// lo = T(x - hi).
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  hi = pack2<T>(x0, x1);
  const float2 hf = unpack2<T>(hi);
  lo = pack2<T>(x0 - hf.x, x1 - hf.y);
}

// The A operand of k-step kk of a second product, as a T hi/lo pair, from
// the accumulators of n-blocks 2kk and 2kk+1: the m16n8 C layout of two
// neighbouring n-blocks is the m16k16 A layout.
template <typename T, int NB>
__device__ __forceinline__ void a_split(const float (&x)[NB][4], int kk,
                                        unsigned (&hi)[4], unsigned (&lo)[4]) {
  split2<T>(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
  split2<T>(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
  split2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
  split2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

// c0, c1 (two neighbouring n8 blocks) += (hi + lo) b, the A pair and the
// ldmatrix fragments b of B both in T: two MMAs a block.
template <typename T>
__device__ __forceinline__ void mma_hilo(float (&c0)[4], float (&c1)[4],
                                         const unsigned (&hi)[4],
                                         const unsigned (&lo)[4],
                                         const unsigned (&b)[4]) {
  mma<T>(c0, hi, b[0], b[1]);
  mma<T>(c1, hi, b[2], b[3]);
  mma<T>(c0, lo, b[0], b[1]);
  mma<T>(c1, lo, b[2], b[3]);
}

// c += (hi + lo) (bh + bl) without lo * bl: three bf16 MMAs.
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&hi)[4],
                                     const unsigned (&lo)[4], unsigned b0,
                                     unsigned b1) {
  unsigned h0, l0, h1, l1;
  float2 f = unpack2<f16>(b0);
  split2<bf16>(f.x, f.y, h0, l0);
  f = unpack2<f16>(b1);
  split2<bf16>(f.x, f.y, h1, l1);
  mma<bf16>(c, hi, h0, h1);
  mma<bf16>(c, hi, l0, l1);
  mma<bf16>(c, lo, h0, h1);
}

// The ds products: c0, c1 += (hi + lo) b with the A pair in bf16 and B in
// T.  bf16: mma_hilo.  fp16: each B register widened exactly into a bf16
// hi/lo pair as it is used (mma3), then hi*hi + hi*lo + lo*hi.
template <typename T>
__device__ __forceinline__ void mma_ds(float (&c0)[4], float (&c1)[4],
                                       const unsigned (&hi)[4],
                                       const unsigned (&lo)[4],
                                       const unsigned (&b)[4]) {
  if constexpr (std::is_same_v<T, bf16>) {
    mma_hilo<bf16>(c0, c1, hi, lo, b);
  } else {
    mma3(c0, hi, lo, b[0], b[1]);
    mma3(c1, hi, lo, b[2], b[3]);
  }
}

// Rows [row0, row0 + R) of one head into an [R][D + PAD] tile of 16-bit T
// by cp.async, NT threads sharing the 16-byte copies; rows at or past
// `len` are zero-filled (0 * garbage could be NaN) from an address kept
// inside the tensor.
template <typename T, int D, int R, int NT, int PAD>
__device__ __forceinline__ void cp_tile(T* dst, const T* src,
                                        long long row_stride, int row0,
                                        int len) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < (R * CH + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + it * NT, r = i / CH, c = i % CH;
    if (R * CH % NT == 0 || i < R * CH) {
      const int s = row0 + r;
      cp_async16(dst + r * (D + PAD) + c * 8,
                 src + min(s, len - 1) * row_stride + c * 8, s < len);
    }
  }
}

// Two f32 of a C fragment row to T at p (4-byte aligned).
template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1) {
  *reinterpret_cast<unsigned*>(p) = pack2<T>(x0, x1);
}

}  // namespace sm90
