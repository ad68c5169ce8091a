// Warp-level tensor-core building blocks shared by the bf16 flash kernels
// (flash_fwd.cu, flash_bwd.cu): cp.async copies into shared memory,
// ldmatrix, mma.sync m16n8k16 (bf16 operands, f32 accumulators) and the
// bf16 hi/lo split that carries an f32 operand into it with ~16
// significant bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

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
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate.  Fragments, with
// g = lane/4 and t = lane%4: a0..a3 hold A rows g, g+8, g, g+8 at columns
// (2t, 2t+1) + 0, 0, 8, 8; b0, b1 hold B column g at rows (2t, 2t+1) + 0, 8;
// c0..c3 hold C rows g, g, g+8, g+8 at columns 2t, 2t+1, 2t, 2t+1.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x0, x1) as a bf16 hi/lo pair, x0 in the low halves: hi = bf16(x),
// lo = bf16(x - hi), so hi + lo keeps ~16 significant bits of x.
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A operand of k-step kk of a second product, as a hi/lo pair, from
// the accumulators of n-blocks 2kk and 2kk+1: the m16n8 C layout of two
// neighbouring n-blocks is the m16k16 A layout.
template <int NB>
__device__ __forceinline__ void a_split(const float (&x)[NB][4], int kk,
                                        unsigned (&hi)[4], unsigned (&lo)[4]) {
  split2(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
  split2(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
  split2(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
  split2(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

// Rows [row0, row0 + R) of one head into an [R][D + PAD] bf16 tile by
// cp.async, NT threads sharing the copies; rows at or past `len` are
// zero-filled (0 * garbage could be NaN) from an address kept inside the
// tensor.
template <int D, int R, int NT, int PAD>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src,
                                        long long row_stride, int row0,
                                        int len) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  static_assert(R * CH % NT == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < R * CH / NT; ++it) {
    const int i = threadIdx.x + it * NT, r = i / CH, c = i % CH;
    const int s = row0 + r;
    cp_async16(dst + r * (D + PAD) + c * 8,
               src + min(s, len - 1) * row_stride + c * 8, s < len);
  }
}

// Two f32 of a C fragment row to bf16 at p (4-byte aligned).
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

}  // namespace sm90
