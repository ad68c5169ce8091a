// RMSNorm forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel tensorflowonspark_tpu/ops/norm.py:_rmsnorm_kernel
// (launched by _rmsnorm_forward).  Same contract: x is [rows, dim] (the
// wrapper flattens any leading shape), scale is [dim] (handed over as f32),
// and y = x_f32 * rsqrt(mean(x_f32^2) + eps) * scale_f32, rounded once to
// x's type.  The math is f32 for f32, bf16 and f16 inputs.
//
// What bounds it on the H100.  Two flops a byte at most: x is read once and
// y written once, so the bound is memory (3.35 TB/s); at the transformer's
// activation shape [8*2048, 1024] bf16 that is 67.1 MB, ~0.020 ms.
//
// What the design does about it.  The Pallas kernel kept a block of
// block_rows rows in VMEM and padded the row count up to a multiple of it;
// here one warp owns one row and a CTA holds up to 8 rows (block_rows caps
// it), so a CTA never spans more than its rows and needs no shared memory.
// Rows past the end are neither read nor written: the grid rounds up and
// each warp checks its row, so nothing is padded.  Where dim is a multiple
// of the 16-byte vector (8 bf16/f16, 4 f32) and x is 16-byte aligned, each
// lane moves 16 bytes a load, neighbouring lanes on neighbouring addresses;
// otherwise it falls to one element a load.  The sum of squares is f32 and
// reduces across the warp with __shfl_xor_sync.  The second pass reads the
// row again, which the first pass left in L1/L2 (2 KB a row at dim 1024).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS_PER_CTA = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T, bool VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ y, long long rows, int dim,
                               float eps) {
  constexpr int V = 16 / sizeof(T);  // elements in one 16-byte vector
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp: rows past the end stay untouched
  const T* xr = x + row * dim;
  T* yr = y + row * dim;

  float ss = 0.f;
  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < dim / V; i += 32) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < dim; i += 32) {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)dim + eps);

  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < dim / V; i += 32) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = from_f<T>(to_f(e[j]) * r * scale[i * V + j]);
      yv[i] = out;
    }
  } else {
    for (int i = lane; i < dim; i += 32)
      yr[i] = from_f<T>(to_f(xr[i]) * r * scale[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y,
                   long long rows, int dim, float eps, int rows_per_cta,
                   int vec, cudaStream_t stream) {
  const long long grid = (rows + rows_per_cta - 1) / rows_per_cta;
  const dim3 block(32 * rows_per_cta);
  if (vec)
    rmsnorm_kernel<T, true><<<(unsigned)grid, block, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), rows, dim, eps);
  else
    rmsnorm_kernel<T, false><<<(unsigned)grid, block, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), rows, dim, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  x and y are contiguous
// [rows, dim]; scale is contiguous float32 [dim].  vec=1 asks for the
// 16-byte path: the caller guarantees dim % (16 / element size) == 0 and
// 16-byte aligned x and y.  Returns a cudaError_t (0 on success), -1 for
// arguments the kernel does not take.
int tfos_rmsnorm_fwd(int dtype, const void* x, const void* scale, void* y,
                     long long rows, int dim, float eps, int rows_per_cta,
                     int vec, void* stream) {
  if (rows < 1 || dim < 1 || rows_per_cta < 1 ||
      rows_per_cta > MAX_ROWS_PER_CTA)
    return -1;
  if ((rows + rows_per_cta - 1) / rows_per_cta > 0x7fffffffLL) return -1;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, s, y, rows, dim, eps, rows_per_cta, vec, st);
    case 1:
      return launch<__nv_bfloat16>(x, s, y, rows, dim, eps, rows_per_cta,
                                   vec, st);
    case 2:
      return launch<__half>(x, s, y, rows, dim, eps, rows_per_cta, vec, st);
    default:
      return -1;
  }
}

const char* tfos_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
