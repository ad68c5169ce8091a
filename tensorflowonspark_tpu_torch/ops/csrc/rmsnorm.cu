// RMSNorm forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel tensorflowonspark_tpu/ops/norm.py:_rmsnorm_kernel
// (launched by _rmsnorm_forward).  Same contract: x is [rows, dim] (the
// wrapper flattens any leading shape), scale is [dim] (handed over as f32),
// and y = x_f32 * rsqrt(mean(x_f32^2) + eps) * scale_f32, rounded once to
// x's type.  The math is f32 for f32, bf16 and f16 inputs.
//
// What bounds it on the H100.  Two flops a byte at most: x is read once and
// y written once, so the bound is memory (3.35 TB/s, H100 SXM data sheet,
// 700 W limit); at the transformer's activation shape [8*2048, 1024] bf16
// that is 67.1 MB, ~0.020 ms.
//
// What the design does about it.  The Pallas kernel kept a block of
// block_rows rows in VMEM and padded the row count up to a multiple of it;
// here one warp owns one row and a CTA holds up to 8 rows (block_rows caps
// it), so a CTA never spans more than its rows and needs no shared memory.
// Rows past the end are neither read nor written: the grid rounds up and
// each warp checks its row, so nothing is padded.  The sum of squares is
// f32 and reduces across the warp with __shfl_xor_sync.  Two paths of one
// kernel, by shape:
// - registers (mode 2): where dim is a multiple of 32 16-byte vectors (256
//   bf16/f16, 128 f32) and a lane's share of the row fits 8 vectors (dim up
//   to 2048 in bf16/f16, 1024 in f32), a template instance on the vectors a
//   lane holds issues every load of the row before the reduction, keeps the
//   row in registers and writes y from them: x is read from device memory
//   once, with the whole row's loads in flight at once.  scale is read as
//   16-byte f32 vectors.
// - two-pass (modes 1 and 0): any other dim.  Where dim is a multiple of
//   the 16-byte vector and x is 16-byte aligned, each lane moves 16 bytes a
//   load (mode 1), else one element (mode 0); the second pass reads the row
//   again, which the first pass left in L1/L2.
// On the 16-byte paths neighbouring lanes read neighbouring vectors.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS_PER_CTA = 8;
constexpr int MAX_VECS_PER_LANE = 8;  // registers path: 8 x 16 B a lane

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

// One pass: NV 16-byte vectors a lane, dim = 32 * NV vectors; x, y and
// scale 16-byte aligned.
template <typename T, int NV>
__global__ void rmsnorm_regs_kernel(const T* __restrict__ x,
                                    const float* __restrict__ scale,
                                    T* __restrict__ y, long long rows,
                                    float eps) {
  constexpr int V = 16 / sizeof(T);  // elements in one 16-byte vector
  constexpr int DIM = 32 * V * NV;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp: rows past the end stay untouched
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * DIM);
  uint4 raw[NV];  // the lane's share of the row: vectors lane + 32*k
#pragma unroll
  for (int k = 0; k < NV; ++k) raw[k] = xv[lane + 32 * k];

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const T* e = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f(e[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)DIM + eps);

  const float4* sv = reinterpret_cast<const float4*>(scale);
  uint4* yv = reinterpret_cast<uint4*>(y + row * DIM);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    float sc[V];
#pragma unroll
    for (int c = 0; c < V / 4; ++c) {
      const float4 s4 = sv[i * (V / 4) + c];
      sc[4 * c] = s4.x;
      sc[4 * c + 1] = s4.y;
      sc[4 * c + 2] = s4.z;
      sc[4 * c + 3] = s4.w;
    }
    const T* e = reinterpret_cast<const T*>(&raw[k]);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = from_f<T>(to_f(e[j]) * r * sc[j]);
    yv[i] = out;
  }
}

template <typename T, int NV>
cudaError_t launch_regs(const void* x, const float* scale, void* y,
                        long long rows, int rows_per_cta, float eps,
                        cudaStream_t stream) {
  const long long grid = (rows + rows_per_cta - 1) / rows_per_cta;
  rmsnorm_regs_kernel<T, NV><<<(unsigned)grid, 32 * rows_per_cta, 0,
                               stream>>>(static_cast<const T*>(x), scale,
                                         static_cast<T*>(y), rows, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y,
                   long long rows, int dim, float eps, int rows_per_cta,
                   int mode, cudaStream_t stream) {
  if (mode == 2) {
    constexpr int V = 16 / sizeof(T);
    switch (dim / (32 * V)) {  // vectors a lane
#define TFOS_REGS(NV) \
  case NV:            \
    return launch_regs<T, NV>(x, scale, y, rows, rows_per_cta, eps, stream)
      TFOS_REGS(1); TFOS_REGS(2); TFOS_REGS(3); TFOS_REGS(4);
      TFOS_REGS(5); TFOS_REGS(6); TFOS_REGS(7); TFOS_REGS(8);
#undef TFOS_REGS
      default:
        return cudaErrorInvalidValue;
    }
  }
  const long long grid = (rows + rows_per_cta - 1) / rows_per_cta;
  const dim3 block(32 * rows_per_cta);
  if (mode == 1)
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
// [rows, dim]; scale is contiguous float32 [dim].  mode: 0 two-pass, one
// element a load; 1 two-pass, 16-byte vectors (dim a multiple of the
// vector, x and y 16-byte aligned); 2 one pass from registers (dim = 32 * NV
// vectors with 1 <= NV <= 8, x, y and scale 16-byte aligned).  Returns a
// cudaError_t (0 on success), -1 for arguments the kernel does not take.
int tfos_rmsnorm_fwd(int dtype, const void* x, const void* scale, void* y,
                     long long rows, int dim, float eps, int rows_per_cta,
                     int mode, void* stream) {
  if (rows < 1 || dim < 1 || rows_per_cta < 1 ||
      rows_per_cta > MAX_ROWS_PER_CTA || mode < 0 || mode > 2)
    return -1;
  if ((rows + rows_per_cta - 1) / rows_per_cta > 0x7fffffffLL) return -1;
  const int esize = dtype == 0 ? 4 : 2, vec = 16 / esize;
  const bool aligned = ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
  if (mode >= 1 && !(aligned && dim % vec == 0)) return -1;
  if (mode == 2 && !((uintptr_t)scale % 16 == 0 && dim % (32 * vec) == 0 &&
                     dim / (32 * vec) <= MAX_VECS_PER_LANE))
    return -1;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, s, y, rows, dim, eps, rows_per_cta, mode, st);
    case 1:
      return launch<__nv_bfloat16>(x, s, y, rows, dim, eps, rows_per_cta,
                                   mode, st);
    case 2:
      return launch<__half>(x, s, y, rows, dim, eps, rows_per_cta, mode, st);
    default:
      return -1;
  }
}

const char* tfos_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
