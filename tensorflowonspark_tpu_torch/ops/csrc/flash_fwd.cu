// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel tensorflowonspark_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_forward).  Same contract: softmax(q k^T * scale + mask) v
// with the online-softmax recurrence (running max m, running sum l, rescaled
// f32 accumulator), q pre-scaled in f32, tail and causal masks on global
// positions filled with the finite -1e30, the causal kv loop trimmed at the
// diagonal, out = acc / max(l, 1e-30) in the input type and the per-row f32
// lse = m + log(max(l, 1e-30)) that the backward consumes.
//
// What bounds it on the H100.  At the serving path's prompt buckets
// (Sq = Skv up to 2048, head_dim 128) attention does ~2*Sq*D flops per
// q row for ~4*D bytes of q/out traffic: far above the card's 295 flop/byte
// ridge, so the bound is arithmetic.  This first kernel does its products
// with f32 FMAs from shared memory (no tensor cores), so it is bound by the
// FMA pipe and shared-memory bandwidth, well below the bf16 tensor-core
// peak; wgmma/TMA versions are later work.
//
// What the design does about it.  The Pallas BlockSpec put the WHOLE K/V
// sequence of a head into VMEM for each program; that and its VMEM ceiling
// are TPU artefacts.  Here one CTA owns one (batch*head, 64-row q tile),
// keeps the scaled q tile in shared memory, and streams 64-row K/V tiles
// through shared memory, so shared memory per CTA is fixed whatever the
// sequence length.  Each of the 256 threads owns a 4x4 score micro-tile and a
// 4 x (D/16) slice of the accumulator in registers, so S never reaches device
// memory.  Row statistics reduce across the 16 lanes of a half-warp with
// shuffles.  With causal masking the CTAs nearest the end of the sequence
// (longest kv loops) are scheduled first.  q, k, v and out are addressed
// through (batch, seq, head) strides with unit stride on head_dim, so the
// wrapper passes non-contiguous views of a fused qkv projection as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;    // q rows per CTA
constexpr int BN = 64;    // kv rows per loop step
constexpr int NT = 256;   // threads per CTA: 16 x 16
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Skv, Strides qs,
                 Strides ks, Strides vs, Strides os, float scale, int causal) {
  constexpr int DP = D + 1;   // padded pitch: conflict-free column reads
  constexpr int PP = BN + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [BM][DP] scaled q tile
  float* sK = sQ + BM * DP;    // [BN][DP]
  float* sV = sK + BN * DP;    // [BN][D]
  float* sP = sV + BN * D;     // [BM][PP] probabilities of this step

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // score columns tx + 16*j, out cols tx + 16*c
  const int ty = tid >> 4;     // rows ty + 16*i
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int qt = causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int q0 = qt * BM;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, c = idx % D, s = q0 + r;
    sQ[r * DP + c] = s < Sq ? to_f32(qb[s * qs.s + c]) * scale : 0.f;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (Skv + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (q0 + BM + BN - 1) / BN);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous step is done with sK, sV and sP
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int r = idx / D, c = idx % D, s = k0 + r;
      const bool ok = s < Skv;  // zero fill: 0 * garbage could be NaN
      sK[r * DP + c] = ok ? to_f32(kb[s * ks.s + c]) : 0.f;
      sV[r * D + c] = ok ? to_f32(vb[s * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = sK[(tx + 16 * jj) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        const bool ok = kpos < Skv && qpos < Sq && (!causal || qpos >= kpos);
        if (!ok) sc[i][jj] = NEG_INF;
        mt = fmaxf(mt, sc[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(sc[i][jj] - m_new);
        sP[(ty + 16 * i) * PP + tx + 16 * jj] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PP + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[n * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);  // fully masked rows: l == 0
    T* orow = out + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(orow + tx + 16 * c, acc[i][c] / denom);
    if (tx == 0) lse[(long long)bh * Sq + qpos] = m[i] + logf(denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int H, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
           Strides os, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, Sq, Skv, qs, ks,
      vs, os, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// [B, S, H, D] layout with unit stride on D.  Returns a cudaError_t
// (0 on success); -1 for an unsupported dtype or head_dim.
int tfos_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, void* out, float* lse, int B, int H, int Sq,
                   int Skv, long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh, long long vsb,
                   long long vss, long long vsh, long long osb, long long oss,
                   long long osh, float scale, int causal, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TFOS_LAUNCH(T, D)                                                   \
  return launch<T, D>(q, k, v, out, lse, B, H, Sq, Skv, qs, ks, vs, os,     \
                      scale, causal, st)
  if (dtype == 0 && head_dim == 64) TFOS_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) TFOS_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) TFOS_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) TFOS_LAUNCH(__nv_bfloat16, 128);
#undef TFOS_LAUNCH
  return -1;
}

const char* tfos_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
