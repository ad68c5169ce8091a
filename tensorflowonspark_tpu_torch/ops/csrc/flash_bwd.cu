// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface:
// the dq kernel and the dk/dv kernel.
//
// Replaces the TPU kernels tensorflowonspark_tpu/ops/attention.py:_dq_kernel
// and :_dkv_kernel (both launched by _flash_backward_pallas).  Same contract:
// from the forward's f32 lse and delta = rowsum(g * out) (computed by the
// wrapper), each (q tile, kv tile) pair recomputes
//     p  = exp(q k^T * scale - lse)        (0 where masked)
//     ds = p * (g v^T - delta) * scale
// in one shared routine (bwd_recompute, the counterpart of _bwd_recompute),
// and the kernels accumulate
//     dq  = ds k                      one CTA per q tile, kv loop
//     dv += p^T g,  dk += ds^T q      one CTA per kv tile, q loop
// Each CTA owns its output tile, so there are no atomics and the gradients
// are deterministic (FlashAttention-2's single pass with atomicAdd on dq
// would give up both).  Masks use global positions (q tail, kv tail,
// causal); rows past the end are zero-filled on load, since 0 * garbage
// could be NaN.  Math is f32 whatever the input type; outputs are in the
// input type.
//
// What bounds it on the H100.  At the training shape (8, 2048, 8, 128)
// causal there are 134.3 M visible (q, kv) pairs per call.  The dq kernel
// does three products a pair (s, dp, dq: 6*D flops) and the dk/dv kernel
// four (s, dp, dv, dk: 8*D flops), for ~10 bytes of q/k/v/g traffic per
// q or kv row: far above the card's ridge, so both are bound by
// operations (0.104 ms and 0.139 ms at the bf16 tensor-core peak).  This
// first version does its products with f32 FMAs from shared memory (no
// tensor cores), so it is bound by the FMA pipe and shared-memory
// bandwidth, far from that peak; mma.sync / wgmma / TMA are later work.
//
// What the design does about it.  The Pallas BlockSpecs put a head's whole
// K/V (dq) or Q/G (dk/dv) sequence in VMEM; here a CTA keeps only its own
// 64-row tile(s) resident and streams 64-row tiles of the other side through
// shared memory, so shared memory is fixed whatever the sequence (146 KB
// for dq, 162 KB for dk/dv at head_dim 128).  Each of the 256 threads owns
// a 4x4 micro-tile of the 64x64 score tile and a 4 x (D/16) slice of its
// accumulators in registers; p and ds pass between the two phases of a step
// through shared memory only.  The causal loops stop (dq) or start (dk/dv)
// at the diagonal, and the CTAs with the longest loops are scheduled first:
// the last q tiles for dq, the first kv tiles for dk/dv.  All tensors are
// addressed through (batch, seq, head) strides with unit stride on
// head_dim, so views of the fused qkv projection go in as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // q rows per tile
constexpr int BN = 64;   // kv rows per tile
constexpr int NT = 256;  // threads per CTA: 16 x 16
constexpr int PP = BN + 1;

struct Strides {
  long long b, s, h;
};

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;  // [B*H, Sq] f32
  void *out0, *out1;         // dq (dq kernel); dk, dv (dk/dv kernel)
  int H, Sq, Skv;
  Strides qs, ks, vs, gs, o0s, o1s;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

// rows [row0, row0 + R) of one head of a [B, S, H, D] tensor into a padded
// f32 tile [R][D + 1]; rows at or past `len` are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int len) {
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D, c = idx % D, s = row0 + r;
    dst[r * (D + 1) + c] = s < len ? to_f32(src[s * row_stride + c]) : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int len) {
  for (int r = threadIdx.x; r < BM; r += NT)
    dst[r] = row0 + r < len ? src[row0 + r] : 0.f;
}

// The one recompute both kernels share (counterpart of _bwd_recompute): p
// and ds for this thread's 4x4 micro-tile of the (q tile at q0, kv tile at
// k0) pair.  Micro-tile rows ty + 16*i are q rows, columns tx + 16*j kv rows.
template <int D>
__device__ __forceinline__ void bwd_recompute(
    const float* sQ, const float* sG, const float* sK, const float* sV,
    const float* sLse, const float* sDelta, int q0, int k0, int Sq, int Skv,
    float scale, int causal, float p[4][4], float ds[4][4]) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = sQ[(ty + 16 * i) * DP + d];
      gv[i] = sG[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = sK[(tx + 16 * j) * DP + d];
      vv[j] = sV[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool ok = qpos < Sq && kpos < Skv && (!causal || qpos >= kpos);
      p[i][j] = ok ? expf(s[i][j] * scale - lse) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta) * scale;
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * BM * (D + 1) + BM * PP + 2 * BM);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * BM * (D + 1) + 2 * BM * PP + 2 * BM);
}

// dq for one 64-row q tile: loop kv tiles, causal-trimmed at the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dq_kernel(Args a) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [BM][DP]
  float* sG = sQ + BM * DP;    // [BM][DP]
  float* sK = sG + BM * DP;    // [BN][DP]
  float* sV = sK + BN * DP;    // [BN][DP]
  float* sDS = sV + BN * DP;   // [BM][PP]
  float* sLse = sDS + BM * PP; // [BM]
  float* sDelta = sLse + BM;   // [BM]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // causal: the last q tiles have the longest kv loops; run them first
  const int qt = a.causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int q0 = qt * BM;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;

  load_tile<T, D, BM>(sQ, q, a.qs.s, q0, a.Sq);
  load_tile<T, D, BM>(sG, g, a.gs.s, q0, a.Sq);
  load_rows(sLse, a.lse + (long long)bh * a.Sq, q0, a.Sq);
  load_rows(sDelta, a.delta + (long long)bh * a.Sq, q0, a.Sq);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int n_kv = (a.Skv + BN - 1) / BN;
  if (a.causal) n_kv = min(n_kv, (q0 + BM + BN - 1) / BN);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous step is done with sK, sV and sDS
    load_tile<T, D, BN>(sK, k, a.ks.s, k0, a.Skv);
    load_tile<T, D, BN>(sV, v, a.vs.s, k0, a.Skv);
    __syncthreads();
    float p[4][4], ds[4][4];
    bwd_recompute<D>(sQ, sG, sK, sV, sLse, sDelta, q0, k0, a.Sq, a.Skv,
                     a.scale, a.causal, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        sDS[(ty + 16 * i) * PP + tx + 16 * jj] = ds[i][jj];
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(ty + 16 * i) * PP + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = sK[n * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    T* row = static_cast<T*>(a.out0) + b * a.o0s.b + qpos * a.o0s.s +
             h * a.o0s.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(row + tx + 16 * c, acc[i][c]);
  }
}

// dk and dv for one 64-row kv tile: loop q tiles, starting at the diagonal
// when causal (q tiles above it see none of this kv tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(Args a) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // [BN][DP]
  float* sV = sK + BN * DP;     // [BN][DP]
  float* sQ = sV + BN * DP;     // [BM][DP]
  float* sG = sQ + BM * DP;     // [BM][DP]
  float* sP = sG + BM * DP;     // [BM][PP]
  float* sDS = sP + BM * PP;    // [BM][PP]
  float* sLse = sDS + BM * PP;  // [BM]
  float* sDelta = sLse + BM;    // [BM]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // causal: the first kv tiles have the longest q loops and come first
  const int k0 = blockIdx.x * BN;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* lse = a.lse + (long long)bh * a.Sq;
  const float* delta = a.delta + (long long)bh * a.Sq;

  load_tile<T, D, BN>(sK, k, a.ks.s, k0, a.Skv);
  load_tile<T, D, BN>(sV, v, a.vs.s, k0, a.Skv);

  float dk[4][DC], dv[4][DC];  // rows: kv rows ty + 16*i
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_q = (a.Sq + BM - 1) / BM;
  // first q tile that reaches this kv tile: floor(k0 / BM), whatever the
  // two tile sizes
  const int i0 = a.causal ? k0 / BM : 0;

  for (int it = i0; it < n_q; ++it) {
    const int q0 = it * BM;
    __syncthreads();  // the previous step is done with sQ, sG, sP, sDS
    load_tile<T, D, BM>(sQ, q, a.qs.s, q0, a.Sq);
    load_tile<T, D, BM>(sG, g, a.gs.s, q0, a.Sq);
    load_rows(sLse, lse, q0, a.Sq);
    load_rows(sDelta, delta, q0, a.Sq);
    __syncthreads();
    float p[4][4], ds[4][4];
    bwd_recompute<D>(sQ, sG, sK, sV, sLse, sDelta, q0, k0, a.Sq, a.Skv,
                     a.scale, a.causal, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        sP[(ty + 16 * i) * PP + tx + 16 * jj] = p[i][jj];
        sDS[(ty + 16 * i) * PP + tx + 16 * jj] = ds[i][jj];
      }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < BM; ++n) {  // q rows of this tile
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[n * PP + ty + 16 * i];
        dsv[i] = sDS[n * PP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float gv = sG[n * DP + tx + 16 * c];
        const float qv = sQ[n * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(pv[i], gv, dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= a.Skv) continue;
    T* krow = static_cast<T*>(a.out0) + b * a.o0s.b + kpos * a.o0s.s +
              h * a.o0s.h;
    T* vrow = static_cast<T*>(a.out1) + b * a.o1s.b + kpos * a.o1s.s +
              h * a.o1s.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(krow + tx + 16 * c, dk[i][c]);
      store(vrow + tx + 16 * c, dv[i][c]);
    }
  }
}

template <typename T, int D>
int launch(int which, const Args& a, int B, cudaStream_t stream) {
  const size_t smem = which == 0 ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  void (*kernel)(Args) =
      which == 0 ? &flash_dq_kernel<T, D> : &flash_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = which == 0 ? (a.Sq + BM - 1) / BM : (a.Skv + BN - 1) / BN;
  const dim3 grid(tiles, B * a.H);
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(int which, int dtype, int head_dim, const void* q, const void* k,
             const void* v, const void* g, const float* lse,
             const float* delta, void* out0, void* out1, int B, int H, int Sq,
             int Skv, const long long* st, float scale, int causal,
             void* stream) {
  const Args a{q,     k,     v,     g,     lse,
               delta, out0,  out1,  H,     Sq,
               Skv,   {st[0], st[1], st[2]},  {st[3], st[4], st[5]},
               {st[6], st[7], st[8]},         {st[9], st[10], st[11]},
               {st[12], st[13], st[14]},      {st[15], st[16], st[17]},
               scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(which, a, B, s);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(which, a, B, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(which, a, B, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(which, a, B, s);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, g are [B, S, H, D] with unit
// stride on D; lse and delta are f32 [B, H, Sq], contiguous.  `strides`
// holds 6 x (batch, seq, head) element strides for q, k, v, g, out0, out1.
// tfos_flash_dq writes dq to out0 (out1 unused); tfos_flash_dkv writes dk to
// out0 and dv to out1.  Returns a cudaError_t (0 on success); -1 for an
// unsupported dtype or head_dim.
int tfos_flash_dq(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, const void* g, const float* lse,
                  const float* delta, void* out0, void* out1, int B, int H,
                  int Sq, int Skv, const long long* strides, float scale,
                  int causal, void* stream) {
  return dispatch(0, dtype, head_dim, q, k, v, g, lse, delta, out0, out1, B,
                  H, Sq, Skv, strides, scale, causal, stream);
}

int tfos_flash_dkv(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, const void* g, const float* lse,
                   const float* delta, void* out0, void* out1, int B, int H,
                   int Sq, int Skv, const long long* strides, float scale,
                   int causal, void* stream) {
  return dispatch(1, dtype, head_dim, q, k, v, g, lse, delta, out0, out1, B,
                  H, Sq, Skv, strides, scale, causal, stream);
}

const char* tfos_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
