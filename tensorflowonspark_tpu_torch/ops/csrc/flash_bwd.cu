// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface:
// the dq kernel and the dk/dv kernel.
//
// Replaces the TPU kernels tensorflowonspark_tpu/ops/attention.py:_dq_kernel
// and :_dkv_kernel (both launched by _flash_backward_pallas).  Same contract:
// from the forward's f32 lse and delta = rowsum(g * out) (computed by the
// wrapper), each (q tile, kv tile) pair recomputes
//     p  = exp(q k^T * scale - lse)        (0 where masked)
//     ds = p * (g v^T - delta) * scale
// and the kernels accumulate
//     dq  = ds k                      one CTA per q tile, kv loop
//     dv += p^T g,  dk += ds^T q      one CTA per kv tile, q loop
// Each CTA owns its output tile, so there are no atomics and the gradients
// are deterministic (FlashAttention-2's single pass with atomicAdd on dq
// would give up both).  Masks use global positions (q tail, kv tail,
// causal); rows past the end are zero-filled on load, since 0 * garbage
// could be NaN.  Outputs are in the input type.  The causal loops stop (dq)
// or start (dk/dv) at the diagonal, and the CTAs with the longest loops are
// scheduled first: the last q tiles for dq, the first kv tiles for dk/dv.
// batch*head sits on the grid's x (no 65,535 limit), tiles on y, so the
// longest loops of every head start first.  All tensors are addressed
// through (batch, seq, head) strides with unit stride on head_dim, so views
// of the fused qkv projection go in as they are.  Two implementations
// behind one interface, each library built for one head_dim (a multiple of
// 16 up to 256) and one dtype (ops/_build.py passes TFOS_HEAD_DIM and
// TFOS_DTYPE); above 256 one library a dtype (TFOS_HEAD_DIM=0) holds the
// chunked kernels, which take any multiple of 128 at run time and sum s
// and dp over head_dim in chunks, the CTA's own chunk last (flash_dq_ and
// flash_dkv_chunked_tc_kernel, flash_dq_ and flash_dkv_chunked_kernel):
//
// bf16 and fp16: tensor cores (namespace tc).  Every product is a
// warp-level mma.sync m16n8k16 (16-bit operands, f32 accumulators), its
// operands loaded from shared memory with ldmatrix (.trans where the
// operand is needed transposed).  A CTA of 4 warps owns a 64-row tile and
// keeps it resident in shared memory (Q and g for dq, K and V for dk/dv);
// the other side streams through a 2-stage ring of 64-row tiles filled by
// cp.async 16-byte copies, so the next tile loads while this one computes.
// Each warp owns 16 rows of its tile, and the scores never leave its
// registers (the FlashAttention-2 register layout): the dq kernel computes
// S = Q K^T and dP = g V^T, the dk/dv kernel the transposes S^T = K Q^T and
// dP^T = V g^T, so that the accumulator fragment of p or ds (the m16n8 C
// layout) is already the A operand (m16k16) of the second product: ds K,
// p^T g, ds^T q.  One routine (tc_recompute) forms p and ds in both, given
// a map from fragment (row, column) to (q, kv) positions, since one kernel
// holds S and the other S^T; tiles wholly below the diagonal and inside
// both sequences skip the mask.  p and ds enter each second product as a
// hi/lo pair (hi = round(x), lo = round(x - hi), two MMAs into one f32
// accumulator): rounding them once to 16 bits would put an error of up to
// 2^-9 on every term, which the per-element check against the f32 plain
// version does not hold for outputs near zero.  p's pair is in the
// kernel's own type; ds's is always bf16, whose range is f32's, and in
// fp16 its B operand is widened exactly into a bf16 pair for three bf16
// MMAs (mma_sm90.cuh says why: ds scales with g, which fp16 cannot hold
// small).  Above head_dim 128 the gradient columns are split over 64-
// column CTAs (out_cols), each recomputing p and ds, so the accumulators
// stay in registers.  Shared-memory rows are padded by 16 bytes so that
// ldmatrix is free of bank conflicts; 102 KiB (dq) and 103 KiB (dk/dv) at
// head_dim 128, so two CTAs fit an SM, 198 KiB at 256.  The cp.async /
// ldmatrix / mma.sync / hi-lo building blocks are shared with the forward
// (mma_sm90.cuh).
//
// What bounds it on the H100.  At the training shape (8, 2048, 8, 128)
// causal there are 134.3 M visible (q, kv) pairs per call, and ~10 bytes
// of q/k/v/g traffic per q or kv row: far above the card's ridge, so both
// kernels are bound by operations.  The function needs 3 products a pair
// for dq (s, dp, dq) and 4 for dk/dv; with the hi/lo split the kernels
// spend 4 (dq) and 6 (dk/dv) product-units of 2*D flops a pair.  mma.sync
// reaches the tensor cores from fragments a warp owns, but not their full
// rate: wgmma with TMA and warp specialisation (shared-memory descriptors,
// swizzled layouts) is the next step for these kernels.
//
// float32: f32 FMAs (the first version, kept for float32, where TF32
// would lose the f32 gradient checks).  Each of 256 threads owns an MI x MI
// micro-tile of the score tile (MI = 4: 64 x 64 tiles; 2 above head_dim
// 128, whose 64-row padded tiles would not fit) and an MI x (D/16) slice
// of its accumulators; tiles are converted to padded f32 tiles in shared
// memory (146 KB for dq, 162 KB for dk/dv at head_dim 128), and p and ds
// pass between the two phases of a step through shared memory.  The
// shared recompute is bwd_scores and bwd_finish (bwd_recompute at a fixed
// head_dim).

#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA: 16 x 16

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
  int D;  // head_dim (the chunked kernels read it; the others' is built in)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Micro-tile rows (and columns) a thread owns: a tile is 16 * MI rows of
// q and of kv.  MI = 4 (64-row tiles) up to head_dim 128; above it 2, so
// that the four padded f32 tiles fit shared memory (at D = 256 four
// 64 x 257 tiles alone are 263,168 bytes).
__host__ __device__ constexpr int micro(int D) {
  return D > 128 ? 2 : 4;
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

template <int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int len) {
  for (int r = threadIdx.x; r < R; r += NT)
    dst[r] = row0 + r < len ? src[row0 + r] : 0.f;
}

// The one recompute both kernels share (counterpart of _bwd_recompute), in
// two parts: bwd_scores adds a W-column slice of head_dim to this thread's
// MI x MI micro-tile of the scores s = q k^T and of dp = g v^T (padded f32
// tiles of pitch W + 1), and bwd_finish turns them into p and ds for the
// (q tile at q0, kv tile at k0) pair.  Micro-tile rows ty + 16*i are q
// rows, columns tx + 16*j kv rows.  The D-templated kernels take the whole
// head_dim in one slice (bwd_recompute), the chunked ones a chunk a step.
template <int MI, int W>
__device__ __forceinline__ void bwd_scores(const float* sQ, const float* sG,
                                           const float* sK, const float* sV,
                                           float (&s)[MI][MI],
                                           float (&dp)[MI][MI]) {
  constexpr int DP = W + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int d = 0; d < W; ++d) {
    float qv[MI], gv[MI], kv[MI], vv[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      qv[i] = sQ[(ty + 16 * i) * DP + d];
      gv[i] = sG[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < MI; ++j) {
      kv[j] = sK[(tx + 16 * j) * DP + d];
      vv[j] = sV[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MI; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

template <int MI>
__device__ __forceinline__ void bwd_finish(
    const float* sLse, const float* sDelta, int q0, int k0, int Sq, int Skv,
    float scale, int causal, const float (&s)[MI][MI],
    const float (&dp)[MI][MI], float (&p)[MI][MI], float (&ds)[MI][MI]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int j = 0; j < MI; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool ok = qpos < Sq && kpos < Skv && (!causal || qpos >= kpos);
      p[i][j] = ok ? expf(s[i][j] * scale - lse) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta) * scale;
    }
  }
}

template <int D>
__device__ __forceinline__ void bwd_recompute(
    const float* sQ, const float* sG, const float* sK, const float* sV,
    const float* sLse, const float* sDelta, int q0, int k0, int Sq, int Skv,
    float scale, int causal, float (&p)[micro(D)][micro(D)],
    float (&ds)[micro(D)][micro(D)]) {
  constexpr int MI = micro(D);
  float s[MI][MI], dp[MI][MI];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < MI; ++j) s[i][j] = dp[i][j] = 0.f;
  bwd_scores<MI, D>(sQ, sG, sK, sV, s, dp);
  bwd_finish<MI>(sLse, sDelta, q0, k0, Sq, Skv, scale, causal, s, dp, p, ds);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int R = 16 * micro(D);
  return sizeof(float) * (4 * R * (D + 1) + R * (R + 1) + 2 * R);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int R = 16 * micro(D);
  return sizeof(float) * (4 * R * (D + 1) + 2 * R * (R + 1) + 2 * R);
}

// dq for one q tile: loop kv tiles, causal-trimmed at the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dq_kernel(Args a) {
  constexpr int DP = D + 1, MI = micro(D), R = 16 * MI, PP = R + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [R][DP]
  float* sG = sQ + R * DP;     // [R][DP]
  float* sK = sG + R * DP;     // [R][DP]
  float* sV = sK + R * DP;     // [R][DP]
  float* sDS = sV + R * DP;    // [R][PP]
  float* sLse = sDS + R * PP;  // [R]
  float* sDelta = sLse + R;    // [R]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // B*H on x (no 65,535 limit), q tiles on y; causal: the last q tiles
  // have the longest kv loops, every head's run first
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? (gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * R;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;

  load_tile<T, D, R>(sQ, q, a.qs.s, q0, a.Sq);
  load_tile<T, D, R>(sG, g, a.gs.s, q0, a.Sq);
  load_rows<R>(sLse, a.lse + (long long)bh * a.Sq, q0, a.Sq);
  load_rows<R>(sDelta, a.delta + (long long)bh * a.Sq, q0, a.Sq);

  float acc[MI][DC];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int n_kv = (a.Skv + R - 1) / R;
  if (a.causal) n_kv = min(n_kv, (q0 + 2 * R - 1) / R);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * R;
    __syncthreads();  // the previous step is done with sK, sV and sDS
    load_tile<T, D, R>(sK, k, a.ks.s, k0, a.Skv);
    load_tile<T, D, R>(sV, v, a.vs.s, k0, a.Skv);
    __syncthreads();
    float p[MI][MI], ds[MI][MI];
    bwd_recompute<D>(sQ, sG, sK, sV, sLse, sDelta, q0, k0, a.Sq, a.Skv,
                     a.scale, a.causal, p, ds);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int jj = 0; jj < MI; ++jj)
        sDS[(ty + 16 * i) * PP + tx + 16 * jj] = ds[i][jj];
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < R; ++n) {
      float dsv[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) dsv[i] = sDS[(ty + 16 * i) * PP + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = sK[n * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < MI; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    T* row = static_cast<T*>(a.out0) + b * a.o0s.b + qpos * a.o0s.s +
             h * a.o0s.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(row + tx + 16 * c, acc[i][c]);
  }
}

// dk and dv for one kv tile: loop q tiles, starting at the diagonal when
// causal (q tiles above it see none of this kv tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(Args a) {
  constexpr int DP = D + 1, MI = micro(D), R = 16 * MI, PP = R + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // [R][DP]
  float* sV = sK + R * DP;      // [R][DP]
  float* sQ = sV + R * DP;      // [R][DP]
  float* sG = sQ + R * DP;      // [R][DP]
  float* sP = sG + R * DP;      // [R][PP]
  float* sDS = sP + R * PP;     // [R][PP]
  float* sLse = sDS + R * PP;   // [R]
  float* sDelta = sLse + R;     // [R]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // B*H on x, kv tiles on y; causal: the first kv tiles have the longest
  // q loops and come first
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * R;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* lse = a.lse + (long long)bh * a.Sq;
  const float* delta = a.delta + (long long)bh * a.Sq;

  load_tile<T, D, R>(sK, k, a.ks.s, k0, a.Skv);
  load_tile<T, D, R>(sV, v, a.vs.s, k0, a.Skv);

  float dk[MI][DC], dv[MI][DC];  // rows: kv rows ty + 16*i
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_q = (a.Sq + R - 1) / R;
  // first q tile that reaches this kv tile (the tiles are square)
  const int i0 = a.causal ? k0 / R : 0;

  for (int it = i0; it < n_q; ++it) {
    const int q0 = it * R;
    __syncthreads();  // the previous step is done with sQ, sG, sP, sDS
    load_tile<T, D, R>(sQ, q, a.qs.s, q0, a.Sq);
    load_tile<T, D, R>(sG, g, a.gs.s, q0, a.Sq);
    load_rows<R>(sLse, lse, q0, a.Sq);
    load_rows<R>(sDelta, delta, q0, a.Sq);
    __syncthreads();
    float p[MI][MI], ds[MI][MI];
    bwd_recompute<D>(sQ, sG, sK, sV, sLse, sDelta, q0, k0, a.Sq, a.Skv,
                     a.scale, a.causal, p, ds);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int jj = 0; jj < MI; ++jj) {
        sP[(ty + 16 * i) * PP + tx + 16 * jj] = p[i][jj];
        sDS[(ty + 16 * i) * PP + tx + 16 * jj] = ds[i][jj];
      }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < R; ++n) {  // q rows of this tile
      float pv[MI], dsv[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        pv[i] = sP[n * PP + ty + 16 * i];
        dsv[i] = sDS[n * PP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float gv = sG[n * DP + tx + 16 * c];
        const float qv = sQ[n * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          dv[i][c] = fmaf(pv[i], gv, dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
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

using KernelFn = void (*)(Args);

// The float32 kernels at head_dim D, as launch and attrs take them.
template <typename T, int D>
struct Fma {
  static constexpr int threads = NT;
  static KernelFn kernel(int which) {
    return which == 0 ? &flash_dq_kernel<T, D> : &flash_dkv_kernel<T, D>;
  }
  static size_t smem(int which) {
    return which == 0 ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  }
  static dim3 grid(int which, const Args& a, int B) {
    constexpr int R = 16 * micro(D);
    return dim3(B * a.H, ((which == 0 ? a.Sq : a.Skv) + R - 1) / R);
  }
};

// Above head_dim 256 (float32): one library takes any head_dim D that is a
// multiple of FKC at run time.  D / FKC CTAs share a tile, each owning FKC
// gradient columns (MI = 4: 64-row tiles, an MI x FKC/16 accumulator slice
// a thread).  A step of the loop over the other side's tiles sums s and dp
// over D in FKC-column chunks of all four tiles (bwd_scores), this CTA's own
// chunk last, so that its tiles are still in shared memory for the second
// products; then bwd_finish.  Every column CTA recomputes s and dp over the
// whole of D.
constexpr int FKC = 64;  // head_dim columns a chunk; gradient columns a CTA
constexpr int FR = 64;   // rows of a tile (MI = 4)

constexpr size_t dq_chunked_smem_bytes() {  // 4 chunk tiles, ds, lse, delta
  return sizeof(float) * (4 * FR * (FKC + 1) + FR * (FR + 1) + 2 * FR);
}

constexpr size_t dkv_chunked_smem_bytes() {  // and p
  return sizeof(float) * (4 * FR * (FKC + 1) + 2 * FR * (FR + 1) + 2 * FR);
}

// Chunk c of a step, in the order that leaves this CTA's own chunk last.
__device__ __forceinline__ int chunk_col(int own, int c, int nc, int width) {
  return ((own + 1 + c) % nc) * width;
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_dq_chunked_kernel(Args a) {
  constexpr int MI = FR / 16, R = FR, DP = FKC + 1, PP = R + 1;
  constexpr int DC = FKC / 16;
  extern __shared__ float smem[];
  float* sQ = smem;            // [R][DP] a chunk of each tile
  float* sG = sQ + R * DP;
  float* sK = sG + R * DP;
  float* sV = sK + R * DP;
  float* sDS = sV + R * DP;    // [R][PP]
  float* sLse = sDS + R * PP;  // [R]
  float* sDelta = sLse + R;    // [R]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nc = a.D / FKC;
  const int bh = blockIdx.x / nc, own = blockIdx.x % nc, d0 = own * FKC;
  const int b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? (gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * R;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;

  load_rows<R>(sLse, a.lse + (long long)bh * a.Sq, q0, a.Sq);
  load_rows<R>(sDelta, a.delta + (long long)bh * a.Sq, q0, a.Sq);

  float acc[MI][DC];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int n_kv = (a.Skv + R - 1) / R;
  if (a.causal) n_kv = min(n_kv, (q0 + 2 * R - 1) / R);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * R;
    float s[MI][MI], dp[MI][MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int jj = 0; jj < MI; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int col = chunk_col(own, c, nc, FKC);
      __syncthreads();  // the previous chunk (and step) is done with smem
      load_tile<T, FKC, R>(sQ, q + col, a.qs.s, q0, a.Sq);
      load_tile<T, FKC, R>(sG, g + col, a.gs.s, q0, a.Sq);
      load_tile<T, FKC, R>(sK, k + col, a.ks.s, k0, a.Skv);
      load_tile<T, FKC, R>(sV, v + col, a.vs.s, k0, a.Skv);
      __syncthreads();
      bwd_scores<MI, FKC>(sQ, sG, sK, sV, s, dp);
    }
    float p[MI][MI], ds[MI][MI];
    bwd_finish<MI>(sLse, sDelta, q0, k0, a.Sq, a.Skv, a.scale, a.causal, s,
                   dp, p, ds);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int jj = 0; jj < MI; ++jj)
        sDS[(ty + 16 * i) * PP + tx + 16 * jj] = ds[i][jj];
    __syncthreads();
    // dq += ds k on this CTA's columns: sK holds its chunk
#pragma unroll 4
    for (int n = 0; n < R; ++n) {
      float dsv[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) dsv[i] = sDS[(ty + 16 * i) * PP + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = sK[n * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < MI; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    T* row = static_cast<T*>(a.out0) + b * a.o0s.b + qpos * a.o0s.s +
             h * a.o0s.h + d0;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(row + tx + 16 * c, acc[i][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_dkv_chunked_kernel(Args a) {
  constexpr int MI = FR / 16, R = FR, DP = FKC + 1, PP = R + 1;
  constexpr int DC = FKC / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // [R][DP] a chunk of each tile
  float* sV = sK + R * DP;
  float* sQ = sV + R * DP;
  float* sG = sQ + R * DP;
  float* sP = sG + R * DP;      // [R][PP]
  float* sDS = sP + R * PP;     // [R][PP]
  float* sLse = sDS + R * PP;   // [R]
  float* sDelta = sLse + R;     // [R]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nc = a.D / FKC;
  const int bh = blockIdx.x / nc, own = blockIdx.x % nc, d0 = own * FKC;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * R;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* lse = a.lse + (long long)bh * a.Sq;
  const float* delta = a.delta + (long long)bh * a.Sq;

  float dk[MI][DC], dv[MI][DC];  // rows: kv rows ty + 16*i
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_q = (a.Sq + R - 1) / R;
  const int i0 = a.causal ? k0 / R : 0;

  for (int it = i0; it < n_q; ++it) {
    const int q0 = it * R;
    float s[MI][MI], dp[MI][MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int jj = 0; jj < MI; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int col = chunk_col(own, c, nc, FKC);
      __syncthreads();  // the previous chunk (and step) is done with smem
      load_tile<T, FKC, R>(sK, k + col, a.ks.s, k0, a.Skv);
      load_tile<T, FKC, R>(sV, v + col, a.vs.s, k0, a.Skv);
      load_tile<T, FKC, R>(sQ, q + col, a.qs.s, q0, a.Sq);
      load_tile<T, FKC, R>(sG, g + col, a.gs.s, q0, a.Sq);
      if (c == 0) {
        load_rows<R>(sLse, lse, q0, a.Sq);
        load_rows<R>(sDelta, delta, q0, a.Sq);
      }
      __syncthreads();
      bwd_scores<MI, FKC>(sQ, sG, sK, sV, s, dp);
    }
    float p[MI][MI], ds[MI][MI];
    bwd_finish<MI>(sLse, sDelta, q0, k0, a.Sq, a.Skv, a.scale, a.causal, s,
                   dp, p, ds);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int jj = 0; jj < MI; ++jj) {
        sP[(ty + 16 * i) * PP + tx + 16 * jj] = p[i][jj];
        sDS[(ty + 16 * i) * PP + tx + 16 * jj] = ds[i][jj];
      }
    __syncthreads();
    // dv += p^T g, dk += ds^T q on this CTA's columns: sG and sQ hold its
    // chunk
#pragma unroll 4
    for (int n = 0; n < R; ++n) {  // q rows of this tile
      float pv[MI], dsv[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        pv[i] = sP[n * PP + ty + 16 * i];
        dsv[i] = sDS[n * PP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float gv = sG[n * DP + tx + 16 * c];
        const float qv = sQ[n * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          dv[i][c] = fmaf(pv[i], gv, dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= a.Skv) continue;
    T* krow = static_cast<T*>(a.out0) + b * a.o0s.b + kpos * a.o0s.s +
              h * a.o0s.h + d0;
    T* vrow = static_cast<T*>(a.out1) + b * a.o1s.b + kpos * a.o1s.s +
              h * a.o1s.h + d0;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(krow + tx + 16 * c, dk[i][c]);
      store(vrow + tx + 16 * c, dv[i][c]);
    }
  }
}

// The float32 chunked kernels, as launch and attrs take them.
template <typename T>
struct FmaChunked {
  static constexpr int threads = NT;
  static KernelFn kernel(int which) {
    return which == 0 ? &flash_dq_chunked_kernel<T>
                      : &flash_dkv_chunked_kernel<T>;
  }
  static size_t smem(int which) {
    return which == 0 ? dq_chunked_smem_bytes() : dkv_chunked_smem_bytes();
  }
  static dim3 grid(int which, const Args& a, int B) {
    return dim3(B * a.H * (a.D / FKC),
                ((which == 0 ? a.Sq : a.Skv) + FR - 1) / FR);
  }
};

// ---------------------------------------------------------------------------
// bf16 and fp16 on tensor cores

namespace tc {

using sm90::a_split;
using sm90::cp_async4;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldsm4;
using sm90::ldsm4_t;
using sm90::mma;
using sm90::mma_ds;
using sm90::mma_hilo;
using sm90::store2;

constexpr int TB = 64;         // rows of a tile, own and streamed side alike
constexpr int NW = 4;          // warps per CTA, 16 own rows each
constexpr int NTC = 32 * NW;   // threads per CTA
constexpr int PAD = 8;         // 16-bit padding of a shared-memory row (16 B)
static_assert(NTC == 2 * TB, "cp_rows gives one thread to each lse/delta");

// Gradient columns a CTA owns: all D up to 128; above that D / 64 CTAs
// share a tile, each recomputing p and ds over the whole head_dim (the
// recompute is the same code, so the split cannot desync it) and
// accumulating its own 64 columns.  (128-column shares spilled: the
// kernels already hold 250-255 registers a thread at D = 128.  At 256 the
// dk/dv kernel still spills 32 bytes, which chip_smoke.py reports.)
__host__ __device__ constexpr int out_cols(int D) {
  return D > 128 ? 64 : D;
}

// Rows [row0, row0 + TB) of one head into a [TB][D + PAD] tile.
template <typename T, int D>
__device__ __forceinline__ void cp_tile(T* dst, const T* src,
                                        long long row_stride, int row0,
                                        int len) {
  sm90::cp_tile<T, D, TB, NTC, PAD>(dst, src, row_stride, row0, len);
}

// lse and delta of rows [row0, row0 + TB), zero past `len`: one float a
// thread.
__device__ __forceinline__ void cp_rows(float* s_lse, float* s_delta,
                                        const float* lse, const float* delta,
                                        int row0, int len) {
  const int i = threadIdx.x % TB, s = row0 + i;
  const bool is_lse = threadIdx.x < TB;
  cp_async4((is_lse ? s_lse : s_delta) + i,
            (is_lse ? lse : delta) + min(s, len - 1), s < len);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Skv,
                                        int causal) {
  return qpos < Sq && kpos < Skv && (!causal || qpos >= kpos);
}

// Maps from fragment element e of n-block i (fragment row g + 8*(e>>1),
// column 8*i + 2t + (e&1)) to its q and kv positions, lse and delta.
// dq kernel, S = Q K^T: rows are q rows; lse and delta per row, in
// registers.  q: position of row g; k: position of column 2t.
struct RowsAreQ {
  int q, k;
  float lse_[2], delta_[2];  // rows g and g + 8
  __device__ int qpos(int, int e) const { return q + 8 * (e >> 1); }
  __device__ int kpos(int i, int e) const { return k + 8 * i + (e & 1); }
  __device__ float lse(int, int e) const { return lse_[e >> 1]; }
  __device__ float delta(int, int e) const { return delta_[e >> 1]; }
};

// dk/dv kernel, S^T = K Q^T: rows are kv rows, columns q rows; lse and
// delta per column, read from the stage's shared-memory copy.  k: position
// of row g; q: position of column 2t; l, dl: its lse and delta.
struct RowsAreKv {
  int q, k;
  const float *l, *dl;
  __device__ int qpos(int i, int e) const { return q + 8 * i + (e & 1); }
  __device__ int kpos(int, int e) const { return k + 8 * (e >> 1); }
  __device__ float lse(int i, int e) const { return l[8 * i + (e & 1)]; }
  __device__ float delta(int i, int e) const { return dl[8 * i + (e & 1)]; }
};

// The one recompute both kernels share (counterpart of _bwd_recompute), on
// a warp's fragments of the scores s and of dp: s becomes p, dp becomes ds.
// `masked` is false for tiles wholly below the diagonal and inside both
// sequences, which skip the mask.
template <int NB, class Map>
__device__ __forceinline__ void tc_recompute(float (&s)[NB][4],
                                             float (&dp)[NB][4], const Map& m,
                                             int Sq, int Skv, int causal,
                                             bool masked, float scale) {
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok =
          !masked || visible(m.qpos(i, e), m.kpos(i, e), Sq, Skv, causal);
      const float p = ok ? expf(s[i][e] * scale - m.lse(i, e)) : 0.f;
      dp[i][e] = p * (dp[i][e] - m.delta(i, e)) * scale;
      s[i][e] = p;
    }
}

// Whether the (q tile at q0, kv tile at k0) pair needs the mask: it crosses
// the diagonal (causal) or a sequence's end.
__device__ __forceinline__ bool needs_mask(int q0, int k0, const Args& a) {
  return (a.causal && k0 + TB - 1 > q0) || q0 + TB > a.Sq || k0 + TB > a.Skv;
}

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, g; K and V in 2 stages
  return 2 * 6 * TB * (D + PAD);
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V; Q, g, lse, delta in 2 stages
  return 2 * 6 * TB * (D + PAD) + sizeof(float) * 4 * TB;
}

// dq for one 64-row q tile (its columns [d0, d0 + out_cols(D))): loop kv
// tiles, causal-trimmed at the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(NTC, 2) flash_dq_tc_kernel(Args a) {
  constexpr int DP = D + PAD, NB = TB / 8;
  constexpr int DO = out_cols(D), SPLIT = D / DO, OB = DO / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* sQ = reinterpret_cast<T*>(tc_smem);  // [TB][DP]
  T* sG = sQ + TB * DP;                   // [TB][DP]
  T* sK = sG + TB * DP;                   // [2][TB][DP]
  T* sV = sK + 2 * TB * DP;               // [2][TB][DP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp;  // this warp's rows of the q tile
  // B*H and a head's column shares on x (no 65,535 limit), q tiles on y;
  // causal: the last q tiles have the longest kv loops, every head's first
  const int bh = blockIdx.x / SPLIT, d0 = (blockIdx.x % SPLIT) * DO;
  const int b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? (gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * TB;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;

  int n_kv = (a.Skv + TB - 1) / TB;
  if (a.causal) n_kv = min(n_kv, (q0 + 2 * TB - 1) / TB);

  cp_tile<T, D>(sQ, q, a.qs.s, q0, a.Sq);
  cp_tile<T, D>(sG, g, a.gs.s, q0, a.Sq);
  cp_tile<T, D>(sK, k, a.ks.s, 0, a.Skv);
  cp_tile<T, D>(sV, v, a.vs.s, 0, a.Skv);
  cp_async_commit();

  RowsAreQ m;
  m.q = q0 + r0 + lane / 4;
  const float* lse = a.lse + (long long)bh * a.Sq;
  const float* delta = a.delta + (long long)bh * a.Sq;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = m.q + 8 * e;
    m.lse_[e] = row < a.Sq ? lse[row] : 0.f;
    m.delta_[e] = row < a.Sq ? delta[row] : 0.f;
  }

  float acc[OB][4];
#pragma unroll
  for (int i = 0; i < OB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // ldmatrix row addresses: A operands (rows of this warp) and B operands
  // without (k_off) and with (t_off) transpose, before the tile offsets
  const int a_off = (r0 + lane % 16) * DP + (lane / 16) * 8;
  const int b_off = (lane % 8 + (lane / 16) * 8) * DP + ((lane / 8) % 2) * 8;
  const int t_off = (lane % 16) * DP + (lane / 16) * 8 + d0;

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {  // the next K/V tile loads while this one computes
      cp_tile<T, D>(sK + (st ^ 1) * TB * DP, k, a.ks.s, (j + 1) * TB, a.Skv);
      cp_tile<T, D>(sV + (st ^ 1) * TB * DP, v, a.vs.s, (j + 1) * TB, a.Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tK = sK + st * TB * DP;
    const T* tV = sV + st * TB * DP;
    const int k0 = j * TB;

    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    // every k-step unrolled up to D = 128; above, none (16 unrolled
    // k-steps spilled more)
#pragma unroll(D > 128 ? 1 : 8)
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned qa[4], ga[4];
      ldsm4(qa, sQ + a_off + 16 * kk);
      ldsm4(ga, sG + a_off + 16 * kk);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        unsigned kb[4], vb[4];
        ldsm4(kb, tK + b_off + 16 * n2 * DP + 16 * kk);
        ldsm4(vb, tV + b_off + 16 * n2 * DP + 16 * kk);
        mma<T>(s[2 * n2], qa, kb[0], kb[1]);
        mma<T>(s[2 * n2 + 1], qa, kb[2], kb[3]);
        mma<T>(dp[2 * n2], ga, vb[0], vb[1]);
        mma<T>(dp[2 * n2 + 1], ga, vb[2], vb[3]);
      }
    }
    m.k = k0 + 2 * (lane % 4);
    tc_recompute<NB>(s, dp, m, a.Sq, a.Skv, a.causal, needs_mask(q0, k0, a),
                     a.scale);
    // dq += ds K, ds as a bf16 hi/lo pair
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      unsigned hi[4], lo[4];
      a_split<sm90::bf16, NB>(dp, kk, hi, lo);
#pragma unroll
      for (int d2 = 0; d2 < OB / 2; ++d2) {
        unsigned kb[4];
        ldsm4_t(kb, tK + t_off + 16 * kk * DP + 16 * d2);
        mma_ds<T>(acc[2 * d2], acc[2 * d2 + 1], hi, lo, kb);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = m.q + 8 * e;
    if (qpos >= a.Sq) continue;
    T* row = static_cast<T*>(a.out0) + b * a.o0s.b + qpos * a.o0s.s +
             h * a.o0s.h + d0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < OB; ++i)
      store2<T>(row + 8 * i, acc[i][2 * e], acc[i][2 * e + 1]);
  }
}

// dk and dv for one 64-row kv tile (their columns [d0, d0 + out_cols(D))):
// loop q tiles, starting at the diagonal when causal.  Each q tile is
// taken in column chunks of NC q rows, which bounds the score fragments'
// registers beside the dk and dv accumulators.
template <typename T, int D, int NC>
__global__ void __launch_bounds__(NTC, 2) flash_dkv_tc_kernel(Args a) {
  constexpr int DP = D + PAD, NB = NC / 8;
  constexpr int DO = out_cols(D), SPLIT = D / DO, OB = DO / 8;
  static_assert(TB % NC == 0 && NC % 16 == 0, "chunks of whole k-steps");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* sK = reinterpret_cast<T*>(tc_smem);  // [TB][DP]
  T* sV = sK + TB * DP;                   // [TB][DP]
  T* sQ = sV + TB * DP;                   // [2][TB][DP]
  T* sG = sQ + 2 * TB * DP;               // [2][TB][DP]
  float* sL = reinterpret_cast<float*>(sG + 2 * TB * DP);  // [2][TB]
  float* sDl = sL + 2 * TB;                                // [2][TB]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp;  // this warp's rows of the kv tile
  // B*H and a head's column shares on x, kv tiles on y; causal: the first
  // kv tiles have the longest q loops, every head's first
  const int bh = blockIdx.x / SPLIT, d0 = (blockIdx.x % SPLIT) * DO;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * TB;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* lse = a.lse + (long long)bh * a.Sq;
  const float* delta = a.delta + (long long)bh * a.Sq;

  const int n_q = (a.Sq + TB - 1) / TB;
  const int i0 = a.causal ? k0 / TB : 0;  // first q tile reaching this one

  cp_tile<T, D>(sK, k, a.ks.s, k0, a.Skv);
  cp_tile<T, D>(sV, v, a.vs.s, k0, a.Skv);
  if (i0 < n_q) {
    cp_tile<T, D>(sQ, q, a.qs.s, i0 * TB, a.Sq);
    cp_tile<T, D>(sG, g, a.gs.s, i0 * TB, a.Sq);
    cp_rows(sL, sDl, lse, delta, i0 * TB, a.Sq);
  }
  cp_async_commit();

  float dk[OB][4], dv[OB][4];
#pragma unroll
  for (int i = 0; i < OB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  RowsAreKv m;
  m.k = k0 + r0 + lane / 4;
  const int a_off = (r0 + lane % 16) * DP + (lane / 16) * 8;
  const int b_off = (lane % 8 + (lane / 16) * 8) * DP + ((lane / 8) % 2) * 8;
  const int t_off = (lane % 16) * DP + (lane / 16) * 8 + d0;

  for (int it = i0; it < n_q; ++it) {
    const int st = (it - i0) & 1;
    if (it + 1 < n_q) {  // the next q tile loads while this one computes
      const int nq0 = (it + 1) * TB;
      cp_tile<T, D>(sQ + (st ^ 1) * TB * DP, q, a.qs.s, nq0, a.Sq);
      cp_tile<T, D>(sG + (st ^ 1) * TB * DP, g, a.gs.s, nq0, a.Sq);
      cp_rows(sL + (st ^ 1) * TB, sDl + (st ^ 1) * TB, lse, delta, nq0, a.Sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tQ = sQ + st * TB * DP;
    const T* tG = sG + st * TB * DP;
    const int q0 = it * TB;
    const bool masked = needs_mask(q0, k0, a);

    // the chunk loop stays rolled: unrolled, ptxas spills at head_dim 128
#pragma unroll 1
    for (int c = 0; c < TB / NC; ++c) {
      float s[NB][4], dp[NB][4];  // S^T and dP^T: kv rows x NC q columns
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll(D > 128 ? 1 : 8)  // as in the dq kernel
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned ka[4], va[4];
        ldsm4(ka, sK + a_off + 16 * kk);
        ldsm4(va, sV + a_off + 16 * kk);
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          unsigned qb[4], gb[4];
          const int off = b_off + (c * NC + 16 * n2) * DP + 16 * kk;
          ldsm4(qb, tQ + off);
          ldsm4(gb, tG + off);
          mma<T>(s[2 * n2], ka, qb[0], qb[1]);
          mma<T>(s[2 * n2 + 1], ka, qb[2], qb[3]);
          mma<T>(dp[2 * n2], va, gb[0], gb[1]);
          mma<T>(dp[2 * n2 + 1], va, gb[2], gb[3]);
        }
      }
      const int col = c * NC + 2 * (lane % 4);
      m.q = q0 + col;
      m.l = sL + st * TB + col;
      m.dl = sDl + st * TB + col;
      tc_recompute<NB>(s, dp, m, a.Sq, a.Skv, a.causal, masked, a.scale);
      // dv += p^T g (p a T hi/lo pair) and dk += ds^T q (ds a bf16 pair)
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        unsigned phi[4], plo[4], dhi[4], dlo[4];
        a_split<T, NB>(s, kk, phi, plo);
        a_split<sm90::bf16, NB>(dp, kk, dhi, dlo);
#pragma unroll
        for (int d2 = 0; d2 < OB / 2; ++d2) {
          unsigned gb[4], qb[4];
          const int off = t_off + (c * NC + 16 * kk) * DP + 16 * d2;
          ldsm4_t(gb, tG + off);
          ldsm4_t(qb, tQ + off);
          mma_hilo<T>(dv[2 * d2], dv[2 * d2 + 1], phi, plo, gb);
          mma_ds<T>(dk[2 * d2], dk[2 * d2 + 1], dhi, dlo, qb);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();  // K/V still in flight when no q tile reaches them

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kpos = m.k + 8 * e;
    if (kpos >= a.Skv) continue;
    const int c0 = d0 + 2 * (lane % 4);
    T* krow = static_cast<T*>(a.out0) + b * a.o0s.b + kpos * a.o0s.s +
              h * a.o0s.h + c0;
    T* vrow = static_cast<T*>(a.out1) + b * a.o1s.b + kpos * a.o1s.s +
              h * a.o1s.h + c0;
#pragma unroll
    for (int i = 0; i < OB; ++i) {
      store2<T>(krow + 8 * i, dk[i][2 * e], dk[i][2 * e + 1]);
      store2<T>(vrow + 8 * i, dv[i][2 * e], dv[i][2 * e + 1]);
    }
  }
}

// q columns a step of the dk/dv kernel takes at once: above 64 gradient
// columns the dk and dv accumulators hold DO registers a thread, so the
// score fragments shrink to 32 columns, and to 16 where ds's products
// widen fp16 operands (fp16 at 128 spilled at 32); 16 too above D = 128,
// where the first products span the whole head_dim
template <typename T>
constexpr int dkv_chunk(int D) {
  if (D > 128) return 16;
  if (out_cols(D) <= 64) return 64;
  return std::is_same_v<T, sm90::f16> ? 16 : 32;
}

// The tensor-core kernels at head_dim D in T, as launch and attrs take
// them.
template <typename T, int D>
struct Tc {
  static constexpr int threads = NTC;
  static KernelFn kernel(int which) {
    return which == 0 ? &flash_dq_tc_kernel<T, D>
                      : &flash_dkv_tc_kernel<T, D, dkv_chunk<T>(D)>;
  }
  static size_t smem(int which) {
    return which == 0 ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  }
  static dim3 grid(int which, const Args& a, int B) {
    const int tiles = ((which == 0 ? a.Sq : a.Skv) + TB - 1) / TB;
    return dim3(B * a.H * (D / out_cols(D)), tiles);
  }
};

// Above head_dim 256: one library a dtype takes any head_dim D that is a
// multiple of KCB at run time.  D / KCB CTAs share a tile, each owning KCB
// gradient columns, as out_cols does at 256.  A step is one (other-side
// tile, chunk) pair: the KCB-column chunks of all four tiles (the CTA's
// own rows and the streamed tile's) land through a BSTAGES-stage cp.async
// ring, and S and dP (S^T and dP^T in the dk/dv kernel) are summed over the
// chunks in the warp's accumulators.  The CTA's own chunk comes last, so
// the tiles its second products read (K for dq; Q and g for dk and dv) are
// that step's.  p and ds come from the one tc_recompute, as above.  Every
// column CTA recomputes S and dP over the whole of D: at D = 512 the first
// products run D / KCB = 8 times the bound's one pass.
constexpr int KCB = 64;      // head_dim columns a chunk; gradient columns a CTA
constexpr int BSTAGES = 2;   // chunk ring stages

constexpr size_t dq_chunked_smem_bytes() {  // four chunk tiles a stage
  return 2 * BSTAGES * 4 * TB * (KCB + PAD);
}

constexpr size_t dkv_chunked_smem_bytes() {  // and lse, delta of two q tiles
  return dq_chunked_smem_bytes() + sizeof(float) * 4 * TB;
}

// dq for one 64-row q tile, its columns [d0, d0 + KCB).
template <typename T>
__global__ void __launch_bounds__(NTC, 2) flash_dq_chunked_tc_kernel(Args a) {
  constexpr int CP = KCB + PAD, NB = TB / 8, OB = KCB / 8;
  constexpr int TS = TB * CP, STAGE = 4 * TS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* sRing = reinterpret_cast<T*>(tc_smem);  // [BSTAGES][Q, g, K, V chunks]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp;  // this warp's rows of the q tile
  const int nc = a.D / KCB;
  const int bh = blockIdx.x / nc, own = blockIdx.x % nc, d0 = own * KCB;
  const int b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? (gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * TB;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;

  int n_kv = (a.Skv + TB - 1) / TB;
  if (a.causal) n_kv = min(n_kv, (q0 + 2 * TB - 1) / TB);
  const int n_steps = n_kv * nc;

  // one commit group a step (empty past the last)
  auto issue = [&](int t) {
    if (t < n_steps) {
      const int k0 = (t / nc) * TB, col = chunk_col(own, t % nc, nc, KCB);
      T* st = sRing + (t % BSTAGES) * STAGE;
      cp_tile<T, KCB>(st, q + col, a.qs.s, q0, a.Sq);
      cp_tile<T, KCB>(st + TS, g + col, a.gs.s, q0, a.Sq);
      cp_tile<T, KCB>(st + 2 * TS, k + col, a.ks.s, k0, a.Skv);
      cp_tile<T, KCB>(st + 3 * TS, v + col, a.vs.s, k0, a.Skv);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < BSTAGES - 1; ++t) issue(t);

  RowsAreQ m;
  m.q = q0 + r0 + lane / 4;
  const float* lse = a.lse + (long long)bh * a.Sq;
  const float* delta = a.delta + (long long)bh * a.Sq;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = m.q + 8 * e;
    m.lse_[e] = row < a.Sq ? lse[row] : 0.f;
    m.delta_[e] = row < a.Sq ? delta[row] : 0.f;
  }

  float acc[OB][4];
#pragma unroll
  for (int i = 0; i < OB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int a_off = (r0 + lane % 16) * CP + (lane / 16) * 8;
  const int b_off = (lane % 8 + (lane / 16) * 8) * CP + ((lane / 8) % 2) * 8;
  const int t_off = (lane % 16) * CP + (lane / 16) * 8;
  float s[NB][4], dp[NB][4];

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<BSTAGES - 2>();  // step t has landed
    // one barrier a step: step t is visible to every warp, and every warp
    // is done with step t - 1, whose stage the next copy refills
    __syncthreads();
    issue(t + BSTAGES - 1);
    const int c = t % nc;
    const T* tQ = sRing + (t % BSTAGES) * STAGE;
    const T* tG = tQ + TS;
    const T* tK = tQ + 2 * TS;
    const T* tV = tQ + 3 * TS;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KCB / 16; ++kk) {
      unsigned qa[4], ga[4];
      ldsm4(qa, tQ + a_off + 16 * kk);
      ldsm4(ga, tG + a_off + 16 * kk);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        unsigned kb[4], vb[4];
        ldsm4(kb, tK + b_off + 16 * n2 * CP + 16 * kk);
        ldsm4(vb, tV + b_off + 16 * n2 * CP + 16 * kk);
        mma<T>(s[2 * n2], qa, kb[0], kb[1]);
        mma<T>(s[2 * n2 + 1], qa, kb[2], kb[3]);
        mma<T>(dp[2 * n2], ga, vb[0], vb[1]);
        mma<T>(dp[2 * n2 + 1], ga, vb[2], vb[3]);
      }
    }
    if (c < nc - 1) continue;  // S and dP are summed over every chunk first
    const int k0 = (t / nc) * TB;
    m.k = k0 + 2 * (lane % 4);
    tc_recompute<NB>(s, dp, m, a.Sq, a.Skv, a.causal, needs_mask(q0, k0, a),
                     a.scale);
    // dq += ds K, ds as a bf16 hi/lo pair, K's own columns this step's
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      unsigned hi[4], lo[4];
      a_split<sm90::bf16, NB>(dp, kk, hi, lo);
#pragma unroll
      for (int d2 = 0; d2 < OB / 2; ++d2) {
        unsigned kb[4];
        ldsm4_t(kb, tK + t_off + 16 * kk * CP + 16 * d2);
        mma_ds<T>(acc[2 * d2], acc[2 * d2 + 1], hi, lo, kb);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = m.q + 8 * e;
    if (qpos >= a.Sq) continue;
    T* row = static_cast<T*>(a.out0) + b * a.o0s.b + qpos * a.o0s.s +
             h * a.o0s.h + d0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < OB; ++i)
      store2<T>(row + 8 * i, acc[i][2 * e], acc[i][2 * e + 1]);
  }
}

// dk and dv for one 64-row kv tile, their columns [d0, d0 + KCB): loop q
// tiles from the diagonal when causal, each a step a chunk.
template <typename T>
__global__ void __launch_bounds__(NTC, 2) flash_dkv_chunked_tc_kernel(Args a) {
  constexpr int CP = KCB + PAD, NB = TB / 8, OB = KCB / 8;
  constexpr int TS = TB * CP, STAGE = 4 * TS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* sRing = reinterpret_cast<T*>(tc_smem);  // [BSTAGES][K, V, Q, g chunks]
  float* sL = reinterpret_cast<float*>(sRing + BSTAGES * STAGE);  // [2][TB]
  float* sDl = sL + 2 * TB;                                        // [2][TB]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp;  // this warp's rows of the kv tile
  const int nc = a.D / KCB;
  const int bh = blockIdx.x / nc, own = blockIdx.x % nc, d0 = own * KCB;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * TB;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* lse = a.lse + (long long)bh * a.Sq;
  const float* delta = a.delta + (long long)bh * a.Sq;

  const int n_q = (a.Sq + TB - 1) / TB;
  const int i0 = a.causal ? k0 / TB : 0;  // first q tile reaching this one
  const int n_steps = max(n_q - i0, 0) * nc;

  // one commit group a step (empty past the last); a q tile's first step
  // also brings its lse and delta, double-buffered by the tile's parity
  auto issue = [&](int t) {
    if (t < n_steps) {
      const int it = i0 + t / nc, col = chunk_col(own, t % nc, nc, KCB);
      T* st = sRing + (t % BSTAGES) * STAGE;
      cp_tile<T, KCB>(st, k + col, a.ks.s, k0, a.Skv);
      cp_tile<T, KCB>(st + TS, v + col, a.vs.s, k0, a.Skv);
      cp_tile<T, KCB>(st + 2 * TS, q + col, a.qs.s, it * TB, a.Sq);
      cp_tile<T, KCB>(st + 3 * TS, g + col, a.gs.s, it * TB, a.Sq);
      if (t % nc == 0)
        cp_rows(sL + (it & 1) * TB, sDl + (it & 1) * TB, lse, delta, it * TB,
                a.Sq);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < BSTAGES - 1; ++t) issue(t);

  float dk[OB][4], dv[OB][4];
#pragma unroll
  for (int i = 0; i < OB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  RowsAreKv m;
  m.k = k0 + r0 + lane / 4;
  const int a_off = (r0 + lane % 16) * CP + (lane / 16) * 8;
  const int b_off = (lane % 8 + (lane / 16) * 8) * CP + ((lane / 8) % 2) * 8;
  const int t_off = (lane % 16) * CP + (lane / 16) * 8;
  float s[NB][4], dp[NB][4];  // S^T and dP^T: kv rows x the q tile's rows

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<BSTAGES - 2>();  // step t has landed
    // one barrier a step: step t is visible to every warp, every warp is
    // done with step t - 1, whose stage the next copy refills (an lse
    // buffer is refilled two q tiles later: nc >= 1 steps after its use)
    __syncthreads();
    issue(t + BSTAGES - 1);
    const int c = t % nc;
    const T* tK = sRing + (t % BSTAGES) * STAGE;
    const T* tV = tK + TS;
    const T* tQ = tK + 2 * TS;
    const T* tG = tK + 3 * TS;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KCB / 16; ++kk) {
      unsigned ka[4], va[4];
      ldsm4(ka, tK + a_off + 16 * kk);
      ldsm4(va, tV + a_off + 16 * kk);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        unsigned qb[4], gb[4];
        const int off = b_off + 16 * n2 * CP + 16 * kk;
        ldsm4(qb, tQ + off);
        ldsm4(gb, tG + off);
        mma<T>(s[2 * n2], ka, qb[0], qb[1]);
        mma<T>(s[2 * n2 + 1], ka, qb[2], qb[3]);
        mma<T>(dp[2 * n2], va, gb[0], gb[1]);
        mma<T>(dp[2 * n2 + 1], va, gb[2], gb[3]);
      }
    }
    if (c < nc - 1) continue;  // S^T and dP^T are summed over every chunk
    const int it = i0 + t / nc, q0 = it * TB;
    const int col = 2 * (lane % 4);
    m.q = q0 + col;
    m.l = sL + (it & 1) * TB + col;
    m.dl = sDl + (it & 1) * TB + col;
    tc_recompute<NB>(s, dp, m, a.Sq, a.Skv, a.causal, needs_mask(q0, k0, a),
                     a.scale);
    // dv += p^T g (p a T hi/lo pair) and dk += ds^T q (ds a bf16 pair), g
    // and q's own columns this step's
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      unsigned phi[4], plo[4], dhi[4], dlo[4];
      a_split<T, NB>(s, kk, phi, plo);
      a_split<sm90::bf16, NB>(dp, kk, dhi, dlo);
#pragma unroll
      for (int d2 = 0; d2 < OB / 2; ++d2) {
        unsigned gb[4], qb[4];
        const int off = t_off + 16 * kk * CP + 16 * d2;
        ldsm4_t(gb, tG + off);
        ldsm4_t(qb, tQ + off);
        mma_hilo<T>(dv[2 * d2], dv[2 * d2 + 1], phi, plo, gb);
        mma_ds<T>(dk[2 * d2], dk[2 * d2 + 1], dhi, dlo, qb);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kpos = m.k + 8 * e;
    if (kpos >= a.Skv) continue;
    const int c0 = d0 + 2 * (lane % 4);
    T* krow = static_cast<T*>(a.out0) + b * a.o0s.b + kpos * a.o0s.s +
              h * a.o0s.h + c0;
    T* vrow = static_cast<T*>(a.out1) + b * a.o1s.b + kpos * a.o1s.s +
              h * a.o1s.h + c0;
#pragma unroll
    for (int i = 0; i < OB; ++i) {
      store2<T>(krow + 8 * i, dk[i][2 * e], dk[i][2 * e + 1]);
      store2<T>(vrow + 8 * i, dv[i][2 * e], dv[i][2 * e + 1]);
    }
  }
}

// The tensor-core chunked kernels in T, as launch and attrs take them.
template <typename T>
struct TcChunked {
  static constexpr int threads = NTC;
  static KernelFn kernel(int which) {
    return which == 0 ? &flash_dq_chunked_tc_kernel<T>
                      : &flash_dkv_chunked_tc_kernel<T>;
  }
  static size_t smem(int which) {
    return which == 0 ? dq_chunked_smem_bytes() : dkv_chunked_smem_bytes();
  }
  static dim3 grid(int which, const Args& a, int B) {
    const int tiles = ((which == 0 ? a.Sq : a.Skv) + TB - 1) / TB;
    return dim3(B * a.H * (a.D / KCB), tiles);
  }
};

}  // namespace tc

template <class K>
int launch(int which, const Args& a, int B, cudaStream_t stream) {
  const size_t smem = K::smem(which);
  const KernelFn kernel = K::kernel(which);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<K::grid(which, a, B), K::threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// What the card made of kernel `which` (0 dq, 1 dk/dv): out[0] registers
// a thread, out[1] dynamic shared memory bytes, out[2] local (spill) bytes
// a thread, out[3] CTAs an SM can hold.
template <class K>
int attrs(int which, int* out) {
  const KernelFn kernel = K::kernel(which);
  const size_t smem = K::smem(which);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                      K::threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)smem;
  out[2] = (int)fa.localSizeBytes;
  out[3] = ctas;
  return 0;
}

// This library's one instantiation, set by the build (ops/_build.py):
// TFOS_HEAD_DIM, a multiple of 16 up to 256, or 0 for the chunked kernels
// (any head_dim above 256 that is a multiple of kChunk, at run time), and
// TFOS_DTYPE 0 = float32 (the FMA kernels), 1 = bfloat16 or 2 = float16
// (the tensor-core kernels).
#if !defined(TFOS_HEAD_DIM) || !defined(TFOS_DTYPE)
#error "build with -DTFOS_HEAD_DIM=<d> -DTFOS_DTYPE=<0|1|2> (ops/_build.py)"
#endif
static_assert(TFOS_HEAD_DIM % 16 == 0 && TFOS_HEAD_DIM <= 256,
              "head_dim a multiple of 16, at most 256; 0: chunked");
constexpr int kChunk = 128;  // the chunked kernels' head_dim granule
static_assert(kChunk % FKC == 0 && kChunk % tc::KCB == 0,
              "a chunked head_dim splits into whole chunks");
#if TFOS_HEAD_DIM == 0
constexpr bool takes(int d) { return d > 256 && d % kChunk == 0; }
#else
constexpr bool takes(int d) { return d == TFOS_HEAD_DIM; }
#endif
#if TFOS_DTYPE == 0 && TFOS_HEAD_DIM == 0
using Kernels = FmaChunked<float>;
#elif TFOS_DTYPE == 0
using Kernels = Fma<float, TFOS_HEAD_DIM>;
#elif TFOS_DTYPE == 1 && TFOS_HEAD_DIM == 0
using Kernels = tc::TcChunked<sm90::bf16>;
#elif TFOS_DTYPE == 1
using Kernels = tc::Tc<sm90::bf16, TFOS_HEAD_DIM>;
#elif TFOS_DTYPE == 2 && TFOS_HEAD_DIM == 0
using Kernels = tc::TcChunked<sm90::f16>;
#elif TFOS_DTYPE == 2
using Kernels = tc::Tc<sm90::f16, TFOS_HEAD_DIM>;
#else
#error "TFOS_DTYPE is 0, 1 or 2"
#endif

int dispatch(int which, int dtype, int head_dim, const void* q, const void* k,
             const void* v, const void* g, const float* lse,
             const float* delta, void* out0, void* out1, int B, int H, int Sq,
             int Skv, const long long* st, float scale, int causal,
             void* stream) {
  if (dtype != TFOS_DTYPE || !takes(head_dim)) return -1;
  const Args a{q,     k,     v,     g,     lse,
               delta, out0,  out1,  H,     Sq,
               Skv,   {st[0], st[1], st[2]},  {st[3], st[4], st[5]},
               {st[6], st[7], st[8]},         {st[9], st[10], st[11]},
               {st[12], st[13], st[14]},      {st[15], st[16], st[17]},
               scale, causal, head_dim};
  return launch<Kernels>(which, a, B, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q, k, v, g are
// [B, S, H, D] with unit stride on D; lse and delta are f32 [B, H, Sq],
// contiguous.  `strides` holds 6 x (batch, seq, head) element strides for
// q, k, v, g, out0, out1.  tfos_flash_dq writes dq to out0 (out1 unused);
// tfos_flash_dkv writes dk to out0 and dv to out1.  Returns a cudaError_t
// (0 on success); -1 for a dtype or head_dim other than this library's
// (the chunked library takes every multiple of 128 above 256).
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

// Kernel `which` (0 dq, 1 dk/dv) of this library as the card holds it:
// out[0] registers a thread, out[1] dynamic shared memory bytes, out[2]
// local (spill) bytes a thread, out[3] CTAs an SM.  Returns a cudaError_t.
int tfos_flash_bwd_attrs(int which, int* out) {
  return attrs<Kernels>(which, out);
}

const char* tfos_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
