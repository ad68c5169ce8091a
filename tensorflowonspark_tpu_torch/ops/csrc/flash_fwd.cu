// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel tensorflowonspark_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_forward).  Same contract: softmax(q k^T * scale + mask) v
// with the online-softmax recurrence (running max m, running sum l, rescaled
// f32 accumulator), tail and causal masks on global positions filled with
// the finite -1e30, the causal kv loop trimmed at the diagonal,
// out = acc / max(l, 1e-30) rounded once to the input type, and the per-row
// f32 lse = m + log(max(l, 1e-30)) that the backward consumes.  q, k, v and
// out are addressed through (batch, seq, head) strides with unit stride on
// head_dim, so the wrapper passes views of a fused qkv projection as they
// are.  With causal masking the CTAs nearest the end of the sequence (the
// longest kv loops) are scheduled first, and batch*head sits on the grid's
// x, which has no 65,535 limit.  Two implementations behind one interface,
// each library built for one head_dim (a multiple of 16 up to 256) and one
// dtype (ops/_build.py passes TFOS_HEAD_DIM and TFOS_DTYPE); above 256 one
// library a dtype (TFOS_HEAD_DIM=0) holds the chunked kernels, which take
// any multiple of 128 at run time and sum the scores over head_dim in
// chunks (flash_fwd_chunked_tc_kernel, flash_fwd_chunked_kernel):
//
// bf16 and fp16: tensor cores (namespace tc, flash_fwd_tc_kernel<T, D>).
//   What bounds it on the H100.  The function needs two products of 2*D
//   flops per visible (q, kv) pair, 4*D flops, for ~4*D bytes of q/k/v/out
//   traffic per row: at the training shape (8, 2048, 8, 128) causal that is
//   134.3 M visible pairs, 68.7 GFLOP against the H100 SXM data sheet's
//   989 TFLOP/s dense bf16 peak at its 700 W limit (0.069 ms) and 33.6 MB
//   against its 3.35 TB/s (0.010 ms), so the bound is operations.
//   What the design does about it.  Both products are warp-level mma.sync
//   m16n8k16 (bf16 operands, f32 accumulators; bf16 x bf16 products are
//   exact in f32).  A CTA of 8 warps owns 128 q rows, 16 a warp; each warp
//   loads its Q A-operand fragments into registers once (ldmatrix) and
//   keeps them for the whole kv loop, while 64-row K and V tiles stream
//   through a 3-stage cp.async ring (16-byte copies, rows padded by 16 B so
//   that ldmatrix is free of bank conflicts): two tiles land while one
//   computes, and one barrier a tile both publishes the landed tile and
//   frees the stage the next copy refills, so warps drift apart within a
//   tile instead of taking their products and their softmax in lockstep.
//   S = Q K^T stays in the warp's f32 accumulators and is scaled there (q
//   is not pre-scaled into bf16: 1/sqrt(128) is no power of two, and the
//   plain version scales after the product); the running max is kept in
//   log2 units, so each p = 2^(s * scale * log2 e - m) is one FFMA and one
//   ex2.  Row max and rescale alpha are reduced over the four lanes that
//   share a row (shuffles) and applied to the accumulator once a tile.  The
//   m16n8 C fragment of two neighbouring n8 blocks of S is the m16k16 A
//   fragment of one k-step of P V, so P goes from the accumulators into the
//   second product without touching shared memory, with V the B operand
//   (ldmatrix .trans).  P enters as a bf16 hi/lo pair (two MMAs into one f32
//   accumulator, ~16 significant bits): rounding it once to bf16 would miss
//   the per-element check against the f32 plain version by ~40x.  That costs
//   a third product-unit: the kernel spends 3 of 2*D flops a pair, against
//   the bound's 2.  In fp16 the pair is fp16 (p is at most 1; mma_sm90.cuh
//   says what its subnormals cost), with fp16 MMAs throughout.  l is
//   summed from the f32 p, so lse keeps f32 accuracy.
//   The mask is applied only on tiles that cross the diagonal or a sequence
//   end; K/V rows past Skv and q rows past Sq are zero-filled; a warp whose
//   16 rows all lie above a causal tile skips it.  Fully masked rows keep
//   l == 0 and write 0.  At head_dim 128: 139,264 bytes of shared memory
//   and 230 registers a thread (ptxas), so one CTA of 8 warps an SM; the
//   grid puts q tiles on y, so that causal CTAs start longest first across
//   every head, not only within one.  Above head_dim 128 two CTAs share a
//   q tile, each recomputing S and the softmax for its own 128 columns of O,
//   with Q's fragments reloaded from shared memory each k-step and a
//   2-stage ring (three stages would need 270,336 bytes at 256): the
//   registers of O and Q stay what they are at 128.
//   wgmma with TMA and warp specialisation is the next step.
//
// float32: f32 FMAs (the first version, kept for float32, where TF32 would
// lose the float32 checks).  One CTA owns one (batch*head, 64-row q tile),
// keeps the scaled q tile in shared memory, and streams 64-row K/V tiles
// through shared memory.  Each of the 256 threads owns a 4x4 score
// micro-tile and a 4 x (D/16) slice of the accumulator in registers, so S
// never reaches device memory; row statistics reduce across the 16 lanes of
// a half-warp with shuffles.

#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BM = 64;    // q rows per CTA
constexpr int BN = 64;    // kv rows per loop step
constexpr int NT = 256;   // threads per CTA: 16 x 16
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1));
}

// The float32 kernels' shared steps, on a thread's 4 q rows (ty + 16*i)
// and its 4 kv columns (tx + 16*j) of a 64 x 64 score tile.
//
// One kv tile's online softmax: mask at global positions, the running max
// m and sum l (reduced over the half-warp that shares the rows), p into
// sP (pitch BN + 1), the accumulator rescaled.
template <int DC>
__device__ __forceinline__ void softmax_rows(float (&sc)[4][4], float (&m)[4],
                                            float (&l)[4], float (&acc)[4][DC],
                                            float* sP, int q0, int k0, int Sq,
                                            int Skv, int causal) {
  constexpr int PP = BN + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
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
}

// acc += P V over the tile: this thread's columns tx + 16*c of sV (row
// pitch VP).
template <int VP, int DC>
__device__ __forceinline__ void pv_rows(float (&acc)[4][DC], const float* sP,
                                       const float* sV) {
  constexpr int PP = BN + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int n = 0; n < BN; ++n) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PP + n];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float vv = sV[n * VP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
    }
  }
}

// The end: O / max(l, 1e-30) (fully masked rows: l == 0, O 0) to out (this
// CTA's first column, rows at pitch `pitch`), and where `with_lse` the f32
// lse = m + log(...) to lse (this head's row 0).
template <typename T, int DC>
__device__ __forceinline__ void store_rows(const float (&acc)[4][DC],
                                          const float (&m)[4],
                                          const float (&l)[4], T* out,
                                          long long pitch, float* lse,
                                          bool with_lse, int q0, int Sq) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + qpos * pitch;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(orow + tx + 16 * c, acc[i][c] / denom);
    if (with_lse && tx == 0) lse[qpos] = m[i] + logf(denom);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Skv, Strides qs,
                 Strides ks, Strides vs, Strides os, float scale, int causal) {
  constexpr int DP = D + 1;   // padded pitch: conflict-free column reads
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [BM][DP] scaled q tile
  float* sK = sQ + BM * DP;    // [BN][DP]
  float* sV = sK + BN * DP;    // [BN][D]
  float* sP = sV + BN * D;     // [BM][BN + 1] probabilities of this step

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // score columns tx + 16*j, out cols tx + 16*c
  const int ty = tid >> 4;     // rows ty + 16*i
  // B*H on x (no 65,535 limit), q tiles on y: under causal masking every
  // head's last q tile (the longest kv loop) starts first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int qt = causal ? (gridDim.y - 1 - blockIdx.y) : blockIdx.y;
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

    softmax_rows(sc, m, l, acc, sP, q0, k0, Sq, Skv, causal);
    __syncthreads();

    pv_rows<D>(acc, sP, sV);
  }

  store_rows(acc, m, l, out + b * os.b + h * os.h, os.s,
             lse + (long long)bh * Sq, true, q0, Sq);
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
  const dim3 grid(B * H, (Sq + BM - 1) / BM);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, Sq, Skv, qs, ks,
      vs, os, scale, causal);
  return (int)cudaGetLastError();
}

// Above head_dim 256 (float32): one library takes any head_dim D that is a
// multiple of FDO at run time.  D / FDO CTAs share a q tile, each owning
// FDO columns of O (a 4 x FDO/16 accumulator slice a thread, as at 128);
// the scores are summed over D in FKC-column chunks of the q and k tiles,
// so shared memory does not grow with D, and a CTA loads only its own
// columns of each V tile.  Every column CTA recomputes the scores over the
// whole of D.
constexpr int FKC = 64;    // head_dim columns a chunk of the scores' sum
constexpr int FDO = 128;   // output columns a CTA owns

constexpr size_t chunked_smem_bytes() {
  return sizeof(float) *
         (BM * (FKC + 1) + BN * (FKC + 1) + BN * FDO + BM * (BN + 1));
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_fwd_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ lse, int H, int Sq, int Skv,
                         int D, Strides qs, Strides ks, Strides vs,
                         Strides os, float scale, int causal) {
  constexpr int CP = FKC + 1;  // padded pitch: conflict-free column reads
  constexpr int DC = FDO / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [BM][CP] scaled chunk of the q tile
  float* sK = sQ + BM * CP;    // [BN][CP] chunk of the k tile
  float* sV = sK + BN * CP;    // [BN][FDO] this CTA's columns of v
  float* sP = sV + BN * FDO;   // [BM][BN + 1] probabilities of this step

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int split = D / FDO, nc = D / FKC;
  const int bh = blockIdx.x / split, d0 = (blockIdx.x % split) * FDO;
  const int b = bh / H, h = bh % H;
  const int qt = causal ? (gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * BM;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

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
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int col = c * FKC;
      __syncthreads();  // the previous chunk (and step) is done with smem
      for (int idx = tid; idx < BM * FKC; idx += NT) {
        const int r = idx / FKC, cc = idx % FKC, s = q0 + r;
        sQ[r * CP + cc] =
            s < Sq ? to_f32(qb[s * qs.s + col + cc]) * scale : 0.f;
      }
      for (int idx = tid; idx < BN * FKC; idx += NT) {
        const int r = idx / FKC, cc = idx % FKC, s = k0 + r;
        sK[r * CP + cc] = s < Skv ? to_f32(kb[s * ks.s + col + cc]) : 0.f;
      }
      if (c == nc - 1) {
        for (int idx = tid; idx < BN * FDO; idx += NT) {
          const int r = idx / FDO, cc = idx % FDO, s = k0 + r;
          sV[r * FDO + cc] = s < Skv ? to_f32(vb[s * vs.s + d0 + cc]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < FKC; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * CP + d];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) kv[jj] = sK[(tx + 16 * jj) * CP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
      }
    }

    softmax_rows(sc, m, l, acc, sP, q0, k0, Sq, Skv, causal);
    __syncthreads();

    pv_rows<FDO>(acc, sP, sV);
  }

  store_rows(acc, m, l, out + b * os.b + h * os.h + d0, os.s,
             lse + (long long)bh * Sq, d0 == 0, q0, Sq);
}

template <typename T>
int launch_chunked(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int Sq, int Skv, int D,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = chunked_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_chunked_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H * (D / FDO), (Sq + BM - 1) / BM);
  flash_fwd_chunked_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, Sq, Skv, D, qs,
      ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 and fp16 on tensor cores

namespace tc {

using sm90::a_split;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::cp_tile;
using sm90::ldsm4;
using sm90::ldsm4_t;
using sm90::mma;
using sm90::mma_hilo;
using sm90::store2;

constexpr int BM = 128;        // q rows per CTA
constexpr int BN = 64;         // kv rows per streamed tile
constexpr int NW = BM / 16;    // warps per CTA, 16 q rows each
constexpr int NTC = 32 * NW;   // threads per CTA
constexpr int PAD = 8;         // 16-bit padding of a shared-memory row (16 B)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Output columns a CTA owns: all D up to 128; above that D / 128 CTAs
// share a q tile, each recomputing S and the softmax and accumulating its
// own 128 columns of O (so O stays at 64 registers a thread).
__host__ __device__ constexpr int out_cols(int D) {
  return D > 128 ? 128 : D;
}
// K/V ring stages: three up to D = 128; two above, where three would
// need (128 + 6 * 64) * 264 * 2 = 270,336 bytes of the 232,448 a CTA may
// have.
__host__ __device__ constexpr int stages(int D) {
  return D > 128 ? 2 : 3;
}

template <int D>
constexpr size_t smem_bytes() {  // Q; K and V in stages(D) stages
  return 2 * (BM + 2 * stages(D) * BN) * (D + PAD);
}

// 2^x on the special-function unit (relative error ~2^-22; 0 far below)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One kv tile of a warp's 16 q rows (from qw; this lane's first row
// qrow), shared by the D-templated and the chunked kernels: mask S where
// the tile crosses the diagonal or a sequence's end, update the running
// max m2 (log2 units, c = scale * log2 e) and this thread's share of the
// running sum l, rescale O, then O += P V with P as a T hi/lo pair
// straight from the accumulators and V's ldmatrix rows at tV (row pitch
// VP elements, this thread's row offset applied).
template <typename T, int VP, int NB, int OB>
__device__ __forceinline__ void softmax_pv(float (&s)[NB][4], float (&m2)[2],
                                          float (&l)[2], float (&o)[OB][4],
                                          const T* tV, int qw, int k0,
                                          int qrow, int lane, int Sq,
                                          int Skv, int causal, float c) {
  const bool masked = (causal && k0 + BN - 1 > qw) || qw + 16 > Sq ||
                      k0 + BN > Skv;
  if (masked) {
    const int kcol = k0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = qrow + 8 * (e >> 1), kp = kcol + 8 * i + (e & 1);
        if (!(qp < Sq && kp < Skv && (!causal || qp >= kp)))
          s[i][e] = NEG_INF;
      }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m2[r], mx[r] * c);
    const float alpha = ex2(m2[r] - m_new);
    m2[r] = m_new;
    l[r] *= alpha;
#pragma unroll
    for (int i = 0; i < OB; ++i) {
      o[i][2 * r] *= alpha;
      o[i][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[i][e];
      // a masked score is 0 even where the row has seen nothing else
      const float p = masked && x == NEG_INF
                          ? 0.f
                          : ex2(fmaf(x, c, -m2[e >> 1]));
      s[i][e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    unsigned hi[4], lo[4];
    a_split<T, NB>(s, kk, hi, lo);
#pragma unroll
    for (int d2 = 0; d2 < OB / 2; ++d2) {
      unsigned vf[4];
      ldsm4_t(vf, tV + 16 * kk * VP + 16 * d2);
      mma_hilo<T>(o[2 * d2], o[2 * d2 + 1], hi, lo, vf);
    }
  }
}

// The end of a warp's 16 rows: l summed over the four lanes that share a
// row, O / max(l, 1e-30) (fully masked rows: l == 0, O 0) to out (this
// CTA's first column, rows at pitch `pitch`), and where `with_lse` the f32
// lse = m + log(...) to lse (this head's row 0).
template <typename T, int OB>
__device__ __forceinline__ void store_rows(float (&l)[2], const float (&m2)[2],
                                          const float (&o)[OB][4], T* out,
                                          long long pitch, float* lse,
                                          bool with_lse, int qrow, int lane,
                                          int Sq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = qrow + 8 * r;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* row = out + qpos * pitch + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < OB; ++i)
      store2<T>(row + 8 * i, o[i][2 * r] / denom, o[i][2 * r + 1] / denom);
    if (with_lse && lane % 4 == 0) lse[qpos] = m2[r] * LN2 + logf(denom);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTC, 1)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, int H, int Sq, int Skv,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    float scale, int causal) {
  constexpr int DP = D + PAD;
  constexpr int DO = out_cols(D), SPLIT = D / DO;
  constexpr int STAGES = stages(D);
  constexpr int NB = BN / 8;   // n8 blocks of S a tile
  constexpr int OB = DO / 8;   // n8 blocks of this CTA's O columns
  constexpr int KD = D / 16;   // k16 steps of Q K^T
  constexpr int TS = BN * DP;  // elements of one K or V stage
  // Q's A fragments stay in registers for the whole kv loop up to
  // D = 128 (KD * 4 of them); above, each k-step reloads them from
  // shared memory
  constexpr bool QREG = D <= 128;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* sQ = reinterpret_cast<T*>(tc_smem);  // [BM][DP]
  T* sK = sQ + BM * DP;                   // [STAGES][BN][DP]
  T* sV = sK + STAGES * TS;               // [STAGES][BN][DP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp;  // this warp's rows of the q tile
  // CTAs start in blockIdx order, x fastest: q tiles on y, so that under
  // causal masking every head's last q tile (the longest kv loop) starts
  // before any head's second-to-last; a head's column shares sit beside
  // each other on x
  const int bh = blockIdx.x / SPLIT, d0 = (blockIdx.x % SPLIT) * DO;
  const int b = bh / H, h = bh % H;
  const int qt = causal ? (gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * BM;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  int n_kv = (Skv + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (q0 + BM + BN - 1) / BN);

  // commit groups: Q, then one per kv tile (empty past the last), so that
  // before step j's wait the newest STAGES - 2 groups are tiles after j
  cp_tile<T, D, BM, NTC, PAD>(sQ, qb, qs.s, q0, Sq);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_kv) {
      cp_tile<T, D, BN, NTC, PAD>(sK + t * TS, kb, ks.s, t * BN, Skv);
      cp_tile<T, D, BN, NTC, PAD>(sV + t * TS, vb, vs.s, t * BN, Skv);
    }
    cp_async_commit();
  }

  // ldmatrix row addresses: A operand (this warp's rows), B operand
  // without (b_off) and with (t_off) transpose, before the tile offsets
  const int a_off = (r0 + lane % 16) * DP + (lane / 16) * 8;
  const int b_off = (lane % 8 + (lane / 16) * 8) * DP + ((lane / 8) % 2) * 8;
  const int t_off = (lane % 16) * DP + (lane / 16) * 8 + d0;

  cp_async_wait<STAGES - 1>();  // Q has landed
  __syncthreads();
  unsigned qa[QREG ? KD : 1][4];  // Q's A fragments (QREG)
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm4(qa[kk], sQ + a_off + 16 * kk);
  }

  // Rows g and g + 8 of the warp's 16: running max in log2 units
  // (m2 = max(s) * scale * log2 e, so that p = 2^(s*c - m2) is one FFMA
  // and one ex2), this thread's share of the running sum (its 2 of every
  // 8 columns), and O.
  const float c = scale * LOG2E;
  const int qrow = q0 + r0 + lane / 4;
  float m2[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[OB][4];
#pragma unroll
  for (int i = 0; i < OB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  int st = 0;  // stage of tile j
  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j has landed
    // one barrier a tile: tile j is visible to every warp, and every warp
    // is done with tile j - 1, whose stage the next copy refills
    __syncthreads();
    {
      const int jn = j + STAGES - 1, sn = st == 0 ? STAGES - 1 : st - 1;
      if (jn < n_kv) {
        cp_tile<T, D, BN, NTC, PAD>(sK + sn * TS, kb, ks.s, jn * BN, Skv);
        cp_tile<T, D, BN, NTC, PAD>(sV + sn * TS, vb, vs.s, jn * BN, Skv);
      }
      cp_async_commit();
    }
    const int k0 = j * BN;
    // a warp whose rows all lie above this causal tile, or past Sq, skips it
    if ((!causal || k0 <= q0 + r0 + 15) && q0 + r0 < Sq) {
      const T* tK = sK + st * TS;
      const T* tV = sV + st * TS;
      float s[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned qf[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[e] = qa[kk][e];
        } else {
          ldsm4(qf, sQ + a_off + 16 * kk);
        }
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          unsigned kf[4];
          ldsm4(kf, tK + b_off + 16 * n2 * DP + 16 * kk);
          mma<T>(s[2 * n2], qf, kf[0], kf[1]);
          mma<T>(s[2 * n2 + 1], qf, kf[2], kf[3]);
        }
      }

      softmax_pv<T, DP>(s, m2, l, o, tV + t_off, q0 + r0, k0, qrow, lane,
                        Sq, Skv, causal, c);
    }
    st = st == STAGES - 1 ? 0 : st + 1;
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  store_rows<T>(l, m2, o, out + b * os.b + h * os.h + d0, os.s,
                lse + (long long)bh * Sq, d0 == 0, qrow, lane, Sq);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int H, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
           Strides os, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H * (D / out_cols(D)), (Sq + BM - 1) / BM);
  flash_fwd_tc_kernel<T, D><<<grid, NTC, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, Sq, Skv, qs, ks,
      vs, os, scale, causal);
  return (int)cudaGetLastError();
}

// Above head_dim 256: one library a dtype takes any head_dim D that is a
// multiple of KC at run time.  As at 256, D / DOC CTAs share a q tile, each
// owning DOC columns of O.  S = Q K^T is summed over D in KC-column chunks:
// a step is one (kv tile, chunk) pair, whose chunks of the q tile and of
// the kv tile stream together through a CSTAGES-stage cp.async ring, so
// shared memory does not grow with D; a kv tile's first step also brings
// this CTA's DOC columns of its V tile, double-buffered beside the ring.
// Every column CTA recomputes S over the whole of D: Q K^T's work is
// D / DOC times the bound's one pass, P V's the bound's (x2, the hi/lo
// pair), so at D = 512 the kernel spends 3x the bound's operations.
constexpr int KC = 128;        // head_dim columns a chunk
constexpr int DOC = 128;       // output columns a CTA owns
constexpr int CSTAGES = 3;     // chunk ring stages

constexpr size_t chunked_smem_bytes() {  // the ring; V in two buffers
  return 2 * (CSTAGES * (BM + BN) * (KC + PAD) + 2 * BN * (DOC + PAD));
}

template <typename T>
__global__ void __launch_bounds__(NTC, 1)
flash_fwd_chunked_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            float* __restrict__ lse, int H, int Sq, int Skv,
                            int D, Strides qs, Strides ks, Strides vs,
                            Strides os, float scale, int causal) {
  constexpr int CP = KC + PAD, VP = DOC + PAD;
  constexpr int NB = BN / 8;   // n8 blocks of S a tile
  constexpr int OB = DOC / 8;  // n8 blocks of this CTA's O columns
  constexpr int QS = BM * CP;  // elements of a q chunk
  constexpr int STAGE = (BM + BN) * CP, VS = BN * VP;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* sRing = reinterpret_cast<T*>(tc_smem);  // [CSTAGES][q chunk, k chunk]
  T* sV = sRing + CSTAGES * STAGE;           // [2][BN][VP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp;  // this warp's rows of the q tile
  const int split = D / DOC, nc = D / KC;
  const int bh = blockIdx.x / split, d0 = (blockIdx.x % split) * DOC;
  const int b = bh / H, h = bh % H;
  const int qt = causal ? (gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * BM;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  int n_kv = (Skv + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (q0 + BM + BN - 1) / BN);
  const int n_steps = n_kv * nc;

  // one commit group a step (empty past the last), so that before step
  // t's wait the newest CSTAGES - 2 groups are later steps'
  auto issue = [&](int t) {
    if (t < n_steps) {
      const int j = t / nc, c = t % nc;
      T* st = sRing + (t % CSTAGES) * STAGE;
      cp_tile<T, KC, BM, NTC, PAD>(st, qb + c * KC, qs.s, q0, Sq);
      cp_tile<T, KC, BN, NTC, PAD>(st + QS, kb + c * KC, ks.s, j * BN, Skv);
      if (c == 0)
        cp_tile<T, DOC, BN, NTC, PAD>(sV + (j & 1) * VS, vb + d0, vs.s,
                                      j * BN, Skv);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < CSTAGES - 1; ++t) issue(t);

  const int a_off = (r0 + lane % 16) * CP + (lane / 16) * 8;
  const int b_off = (lane % 8 + (lane / 16) * 8) * CP + ((lane / 8) % 2) * 8;
  const int t_off = (lane % 16) * VP + (lane / 16) * 8;

  const float cl = scale * LOG2E;
  const int qrow = q0 + r0 + lane / 4;
  float m2[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[OB][4];
#pragma unroll
  for (int i = 0; i < OB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float s[NB][4];

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<CSTAGES - 2>();  // step t has landed
    // one barrier a step: step t is visible to every warp, and every warp
    // is done with step t - 1, whose stage the next copy refills (a V
    // buffer is refilled two kv tiles later: nc >= 2 steps after its use)
    __syncthreads();
    issue(t + CSTAGES - 1);
    const int j = t / nc, c = t % nc, k0 = j * BN;
    // a warp whose rows all lie above this causal tile, or past Sq, skips it
    if ((causal && k0 > q0 + r0 + 15) || q0 + r0 >= Sq) continue;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    }
    const T* tQ = sRing + (t % CSTAGES) * STAGE;
    const T* tK = tQ + QS;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      unsigned qf[4];
      ldsm4(qf, tQ + a_off + 16 * kk);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        unsigned kf[4];
        ldsm4(kf, tK + b_off + 16 * n2 * CP + 16 * kk);
        mma<T>(s[2 * n2], qf, kf[0], kf[1]);
        mma<T>(s[2 * n2 + 1], qf, kf[2], kf[3]);
      }
    }
    if (c < nc - 1) continue;  // S is summed over every chunk first

    softmax_pv<T, VP>(s, m2, l, o, sV + (j & 1) * VS + t_off, q0 + r0, k0,
                      qrow, lane, Sq, Skv, causal, cl);
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  store_rows<T>(l, m2, o, out + b * os.b + h * os.h + d0, os.s,
                lse + (long long)bh * Sq, d0 == 0, qrow, lane, Sq);
}

template <typename T>
int launch_chunked(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int Sq, int Skv, int D,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = chunked_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_chunked_tc_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H * (D / DOC), (Sq + BM - 1) / BM);
  flash_fwd_chunked_tc_kernel<T><<<grid, NTC, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, Sq, Skv, D, qs,
      ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

// What the card made of a kernel: out[0] registers a thread, out[1]
// dynamic shared memory bytes, out[2] local (spill) bytes a thread, out[3]
// CTAs an SM can hold.
template <typename Kernel>
int attrs(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                      smem);
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
static_assert(kChunk % FDO == 0 && kChunk % tc::KC == 0 &&
                  kChunk % tc::DOC == 0,
              "a chunked head_dim splits into whole chunks and column CTAs");
#if TFOS_HEAD_DIM == 0
constexpr bool takes(int d) { return d > 256 && d % kChunk == 0; }
#else
constexpr bool takes(int d) { return d == TFOS_HEAD_DIM; }
#endif
#if TFOS_DTYPE == 0
using Elem = float;
constexpr int kThreads = NT;
#if TFOS_HEAD_DIM == 0
#define TFOS_KERNEL flash_fwd_chunked_kernel<float>
constexpr size_t kSmem = chunked_smem_bytes();
#else
#define TFOS_KERNEL flash_fwd_kernel<float, TFOS_HEAD_DIM>
constexpr size_t kSmem = smem_bytes<TFOS_HEAD_DIM>();
#endif
#else
#if TFOS_DTYPE == 1
using Elem = sm90::bf16;
#elif TFOS_DTYPE == 2
using Elem = sm90::f16;
#else
#error "TFOS_DTYPE is 0, 1 or 2"
#endif
constexpr int kThreads = tc::NTC;
#if TFOS_HEAD_DIM == 0
#define TFOS_KERNEL tc::flash_fwd_chunked_tc_kernel<Elem>
constexpr size_t kSmem = tc::chunked_smem_bytes();
#else
#define TFOS_KERNEL tc::flash_fwd_tc_kernel<Elem, TFOS_HEAD_DIM>
constexpr size_t kSmem = tc::smem_bytes<TFOS_HEAD_DIM>();
#endif
#endif

int launch_any(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int Sq, int Skv, int D, Strides qs,
               Strides ks, Strides vs, Strides os, float scale, int causal,
               cudaStream_t stream) {
#if TFOS_HEAD_DIM == 0 && TFOS_DTYPE == 0
  return launch_chunked<float>(q, k, v, out, lse, B, H, Sq, Skv, D, qs, ks,
                               vs, os, scale, causal, stream);
#elif TFOS_HEAD_DIM == 0
  return tc::launch_chunked<Elem>(q, k, v, out, lse, B, H, Sq, Skv, D, qs, ks,
                                  vs, os, scale, causal, stream);
#elif TFOS_DTYPE == 0
  return launch<float, TFOS_HEAD_DIM>(q, k, v, out, lse, B, H, Sq, Skv, qs, ks,
                                      vs, os, scale, causal, stream);
#else
  return tc::launch<Elem, TFOS_HEAD_DIM>(q, k, v, out, lse, B, H, Sq, Skv, qs,
                                         ks, vs, os, scale, causal, stream);
#endif
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16, 2 = float16 (tensor-core
// kernels; q, k and v 16-byte aligned, with batch, seq and head strides of
// whole 16-byte vectors).  Strides are in elements, for the [B, S, H, D]
// layout with unit stride on D.  Returns a cudaError_t (0 on success); -1
// for a dtype or head_dim other than this library's (the chunked library
// takes every multiple of 128 above 256).
int tfos_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, void* out, float* lse, int B, int H, int Sq,
                   int Skv, long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh, long long vsb,
                   long long vss, long long vsh, long long osb, long long oss,
                   long long osh, float scale, int causal, void* stream) {
  if (dtype != TFOS_DTYPE || !takes(head_dim)) return -1;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  return launch_any(q, k, v, out, lse, B, H, Sq, Skv, head_dim, qs, ks, vs, os,
                    scale, causal, static_cast<cudaStream_t>(stream));
}

// This library's kernel as the card holds it: out[0] registers a thread,
// out[1] dynamic shared memory bytes, out[2] local (spill) bytes a thread,
// out[3] CTAs an SM.  Returns a cudaError_t.
int tfos_flash_fwd_attrs(int* out) {
  return attrs(TFOS_KERNEL, kThreads, kSmem, out);
}

const char* tfos_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
