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
// longest kv loops) are scheduled first.  Two implementations behind one
// interface, each library built for one head_dim (a multiple of 16 up to
// 256) and one dtype (ops/_build.py passes TFOS_HEAD_DIM and TFOS_DTYPE):
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

      // mask where the tile crosses the diagonal or a sequence's end
      const bool masked = (causal && k0 + BN - 1 > q0 + r0) ||
                          q0 + r0 + 16 > Sq || k0 + BN > Skv;
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

      // O += P V, P as a T hi/lo pair straight from the accumulators
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        unsigned hi[4], lo[4];
        a_split<T, NB>(s, kk, hi, lo);
#pragma unroll
        for (int d2 = 0; d2 < OB / 2; ++d2) {
          unsigned vf[4];
          ldsm4_t(vf, tV + t_off + 16 * kk * DP + 16 * d2);
          mma_hilo<T>(o[2 * d2], o[2 * d2 + 1], hi, lo, vf);
        }
      }
    }
    st = st == STAGES - 1 ? 0 : st + 1;
  }
  cp_async_wait<0>();  // no copy outlives the CTA

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = qrow + 8 * r;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);  // fully masked rows: l == 0
    T* row = out + b * os.b + qpos * os.s + h * os.h + d0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < OB; ++i)
      store2<T>(row + 8 * i, o[i][2 * r] / denom, o[i][2 * r + 1] / denom);
    if (d0 == 0 && lane % 4 == 0)
      lse[(long long)bh * Sq + qpos] = m2[r] * LN2 + logf(denom);
  }
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
// TFOS_HEAD_DIM, and TFOS_DTYPE 0 = float32 (the FMA kernel), 1 = bfloat16
// or 2 = float16 (the tensor-core kernel).
#if !defined(TFOS_HEAD_DIM) || !defined(TFOS_DTYPE)
#error "build with -DTFOS_HEAD_DIM=<d> -DTFOS_DTYPE=<0|1|2> (ops/_build.py)"
#endif
static_assert(TFOS_HEAD_DIM % 16 == 0 && TFOS_HEAD_DIM <= 256,
              "head_dim a multiple of 16, at most 256");
#if TFOS_DTYPE == 0
#define TFOS_LAUNCH launch<float, TFOS_HEAD_DIM>
#define TFOS_KERNEL flash_fwd_kernel<float, TFOS_HEAD_DIM>
constexpr int kThreads = NT;
constexpr size_t kSmem = smem_bytes<TFOS_HEAD_DIM>();
#else
#if TFOS_DTYPE == 1
using Elem = sm90::bf16;
#elif TFOS_DTYPE == 2
using Elem = sm90::f16;
#else
#error "TFOS_DTYPE is 0, 1 or 2"
#endif
#define TFOS_LAUNCH tc::launch<Elem, TFOS_HEAD_DIM>
#define TFOS_KERNEL tc::flash_fwd_tc_kernel<Elem, TFOS_HEAD_DIM>
constexpr int kThreads = tc::NTC;
constexpr size_t kSmem = tc::smem_bytes<TFOS_HEAD_DIM>();
#endif

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16, 2 = float16 (tensor-core
// kernels; q, k and v 16-byte aligned, with batch, seq and head strides of
// whole 16-byte vectors).  Strides are in elements, for the [B, S, H, D]
// layout with unit stride on D.  Returns a cudaError_t (0 on success); -1
// for a dtype or head_dim other than this library's.
int tfos_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, void* out, float* lse, int B, int H, int Sq,
                   int Skv, long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh, long long vsb,
                   long long vss, long long vsh, long long osb, long long oss,
                   long long osh, float scale, int causal, void* stream) {
  if (dtype != TFOS_DTYPE || head_dim != TFOS_HEAD_DIM) return -1;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  return TFOS_LAUNCH(q, k, v, out, lse, B, H, Sq, Skv, qs, ks, vs, os, scale,
                     causal, static_cast<cudaStream_t>(stream));
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
