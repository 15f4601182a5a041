// Flash attention backward for Hopper (sm_90a): the gradient of B6
// (csrc/attention.cu) with respect to q, k and v.
//
// It replaces no TPU kernel: the reference's Pallas kernel
// (kernels/flash_attention.py::_flash_kernel) has no backward, and the
// reference trains through its plain blockwise scan
// (models/attention.py::_blockwise_attention), which jax.grad differentiates
// with a jax.checkpoint per KV step.  These kernels compute that gradient as
// the plain torch version flash_attention_bwd_plain (kernels/
// flash_attention.py) does, without storing any score: the forward's row
// statistic lse = m + log(l) (natural log, float32, (B, H, S)) gives every
// probability again, p = exp(scale * q.k - lse).
//
//   flash_bwd_dot   delta = rowsum(dO * O) in float32, one warp per row of
//                   (B, H, S).
//   flash_bwd_dkdv  one block per (KV head, key tile, batch).  The K and V
//                   tile stay in shared memory; the block walks the H / Hk
//                   query heads of its group and, for each, the query tiles
//                   that can see its keys (causal: from the tile's first key
//                   on; window: up to its last key + window - 1), recomputes
//                   s = q.k^T and dp = dO.v^T, forms p and ds = p (dp -
//                   delta) on visible pairs, and accumulates dv += p^T.dO and
//                   dk += ds^T.q in registers; dk is scaled once at the end.
//                   The sum over a group's query heads stays in the block.
//   flash_bwd_dq    one block per (query head, query tile, batch): q, dO,
//                   lse and delta stay put while the block walks the key
//                   tiles its rows can see, recomputing s, dp and ds, and
//                   accumulates dq += ds.k; scaled at the end.
//
// Masks: those of the forward (kpos <= qpos when causal, kpos > qpos -
// window when window > 0, keys past T absent).  Masked pairs carry no
// gradient, as under autograd through the plain forward's where(ok, s,
// -1e30).  A row that sees no key (window > 0 and qpos >= T - 1 + window)
// has no such gradient: the entry point refuses any call with one.
//
// Bound: operations.  The work is 2 D (s) + 2 Dv (dp) + 2 Dv (dv) + 2 D (dk)
// + 2 D (dq) = 6 D + 4 Dv FLOPs per visible (q, k) pair.  At Qwen3-0.6B's
// train layer (q [1, 4096, 16, 128], k/v 8 heads, causal) that is 1.72e11
// FLOPs, 0.174 ms at the bf16 tensor-core rate and 2.56 ms at the float32
// FFMA rate (67 TFLOP/s).  No float atomics anywhere (dk/dv and dq are two
// kernels, each sum in one block), so the same inputs give the same bits.
// dq, dk and dv are written once, in q's dtype, contiguous (B, S, H, D),
// (B, T, Hk, D), (B, T, Hk, Dv).  D and Dv up to 256 and not necessarily
// equal: the instance is the smallest of (64, 64), (128, 128), (192, 128),
// (256, 256) that holds both, columns past D or Dv zero in shared memory.
//
// Two routes, by instance:
//
// bfloat16 at (64, 64), (128, 128) and (192, 128): flash_bwd_dkdv_wgmma and
// flash_bwd_dq_wgmma, on the tensor cores (wgmma) from shared memory that
// TMA fills, in the forward's layout (tiles of 64 columns, 128-byte
// swizzle) and with its building blocks (csrc/hopper.cuh).
//   * Blocks of 256 threads, two consumer warpgroups and no producer warp
//     (as the forward: thread 0 issues the copies), one block per SM.
//     dk/dv: 128 keys a block, 64 a warpgroup, K and V loaded once; tiles
//     of NQ query rows with their lse and delta come through a ring of 3
//     stages, key tiles in order (the causally longest first).  NQ is the
//     widest s^T and dp^T that fit beside the dk and dv accumulators
//     without a spill: 64 at (64, 64); 48 at (128, 128), where 64 spilled
//     at 255 registers a thread (48 takes 254); 32 at (192, 128), whose
//     dk alone takes 96 registers a thread.  dq: 128 query rows a block, 64 a
//     warpgroup, q and dO loaded once; K/V tiles of 64 keys through a ring
//     of 3 stages; query tiles longest first.  A "full" mbarrier per stage
//     (TMA bytes, and the cp.async arrivals of lse and delta) and an
//     "empty" one (all 256 threads) hand stages over; warp 0 refills a
//     stage once both warpgroups are done with it.
//   * dk/dv per tile and warpgroup: s^T = K.q^T and dp^T = V.dO^T (wgmma
//     from shared memory, both K-major; s's group is waited for first, so
//     the exponentials overlap dp's product), p^T = 2^(s^T scale log2e -
//     lse log2e) on the special-function unit, ds^T = p^T (dp^T - delta) in
//     float32 registers, then dv += p^T.dO (issued while ds^T is split)
//     and dk += ds^T.q with A from registers (the accumulator layout of
//     s^T is the A-operand layout) and B MN-major, as the forward's p.v
//     reads V.  dq: s = q.K^T, dp = dO.V^T, p, ds, then dq += ds.K (K
//     MN-major).
//   * p and ds keep about 16 bits: each is split into hi = bf16(x) and
//     lo = bf16(x - hi), both multiplying the bf16 operand (exact in
//     float32) with float32 accumulation.  So the kernels issue 12 D + 8 Dv
//     FLOPs per visible pair (s and dp in both, the three register-operand
//     products twice): 0.348 ms "as issued" at Qwen3's layer.
//   * Tiles wholly above the causal diagonal or outside the window are
//     skipped (a warpgroup with no visible pair in a tile only hands its
//     stage back); masks are applied only on tiles that need them.
//   * q, k and v are read by TMA (the wrapper checks their layout, as the
//     bf16 forward does); dO by TMA where its layout allows, otherwise each
//     element is staged into the same swizzled tiles by the block's threads
//     (a fence orders those writes before the tensor cores read them).
//
// float32 (every instance), and bfloat16 at (256, 256): flash_bwd_dkdv and
// flash_bwd_dq on FFMA.  float32 stays exact: every product is one FFMA on
// the SIMT units, p float32 in every product, full-precision expf; it runs
// in check steps only.  At (256, 256) (gemma's head size) a warpgroup's dk
// and dv accumulators alone would take 256 registers a thread, so the bf16
// instance stays on FFMA as well.  Tiles of 64 rows by 64 keys (32 by 32 at
// D = 256) in shared memory, each thread a register tile of 4 x 4 scores
// and 4 keys (rows) x D/16 gradient columns; bf16 operands are widened
// (exact).  Operands through their four element strides each (any strides:
// nothing is copied); s and dp are recomputed in both kernels, 8 D + 6 Dv
// FLOPs per visible pair.
//
// Plain C entry point, loaded with ctypes; it returns the first
// cudaGetLastError() after a launch, or a cudaError_t for operands it
// cannot take.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::allow_smem;
using hopper::kMaxDevices;

constexpr int kThreads = 256;
constexpr int kMaxDim = 256;
constexpr size_t kSmemMax = 232448;   // what one block may use on sm_90
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Params {
  int64_t B, S, T, H, Hk, G;
  int64_t qs[4], ks[4], vs[4], os[4], gs[4];   // element strides (gs: dO)
  int D, Dv, causal, window;
  float scale;
};

// Rows [row0, row0 + ROWS) and columns [0, COLS) of one (batch, head) slice
// of x into dst (row pitch `pitch` floats), widened to float32; zeros past
// n_rows or cols.  Neighbouring threads read neighbouring columns.
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* x,
                                          int64_t row_stride,
                                          int64_t col_stride, int64_t row0,
                                          int64_t n_rows, int cols) {
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kThreads) {
    const int r = idx / COLS, c = idx % COLS;
    float val = 0.f;
    if (row0 + r < n_rows && c < cols)
      val = ld(x + (row0 + r) * row_stride + c * col_stride);
    dst[r * pitch + c] = val;
  }
}

// acc[i][j] = sum_c a[rt + 16 i][c] b[ct + 16 j][c] over C columns (a
// multiple of 4) of two row-major tiles with pitch `pitch`.
template <int RI, int CJ, int C>
__device__ __forceinline__ void dot_tiles(float (&acc)[RI][CJ],
                                          const float* a, const float* b,
                                          int pitch, int rt, int ct) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; c += 4) {
    float4 af[RI], bf[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      af[i] = *reinterpret_cast<const float4*>(a + (rt + 16 * i) * pitch + c);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      bf[j] = *reinterpret_cast<const float4*>(b + (ct + 16 * j) * pitch + c);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        acc[i][j] = fmaf(af[i].x, bf[j].x, acc[i][j]);
        acc[i][j] = fmaf(af[i].y, bf[j].y, acc[i][j]);
        acc[i][j] = fmaf(af[i].z, bf[j].z, acc[i][j]);
        acc[i][j] = fmaf(af[i].w, bf[j].w, acc[i][j]);
      }
  }
}

// p and ds of the pair (qpos, kpos) from s = q.k (unscaled), dp = dO.v,
// the row's lse and delta.
__device__ __forceinline__ void p_ds(const Params& p, int64_t qpos,
                                     int64_t kpos, float s, float dp,
                                     float lse, float delta, float* pr,
                                     float* ds) {
  const bool ok = qpos < p.S && kpos < p.T &&
                  (!p.causal || kpos <= qpos) &&
                  (p.window == 0 || kpos > qpos - p.window);
  const float pv = ok ? expf(s * p.scale - lse) : 0.f;
  *pr = pv;
  *ds = ok ? pv * (dp - delta) : 0.f;
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ delta, Params p) {
  const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= p.B * p.H * p.S) return;
  // row = (b H + h) S + s, the layout of delta and lse
  const int64_t s = row % p.S, h = (row / p.S) % p.H, b = row / (p.S * p.H);
  const T* orow = o + b * p.os[0] + s * p.os[1] + h * p.os[2];
  const T* grow = dout + b * p.gs[0] + s * p.gs[1] + h * p.gs[2];
  float acc = 0.f;
  for (int c = lane; c < p.Dv; c += 32)
    acc = fmaf(ld(orow + c * p.os[3]), ld(grow + c * p.gs[3]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (KV head, key tile, batch)
// ---------------------------------------------------------------------------

template <int DP, int DVP, int BQ, int BK>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * ((size_t)(BK + BQ) * (DP + 4) +
                          (size_t)(BK + BQ) * (DVP + 4) +
                          2 * (size_t)BQ * (BK + 16) + 2 * BQ);
}

template <typename T, int DP, int DVP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, Params p) {
  constexpr int QP = DP + 4, VP = DVP + 4, PP = BK + 16;
  constexpr int RI = BQ / 16, CJ = BK / 16, DM = DP / 64, VM = DVP / 64;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [BK][QP]
  float* vs = ks + BK * QP;                      // [BK][VP]
  float* qs = vs + BK * VP;                      // [BQ][QP]
  float* gs = qs + BQ * QP;                      // [BQ][VP]  dO
  float* ps = gs + BQ * VP;                      // [BQ][PP]
  float* dss = ps + BQ * PP;                     // [BQ][PP]
  float* lse_s = dss + BQ * PP;                  // [BQ]
  float* del_s = lse_s + BQ;                     // [BQ]

  const int64_t hk = blockIdx.x, b = blockIdx.z;
  const int64_t k0 = (int64_t)blockIdx.y * BK;
  const int64_t k_last = (k0 + BK < p.T ? k0 + BK : p.T) - 1;
  const int tid = threadIdx.x, rt = tid >> 4, ct = tid & 15;

  load_tile<BK, DP>(ks, QP, k + b * p.ks[0] + hk * p.ks[2], p.ks[1], p.ks[3],
                    k0, p.T, p.D);
  load_tile<BK, DVP>(vs, VP, v + b * p.vs[0] + hk * p.vs[2], p.vs[1],
                     p.vs[3], k0, p.T, p.Dv);

  // the query rows that can see a key of this tile
  int64_t q_lo = p.causal ? k0 : 0;
  int64_t q_hi = p.S;
  if (p.window > 0 && k_last + p.window < q_hi) q_hi = k_last + p.window;
  q_lo = q_lo / BQ * BQ;

  // this thread's keys ct + 16 j, columns 4 rt + 64 m (+ 0..3)
  float dka[CJ][DM][4], dva[CJ][VM][4];
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
#pragma unroll
    for (int m = 0; m < DM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[j][m][e] = 0.f;
#pragma unroll
    for (int m = 0; m < VM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) dva[j][m][e] = 0.f;
  }

  for (int64_t g = 0; g < p.G; ++g) {
    const int64_t h = hk * p.G + g;
    for (int64_t q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the previous tile's reads are done
      load_tile<BQ, DP>(qs, QP, q + b * p.qs[0] + h * p.qs[2], p.qs[1],
                        p.qs[3], q0, p.S, p.D);
      load_tile<BQ, DVP>(gs, VP, dout + b * p.gs[0] + h * p.gs[2], p.gs[1],
                         p.gs[3], q0, p.S, p.Dv);
      if (tid < BQ) {
        const int64_t qq = q0 + tid;
        const int64_t at = (b * p.H + h) * p.S + qq;
        lse_s[tid] = qq < p.S ? lse[at] : 0.f;
        del_s[tid] = qq < p.S ? delta[at] : 0.f;
      }
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ];
      dot_tiles<RI, CJ, DP>(s, qs, ks, QP, rt, ct);
      dot_tiles<RI, CJ, DVP>(dp, gs, vs, VP, rt, ct);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = rt + 16 * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = ct + 16 * j;
          float pr, ds;
          p_ds(p, q0 + r, k0 + c, s[i][j], dp[i][j], lse_s[r], del_s[r], &pr,
               &ds);
          ps[r * PP + c] = pr;
          dss[r * PP + c] = ds;
        }
      }
      __syncthreads();

      // dv += p^T dO, dk += ds^T q over the tile's rows
      const int rows = (int)(p.S - q0 < BQ ? p.S - q0 : BQ);
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        float pj[CJ], dj[CJ];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          pj[j] = ps[r * PP + ct + 16 * j];
          dj[j] = dss[r * PP + ct + 16 * j];
        }
#pragma unroll
        for (int m = 0; m < VM; ++m) {
          const float4 gf =
              *reinterpret_cast<const float4*>(gs + r * VP + 4 * rt + 64 * m);
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            dva[j][m][0] = fmaf(pj[j], gf.x, dva[j][m][0]);
            dva[j][m][1] = fmaf(pj[j], gf.y, dva[j][m][1]);
            dva[j][m][2] = fmaf(pj[j], gf.z, dva[j][m][2]);
            dva[j][m][3] = fmaf(pj[j], gf.w, dva[j][m][3]);
          }
        }
#pragma unroll
        for (int m = 0; m < DM; ++m) {
          const float4 qf =
              *reinterpret_cast<const float4*>(qs + r * QP + 4 * rt + 64 * m);
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            dka[j][m][0] = fmaf(dj[j], qf.x, dka[j][m][0]);
            dka[j][m][1] = fmaf(dj[j], qf.y, dka[j][m][1]);
            dka[j][m][2] = fmaf(dj[j], qf.z, dka[j][m][2]);
            dka[j][m][3] = fmaf(dj[j], qf.w, dka[j][m][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int64_t kpos = k0 + ct + 16 * j;
    if (kpos >= p.T) continue;
    T* krow = dk + ((b * p.T + kpos) * p.Hk + hk) * p.D;
    T* vrow = dv + ((b * p.T + kpos) * p.Hk + hk) * p.Dv;
#pragma unroll
    for (int m = 0; m < DM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * rt + 64 * m + e;
        if (col < p.D) st(krow + col, dka[j][m][e] * p.scale);
      }
#pragma unroll
    for (int m = 0; m < VM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * rt + 64 * m + e;
        if (col < p.Dv) st(vrow + col, dva[j][m][e]);
      }
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (query head, query tile, batch)
// ---------------------------------------------------------------------------

template <int DP, int DVP, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((size_t)(BK + BQ) * (DP + 4) +
                          (size_t)(BK + BQ) * (DVP + 4) +
                          (size_t)BQ * (BK + 16) + 2 * BQ);
}

template <typename T, int DP, int DVP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, Params p) {
  constexpr int QP = DP + 4, VP = DVP + 4, PP = BK + 16;
  constexpr int RI = BQ / 16, CJ = BK / 16, DM = DP / 64;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][QP]
  float* gs = qs + BQ * QP;                      // [BQ][VP]  dO
  float* ks = gs + BQ * VP;                      // [BK][QP]
  float* vs = ks + BK * QP;                      // [BK][VP]
  float* dss = vs + BK * VP;                     // [BQ][PP]
  float* lse_s = dss + BQ * PP;                  // [BQ]
  float* del_s = lse_s + BQ;                     // [BQ]

  const int64_t h = blockIdx.x, b = blockIdx.z, hk = h / p.G;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;  // longest
  const int64_t q_last = (q0 + BQ < p.S ? q0 + BQ : p.S) - 1;      // first
  const int tid = threadIdx.x, rt = tid >> 4, ct = tid & 15;

  load_tile<BQ, DP>(qs, QP, q + b * p.qs[0] + h * p.qs[2], p.qs[1], p.qs[3],
                    q0, p.S, p.D);
  load_tile<BQ, DVP>(gs, VP, dout + b * p.gs[0] + h * p.gs[2], p.gs[1],
                     p.gs[3], q0, p.S, p.Dv);
  if (tid < BQ) {
    const int64_t qq = q0 + tid;
    const int64_t at = (b * p.H + h) * p.S + qq;
    lse_s[tid] = qq < p.S ? lse[at] : 0.f;
    del_s[tid] = qq < p.S ? delta[at] : 0.f;
  }

  // the keys the tile's rows can see
  int64_t k_lo = 0, k_hi = p.T;
  if (p.causal && q_last + 1 < k_hi) k_hi = q_last + 1;
  if (p.window > 0 && q0 - p.window + 1 > k_lo) k_lo = q0 - p.window + 1;

  // this thread's rows rt + 16 i, columns 4 ct + 64 m (+ 0..3)
  float dqa[RI][DM][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int m = 0; m < DM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[i][m][e] = 0.f;

  for (int64_t k0 = k_lo / BK * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's reads are done
    load_tile<BK, DP>(ks, QP, k + b * p.ks[0] + hk * p.ks[2], p.ks[1],
                      p.ks[3], k0, p.T, p.D);
    load_tile<BK, DVP>(vs, VP, v + b * p.vs[0] + hk * p.vs[2], p.vs[1],
                       p.vs[3], k0, p.T, p.Dv);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
    dot_tiles<RI, CJ, DP>(s, qs, ks, QP, rt, ct);
    dot_tiles<RI, CJ, DVP>(dp, gs, vs, VP, rt, ct);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rt + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = ct + 16 * j;
        float pr, ds;
        p_ds(p, q0 + r, k0 + c, s[i][j], dp[i][j], lse_s[r], del_s[r], &pr,
             &ds);
        dss[r * PP + c] = ds;
      }
    }
    __syncthreads();

    // dq += ds k over the tile's keys
    const int keys = (int)(p.T - k0 < BK ? p.T - k0 : BK);
#pragma unroll 2
    for (int c = 0; c < keys; ++c) {
      float di[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) di[i] = dss[(rt + 16 * i) * PP + c];
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const float4 kf =
            *reinterpret_cast<const float4*>(ks + c * QP + 4 * ct + 64 * m);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          dqa[i][m][0] = fmaf(di[i], kf.x, dqa[i][m][0]);
          dqa[i][m][1] = fmaf(di[i], kf.y, dqa[i][m][1]);
          dqa[i][m][2] = fmaf(di[i], kf.z, dqa[i][m][2]);
          dqa[i][m][3] = fmaf(di[i], kf.w, dqa[i][m][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int64_t qpos = q0 + rt + 16 * i;
    if (qpos >= p.S) continue;
    T* qrow = dq + ((b * p.S + qpos) * p.H + h) * p.D;
#pragma unroll
    for (int m = 0; m < DM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * ct + 64 * m + e;
        if (col < p.D) st(qrow + col, dqa[i][m][e] * p.scale);
      }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;   // two consumer warpgroups
constexpr int kTcStages = 3;      // ring depth
constexpr int kKeys = 128;        // keys per dk/dv block, 64 per warpgroup
constexpr int kRows = 128;        // query rows per dq block, 64 per warpgroup
constexpr int kKvTile = 64;       // keys per K/V tile of the dq kernel

// Params for the tensor-core kernels: positions in 32 bits (S, T and H
// are below 2^31, the entry checks), so the mask arithmetic takes one
// register a value at 254-255 registers a thread.
struct TcParams {
  int S, T, H, Hk, G;
  int64_t gs[4];                  // dO's element strides (element staging)
  int D, Dv, causal, window;
  int tma_do;                     // dO read by TMA, else staged by element
  float scale;
};

// The index of element (r, c) of a [rows][64] bf16 tile as TMA writes it
// with the 128-byte swizzle: 16-byte chunk c / 8 of row r at c / 8 ^ r % 8.
__device__ __forceinline__ int sw64(int r, int c) {
  return r * 64 + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 48 || N == 32, "n64, n48 or n32");
  if constexpr (N == 64)
    hopper::wgmma_ss_m64n64k16(d, a, b, accumulate);
  else if constexpr (N == 48)
    hopper::wgmma_ss_m64n48k16(d, a, b, accumulate);
  else
    hopper::wgmma_ss_m64n32k16(d, a, b, accumulate);
}

// d (64 x N) = A . B^T over 64 C columns: A rows [a0, a0 + 64) of a
// [C][a_rows][64] tile, B rows [0, N) of a [C][N-or-more][64] tile (b_rows
// its row count), both K-major (issued, not committed).
template <int N, int C>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], const bf16* a,
                                           int a_rows, int a0, const bf16* b,
                                           int b_rows) {
#pragma unroll
  for (int kk = 0; kk < 4 * C; ++kk)
    wgmma_ss<N>(d,
                hopper::desc_sw128(a + ((kk / 4) * a_rows + a0) * 64 +
                                       (kk % 4) * 16, 16, 1024),
                hopper::desc_sw128(b + (kk / 4) * b_rows * 64 + (kk % 4) * 16,
                                   16, 1024),
                kk > 0);
}

// acc (64 x 64 C) += A . B for one k16 slice: A bf16 fragments, B rows
// [r0, r0 + 16) of a [C][b_rows][64] tile read MN-major, in column slices
// of 128, then of 64 (issued, not committed).
template <int C>
__device__ __forceinline__ void rs_product(float (&acc)[C][32],
                                           const uint32_t (&a)[4],
                                           const bf16* b, int b_rows, int r0) {
#pragma unroll
  for (int n = 0; n < C; n += (C - n >= 2 ? 2 : 1)) {
    const uint64_t db =
        hopper::desc_sw128(b + (n * b_rows + r0) * 64, b_rows * 128, 1024);
    if (C - n >= 2)
      hopper::wgmma_rs_m64n128k16_mn(
          *reinterpret_cast<float(*)[64]>(&acc[n][0]), a, db);
    else
      hopper::wgmma_rs_m64n64k16_mn(acc[n], a, db);
  }
}

// Keeps the compiler from moving reads or writes of these registers
// across the asynchronous products (hopper::reg_fence on each).
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) hopper::reg_fence(x[e]);
}
template <int C>
__device__ __forceinline__ void fence_regs(float (&x)[C][32]) {
#pragma unroll
  for (int n = 0; n < C; ++n) fence_regs(x[n]);
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) hopper::reg_fence(x[kk][r]);
}

// An accumulator (m64nN, N / 2 floats) as A fragments of its N / 16 k16
// slices, each value split into bf16 hi and lo: slice kk is n8 blocks 2 kk
// and 2 kk + 1 (element 4 j + 2 i + e is row 8 i, column 8 j + e from this
// thread's first).
template <int N>
__device__ __forceinline__ void split_frags(const float (&x)[N / 2],
                                            uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e0 = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[e0], x[e0 + 1]);
      const float2 back = __bfloat1622float2(h2);
      const __nv_bfloat162 l2 =
          __floats2bfloat162_rn(x[e0] - back.x, x[e0 + 1] - back.y);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[kk][r] = *reinterpret_cast<const uint32_t*>(&l2);
    }
}

// Columns col and col + 1 of a row of n values, rounded to bf16.
__device__ __forceinline__ void store2(bf16* row, int col, float a, float c,
                                       int n) {
  if (col + 1 < n && (n & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(a, c);
  } else {
    if (col < n) row[col] = __float2bfloat16_rn(a);
    if (col + 1 < n) row[col + 1] = __float2bfloat16_rn(c);
  }
}

// Rows [r0, r0 + rows) of dO (batch b, head h) into a swizzled
// [DVP / 64][rows][64] tile element by element, zeros past S and Dv, by the
// block's threads; the writes are fenced for the tensor cores.
template <int DVP>
__device__ __forceinline__ void stage_dout(bf16* dst, int rows,
                                           const bf16* __restrict__ dout,
                                           const TcParams& p, int64_t b,
                                           int64_t h, int64_t r0) {
  const bf16* src = dout + b * p.gs[0] + h * p.gs[2];
  for (int i = threadIdx.x; i < rows * DVP; i += kTcThreads) {
    const int r = i / DVP, c = i % DVP;
    bf16 x = __ushort_as_bfloat16((unsigned short)0);
    if (r0 + r < p.S && c < p.Dv) x = src[(r0 + r) * p.gs[1] + c * p.gs[3]];
    dst[(c / 64) * rows * 64 + sw64(r, c % 64)] = x;
  }
  hopper::fence_proxy_async();
}

template <int DP, int DVP, int NQ>
constexpr size_t dkdv_tc_smem_bytes() {
  return 1024 /* alignment slack */ +
         2 * ((size_t)kKeys * (DP + DVP) + (size_t)kTcStages * NQ * (DP + DVP)) +
         4 * 2 * kTcStages * NQ + 8 * (1 + 2 * kTcStages);
}

template <int DP, int DVP, int NQ>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const TcParams p) {
  constexpr int kDC = DP / 64, kVC = DVP / 64, kQS = NQ / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* ks = reinterpret_cast<bf16*>(base);   // [kDC][kKeys][64]
  bf16* vs = ks + kKeys * DP;                 // [kVC][kKeys][64]
  bf16* qs = vs + kKeys * DVP;                // [kTcStages][kDC][NQ][64]
  bf16* gs = qs + kTcStages * NQ * DP;        // [kTcStages][kVC][NQ][64] dO
  float* lse_s = reinterpret_cast<float*>(gs + kTcStages * NQ * DVP);
  float* del_s = lse_s + kTcStages * NQ;      // [kTcStages][NQ] each
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(del_s + kTcStages * NQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kTcStages;

  const int hk = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int k0 = blockIdx.y * kKeys;
  const int k_last = min(k0 + kKeys, p.T) - 1;
  // the query rows that can see a key of this block
  int q_lo = p.causal ? k0 : 0, q_hi = p.S;
  if (p.window > 0 && (int64_t)k_last + p.window < q_hi)
    q_hi = k_last + p.window;
  q_lo = q_lo / NQ * NQ;
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + NQ - 1) / NQ : 0;
  const int n_it = p.G * n_qt;   // tile it: head hk G + it / n_qt

  // Stage it % kTcStages takes tile it: thread 0 copies q (and dO) by TMA;
  // the fillers, warp 0 (every thread when dO is staged by element), copy
  // the rows' lse and delta (zeros past S).
  const int fillers = p.tma_do ? 32 : kTcThreads;
  auto fill = [&](int it) {
    const int s = it % kTcStages;
    const int h = hk * p.G + it / n_qt;
    const int q0 = q_lo + (it % n_qt) * NQ;
    if (tid == 0) {
      hopper::mbar_expect_tx(&full[s], NQ * (DP + (p.tma_do ? DVP : 0)) * 2);
      for (int c = 0; c < kDC; ++c)
        hopper::tma_load_4d(qs + (s * kDC + c) * NQ * 64, &tm_q, &full[s],
                            64 * c, h, q0, b);
      if (p.tma_do)
        for (int c = 0; c < kVC; ++c)
          hopper::tma_load_4d(gs + (s * kVC + c) * NQ * 64, &tm_do, &full[s],
                              64 * c, h, q0, b);
    }
    const int64_t row = ((int64_t)b * p.H + h) * p.S;
    if (p.tma_do) {
      for (int i = tid; i < 2 * NQ; i += 32) {
        const int r = i % NQ;
        const bool ok = q0 + r < p.S;
        hopper::cp_async4((i < NQ ? lse_s : del_s) + s * NQ + r,
                          (i < NQ ? lse : delta) + row + (ok ? q0 + r : 0),
                          ok ? 4 : 0);
      }
      hopper::cp_async_mbar_arrive(&full[s]);
    } else {
      for (int i = tid; i < 2 * NQ; i += kTcThreads) {
        const int r = i % NQ;
        const float x = q0 + r < p.S ? (i < NQ ? lse : delta)[row + q0 + r]
                                     : 0.f;
        (i < NQ ? lse_s : del_s)[s * NQ + r] = x;
      }
      stage_dout<DVP>(gs + s * kVC * NQ * 64, NQ, dout, p, b, h, q0);
      hopper::mbar_arrive(&full[s]);
    }
  };

  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1 + fillers);
      hopper::mbar_init(&empty[s], kTcThreads);
    }
    hopper::mbar_init_fence();
    hopper::mbar_expect_tx(kv_full, kKeys * (DP + DVP) * 2);
    for (int c = 0; c < kDC; ++c)
      hopper::tma_load_4d(ks + c * kKeys * 64, &tm_k, kv_full, 64 * c, hk, k0,
                          b);
    for (int c = 0; c < kVC; ++c)
      hopper::tma_load_4d(vs + c * kKeys * 64, &tm_v, kv_full, 64 * c, hk, k0,
                          b);
  }
  __syncthreads();
  const bool filler = tid < fillers;
  if (filler)
    for (int it = 0; it < kTcStages && it < n_it; ++it) fill(it);

  // ---- both warpgroups: 64 keys each.  Accumulator layout of s^T (m64nNQ)
  // and of dk, dv (per 64 columns): element 4 j + 2 i + e is key row
  // kr + 8 i of the warpgroup, column 8 j + cq + e.
  const int wg = tid / 128, t = tid & 127, ln = t & 31;
  const int kr = 16 * (t / 32) + ln / 4, cq = 2 * (ln & 3);
  const int kw0 = k0 + 64 * wg;
  const int kw_last = min(kw0 + 64, p.T) - 1;
  const float sl2 = p.scale * kLog2e;

  float dka[kDC][32], dva[kVC][32];
#pragma unroll
  for (int n = 0; n < kDC; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < kVC; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) dva[n][e] = 0.f;
  float sc[NQ / 2], dp[NQ / 2];
  uint32_t ph[kQS][4], pl[kQS][4], dh[kQS][4], dl[kQS][4];

  hopper::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kTcStages;
    const int q0 = q_lo + (it % n_qt) * NQ;
    hopper::mbar_wait(&full[s], (it / kTcStages) & 1);
    const bool seen = kw0 < p.T && (!p.causal || q0 + NQ - 1 >= kw0) &&
                      (p.window == 0 || q0 - kw_last < p.window);
    if (seen) {
      const bf16* qt = qs + s * kDC * NQ * 64;
      const bf16* gt = gs + s * kVC * NQ * 64;
      const float* ls = lse_s + s * NQ;
      const float* ds = del_s + s * NQ;
      hopper::wgmma_fence();
      ss_product<NQ, kDC>(sc, ks, kKeys, 64 * wg, qt, NQ);
      hopper::wgmma_commit();
      ss_product<NQ, kVC>(dp, vs, kKeys, 64 * wg, gt, NQ);
      hopper::wgmma_commit();
      const bool no_mask = kw0 + 64 <= p.T && q0 + NQ <= p.S &&
                           (!p.causal || kw0 + 63 <= q0) &&
                           (p.window == 0 || q0 + NQ - 1 - kw0 < p.window);
      // kpos - qpos, queries left before S and keys left before T at this
      // thread's first element (key kr, query cq)
      const int dk = kw0 + kr - q0 - cq;
      const int q_left = p.S - q0 - cq, k_left = p.T - kw0 - kr;
      hopper::wgmma_wait<1>();   // s^T is done, dp^T may still run
      fence_regs(sc);
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
        const float nl[2] = {-lv.x * kLog2e, -lv.y * kLog2e};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = hopper::fast_exp2(fmaf(x, sl2, nl[e]));
            if (!no_mask) {
              const int d = dk + 8 * i - 8 * j - e;
              const bool ok = 8 * j + e < q_left && 8 * i < k_left &&
                              (!p.causal || d <= 0) &&
                              (p.window == 0 || d > -p.window);
              x = ok ? x : 0.f;
            }
          }
      }
      hopper::wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(ds + 8 * j + cq);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float* x = &dp[4 * j + 2 * i];
          x[0] = sc[4 * j + 2 * i] * (x[0] - dd.x);
          x[1] = sc[4 * j + 2 * i + 1] * (x[1] - dd.y);
        }
      }
      // dv's product runs while ds^T is split for dk's
      split_frags<NQ>(sc, ph, pl);
      fence_regs(dva);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQS; ++kk) {
        rs_product<kVC>(dva, ph[kk], gt, NQ, 16 * kk);
        rs_product<kVC>(dva, pl[kk], gt, NQ, 16 * kk);
      }
      hopper::wgmma_commit();
      split_frags<NQ>(dp, dh, dl);
      fence_regs(dka);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQS; ++kk) {
        rs_product<kDC>(dka, dh[kk], qt, NQ, 16 * kk);
        rs_product<kDC>(dka, dl[kk], qt, NQ, 16 * kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(dh);
      fence_regs(dl);
    }
    hopper::mbar_arrive(&empty[s]);
    if (filler && it + kTcStages < n_it) {
      hopper::mbar_wait(&empty[s], (it / kTcStages) & 1);
      fill(it + kTcStages);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = kw0 + kr + 8 * i;
    if (kpos >= p.T) continue;
    const int64_t at = ((int64_t)b * p.T + kpos) * p.Hk + hk;
    bf16* krow = dk + at * p.D;
    bf16* vrow = dv + at * p.Dv;
#pragma unroll
    for (int n = 0; n < kDC; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(krow, 64 * n + 8 * j + cq, dka[n][4 * j + 2 * i] * p.scale,
               dka[n][4 * j + 2 * i + 1] * p.scale, p.D);
#pragma unroll
    for (int n = 0; n < kVC; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(vrow, 64 * n + 8 * j + cq, dva[n][4 * j + 2 * i],
               dva[n][4 * j + 2 * i + 1], p.Dv);
  }
}

template <int DP, int DVP>
constexpr size_t dq_tc_smem_bytes() {
  return 1024 /* alignment slack */ +
         2 * ((size_t)kRows * (DP + DVP) +
              (size_t)kTcStages * kKvTile * (DP + DVP)) +
         8 * (1 + 2 * kTcStages);
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   const TcParams p) {
  constexpr int kDC = DP / 64, kVC = DVP / 64, kKS = kKvTile / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(base);   // [kDC][kRows][64]
  bf16* gs = qs + kRows * DP;                 // [kVC][kRows][64]  dO
  bf16* ks = gs + kRows * DVP;                // [kTcStages][kDC][kKvTile][64]
  bf16* vs = ks + kTcStages * kKvTile * DP;   // [kTcStages][kVC][kKvTile][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kTcStages * kKvTile * DVP);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kTcStages;

  const int h = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int hk = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // longest first
  const int q_last = min(q0 + kRows, p.S) - 1;
  // the keys the block's rows can see
  int lo = 0, hi = p.T;
  if (p.causal && q_last + 1 < hi) hi = q_last + 1;
  if (p.window > 0 && q0 - p.window + 1 > lo) lo = q0 - p.window + 1;
  const int first = lo / kKvTile;
  const int n_tiles = hi > lo ? (hi + kKvTile - 1) / kKvTile - first : 0;

  auto load_kv = [&](int it) {   // thread 0
    const int s = it % kTcStages;
    const int kt0 = (first + it) * kKvTile;
    hopper::mbar_expect_tx(&full[s], kKvTile * (DP + DVP) * 2);
    for (int c = 0; c < kDC; ++c)
      hopper::tma_load_4d(ks + (s * kDC + c) * kKvTile * 64, &tm_k, &full[s],
                          64 * c, hk, kt0, b);
    for (int c = 0; c < kVC; ++c)
      hopper::tma_load_4d(vs + (s * kVC + c) * kKvTile * 64, &tm_v, &full[s],
                          64 * c, hk, kt0, b);
  };
  if (tid == 0) {
    hopper::mbar_init(q_full, 1 + (p.tma_do ? 0 : kTcThreads));
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kTcThreads);
    }
    hopper::mbar_init_fence();
    hopper::mbar_expect_tx(q_full, kRows * (DP + (p.tma_do ? DVP : 0)) * 2);
    for (int c = 0; c < kDC; ++c)
      hopper::tma_load_4d(qs + c * kRows * 64, &tm_q, q_full, 64 * c, h, q0,
                          b);
    if (p.tma_do)
      for (int c = 0; c < kVC; ++c)
        hopper::tma_load_4d(gs + c * kRows * 64, &tm_do, q_full, 64 * c, h,
                            q0, b);
    for (int it = 0; it < kTcStages && it < n_tiles; ++it) load_kv(it);
  }
  __syncthreads();
  if (!p.tma_do) {
    stage_dout<DVP>(gs, kRows, dout, p, b, h, q0);
    hopper::mbar_arrive(q_full);
  }

  // ---- both warpgroups: 64 query rows each.  Accumulator layout of s
  // (m64n64) and of dq (per 64 columns): element 4 j + 2 i + e is row
  // rr + 8 i of the warpgroup, column 8 j + cq + e.
  const int wg = tid / 128, t = tid & 127, ln = t & 31;
  const int rr = 16 * (t / 32) + ln / 4, cq = 2 * (ln & 3);
  const int qw0 = q0 + 64 * wg;
  const int qw_last = min(qw0 + 64, p.S) - 1;
  const float sl2 = p.scale * kLog2e;
  float nl[2], dd[2];   // -lse log2e and delta of rows rr and rr + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qw0 + rr + 8 * i;
    const int64_t at = ((int64_t)b * p.H + h) * p.S + qpos;
    nl[i] = qpos < p.S ? -lse[at] * kLog2e : 0.f;
    dd[i] = qpos < p.S ? delta[at] : 0.f;
  }

  float dqa[kDC][32];
#pragma unroll
  for (int n = 0; n < kDC; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) dqa[n][e] = 0.f;
  float sc[32], dp[32];
  uint32_t dh[kKS][4], dl[kKS][4];

  hopper::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTcStages;
    const int kt0 = (first + it) * kKvTile;
    const int kt_last = min(kt0 + kKvTile, p.T) - 1;
    hopper::mbar_wait(&full[s], (it / kTcStages) & 1);
    const bool seen = qw0 < p.S && (!p.causal || kt0 <= qw_last) &&
                      (p.window == 0 || qw0 - kt_last < p.window);
    if (seen) {
      const bf16* kt = ks + s * kDC * kKvTile * 64;
      const bf16* vt = vs + s * kVC * kKvTile * 64;
      hopper::wgmma_fence();
      ss_product<64, kDC>(sc, qs, kRows, 64 * wg, kt, kKvTile);
      hopper::wgmma_commit();
      ss_product<64, kVC>(dp, gs, kRows, 64 * wg, vt, kKvTile);
      hopper::wgmma_commit();
      const bool no_mask = kt0 + kKvTile <= p.T &&
                           (!p.causal || kt0 + kKvTile - 1 <= qw0) &&
                           (p.window == 0 || qw0 + 63 - kt0 < p.window);
      // kpos - qpos and keys left before T at this thread's first element
      // (row rr, key cq)
      const int dk = kt0 + cq - qw0 - rr, k_left = p.T - kt0 - cq;
      hopper::wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = hopper::fast_exp2(fmaf(x, sl2, nl[i]));
            if (!no_mask) {
              const int d = dk + 8 * j + e - 8 * i;
              const bool ok = 8 * j + e < k_left && (!p.causal || d <= 0) &&
                              (p.window == 0 || d > -p.window);
              x = ok ? x : 0.f;
            }
          }
      hopper::wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = sc[e] * (dp[e] - dd[(e >> 1) & 1]);
      split_frags<64>(dp, dh, dl);
      fence_regs(dqa);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        rs_product<kDC>(dqa, dh[kk], kt, kKvTile, 16 * kk);
        rs_product<kDC>(dqa, dl[kk], kt, kKvTile, 16 * kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_regs(dqa);
      fence_regs(dh);
      fence_regs(dl);
    }
    hopper::mbar_arrive(&empty[s]);
    if (tid == 0 && it + kTcStages < n_tiles) {
      hopper::mbar_wait(&empty[s], (it / kTcStages) & 1);
      load_kv(it + kTcStages);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qw0 + rr + 8 * i;
    if (qpos >= p.S) continue;
    bf16* qrow = dq + (((int64_t)b * p.S + qpos) * p.H + h) * p.D;
#pragma unroll
    for (int n = 0; n < kDC; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(qrow, 64 * n + 8 * j + cq, dqa[n][4 * j + 2 * i] * p.scale,
               dqa[n][4 * j + 2 * i + 1] * p.scale, p.D);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int DP, int DVP, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, const Params& p, cudaStream_t stream) {
  static_assert(dkdv_smem_bytes<DP, DVP, BQ, BK>() <= kSmemMax, "smem");
  static_assert(dq_smem_bytes<DP, DVP, BQ, BK>() <= kSmemMax, "smem");
  if (dk != nullptr) {
    auto kernel = flash_bwd_dkdv<T, DP, DVP, BQ, BK>;
    constexpr size_t smem = dkdv_smem_bytes<DP, DVP, BQ, BK>();
    static bool configured[kMaxDevices] = {};
    int err = allow_smem(kernel, smem, configured);
    if (err != 0) return err;
    const dim3 grid((unsigned)p.Hk, (unsigned)((p.T + BK - 1) / BK),
                    (unsigned)p.B);
    kernel<<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, p);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (dq != nullptr) {
    auto kernel = flash_bwd_dq<T, DP, DVP, BQ, BK>;
    constexpr size_t smem = dq_smem_bytes<DP, DVP, BQ, BK>();
    static bool configured[kMaxDevices] = {};
    int err = allow_smem(kernel, smem, configured);
    if (err != 0) return err;
    const dim3 grid((unsigned)p.H, (unsigned)((p.S + BQ - 1) / BQ),
                    (unsigned)p.B);
    kernel<<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dq, p);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// The tensor-core instance (DP, DVP) with query tiles of NQ rows in dk/dv:
// tensor maps encoded per call (q, k, v must take TMA; dO where it can,
// else it is staged by element), dk/dv then dq.
template <int DP, int DVP, int NQ>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, const Params& p, cudaStream_t stream) {
  static_assert(dkdv_tc_smem_bytes<DP, DVP, NQ>() <= kSmemMax, "smem");
  static_assert(dq_tc_smem_bytes<DP, DVP>() <= kSmemMax, "smem");
  const int64_t q_shape[4] = {p.B, p.S, p.H, p.D};
  const int64_t k_shape[4] = {p.B, p.T, p.Hk, p.D};
  const int64_t v_shape[4] = {p.B, p.T, p.Hk, p.Dv};
  const int64_t g_shape[4] = {p.B, p.S, p.H, p.Dv};
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  // maps with boxes of q_rows query rows and kv_rows keys; false when q, k
  // or v cannot take TMA
  auto maps = [&](CUtensorMap* tm, int q_rows, int kv_rows, TcParams* tp) {
    tp->tma_do = hopper::encode_map(&tm[3], kBf16, 2, 64, kSw, dout, g_shape,
                                    p.gs, q_rows);
    return hopper::encode_map(&tm[0], kBf16, 2, 64, kSw, q, q_shape, p.qs,
                              q_rows) &&
           hopper::encode_map(&tm[1], kBf16, 2, 64, kSw, k, k_shape, p.ks,
                              kv_rows) &&
           hopper::encode_map(&tm[2], kBf16, 2, 64, kSw, v, v_shape, p.vs,
                              kv_rows);
  };
  TcParams tp;
  tp.S = (int)p.S;
  tp.T = (int)p.T;
  tp.H = (int)p.H;
  tp.Hk = (int)p.Hk;
  tp.G = (int)p.G;
  for (int i = 0; i < 4; ++i) tp.gs[i] = p.gs[i];
  tp.D = p.D;
  tp.Dv = p.Dv;
  tp.causal = p.causal;
  tp.window = p.window;
  tp.scale = p.scale;
  if (dk != nullptr) {
    CUtensorMap tm[4] = {};
    if (!maps(tm, NQ, kKeys, &tp)) return (int)cudaErrorInvalidValue;
    auto kernel = flash_bwd_dkdv_wgmma<DP, DVP, NQ>;
    constexpr size_t smem = dkdv_tc_smem_bytes<DP, DVP, NQ>();
    static bool configured[kMaxDevices] = {};
    int err = allow_smem(kernel, smem, configured);
    if (err != 0) return err;
    const dim3 grid((unsigned)p.Hk, (unsigned)((p.T + kKeys - 1) / kKeys),
                    (unsigned)p.B);
    kernel<<<grid, kTcThreads, smem, stream>>>(
        tm[0], tm[1], tm[2], tm[3], (const bf16*)dout, lse, delta, (bf16*)dk,
        (bf16*)dv, tp);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (dq != nullptr) {
    CUtensorMap tm[4] = {};
    if (!maps(tm, kRows, kKvTile, &tp)) return (int)cudaErrorInvalidValue;
    auto kernel = flash_bwd_dq_wgmma<DP, DVP>;
    constexpr size_t smem = dq_tc_smem_bytes<DP, DVP>();
    static bool configured[kMaxDevices] = {};
    int err = allow_smem(kernel, smem, configured);
    if (err != 0) return err;
    const dim3 grid((unsigned)p.H, (unsigned)((p.S + kRows - 1) / kRows),
                    (unsigned)p.B);
    kernel<<<grid, kTcThreads, smem, stream>>>(
        tm[0], tm[1], tm[2], tm[3], (const bf16*)dout, lse, delta, (bf16*)dq,
        tp);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// delta, then the instance for (D, Dv): bf16 up to (192, 128) on the tensor
// cores, float32 and (256, 256) on FFMA.
template <typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* delta, void* dq, void* dk,
        void* dv, const Params& p, cudaStream_t stream) {
  const int64_t rows = p.B * p.H * p.S;
  const int64_t blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  flash_bwd_dot<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, p);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.D <= 64 && p.Dv <= 64)
      return launch_tc<64, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, p,
                                   stream);
    if (p.D <= 128 && p.Dv <= 128)
      return launch_tc<128, 128, 48>(q, k, v, dout, lse, delta, dq, dk, dv, p,
                                     stream);
    if (p.D <= 192 && p.Dv <= 128)
      return launch_tc<192, 128, 32>(q, k, v, dout, lse, delta, dq, dk, dv, p,
                                     stream);
  } else {
    if (p.D <= 64 && p.Dv <= 64)
      return launch<T, 64, 64, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       p, stream);
    if (p.D <= 128 && p.Dv <= 128)
      return launch<T, 128, 128, 64, 64>(q, k, v, dout, lse, delta, dq, dk,
                                         dv, p, stream);
    if (p.D <= 192 && p.Dv <= 128)
      return launch<T, 192, 128, 64, 64>(q, k, v, dout, lse, delta, dq, dk,
                                         dv, p, stream);
  }
  return launch<T, 256, 256, 32, 32>(q, k, v, dout, lse, delta, dq, dk, dv, p,
                                     stream);
}

}  // namespace

// dims: B, S, T, H, Hk, D, Dv.  strides: the four element strides of q,
// k, v, O and dO, in that order (bf16 up to (192, 128): q, k and v as TMA
// reads them).  lse: float32 (B, H, S) from the forward;
// delta: float32 (B, H, S) scratch.  dq (B, S, H, D), dk (B, T, Hk, D) and
// dv (B, T, Hk, Dv) are written contiguous in the operands' dtype; dq may
// be null (its kernel is not launched), dk and dv both null or neither.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int bf16, const int64_t* dims, const int64_t* strides,
    int causal, int window, float scale, void* stream) {
  Params p;
  p.B = dims[0];
  p.S = dims[1];
  p.T = dims[2];
  p.H = dims[3];
  p.Hk = dims[4];
  p.D = (int)dims[5];
  p.Dv = (int)dims[6];
  if (p.B < 1 || p.S < 1 || p.T < 1 || p.Hk < 1 || p.H % p.Hk != 0 ||
      p.D < 1 || p.D > kMaxDim || p.Dv < 1 || p.Dv > kMaxDim || window < 0 ||
      p.B > 65535 || p.H > 65535 || p.S >= INT32_MAX || p.T >= INT32_MAX ||
      (p.S + 31) / 32 > 65535 || (p.T + 31) / 32 > 65535 ||
      (dk == nullptr) != (dv == nullptr) ||
      (window > 0 && p.S > p.T - 1 + window))   // a row that sees no key
    return (int)cudaErrorInvalidValue;
  p.G = p.H / p.Hk;
  for (int i = 0; i < 4; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[4 + i];
    p.vs[i] = strides[8 + i];
    p.os[i] = strides[12 + i];
    p.gs[i] = strides[16 + i];
  }
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? run<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   p, st)
              : run<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, st);
}
