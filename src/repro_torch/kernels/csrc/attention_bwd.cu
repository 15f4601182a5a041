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
//                   on; window: up to its last key + window - 1; every row
//                   when some row sees no key).  Per query tile it loads
//                   q, dO, lse and delta, recomputes s = q.k^T and
//                   dp = dO.v^T, forms p and ds = p (dp - delta) on visible
//                   pairs, and accumulates dv += p^T.dO and dk += ds^T.q in
//                   registers; dk is scaled once at the end.  The sum over a
//                   group's query heads stays in the block: no atomics.
//   flash_bwd_dq    one block per (query head, query tile, batch): q, dO,
//                   lse and delta stay in shared memory while the block
//                   walks the key tiles its rows can see, recomputing s,
//                   dp and ds, and accumulates dq += ds.k; scaled at the
//                   end.
//
// Masks: those of the forward (kpos <= qpos when causal, kpos > qpos -
// window when window > 0, keys past T absent).  Masked pairs carry no
// gradient, as under autograd through the plain forward's where(ok, s,
// -1e30).  A row that sees no key at all (window > 0 and qpos >= T - 1 +
// window) got p = 1 on each of its T keys in the forward (all scores equal
// the sentinel), so out = mean(v): its p is 1 / T on every key for dv, and
// it gives nothing to dq or dk.
//
// Numbers: every product is one FFMA in float32 on the SIMT units; bf16
// operands are read as bf16 and widened (exact), p stays float32 in every
// product, exponentials are full-precision expf.  dq, dk and dv are written
// once, in q's dtype, contiguous (B, S, H, D), (B, T, Hk, D), (B, T, Hk, Dv).
// No float atomics anywhere, so the same inputs give the same bits.
//
// Operands: q, k, v, O and dO through their four element strides each (any
// strides, a gradient autograd hands over non-contiguous included: nothing
// is copied), lse contiguous.  D and Dv up to 256 and not necessarily
// equal: the instance is the smallest of (64, 64), (128, 128), (192, 128),
// (256, 256) that holds both, columns past D or Dv zero in shared memory.
//
// Bound: operations.  The work is 2 D (s) + 2 Dv (dp) + 2 Dv (dv) + 2 D (dk)
// + 2 D (dq) = 6 D + 4 Dv FLOPs per visible (q, k) pair; the kernels do
// 8 D + 6 Dv (s and dp are recomputed in both).  At Qwen3-0.6B's train
// layer (q [1, 4096, 16, 128], k/v 8 heads, causal) that is 1.72e11 FLOPs,
// 0.174 ms at the bf16 tensor-core rate and 2.56 ms at the float32 FFMA
// rate (67 TFLOP/s).  This first version runs on FFMA: tiles of 64 rows by
// 64 keys (32 by 32 at D = 256) in shared memory, each thread a register
// tile of 4 x 4 scores and 4 keys (rows) x D/16 gradient columns; a
// tensor-core version (mma.sync / wgmma) is later work.
//
// Plain C entry point, loaded with ctypes; it returns the first
// cudaGetLastError() after a launch, or a cudaError_t for operands it
// cannot take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 256;
constexpr int kMaxDevices = 64;
constexpr size_t kSmemMax = 232448;   // what one block may use on sm_90

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
  float scale, inv_t;
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
  const bool in = qpos < p.S && kpos < p.T;
  const bool ok = in && (!p.causal || kpos <= qpos) &&
                  (p.window == 0 || kpos > qpos - p.window);
  const bool dead = in && p.window > 0 && qpos >= p.T - 1 + p.window;
  const float pv = ok ? expf(s * p.scale - lse) : (dead ? p.inv_t : 0.f);
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
  if (p.window > 0 && p.S > p.T - 1 + p.window) q_hi = p.S;   // rows seeing
                                                               // no key
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

  // the keys the tile's rows can see (rows that see none get no dq)
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
// host side
// ---------------------------------------------------------------------------

// Allows `bytes` of dynamic shared memory for `kernel`, once per device, so
// that no attribute is set while a CUDA graph is being captured.
template <typename K>
int allow_smem(K kernel, size_t bytes, bool* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  return 0;
}

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
  if (p.D <= 64 && p.Dv <= 64)
    return launch<T, 64, 64, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, p,
                                     stream);
  if (p.D <= 128 && p.Dv <= 128)
    return launch<T, 128, 128, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       p, stream);
  if (p.D <= 192 && p.Dv <= 128)
    return launch<T, 192, 128, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       p, stream);
  return launch<T, 256, 256, 32, 32>(q, k, v, dout, lse, delta, dq, dk, dv, p,
                                     stream);
}

}  // namespace

// dims: B, S, T, H, Hk, D, Dv.  strides: the four element strides of q,
// k, v, O and dO, in that order.  lse: float32 (B, H, S) from the forward;
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
      (dk == nullptr) != (dv == nullptr))
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
  p.inv_t = 1.f / (float)p.T;
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? run<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   p, st)
              : run<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, st);
}
