// Flash attention forward for Hopper (sm_90a): causal / sliding-window
// grouped-query attention with an online softmax.
//
// Both kernels replace the reference's Pallas kernel
// kernels/flash_attention.py::_flash_kernel (launched by flash_attention).
// They compute what that kernel computes: scores (q.k) * scale in float32,
// the mask kpos <= qpos (causal) and kpos > qpos - window (window > 0) with
// the sentinel -1e30, a running (max, sum, acc) in float32 over KV tiles,
// p.v with p kept to float32 precision (the TPU kernel casts v to float32),
// and out = acc / max(l, 1e-30) in q's dtype.  Query and key positions are
// the row indices (both start at 0).  Keys past T carry no weight (-inf).
// Query head h reads KV head h / (H / Hk); KV heads are never repeated.
//
// Layout: q (B, S, H, D), k (B, T, Hk, D), v (B, T, Hk, Dv), read through
// their element strides (no transposed copies); the output is a contiguous
// (B, S, H, Dv).  D and Dv are at most 256 and need not be equal.  S and T
// need not be multiples of any tile.
//
// Bound: operations.  Each visible (q, k) pair costs 2 D + 2 Dv FLOPs; at
// the 32k prefill (B 2, S = T 32768, H 16, D = Dv 128, causal) that is
// 8.8e12 FLOPs, 8.9 ms at the bf16 tensor-core rate (989 TFLOP/s), against
// 0.8 GB of q, k, v and o (0.24 ms).
//
// bfloat16: flash_fwd_wgmma, on the tensor cores.
//   * One block of 256 threads per (query head, 128-row query tile, batch):
//     two consumer warpgroups of 64 query rows each.  Block x runs over the
//     heads, so the G query heads of one KV head are neighbours and share
//     its K/V tiles in L2; query tiles go longest first.  No producer warp:
//     wgmma kernels are given registers per warpgroup, so a ninth warp
//     would cut every thread to 168 registers and spill; with 256 threads
//     each has up to 255.  Thread 0 issues the TMA copies between its own
//     products instead.
//   * TMA copies the q tile once and K/V tiles of 128 keys (64 at D = 256)
//     into a ring of 2 stages.  K and V each have a "full" mbarrier (TMA
//     bytes) and an "empty" one (all 256 threads arrive): K tile it + 2 is
//     requested once both warpgroups' q.k of tile it is done, V tile it + 1
//     once their p.v of tile it - 1 is, so copies run a tile or more ahead
//     of the products.  Tiles are 64 columns wide with the 128-byte swizzle;
//     TMA zero-fills rows past S or T and columns past D or Dv.  Instances
//     pad D / Dv to 64/64, 128/128, 192/128 and 256/256.
//   * s = q.k^T is wgmma m64n128k16 (m64n64k16 for a 64-key tile) from
//     shared memory; bf16 x bf16 products are exact in float32, as the TPU's
//     q.astype(f32) . k.astype(f32).
//   * p.v: p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi) (about
//     16 significant bits) and both multiply bf16 v (exact in float32) with
//     float32 accumulation: wgmma m64n128k16 with A from registers, B (v)
//     MN-major.  That is 1.5x the reference's FLOPs (13.3 ms at the bf16
//     rate at the 32k prefill); l is summed from the float32 p.
//   * Software pipeline in each warpgroup: q.k of tile it is issued, then
//     p.v of tile it - 1 behind it; the softmax of tile it runs on the SIMT
//     units while that p.v is on the tensor cores.  p alternates between two
//     register buffers (the loop is unrolled by 2), so the softmax never
//     writes registers an in-flight product reads.
//   * Softmax: exponentials as 2^x on the special-function unit; tiles with
//     no masked entry take a path without mask arithmetic and fold the scale
//     into one fma per score.
//   * KV tiles wholly above the causal diagonal or wholly below the window
//     are skipped, which halves the causal work and leaves the result as it
//     was (their entries would add exp(-1e30 - m) = 0); when a tile has a
//     row that sees no key at all, every tile is visited, as on the TPU.
//   * Tensor maps are encoded per call on the host (cuTensorMapEncodeTiled
//     through cudaGetDriverEntryPoint, so no -lcuda) and passed as
//     __grid_constant__ parameters; nothing is set while a graph captures.
//
// float32: flash_fwd_simt, on the float32 SIMT units (67 TFLOP/s), 131 ms
// at the 32k shape; no path of the bf16 prefill reaches it.
//   * one block of 256 threads per (batch, query head, 64-row query tile);
//     the q tile and one 64-key K and V tile at a time sit in shared memory;
//     the probability tile reuses the K tile's space;
//   * each thread owns rows ty + 16 i (i < 4): scores for keys tx + 16 j
//     (j < 4) and the accumulator for value columns 64 c + 4 tx + e;
//   * inner products read shared memory as float4; the tile skipping and
//     the longest-first order are those of the bf16 kernel.
//
// Plain C entry point, loaded with ctypes; it returns cudaGetLastError()
// right after the launch, or a cudaError_t for operands it cannot take.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;     // the reference's masking sentinel
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error under 2^-22; results
// below 2^-126 flush to 0, far under a row sum of at least 1).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Allows `bytes` of dynamic shared memory for `kernel`, once per device
// (`configured` is the caller's, one array per kernel), so that no attribute
// is set while a CUDA graph is being captured.
constexpr int kMaxDevices = 64;

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

// The KV positions [lo, hi) a query tile of rows [q0, q_last] must visit.
// Keys above the causal diagonal of its last row, or at or below
// q0 - window, are masked for every row; when some row sees no key at all
// (window > 0 and q_last >= T - 1 + window) every key is visited.
__device__ __forceinline__ void kv_range(int64_t q0, int64_t q_last,
                                         int64_t T, int causal, int window,
                                         int64_t* lo, int64_t* hi) {
  *lo = 0;
  *hi = T;
  if (window > 0 && q_last >= T - 1 + window) return;
  if (causal && q_last + 1 < *hi) *hi = q_last + 1;
  if (window > 0 && q0 - window + 1 > *lo) *lo = q0 - window + 1;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128;              // query rows per block
constexpr int kStages = 2;            // K/V ring depth
constexpr int kTcThreads = 256;       // 2 consumer warpgroups

struct TcParams {
  int64_t S, T, H, G;                 // G = H / Hk
  int Dv, causal, window;
  float scale;
};

template <int DP, int DVP, int BN>
constexpr size_t tc_smem_bytes() {
  return 1024 /* alignment slack */ + 2 * ((size_t)kBM * DP +
                                           (size_t)kStages * BN * (DP + DVP)) +
         8 * (1 + 4 * kStages);
}

template <int DP, int DVP, int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, const TcParams p) {
  using bf16 = __nv_bfloat16;
  using PTile = uint32_t[BN / 16][4];
  constexpr int kDC = DP / 64, kVC = DVP / 64, kNC = BN / 64, kKS = BN / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(base);     // [kDC][kBM][64]
  bf16* ks = qs + kBM * DP;                     // [kStages][kDC][BN][64]
  bf16* vs = ks + kStages * BN * DP;            // [kStages][kVC][BN][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * BN * DVP);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = (int)(h / p.G);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBM;
  const int64_t q_last = (q0 + kBM < p.S ? q0 + kBM : p.S) - 1;
  int64_t lo, hi;
  kv_range(q0, q_last, p.T, p.causal, p.window, &lo, &hi);
  const int64_t first = lo / BN;
  const int n_tiles = (int)((hi + BN - 1) / BN - first);

  // Thread 0 issues every TMA copy.  K tile it goes into stage
  // it % kStages once both warpgroups' q.k of tile it - kStages is done,
  // V tile it once their p.v of tile it - kStages is done.
  const bool leader = threadIdx.x == 0;
  auto load_k = [&](int it) {
    const int s = it % kStages;
    hopper::mbar_expect_tx(&k_full[s], BN * DP * 2);
    for (int c = 0; c < kDC; ++c)
      hopper::tma_load_4d(ks + (s * kDC + c) * BN * 64, &tm_k, &k_full[s],
                          64 * c, hk, (int)((first + it) * BN), b);
  };
  auto load_v = [&](int it) {
    const int s = it % kStages;
    hopper::mbar_expect_tx(&v_full[s], BN * DVP * 2);
    for (int c = 0; c < kVC; ++c)
      hopper::tma_load_4d(vs + (s * kVC + c) * BN * 64, &tm_v, &v_full[s],
                          64 * c, hk, (int)((first + it) * BN), b);
  };
  if (leader) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], kTcThreads);
      hopper::mbar_init(&v_empty[s], kTcThreads);
    }
    hopper::mbar_init_fence();
    hopper::mbar_expect_tx(q_full, kBM * DP * 2);
    for (int c = 0; c < kDC; ++c)
      hopper::tma_load_4d(qs + c * kBM * 64, &tm_q, q_full, 64 * c, h,
                          (int)q0, b);
    for (int it = 0; it < kStages && it < n_tiles; ++it) {
      load_k(it);
      load_v(it);
    }
  }
  __syncthreads();

  // ---- both warpgroups: 64 query rows each
  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x & 127, lane = t & 31;
  const int64_t row_lo = q0 + 64 * cw;            // this warpgroup's rows
  const int64_t qrow = row_lo + 16 * (t / 32) + lane / 4;   // and qrow + 8
  const int cq = 2 * (lane & 3);   // column of this thread in an n8 block
  const bf16* qw = qs + 64 * cw * 64;

  // Accumulator layout of m64nN: element 4 j + 2 i + e of a 64-column
  // slice is row qrow + 8 i, column 8 j + cq + e.
  float acc[kVC][32];
#pragma unroll
  for (int n = 0; n < kVC; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float sc[kNC][32];
  // p of a tile split into bf16 hi and lo parts, in the A-operand layout:
  // slice kk (keys 16 kk ..) is n8 blocks 2 kk and 2 kk + 1 of the scores.
  // Two buffers: one is read by the p.v in flight while the softmax of the
  // next tile writes the other.
  PTile pa_hi, pa_lo, pb_hi, pb_lo;

  // sc = q . k^T for the tile in stage s (issued, not waited for)
  auto issue_qk = [&](int s) {
    const bf16* kt = ks + s * kDC * BN * 64;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = hopper::desc_sw128(
          qw + (kk / 4) * kBM * 64 + (kk % 4) * 16, 16, 1024);
      // keys in slices of 128 (one m64n128k16), then of 64
#pragma unroll
      for (int j = 0; j < kNC; j += (kNC - j >= 2 ? 2 : 1)) {
        const uint64_t db = hopper::desc_sw128(
            kt + (kk / 4) * BN * 64 + j * 64 * 64 + (kk % 4) * 16, 16, 1024);
        if (kNC - j >= 2)
          hopper::wgmma_ss_m64n128k16(
              *reinterpret_cast<float(*)[64]>(&sc[j][0]), da, db, kk > 0);
        else
          hopper::wgmma_ss_m64n64k16(sc[j], da, db, kk > 0);
      }
    }
    hopper::wgmma_commit();
  };
  // acc += p_hi . v + p_lo . v for the tile in stage s (issued)
  auto issue_pv = [&](int s, PTile& ph, PTile& pl) {
    const bf16* vt = vs + s * kVC * BN * 64;
#pragma unroll
    for (int n = 0; n < kVC; ++n)
#pragma unroll
      for (int e = 0; e < 32; ++e) hopper::reg_fence(acc[n][e]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
      // value columns in slices of 128, then of 64
#pragma unroll
      for (int n = 0; n < kVC; n += (kVC - n >= 2 ? 2 : 1)) {
        const uint64_t dv = hopper::desc_sw128(
            vt + n * BN * 64 + kk * 16 * 64, BN * 128, 1024);
        if (kVC - n >= 2) {
          float(&d)[64] = *reinterpret_cast<float(*)[64]>(&acc[n][0]);
          hopper::wgmma_rs_m64n128k16_mn(d, ph[kk], dv);
          hopper::wgmma_rs_m64n128k16_mn(d, pl[kk], dv);
        } else {
          hopper::wgmma_rs_m64n64k16_mn(acc[n], ph[kk], dv);
          hopper::wgmma_rs_m64n64k16_mn(acc[n], pl[kk], dv);
        }
      }
    hopper::wgmma_commit();
  };
  // after the p.v reading (ph, pl) into acc is waited for
  auto fence_pv = [&](PTile& ph, PTile& pl) {
#pragma unroll
    for (int n = 0; n < kVC; ++n)
#pragma unroll
      for (int e = 0; e < 32; ++e) hopper::reg_fence(acc[n][e]);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hopper::reg_fence(ph[kk][r]);
        hopper::reg_fence(pl[kk][r]);
      }
  };
  // scale and mask sc (keys from k0), the online softmax of rows qrow and
  // qrow + 8: new m, corr, l, and p in float32 split into (ph, pl)
  auto softmax = [&](int64_t k0, PTile& ph, PTile& pl) {
#pragma unroll
    for (int j = 0; j < kNC; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) hopper::reg_fence(sc[j][e]);
    const bool no_mask =
        k0 + BN <= p.T && (!p.causal || k0 + BN - 1 <= row_lo) &&
        (p.window == 0 || k0 > row_lo + 63 - p.window);
    // Row maxima in 4 partial chains per row (shorter dependences).  A tile
    // that needs no mask keeps its raw scores: the scale is applied to the
    // maximum (rounding is monotone, so that is the maximum of the scaled
    // scores) and inside the exponent, fma(s, scale, -m).  A masked tile is
    // scaled and masked first; its exponent is fma(x, 1, -m) = x - m, which
    // is exactly 0 where x and m are both the -1e30 sentinel.
    float mx[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) mx[i][u] = -INFINITY;
    if (no_mask) {
#pragma unroll
      for (int j = 0; j < kNC; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          float& mp = mx[(e >> 1) & 1][(e >> 2) & 3];
          mp = fmaxf(mp, sc[j][e]);
        }
    } else {
      // key - query position and keys left before T, at this thread's
      // first element (32-bit: S and T are below 2^31)
      const int dk = (int)(k0 + cq - qrow);
      const int64_t left = p.T - (k0 + cq);
#pragma unroll
      for (int j = 0; j < kNC; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int col = 64 * j + 8 * (e >> 2) + (e & 1);
          const int d = dk + col - 8 * i;            // kpos - qpos
          const bool ok = (!p.causal || d <= 0) &&
                          (p.window == 0 || d > -p.window);
          const float x = col >= left ? -INFINITY
                                      : (ok ? sc[j][e] * p.scale : kNegInf);
          sc[j][e] = x;
          mx[i][(e >> 2) & 3] = fmaxf(mx[i][(e >> 2) & 3], x);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float r = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
      const float m_new = fmaxf(m[i], no_mask ? r * p.scale : r);
      corr[i] = fast_exp2((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= corr[i];   // this thread's part of the row sum
    }
    const float sx = no_mask ? p.scale : 1.f;
    float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // partial row sums
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = kk / 4;
        const int e0 = 4 * (2 * (kk % 4) + (r >> 1)) + 2 * (r & 1);
        const int i = r & 1;
        const float a = fast_exp2(fmaf(sc[j][e0], sx, -m[i]) * kLog2e);
        const float c = fast_exp2(fmaf(sc[j][e0 + 1], sx, -m[i]) * kLog2e);
        ls[i][kk & 1] += a + c;
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(a, c);
        const float2 back = __bfloat1622float2(hi2);
        const __nv_bfloat162 lo2 =
            __floats2bfloat162_rn(a - back.x, c - back.y);
        ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi2);
        pl[kk][r] = *reinterpret_cast<const uint32_t*>(&lo2);
      }
    l[0] += ls[0][0] + ls[0][1];
    l[1] += ls[1][0] + ls[1][1];
  };

  // Software pipeline, step it >= 1: q.k of tile it runs on the tensor
  // cores with the p.v of tile it - 1 queued behind it; the softmax of tile
  // it runs while that p.v is in flight; then acc is rescaled.
  auto step = [&](int it, PTile& cur_hi, PTile& cur_lo, PTile& nxt_hi,
                  PTile& nxt_lo) {
    const int s = it % kStages, sp = (it - 1) % kStages;
    hopper::mbar_wait(&k_full[s], (it / kStages) & 1);
    issue_qk(s);
    hopper::mbar_wait(&v_full[sp], ((it - 1) / kStages) & 1);
    issue_pv(sp, cur_hi, cur_lo);
    hopper::wgmma_wait<1>();           // q.k of tile it is done
    hopper::mbar_arrive(&k_empty[s]);
    if (leader && it + kStages < n_tiles) {
      hopper::mbar_wait(&k_empty[s], (it / kStages) & 1);
      load_k(it + kStages);
    }
    softmax((first + it) * BN, nxt_hi, nxt_lo);
    hopper::wgmma_wait<0>();           // p.v of tile it - 1 is done
    fence_pv(cur_hi, cur_lo);
    hopper::mbar_arrive(&v_empty[sp]);
    if (leader && it - 1 + kStages < n_tiles) {
      hopper::mbar_wait(&v_empty[sp], ((it - 1) / kStages) & 1);
      load_v(it - 1 + kStages);
    }
#pragma unroll
    for (int n = 0; n < kVC; ++n)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[n][e] *= corr[(e >> 1) & 1];
  };
  auto last_pv = [&](PTile& ph, PTile& pl) {
    const int sp = (n_tiles - 1) % kStages;
    hopper::mbar_wait(&v_full[sp], ((n_tiles - 1) / kStages) & 1);
    issue_pv(sp, ph, pl);
    hopper::wgmma_wait<0>();
    fence_pv(ph, pl);
  };

  hopper::mbar_wait(q_full, 0);
  hopper::mbar_wait(&k_full[0], 0);
  issue_qk(0);
  hopper::wgmma_wait<0>();
  hopper::mbar_arrive(&k_empty[0]);
  if (leader && kStages < n_tiles) {
    hopper::mbar_wait(&k_empty[0], 0);
    load_k(kStages);
  }
  softmax(first * BN, pa_hi, pa_lo);
  int it = 1;
  for (; it + 1 < n_tiles; it += 2) {   // the two p buffers take turns
    step(it, pa_hi, pa_lo, pb_hi, pb_lo);
    step(it + 1, pb_hi, pb_lo, pa_hi, pa_lo);
  }
  if (it < n_tiles) {
    step(it, pa_hi, pa_lo, pb_hi, pb_lo);
    last_pv(pb_hi, pb_lo);
  } else {
    last_pv(pa_hi, pa_lo);
  }

  // out = acc / max(l, 1e-30), rounded once to bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int64_t qpos = qrow + 8 * i;
    if (qpos >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* orow = o + ((b * p.S + qpos) * p.H + h) * (int64_t)p.Dv;
#pragma unroll
    for (int n = 0; n < kVC; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * n + 8 * j + cq;
        const float a = acc[n][4 * j + 2 * i] / denom;
        const float c = acc[n][4 * j + 2 * i + 1] / denom;
        if (col + 1 < p.Dv && (p.Dv & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(&orow[col]) =
              __floats2bfloat162_rn(a, c);
        } else {
          if (col < p.Dv) orow[col] = __float2bfloat16_rn(a);
          if (col + 1 < p.Dv) orow[col + 1] = __float2bfloat16_rn(c);
        }
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-d map over a (B, R, Hx, Dx) bf16 tensor with element strides st
// (st[3] == 1): boxes of 64 columns x 1 head x `rows` rows x 1 batch,
// 128-byte swizzled, zeros past every edge.
bool encode_map(CUtensorMap* map, const void* ptr, const int64_t* shape,
                const int64_t* st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || st[3] != 1 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return false;
  const cuuint64_t gdim[4] = {(cuuint64_t)shape[3], (cuuint64_t)shape[2],
                              (cuuint64_t)shape[1], (cuuint64_t)shape[0]};
  cuuint64_t gstride[3];
  for (int i = 0; i < 3; ++i) {
    if (st[2 - i] <= 0 || (st[2 - i] * 2) % 16 != 0) return false;
    gstride[i] = (cuuint64_t)st[2 - i] * 2;
  }
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int DVP, int BN>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const int64_t* dims, const int64_t* strides, int causal,
                 int window, float scale, cudaStream_t stream) {
  const int64_t B = dims[0], S = dims[1], T = dims[2], H = dims[3],
                Hk = dims[4];
  const int64_t q_shape[4] = {B, S, H, dims[5]};
  const int64_t k_shape[4] = {B, T, Hk, dims[5]};
  const int64_t v_shape[4] = {B, T, Hk, dims[6]};
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, q_shape, strides, kBM) ||
      !encode_map(&tk, k, k_shape, strides + 4, BN) ||
      !encode_map(&tv, v, v_shape, strides + 8, BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma<DP, DVP, BN>;
  constexpr size_t smem = tc_smem_bytes<DP, DVP, BN>();
  static bool configured[kMaxDevices] = {};
  const int err = allow_smem(kernel, smem, configured);
  if (err != 0) return err;
  TcParams p;
  p.S = S;
  p.T = T;
  p.H = H;
  p.G = H / Hk;
  p.Dv = (int)dims[6];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const dim3 grid((unsigned)H, (unsigned)((S + kBM - 1) / kBM), (unsigned)B);
  kernel<<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, (__nv_bfloat16*)o,
                                             p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: SIMT
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per KV tile
constexpr int kThreads = 256;         // 16 x 16: tx = key / column, ty = row
constexpr int kPStride = kBK + 16;    // probability tile pitch (floats)

struct Params {
  int64_t S, T, H, Hk;
  int64_t qs[4], ks[4], vs[4];        // element strides
  int D, Dv;
  int dp;                             // q / k tile pitch in floats
  int causal, window;
  float scale;
};

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// Copies rows [r0, r0 + 64) of a (rows, cols) slice with element strides
// (row_stride, col_stride) into a float tile of pitch `pitch`, zero-filling
// rows >= n_rows and columns in [cols, pad_cols).  One warp per row at a
// time, lanes on consecutive columns: coalesced reads, conflict-free writes.
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* __restrict__ src,
                                          int64_t row_stride,
                                          int64_t col_stride, int64_t r0,
                                          int64_t n_rows, int cols,
                                          int pad_cols) {
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  for (int r = warp; r < 64; r += kThreads / 32) {
    const bool row_ok = r0 + r < n_rows;
    const float* srow = src + (r0 + r) * row_stride;
    for (int c = ln; c < pad_cols; c += 32)
      dst[r * pitch + c] = (row_ok && c < cols) ? srow[c * col_stride] : 0.f;
  }
}

template <int DVC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, Params p) {
  constexpr int DVP = 64 * DVC;       // value columns held, Dv <= DVP
  extern __shared__ float4 smem4[];
  const int dp = p.dp;
  const int d4 = (p.D + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem4);          // [kBQ][dp]
  float* ks = qs + kBQ * dp;                            // [kBK][dp]
  float* ps = ks;                                       // [kBQ][kPStride]
  const int k_floats = kBK * dp > kBQ * kPStride ? kBK * dp : kBQ * kPStride;
  float* vs = ks + k_floats;                            // [kBK][DVP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t n_qt = (p.S + kBQ - 1) / kBQ;
  const int64_t q0 = (n_qt - 1 - blockIdx.x) * kBQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / (p.H / p.Hk);

  load_tile(qs, dp, q + b * p.qs[0] + h * p.qs[2], p.qs[1], p.qs[3], q0, p.S,
            p.D, d4);

  const int64_t q_last = (q0 + kBQ < p.S ? q0 + kBQ : p.S) - 1;
  int64_t lo, hi;
  kv_range(q0, q_last, p.T, p.causal, p.window, &lo, &hi);

  float m[4], l[4], acc[4][DVC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DVC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  const float* kb = k + b * p.ks[0] + hk * p.ks[2];
  const float* vb = v + b * p.vs[0] + hk * p.vs[2];
  for (int64_t k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();   // the previous tile's p.v is done with ps and vs
    load_tile(ks, dp, kb, p.ks[1], p.ks[3], k0, p.T, p.D, d4);
    load_tile(vs, DVP, vb, p.vs[1], p.vs[3], k0, p.T, p.Dv, DVP);
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < d4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * dp + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * dp + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, then the online softmax of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = k0 + tx + 16 * j;
        float x = -INFINITY;          // past the last key: no entry at all
        if (kpos < p.T) {
          x = s[i][j] * p.scale;
          bool ok = true;
          if (p.causal) ok = kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          if (!ok) x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DVC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }

    __syncthreads();   // every thread is done reading ks
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc += p.v over the tile's 64 keys
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &ps[(ty + 16 * i) * kPStride + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = &vs[(kk + u) * DVP + 4 * tx];
#pragma unroll
        for (int c = 0; c < DVC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(&vrow[64 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pp = lane(pv[i], u);
            acc[i][c][0] = fmaf(pp, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pp, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pp, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pp, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qpos = q0 + ty + 16 * i;
    if (qpos >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + ((b * p.S + qpos) * p.H + h) * (int64_t)p.Dv;
#pragma unroll
    for (int c = 0; c < DVC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < p.Dv) orow[col] = acc[i][c][e] / denom;
      }
  }
}

// q / k tile pitch in floats: odd in 16-byte units, so a quarter-warp's k
// rows hit distinct banks
int tile_pitch(int d) {
  const int d4 = (d + 3) & ~3;
  return (d4 / 4) % 2 == 0 ? d4 + 4 : d4 + 8;
}

size_t simt_smem_bytes(int dp, int dvc) {
  const int k_floats = kBK * dp > kBQ * kPStride ? kBK * dp : kBQ * kPStride;
  return sizeof(float) * ((size_t)kBQ * dp + k_floats + (size_t)kBK * 64 * dvc);
}

template <int DVC>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                const Params& p, int64_t batch, cudaStream_t stream) {
  auto kernel = flash_fwd_simt<DVC>;
  // the largest tile this instance can need (D = 256)
  static bool configured[kMaxDevices] = {};
  const int err = allow_smem(
      kernel, simt_smem_bytes(tile_pitch(kMaxDim), DVC), configured);
  if (err != 0) return err;
  const dim3 grid((unsigned)((p.S + kBQ - 1) / kBQ), (unsigned)p.H,
                  (unsigned)batch);
  kernel<<<grid, kThreads, simt_smem_bytes(p.dp, DVC), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, p);
  return (int)cudaGetLastError();
}

int dispatch_simt(const void* q, const void* k, const void* v, void* o,
                  const int64_t* dims, const int64_t* strides, int causal,
                  int window, float scale, cudaStream_t stream) {
  Params p;
  p.S = dims[1];
  p.T = dims[2];
  p.H = dims[3];
  p.Hk = dims[4];
  p.D = (int)dims[5];
  p.Dv = (int)dims[6];
  for (int i = 0; i < 4; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[4 + i];
    p.vs[i] = strides[8 + i];
  }
  p.dp = tile_pitch(p.D);
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  switch ((p.Dv + 63) / 64) {
    case 1: return launch_simt<1>(q, k, v, o, p, dims[0], stream);
    case 2: return launch_simt<2>(q, k, v, o, p, dims[0], stream);
    case 3: return launch_simt<3>(q, k, v, o, p, dims[0], stream);
    case 4: return launch_simt<4>(q, k, v, o, p, dims[0], stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 instance for (D, Dv): the smallest padded pair that holds both.
int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   const int64_t* dims, const int64_t* strides, int causal,
                   int window, float scale, cudaStream_t stream) {
  const int64_t d = dims[5], dv = dims[6];
  if ((dims[1] + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  if (d <= 64 && dv <= 64)
    return launch_wgmma<64, 64, 128>(q, k, v, o, dims, strides, causal,
                                     window, scale, stream);
  if (d <= 128 && dv <= 128)
    return launch_wgmma<128, 128, 128>(q, k, v, o, dims, strides, causal,
                                       window, scale, stream);
  if (d <= 192 && dv <= 128)
    return launch_wgmma<192, 128, 128>(q, k, v, o, dims, strides, causal,
                                       window, scale, stream);
  return launch_wgmma<256, 256, 64>(q, k, v, o, dims, strides, causal, window,
                                    scale, stream);
}

}  // namespace

// dims: B, S, T, H, Hk, D, Dv.  strides: q's four, then k's, then v's.
// bf16 operands take the tensor-core kernel (their strides 16-byte aligned,
// the last 1), float32 the SIMT kernel.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bf16,
                                     const int64_t* dims,
                                     const int64_t* strides, int causal,
                                     int window, float scale, void* stream) {
  const int64_t batch = dims[0], S = dims[1], T = dims[2], H = dims[3],
                Hk = dims[4];
  if (batch < 1 || S < 1 || T < 1 || Hk < 1 || H % Hk != 0 || dims[5] < 1 ||
      dims[5] > kMaxDim || dims[6] < 1 || dims[6] > kMaxDim || window < 0 ||
      batch > 65535 || H > 65535 || S >= INT32_MAX || T >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch_wgmma(q, k, v, o, dims, strides, causal, window,
                               scale, (cudaStream_t)stream)
              : dispatch_simt(q, k, v, o, dims, strides, causal, window,
                              scale, (cudaStream_t)stream);
}
