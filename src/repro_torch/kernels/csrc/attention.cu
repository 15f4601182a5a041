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
// float32: flash_fwd_simt, exact float32 on the SIMT units: every product
// is one FFMA (no TF32, no bf16 split), so its bound is the 67 TFLOP/s
// FFMA rate (1.026 ms at the float32 check prefill's layer, q [1, 4096,
// 16, 128], k/v [1, 4096, 8, 128], causal).  Shared-memory reads, not the
// FFMA rate, held the first tiling back: timed by phase, a warp's 16-byte
// shared load behaves as if it took 4 of the SM's shared-memory cycles
// even when its lanes share addresses, so a thread must do 4 FFMAs per
// float it reads to keep the FFMA units busy.
//   * One block of 256 threads per (query head, query tile, batch), heads
//     fastest and query tiles longest first, as the bf16 kernel.  Tiles of
//     128 query rows and a ring of 3 slots where D <= 128 and Dv <= 128, 64
//     rows and 2 slots above (D, Dv up to 256).  KV tiles of 64 keys.
//   * The ring holds K and V tiles in turn (K0, V0, K1, ...).  Thread 0
//     fills a slot by TMA, 32-column boxes with the 128-byte swizzle,
//     counted on the slot's mbarrier, so no warp stalls on the copies;
//     while the q.k of tile it runs, V it and K it + 1 are in flight.  An
//     operand TMA cannot read (a last stride other than 1, a stride or base
//     not 16-byte aligned) is copied into the same swizzled tiles one 4-byte
//     cp.async per element, each thread arriving on the mbarrier when its
//     copies land.  Rows past S or T and columns past D are zeros.  One
//     barrier per slot consumed hands the slot back.
//   * Scores: lanes pair up over the two depth halves (chunks 0-3 and 4-7
//     of each 32-column box); each thread holds 8 rows x 8 keys of its half
//     (8 q and 8 k float4 per depth chunk, 256 FFMAs: 4 per float read) and
//     swaps halves with its partner (one shuffle per kept score): 8
//     rows x 4 keys.  A warp holds 16 rows x 64 keys, so row maxima and sums
//     stay in 16 lanes and p in the warp (pitch 80: conflict-free stores).
//   * Softmax: 2^x on the special-function unit; a tile that every row of
//     the block sees whole keeps its raw scores and folds scale * log2e
//     into one FFMA per score; others are scaled and masked first.
//   * p.v: each thread holds the same 8 rows x 8 value columns (64 c +
//     4 cg + e) and per 4 keys reads 8 p and 8 v float4 for 256 FFMAs; the
//     swizzle keeps a warp's k, q and v reads free of bank conflicts.
//   * 254 registers a thread, no spills; 204,832 bytes of shared memory a
//     block at D = Dv = 128, so one block (8 warps) per SM (chip_smoke.py
//     prints the registers and spills of every instance).
//   * The tile skipping and the visit of every tile when a row sees no key
//     are those of the bf16 kernel.
//
// Row statistic for the backward (csrc/attention_bwd.cu): given a non-null
// `lse`, float32 (B, H, S) contiguous, both kernels also write each row's
// natural-log sum, lse = m + logf(l), with m the row's largest scaled score
// and l its sum of p (so p / l = exp(s * scale - lse)).  The kernels keep
// their base-2 exponentials inside; lse is converted once per row.  With a
// null pointer nothing else changes: the output is bitwise what it was.
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

using hopper::allow_smem;
using hopper::encode_map;
using hopper::fast_exp2;
using hopper::kMaxDevices;

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
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                const TcParams p) {
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
    if (lse != nullptr && (lane & 3) == 0)
      lse[(b * p.H + h) * p.S + qpos] = m[i] + logf(l[i]);
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

template <int DP, int DVP, int BN>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, const int64_t* dims, const int64_t* strides,
                 int causal, int window, float scale, cudaStream_t stream) {
  const int64_t B = dims[0], S = dims[1], T = dims[2], H = dims[3],
                Hk = dims[4];
  const int64_t q_shape[4] = {B, S, H, dims[5]};
  const int64_t k_shape[4] = {B, T, Hk, dims[5]};
  const int64_t v_shape[4] = {B, T, Hk, dims[6]};
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode_map(&tq, kBf16, 2, 64, kSw, q, q_shape, strides, kBM) ||
      !encode_map(&tk, kBf16, 2, 64, kSw, k, k_shape, strides + 4, BN) ||
      !encode_map(&tv, kBf16, 2, 64, kSw, v, v_shape, strides + 8, BN))
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
                                             lse, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: register-tiled FFMA over a K/V ring filled by TMA
// ---------------------------------------------------------------------------

constexpr int kBK = 64;               // keys per K / V tile
constexpr int kThreads = 256;
constexpr int kPPitch = kBK + 16;     // probability tile pitch (floats)
constexpr int kBox = 32;              // floats per 128-byte box row
constexpr size_t kSmemMax = 232448;   // what one block may use on sm_90

struct Params {
  int64_t S, T, H, Hk;
  int64_t qs[4], ks[4], vs[4];        // element strides
  int D, Dv;
  int nbk, nbv;                       // 32-column boxes of q / k and of v
  int slot;                           // floats per ring slot
  int tma_q, tma_kv;                  // q, and k and v, copied by TMA
  int causal, window;
  float scale;
};

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// Tiles live as TMA writes them with the 128-byte swizzle: 32-column boxes
// of `rows` rows of 128 bytes, the 16-byte chunk c of row r at chunk
// c ^ (r % 8).  The float index of element (r, col):
__device__ __forceinline__ int sw_index(int rows, int r, int col) {
  return (col >> 5) * rows * kBox + r * kBox +
         ((((col >> 2) & 7) ^ (r & 7)) << 2) + (col & 3);
}

// Rows [row0, row0 + ROWS) of operand x (batch b, head hx) into `dst`:
// by TMA (thread 0 announces the bytes on `bar` and issues one copy per
// box) or, for an operand TMA cannot read (a last stride other than 1, or
// strides or base not 16-byte aligned), one 4-byte cp.async per element,
// zeros past `n_rows` and `cols`, each thread arriving on `bar` once its
// own copies have landed.  So `bar` counts one arrival (with the bytes) for
// a TMA fill and kThreads for an element fill.
template <int ROWS>
__device__ __forceinline__ void fill_tile(float* dst, uint64_t* bar, bool tma,
                                          const CUtensorMap* map,
                                          const float* __restrict__ x,
                                          const int64_t* st, int64_t b,
                                          int64_t hx, int64_t row0,
                                          int64_t n_rows, int cols, int nb) {
  if (tma) {
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bar, nb * ROWS * kBox * 4);
      for (int bx = 0; bx < nb; ++bx)
        hopper::tma_load_4d(dst + bx * ROWS * kBox, map, bar, kBox * bx,
                            (int)hx, (int)row0, (int)b);
    }
    return;
  }
  const float* src = x + b * st[0] + hx * st[2] + row0 * st[1];
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  for (int r = warp; r < ROWS; r += kThreads / 32)
    for (int col = ln; col < nb * kBox; col += 32) {
      const bool ok = r < n_rows && col < cols;
      hopper::cp_async4(dst + sw_index(ROWS, r, col),
                        ok ? src + r * st[1] + col * st[3] : x, ok ? 4 : 0);
    }
  hopper::cp_async_mbar_arrive(bar);
}

template <int BQ, int DVC, int NS>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_simt(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, Params p) {
  constexpr int R = BQ / 16;          // rows per thread
  // no static shared memory, so the dynamic block starts 1024-byte aligned
  extern __shared__ __align__(1024) float smem_f[];
  float* qs = smem_f;                            // [nbk][BQ][kBox], swizzled
  float* ring = qs + BQ * kBox * p.nbk;          // [NS][slot]: K, V, K, ...
  float* ps = ring + NS * p.slot;                // [BQ][kPPitch]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ps + BQ * kPPitch);
  uint64_t* full = q_full + 1;                   // [NS]

  // Lanes: bit 0 the depth half dh, bits 1-3 the key group kg, bit 4 with
  // the warp the row group rg; a thread owns rows rg + 16 i (i < R).
  // Scores: over its depth half (chunks 4 dh .. 4 dh + 3 of each 32-column
  // box) for keys kg + 8 j (j < 8); then, summed with its partner's half,
  // for keys kg + 8 (2 m + dh) (m < 4): a row's 64 keys lie in 16 lanes of
  // one warp.  Output: columns 64 c + 4 cg + e (cg = lane % 16) of the same
  // rows, so p stays in the warp and each row's statistics in the thread.
  const int tid = threadIdx.x, ln = tid & 31;
  const int dh = ln & 1, kg = (ln >> 1) & 7, cg = ln & 15;
  const int rg = 2 * (tid >> 5) + (ln >> 4);

  const int64_t H = p.H, n_qt = (p.S + BQ - 1) / BQ;
  const int h = (int)(blockIdx.x % H);
  const int64_t q0 = (n_qt - 1 - blockIdx.x / H) * BQ;   // longest first
  const int64_t b = blockIdx.y;
  const int64_t hk = h / (H / p.Hk);
  const int64_t q_last = (q0 + BQ < p.S ? q0 + BQ : p.S) - 1;
  int64_t lo, hi;
  kv_range(q0, q_last, p.T, p.causal, p.window, &lo, &hi);
  const int64_t first = lo / kBK;
  const int n_tiles = (int)((hi + kBK - 1) / kBK - first);
  const int n_half = 2 * n_tiles;     // K tile it is half 2 it, V tile 2 it + 1

  auto fill_half = [&](int hh) {
    float* dst = ring + (hh % NS) * p.slot;
    const int64_t k0 = (first + hh / 2) * kBK;
    if (hh & 1)
      fill_tile<kBK>(dst, &full[hh % NS], p.tma_kv, &tm_v, v, p.vs, b, hk, k0,
                     p.T - k0, p.Dv, p.nbv);
    else
      fill_tile<kBK>(dst, &full[hh % NS], p.tma_kv, &tm_k, k, p.ks, b, hk, k0,
                     p.T - k0, p.D, p.nbk);
  };
  // Half hh is consumed once its slot's barrier has completed the phase of
  // this fill and every thread has passed __syncthreads, which also shows
  // that half hh - 1 is consumed: its slot takes half hh + NS - 1.
  auto advance = [&](int hh) {
    hopper::mbar_wait(&full[hh % NS], (hh / NS) & 1);
    __syncthreads();
    if (hh + NS - 1 < n_half) fill_half(hh + NS - 1);
  };

  if (tid == 0) {
    // the swizzled boxes need a 1024-byte aligned base
    if (hopper::smem_addr(smem_f) % 1024 != 0) __trap();
    hopper::mbar_init(q_full, p.tma_q ? 1 : kThreads);
    for (int s = 0; s < NS; ++s)
      hopper::mbar_init(&full[s], p.tma_kv ? 1 : kThreads);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  fill_tile<BQ>(qs, q_full, p.tma_q, &tm_q, q, p.qs, b, h, q0, p.S - q0, p.D,
                p.nbk);
  for (int hh = 0; hh < NS - 1 && hh < n_half; ++hh) fill_half(hh);

  float m[R], l[R], acc[R][DVC][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DVC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  const float sl2 = p.scale * kLog2e;
  float* prow = ps + rg * kPPitch;
  hopper::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int64_t k0 = (first + it) * kBK;
    advance(2 * it);
    const float* kt = ring + ((2 * it) % NS) * p.slot;

    // partial s = q . k^T over this thread's depth half: per depth chunk,
    // R + 8 float4 reads for 32 R FFMAs.  Keys kg + 8 j and rows rg + 16 i
    // share their swizzle (kg, rg % 8), so one address serves all j (i).
    float s[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    {
      const float* kb = kt + kg * kBox;
      const float* qb = qs + rg * kBox;
      for (int bx = 0; bx < p.nbk; ++bx, kb += kBK * kBox, qb += BQ * kBox) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int cs = 4 * dh + t;
          const float* kc = kb + ((cs ^ kg) << 2);
          const float* qc = qb + ((cs ^ (rg & 7)) << 2);
          float4 kf[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            kf[j] = *reinterpret_cast<const float4*>(kc + 8 * j * kBox);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float4 qf =
                *reinterpret_cast<const float4*>(qc + 16 * i * kBox);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
              s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
              s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
              s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
            }
          }
        }
      }
    }
    // the two depth halves: keep keys j = 2 m + dh, send the others
    float x[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const float keep = dh ? s[i][2 * mm + 1] : s[i][2 * mm];
        const float send = dh ? s[i][2 * mm] : s[i][2 * mm + 1];
        x[i][mm] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }

    // The online softmax of each row.  A tile every row sees whole keeps
    // its raw scores: the row maximum is scaled once (rounding is monotone)
    // and p = 2^(s scale log2e - m log2e) is one FFMA and one ex2 a score.
    // Otherwise scores are scaled and masked first, and p = 2^((x - m)
    // log2e), which is 1 where x and m are both the -1e30 sentinel.
    const bool no_mask =
        k0 + kBK <= p.T && (!p.causal || k0 + kBK - 1 <= q0) &&
        (p.window == 0 || k0 > q0 + BQ - 1 - p.window);
    if (!no_mask) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int64_t qpos = q0 + rg + 16 * i;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int64_t kpos = k0 + kg + 8 * (2 * mm + dh);
          const bool ok = (!p.causal || kpos <= qpos) &&
                          (p.window == 0 || kpos > qpos - p.window);
          x[i][mm] = kpos >= p.T ? -INFINITY
                                 : (ok ? x[i][mm] * p.scale : kNegInf);
        }
      }
    }
    float corr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = fmaxf(fmaxf(x[i][0], x[i][1]), fmaxf(x[i][2], x[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], no_mask ? mx * p.scale : mx);
      corr[i] = fast_exp2((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      float rs = 0.f;
      if (no_mask) {
        const float ml = m_new * kLog2e;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          x[i][mm] = fast_exp2(fmaf(x[i][mm], sl2, -ml));
          rs += x[i][mm];
        }
      } else {
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          x[i][mm] = fast_exp2((x[i][mm] - m_new) * kLog2e);
          rs += x[i][mm];
        }
      }
      l[i] = l[i] * corr[i] + rs;     // this thread's part of the row sum
#pragma unroll
      for (int mm = 0; mm < 4; ++mm)
        prow[16 * i * kPPitch + kg + 8 * (2 * mm + dh)] = x[i][mm];
    }
    __syncwarp();                     // p of the warp's rows is written

    // acc = acc corr + p . v: per 4 keys, R + 4 DVC float4 reads for
    // 16 R DVC FFMAs.  Columns 64 c + 4 cg are chunk cg % 8 of box
    // 2 c + cg / 8.
    advance(2 * it + 1);
    const float* vcol = ring + ((2 * it + 1) % NS) * p.slot +
                        (cg >> 3) * kBK * kBox;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < DVC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr[i];
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pf[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        pf[i] = *reinterpret_cast<const float4*>(&prow[16 * i * kPPitch + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = kk + u;
        const float* vrow = vcol + key * kBox + (((cg & 7) ^ (key & 7)) << 2);
#pragma unroll
        for (int c = 0; c < DVC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vrow + 2 * c * kBK * kBox);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float pp = lane(pf[i], u);
            acc[i][c][0] = fmaf(pp, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pp, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pp, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pp, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), l summed over the row's 16 lanes
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int64_t qpos = q0 + rg + 16 * i;
    if (qpos >= p.S) continue;
    if (lse != nullptr && cg == 0)
      lse[(b * H + h) * p.S + qpos] = m[i] + logf(l[i]);
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + ((b * p.S + qpos) * H + h) * (int64_t)p.Dv;
#pragma unroll
    for (int c = 0; c < DVC; ++c) {
      const int col = 64 * c + 4 * cg;
      const float4 r = make_float4(acc[i][c][0] / denom, acc[i][c][1] / denom,
                                   acc[i][c][2] / denom, acc[i][c][3] / denom);
      if ((p.Dv & 3) == 0) {
        if (col < p.Dv) *reinterpret_cast<float4*>(&orow[col]) = r;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < p.Dv) orow[col + e] = lane(r, e);
      }
    }
  }
}

size_t simt_smem_bytes(int bq, int ns, int nbk, int slot) {
  return sizeof(float) * ((size_t)bq * kBox * nbk + (size_t)ns * slot +
                          (size_t)bq * kPPitch) +
         8 * (1 + ns);
}

template <int BQ, int DVC, int NS>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, Params& p, const int64_t* strides, int64_t batch,
                cudaStream_t stream) {
  const int64_t q_shape[4] = {batch, p.S, p.H, p.D};
  const int64_t k_shape[4] = {batch, p.T, p.Hk, p.D};
  const int64_t v_shape[4] = {batch, p.T, p.Hk, p.Dv};
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq = {}, tk = {}, tv = {};
  p.tma_q = encode_map(&tq, kF32, 4, kBox, kSw, q, q_shape, strides, BQ);
  p.tma_kv =
      encode_map(&tk, kF32, 4, kBox, kSw, k, k_shape, strides + 4, kBK) &&
      encode_map(&tv, kF32, 4, kBox, kSw, v, v_shape, strides + 8, kBK);
  auto kernel = flash_fwd_simt<BQ, DVC, NS>;
  static bool configured[kMaxDevices] = {};
  const int err = allow_smem(kernel, kSmemMax, configured);
  if (err != 0) return err;
  const size_t smem = simt_smem_bytes(BQ, NS, p.nbk, p.slot);
  const int64_t blocks = p.H * ((p.S + BQ - 1) / BQ);
  if (smem > kSmemMax || blocks > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, (const float*)q, (const float*)k, (const float*)v,
      (float*)o, lse, p);
  return (int)cudaGetLastError();
}

// 128 query rows and a 3-slot ring where D <= 128 and Dv <= 128 (the
// models' head sizes), else 64 rows and 2 slots (D or Dv up to 256).
int dispatch_simt(const void* q, const void* k, const void* v, void* o,
                  float* lse, const int64_t* dims, const int64_t* strides,
                  int causal, int window, float scale, cudaStream_t stream) {
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
  p.nbk = (p.D + kBox - 1) / kBox;
  p.nbv = (p.Dv + kBox - 1) / kBox;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.slot = kBK * kBox * (p.nbk > p.nbv ? p.nbk : p.nbv);
  const int dvc = (p.Dv + 63) / 64;
  const int64_t B = dims[0];
  if (dvc <= 2 && simt_smem_bytes(128, 3, p.nbk, p.slot) <= kSmemMax)
    return dvc == 1
               ? launch_simt<128, 1, 3>(q, k, v, o, lse, p, strides, B, stream)
               : launch_simt<128, 2, 3>(q, k, v, o, lse, p, strides, B, stream);
  switch (dvc) {
    case 1:
      return launch_simt<64, 1, 2>(q, k, v, o, lse, p, strides, B, stream);
    case 2:
      return launch_simt<64, 2, 2>(q, k, v, o, lse, p, strides, B, stream);
    case 3:
      return launch_simt<64, 3, 2>(q, k, v, o, lse, p, strides, B, stream);
    case 4:
      return launch_simt<64, 4, 2>(q, k, v, o, lse, p, strides, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 instance for (D, Dv): the smallest padded pair that holds both.
int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int64_t* dims, const int64_t* strides,
                   int causal, int window, float scale, cudaStream_t stream) {
  const int64_t d = dims[5], dv = dims[6];
  if ((dims[1] + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  if (d <= 64 && dv <= 64)
    return launch_wgmma<64, 64, 128>(q, k, v, o, lse, dims, strides, causal,
                                     window, scale, stream);
  if (d <= 128 && dv <= 128)
    return launch_wgmma<128, 128, 128>(q, k, v, o, lse, dims, strides, causal,
                                       window, scale, stream);
  if (d <= 192 && dv <= 128)
    return launch_wgmma<192, 128, 128>(q, k, v, o, lse, dims, strides, causal,
                                       window, scale, stream);
  return launch_wgmma<256, 256, 64>(q, k, v, o, lse, dims, strides, causal,
                                    window, scale, stream);
}

}  // namespace

// dims: B, S, T, H, Hk, D, Dv.  strides: q's four, then k's, then v's.
// lse: null, or float32 (B, H, S) for the row statistic.
// bf16 operands take the tensor-core kernel (their strides 16-byte aligned,
// the last 1), float32 the SIMT kernel.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int bf16,
                                     const int64_t* dims,
                                     const int64_t* strides, int causal,
                                     int window, float scale, void* stream) {
  const int64_t batch = dims[0], S = dims[1], T = dims[2], H = dims[3],
                Hk = dims[4];
  if (batch < 1 || S < 1 || T < 1 || Hk < 1 || H % Hk != 0 || dims[5] < 1 ||
      dims[5] > kMaxDim || dims[6] < 1 || dims[6] > kMaxDim || window < 0 ||
      batch > 65535 || H > 65535 || S >= INT32_MAX || T >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch_wgmma(q, k, v, o, lse, dims, strides, causal, window,
                               scale, (cudaStream_t)stream)
              : dispatch_simt(q, k, v, o, lse, dims, strides, causal, window,
                              scale, (cudaStream_t)stream);
}
