// Flash attention forward for Hopper (sm_90a): causal / sliding-window
// grouped-query attention with an online softmax.
//
// flash_fwd_kernel replaces the reference's Pallas kernel
// kernels/flash_attention.py::_flash_kernel (launched by flash_attention).
// It computes what that kernel computes: scores (q.k) * scale in float32,
// the mask kpos <= qpos (causal) and kpos > qpos - window (window > 0) with
// the sentinel -1e30, a running (max, sum, acc) in float32 over KV tiles,
// p.v in float32 (the TPU kernel casts v to float32), and
// out = acc / max(l, 1e-30) in q's dtype.  Query and key positions are the
// row indices (both start at 0).  Query head h reads KV head h / (H / Hk);
// KV heads are never repeated.
//
// Layout: q (B, S, H, D), k (B, T, Hk, D), v (B, T, Hk, Dv), read through
// their element strides (no transposed copies); the output is a contiguous
// (B, S, H, Dv).  D and Dv are at most 256 and need not be equal.  S and T
// need not be multiples of any tile: the kernel masks its ragged edges.
//
// Bound: operations.  Each visible (q, k) pair costs 2 D + 2 Dv FLOPs; at
// the 32k prefill (B 2, S = T 32768, H 16, D = Dv 128, causal) that is
// 8.8e12 FLOPs against 0.40 GB of q, k, v and o.  This first version runs
// on the float32 SIMT units (67 TFLOP/s on an H100 SXM), not the tensor
// cores:
//   * one block of 256 threads per (batch, query head, 64-row query tile);
//     the q tile and one 64-key K and V tile at a time sit in shared memory
//     as float32; the probability tile reuses the K tile's space;
//   * each thread owns rows ty + 16 i (i < 4): scores for keys tx + 16 j
//     (j < 4) and the accumulator for value columns 64 c + 4 tx + e, so a
//     row's max and sum are half-warp shuffles and corr stays in registers;
//   * inner products read shared memory as float4 (8 loads per 64 FMAs);
//     the row pitch of the q and k tiles is odd in 16-byte units, so the
//     k reads of a quarter-warp hit distinct banks;
//   * KV tiles wholly above the causal diagonal or wholly below the window
//     are skipped, which halves the causal work and leaves the result as it
//     was (their entries would add exp(-1e30 - m) = 0); when a tile has a
//     row that sees no key at all, every tile is visited, as on the TPU;
//   * query tiles are scheduled longest first (reverse order).
// Tensor cores, TMA and one block per KV head serving its G query heads
// are left to a later version.
//
// Plain C entry point, loaded with ctypes; it returns cudaGetLastError()
// right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per KV tile
constexpr int kThreads = 256;         // 16 x 16: tx = key / column, ty = row
constexpr int kMaxDim = 256;
constexpr int kPStride = kBK + 16;    // probability tile pitch (floats)
constexpr float kNegInf = -1e30f;     // the reference's masking sentinel

struct Params {
  int64_t S, T, H, Hk;
  int64_t qs[4], ks[4], vs[4];        // element strides
  int D, Dv;
  int dp;                             // q / k tile pitch in floats
  int causal, window;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);           // round to nearest even, as astype
}

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// Copies rows [r0, r0 + 64) of a (rows, cols) slice with element strides
// (row_stride, col_stride) into a float tile of pitch `pitch`, zero-filling
// rows >= n_rows and columns in [cols, pad_cols).  One warp per row at a
// time, lanes on consecutive columns: coalesced reads, conflict-free writes.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* __restrict__ src,
                                          int64_t row_stride,
                                          int64_t col_stride, int64_t r0,
                                          int64_t n_rows, int cols,
                                          int pad_cols) {
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  for (int r = warp; r < 64; r += kThreads / 32) {
    const bool row_ok = r0 + r < n_rows;
    const T* srow = src + (r0 + r) * row_stride;
    for (int c = ln; c < pad_cols; c += 32)
      dst[r * pitch + c] =
          (row_ok && c < cols) ? to_f32(srow[c * col_stride]) : 0.f;
  }
}

template <typename T, int DVC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Params p) {
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

  // The KV tiles this query tile needs.  Keys above the causal diagonal of
  // its last row, or at or below q0 - window, are masked for every row.
  const int64_t q_last = (q0 + kBQ < p.S ? q0 + kBQ : p.S) - 1;
  int64_t lo = 0, hi = p.T;
  const bool every_row_sees_a_key =
      !(p.window > 0 && q_last >= p.T - 1 + p.window);
  if (every_row_sees_a_key) {
    if (p.causal && q_last + 1 < hi) hi = q_last + 1;
    if (p.window > 0 && q0 - p.window + 1 > lo) lo = q0 - p.window + 1;
  }

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

  const T* kb = k + b * p.ks[0] + hk * p.ks[2];
  const T* vb = v + b * p.vs[0] + hk * p.vs[2];
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
    T* orow = o + ((b * p.S + qpos) * p.H + h) * (int64_t)p.Dv;
#pragma unroll
    for (int c = 0; c < DVC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < p.Dv) store_out(&orow[col], acc[i][c][e] / denom);
      }
  }
}

// q / k tile pitch in floats: odd in 16-byte units, so a quarter-warp's k
// rows hit distinct banks
int tile_pitch(int d) {
  const int d4 = (d + 3) & ~3;
  return (d4 / 4) % 2 == 0 ? d4 + 4 : d4 + 8;
}

size_t smem_bytes(int dp, int dvc) {
  const int k_floats = kBK * dp > kBQ * kPStride ? kBK * dp : kBQ * kPStride;
  return sizeof(float) * ((size_t)kBQ * dp + k_floats + (size_t)kBK * 64 * dvc);
}

template <typename T, int DVC>
int launch(const void* q, const void* k, const void* v, void* o,
           const Params& p, int64_t batch, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DVC>;
  // Allow the largest tile this instance can need (D = 256), once per
  // device, so no attribute is set while a CUDA graph is being captured.
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(tile_pitch(kMaxDim), DVC));
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const dim3 grid((unsigned)((p.S + kBQ - 1) / kBQ), (unsigned)p.H,
                  (unsigned)batch);
  kernel<<<grid, kThreads, smem_bytes(p.dp, DVC), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const Params& p, int64_t batch, cudaStream_t stream) {
  switch ((p.Dv + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, p, batch, stream);
    case 2: return launch<T, 2>(q, k, v, o, p, batch, stream);
    case 3: return launch<T, 3>(q, k, v, o, p, batch, stream);
    case 4: return launch<T, 4>(q, k, v, o, p, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dims: B, S, T, H, Hk, D, Dv.  strides: q's four, then k's, then v's.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bf16,
                                     const int64_t* dims,
                                     const int64_t* strides, int causal,
                                     int window, float scale, void* stream) {
  const int64_t batch = dims[0];
  Params p;
  p.S = dims[1];
  p.T = dims[2];
  p.H = dims[3];
  p.Hk = dims[4];
  if (batch < 1 || p.S < 1 || p.T < 1 || p.Hk < 1 || p.H % p.Hk != 0 ||
      dims[5] < 1 || dims[5] > kMaxDim || dims[6] < 1 || dims[6] > kMaxDim ||
      window < 0 || batch > 65535 || p.H > 65535)
    return (int)cudaErrorInvalidValue;
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
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, p, batch,
                                        (cudaStream_t)stream)
              : dispatch<float>(q, k, v, o, p, batch, (cudaStream_t)stream);
}
