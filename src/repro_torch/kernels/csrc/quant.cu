// FediAC phase-2 quantization kernels for Hopper (sm_90a).
//
// gather_quant replaces the reference's Pallas kernel
// kernels/gather_quant.py::_gather_quant_kernel; stoch_quant replaces
// kernels/stoch_quant.py::_quant_kernel.  Both are elementwise and bound by
// device-memory bytes: gather_quant reads u and the uniforms (8 B) and
// writes q and the residual (8 B) per element, plus the shared uint8 sel
// row once; stoch_quant moves 12 B per element.  One launch covers all N
// clients of a round.
//
// Bitwise parity with the reference needs every float operation rounded
// once, in the reference's order: x = u*f and frac = x - floor(x) use the
// _rn intrinsics, which the compiler never contracts into an FMA (an FMA
// would compute u*f - floor(u*f) exactly and change frac), and q/f is an
// IEEE division.  Never build with --use_fast_math.
//
// gather_quant's design.  Its operands are [N, L] views: u, the uniforms
// and the residual each have a row stride of their own and unit column
// stride (the stream engine hands over column chunks of an [N, d] stack
// and their slots of the residual stack, so nothing is copied around a
// launch); q is a fresh contiguous [N, L].  The residual may be u itself:
// every thread loads an element before it stores the same element, and no
// other thread touches it, so u and res carry no __restrict__.
//  - 16-byte accesses: float4 loads of u and the uniforms, int4 and float4
//    stores of q and the residual, one 32-bit word for four sel bytes (four
//    byte loads where sel's row does not sit on a 4-byte boundary there).
//    Each thread starts its loads of every operand (kUnroll vectors each)
//    before it uses the first.  kUnroll = 1 was measured best on an H100:
//    at 2, 4 and 8 vectors a thread the large shapes ([32, 1e6],
//    [1, 1.25e7], [1, 1.56e8]) moved by under 1% (8 with a register cap
//    spilled and lost 30%), while the FL loop's small stacks lost up to
//    1.8x ([10, 15,178]: 0.0027 ms at 1, 0.0049 at 4), their fewer, longer
//    tiles leaving SMs idle; 48 registers fit 5 blocks of 256 threads on
//    an SM, 46 KB of loads in flight.
//  - A row takes the vector path only where its four float operands share
//    one offset from a 16-byte boundary: a ragged head of up to 3 scalars
//    brings them to it, a tail of up to 3 ends the row.  Views whose rows
//    disagree (a strided u beside a contiguous q whose row length is not a
//    multiple of 4) take a scalar path in which neighbouring threads still
//    touch neighbouring elements.
//  - The grid is sized to the card (the SMs times the blocks the occupancy
//    calculator fits on one) and walks tiles of (row, kTile elements), so
//    [1, 1.5e8] and [32, 1e6] fill all SMs alike.  Offsets are 64-bit once
//    per tile and 32-bit within it.
// Plain vector loads were kept over a cp.async or TMA ring: each element
// is used once, in registers, so a ring through shared memory would only
// add a copy; the loads in flight already cover the memory latency (the
// large shapes reach 82-84% of the bytes bound).
//
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError()
// right after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 65535;
constexpr int kVec = 4;                            // floats in 16 bytes
constexpr int kUnroll = 1;                         // vectors a thread holds
constexpr int kTileVecs = kThreads * kUnroll;      // vectors of one tile
constexpr int kTile = kTileVecs * kVec;            // elements of one tile
constexpr int kMaxDevices = 64;

// Eq. 1: floor(f*u) + [uni < frac(f*u)], as the reference rounds it.
__device__ __forceinline__ int stoch_round(float u, float uni, float f) {
  const float x = __fmul_rn(u, f);
  const float lo = floorf(x);
  const float up = (uni < __fsub_rn(x, lo)) ? 1.0f : 0.0f;
  return __float2int_rz(__fadd_rn(lo, up));
}

// One coordinate: q = sel ? stoch_round : 0, res = u - (sel ? q/f : 0).
// Where sel is 0 the residual is u itself (u - 0.0 == u, -0.0 included).
__device__ __forceinline__ void quant_one(float uv, float nv, bool on, float f,
                                          int32_t& qi, float& r) {
  qi = 0;
  r = uv;
  if (on) {
    qi = stoch_round(uv, nv, f);
    r = __fsub_rn(uv, __fdiv_rn(__int2float_rn(qi), f));
  }
}

// The offset of p from a 16-byte boundary, in floats.
__device__ __forceinline__ unsigned off16(const void* p) {
  return (unsigned)(((uintptr_t)p >> 2) & 3);
}

__device__ __forceinline__ void scalar_at(const float* u, const float* uni,
                                          const uint8_t* sel, int32_t* q,
                                          float* res, int64_t e, float f) {
  const float uv = u[e];
  const bool on = sel[e] != 0;
  int32_t qi;
  float r;
  quant_one(uv, on ? uni[e] : 0.0f, on, f, qi, r);
  q[e] = qi;
  res[e] = r;
}

// u, uni, res: row strides su, sn, sr (elements); q: row stride len.
__global__ void __launch_bounds__(kThreads)
gather_quant_kernel(const float* u, int64_t su,
                    const float* __restrict__ uni, int64_t sn,
                    const uint8_t* __restrict__ sel,
                    const float* __restrict__ f_ptr,
                    int32_t* __restrict__ q, float* res, int64_t sr,
                    int64_t n_rows, int64_t len, int64_t tiles_per_row) {
  const float f = *f_ptr;
  const int64_t n_tiles = n_rows * tiles_per_row;
  const int t = threadIdx.x;
  for (int64_t g = blockIdx.x; g < n_tiles; g += gridDim.x) {
    const int64_t row = g / tiles_per_row;
    const int64_t tile = g - row * tiles_per_row;
    const float* ur = u + row * su;
    const float* nr = uni + row * sn;
    int32_t* qr = q + row * len;
    float* rr = res + row * sr;
    const unsigned off = off16(ur);
    if (off16(nr) != off || off16(qr) != off || off16(rr) != off) {
      // rows that disagree: scalars, kThreads apart
      const int64_t e0 = tile * kTile;
      const int64_t left = len - e0;
      const int ne = left < kTile ? (int)left : kTile;
#pragma unroll 4
      for (int k = 0; k < kVec * kUnroll; ++k) {
        const int e = k * kThreads + t;
        if (e < ne) scalar_at(ur, nr, sel, qr, rr, e0 + e, f);
      }
      continue;
    }
    const int64_t to16 = (4 - off) & 3;
    const int64_t head = to16 < len ? to16 : len;
    const int64_t nvec = (len - head) >> 2;
    if (tile == 0) {
      // the ragged head (to the 16-byte boundary) and tail of the row
      const int64_t tail0 = head + 4 * nvec;
      if (t < head)
        scalar_at(ur, nr, sel, qr, rr, t, f);
      else if (t - head < len - tail0)
        scalar_at(ur, nr, sel, qr, rr, tail0 + (t - head), f);
    }
    const int64_t v0 = tile * kTileVecs;
    const int64_t vleft = nvec - v0;
    if (vleft <= 0) continue;
    const int nv = vleft < kTileVecs ? (int)vleft : kTileVecs;
    const int64_t base = head + 4 * v0;
    const float4* u4 = reinterpret_cast<const float4*>(ur + base);
    const float4* n4 = reinterpret_cast<const float4*>(nr + base);
    int4* q4 = reinterpret_cast<int4*>(qr + base);
    float4* r4 = reinterpret_cast<float4*>(rr + base);
    const uint8_t* sb = sel + base;
    const bool sel_words = ((uintptr_t)sb & 3) == 0;
    float4 a[kUnroll], b[kUnroll];
    uint32_t s[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = k * kThreads + t;
      if (v < nv) {
        a[k] = __ldcs(u4 + v);
        b[k] = __ldcs(n4 + v);
        const uint8_t* sv = sb + 4 * v;
        s[k] = sel_words ? *reinterpret_cast<const uint32_t*>(sv)
                         : (uint32_t)sv[0] | (uint32_t)sv[1] << 8 |
                               (uint32_t)sv[2] << 16 | (uint32_t)sv[3] << 24;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = k * kThreads + t;
      if (v < nv) {
        int4 qv;
        float4 rv;
        quant_one(a[k].x, b[k].x, (s[k] & 0xffu) != 0, f, qv.x, rv.x);
        quant_one(a[k].y, b[k].y, (s[k] & 0xff00u) != 0, f, qv.y, rv.y);
        quant_one(a[k].z, b[k].z, (s[k] & 0xff0000u) != 0, f, qv.z, rv.z);
        quant_one(a[k].w, b[k].w, (s[k] & 0xff000000u) != 0, f, qv.w, rv.w);
        q4[v] = qv;
        r4[v] = rv;
      }
    }
  }
}

__global__ void stoch_quant_kernel(const float* __restrict__ u,
                                   const float* __restrict__ uni,
                                   const float* __restrict__ f_ptr,
                                   int32_t* __restrict__ q, int64_t n) {
  const float f = *f_ptr;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    q[i] = stoch_round(u[i], uni[i], f);
  }
}

int64_t blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocksX ? kMaxBlocksX : b);
}

// gather_quant's grid: the card's SMs times the blocks of kThreads that
// fit on one, found once per device, and no more blocks than tiles.
int gather_quant_blocks(int64_t n_tiles, int* blocks) {
  static int per_card[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int full = dev < kMaxDevices ? per_card[dev] : 0;
  if (full == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_quant_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    full = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) per_card[dev] = full;
  }
  *blocks = n_tiles < full ? (int)n_tiles : full;
  return 0;
}

}  // namespace

// u, uni, res: [n_rows, len] with row strides su, sn, sr and unit column
// stride; res may be u itself.  q: contiguous [n_rows, len].
extern "C" int repro_gather_quant(const void* u, int64_t su, const void* uni,
                                  int64_t sn, const void* sel, const void* f,
                                  void* q, void* res, int64_t sr,
                                  int64_t n_rows, int64_t len, void* stream) {
  if (n_rows <= 0 || len <= 0) return 0;
  const int64_t tiles_per_row = (len + kTile - 1) / kTile;
  int blocks = 0;
  const int err = gather_quant_blocks(n_rows * tiles_per_row, &blocks);
  if (err != 0) return err;
  gather_quant_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, su, (const float*)uni, sn, (const uint8_t*)sel,
      (const float*)f, (int32_t*)q, (float*)res, sr, n_rows, len,
      tiles_per_row);
  return (int)cudaGetLastError();
}

extern "C" int repro_stoch_quant(const void* u, const void* uni,
                                 const void* f, void* q, int64_t n,
                                 void* stream) {
  if (n <= 0) return 0;
  stoch_quant_kernel<<<(unsigned)blocks_for(n), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)u, (const float*)uni, (const float*)f, (int32_t*)q, n);
  return (int)cudaGetLastError();
}
