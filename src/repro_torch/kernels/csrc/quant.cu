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
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError()
// right after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 65535;

// Eq. 1: floor(f*u) + [uni < frac(f*u)], as the reference rounds it.
__device__ __forceinline__ int stoch_round(float u, float uni, float f) {
  const float x = __fmul_rn(u, f);
  const float lo = floorf(x);
  const float up = (uni < __fsub_rn(x, lo)) ? 1.0f : 0.0f;
  return __float2int_rz(__fadd_rn(lo, up));
}

// Grid: x strides over the L coordinates of a row, y walks the N clients.
// Each block reads its row's sel entries directly (no int32 copy).
__global__ void gather_quant_kernel(const float* __restrict__ u,
                                    const float* __restrict__ uni,
                                    const uint8_t* __restrict__ sel,
                                    const float* __restrict__ f_ptr,
                                    int32_t* __restrict__ q,
                                    float* __restrict__ res,
                                    int64_t n_rows, int64_t len) {
  const float f = *f_ptr;
  for (int64_t row = blockIdx.y; row < n_rows; row += gridDim.y) {
    const int64_t base = row * len;
    for (int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; l < len;
         l += (int64_t)gridDim.x * blockDim.x) {
      const int64_t i = base + l;
      const float uv = u[i];
      int32_t qi = 0;
      float r = uv;  // u - 0.0 == u for every u, -0.0 included
      if (sel[l] != 0) {
        qi = stoch_round(uv, uni[i], f);
        r = __fsub_rn(uv, __fdiv_rn(__int2float_rn(qi), f));
      }
      q[i] = qi;
      res[i] = r;
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

}  // namespace

extern "C" int repro_gather_quant(const void* u, const void* uni,
                                  const void* sel, const void* f, void* q,
                                  void* res, int64_t n_rows, int64_t len,
                                  void* stream) {
  if (n_rows <= 0 || len <= 0) return 0;
  const dim3 grid((unsigned)blocks_for(len),
                  (unsigned)(n_rows > kMaxBlocksX ? kMaxBlocksX : n_rows));
  gather_quant_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)uni, (const uint8_t*)sel,
      (const float*)f, (int32_t*)q, (float*)res, n_rows, len);
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
