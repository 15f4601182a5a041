// FediAC packed vote wire kernels for Hopper (sm_90a).
//
// pack_kernel replaces the reference's Pallas kernel
// kernels/bitpack.py::_pack_kernel, unpack_kernel ::_unpack_kernel,
// vote_pack_kernel kernels/vote_pack.py::_vote_pack_kernel and
// popcount_kernel kernels/vote_popcount.py::_popcount_kernel.
//
// The wire layout is the reference's: a flat d-vector is viewed as rows of
// kLanes (1024) lanes, and bit r of word (g, l) holds element
// (32 g + r) * 1024 + l.  The reference pads d to a whole number of
// 256-row tiles; here the word count comes from the caller and every
// element index >= d is padding that is never read or written (0 for pack,
// the reference's -inf fill for vote_pack).
//
// All four are integer bit kernels bound by device-memory bytes: one thread
// owns one word position (g, l) and walks its 32 rows, so neighbouring
// threads touch neighbouring lanes and every access of a warp is
// coalesced.  Nothing is rounded, so any order of operations is exact.
//
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError()
// right after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;
constexpr int64_t kLanes = 1024;
constexpr int kGroup = 32;

// Flat element index of row r of word position w.
__device__ __forceinline__ int64_t elem(int64_t w, int r) {
  return (w / kLanes) * (kGroup * kLanes) + (int64_t)r * kLanes + w % kLanes;
}

__device__ __forceinline__ int64_t first_word() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t word_stride() {
  return (int64_t)gridDim.x * blockDim.x;
}

__global__ void pack_kernel(const uint8_t* __restrict__ mask, int64_t d,
                            uint32_t* __restrict__ words, int64_t n_words) {
  for (int64_t w = first_word(); w < n_words; w += word_stride()) {
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int64_t i = elem(w, r);
      if (i < d && mask[i] != 0) word |= 1u << r;
    }
    words[w] = word;
  }
}

// NaN never votes (every comparison with NaN is false), as on the TPU.
__global__ void vote_pack_kernel(const float* __restrict__ scores,
                                 const float* __restrict__ tau_ptr, int64_t d,
                                 uint32_t* __restrict__ words,
                                 int64_t n_words) {
  const float tau = *tau_ptr;
  const bool pad_votes = -INFINITY >= tau;
  for (int64_t w = first_word(); w < n_words; w += word_stride()) {
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int64_t i = elem(w, r);
      if (i < d ? scores[i] >= tau : pad_votes) word |= 1u << r;
    }
    words[w] = word;
  }
}

__global__ void unpack_kernel(const uint32_t* __restrict__ words,
                              int64_t n_words, uint8_t* __restrict__ out,
                              int64_t d) {
  for (int64_t w = first_word(); w < n_words; w += word_stride()) {
    const uint32_t word = words[w];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int64_t i = elem(w, r);
      if (i < d) out[i] = (uint8_t)((word >> r) & 1u);
    }
  }
}

// 32 counters per thread, kept in registers (the r loops unroll fully).
__global__ void popcount_kernel(const uint32_t* __restrict__ words,
                                int64_t n_clients, int64_t n_words,
                                int32_t* __restrict__ out, int64_t d) {
  for (int64_t w = first_word(); w < n_words; w += word_stride()) {
    int32_t count[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) count[r] = 0;
    for (int64_t n = 0; n < n_clients; ++n) {
      const uint32_t word = words[n * n_words + w];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) count[r] += (int32_t)((word >> r) & 1u);
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int64_t i = elem(w, r);
      if (i < d) out[i] = count[r];
    }
  }
}

unsigned blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

extern "C" int repro_pack(const void* mask, int64_t d, void* words,
                          int64_t n_words, void* stream) {
  if (n_words <= 0) return 0;
  pack_kernel<<<blocks_for(n_words), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, d, (uint32_t*)words, n_words);
  return (int)cudaGetLastError();
}

extern "C" int repro_vote_pack(const void* scores, const void* tau, int64_t d,
                               void* words, int64_t n_words, void* stream) {
  if (n_words <= 0) return 0;
  vote_pack_kernel<<<blocks_for(n_words), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)tau, d, (uint32_t*)words, n_words);
  return (int)cudaGetLastError();
}

extern "C" int repro_unpack(const void* words, int64_t n_words, void* out,
                            int64_t d, void* stream) {
  if (n_words <= 0) return 0;
  unpack_kernel<<<blocks_for(n_words), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (uint8_t*)out, d);
  return (int)cudaGetLastError();
}

extern "C" int repro_popcount(const void* words, int64_t n_clients,
                              int64_t n_words, void* out, int64_t d,
                              void* stream) {
  if (n_words <= 0) return 0;
  popcount_kernel<<<blocks_for(n_words), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_clients, n_words, (int32_t*)out, d);
  return (int)cudaGetLastError();
}
