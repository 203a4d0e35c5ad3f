// A yardstick for K3 (csrc/gear.cu), not a kernel of any path: the least
// time a pass that reads a region once takes on this card. It reads the
// 16-byte words that hold a region of n bytes at any alignment (the words
// K3 reads), coalesced: neighbouring threads read neighbouring words,
// kUnroll words a thread in flight. It folds them by XOR into one word a
// block, which it stores, so that no load can be dropped.
// chip_smoke.py and tools/gear_variants.py time it, through
// dragonfly2_tpu_torch/bench.py's read_floor, as `read_ms` beside K3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
read_floor_kernel(const uint4* __restrict__ words, long long n_words,
                  unsigned* __restrict__ out) {
  __shared__ unsigned warp_x[kThreads / 32];
  unsigned x = 0;
  const long long stride = (long long)gridDim.x * kThreads * kUnroll;
  for (long long i0 = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
       i0 < n_words; i0 += stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + (long long)k * kThreads;
      v[k] = i < n_words ? __ldg(words + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) x ^= v[k].x ^ v[k].y ^ v[k].z ^ v[k].w;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) warp_x[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) x ^= warp_x[w];
    out[blockIdx.x] = x;
  }
}

}  // namespace

extern "C" {

// data: n bytes on the card, at any alignment. out: room for `blocks`
// uint32, one a block (the grid is at most `blocks`, grid-stride beyond).
int df_read_floor(const void* data, int64_t n, void* out, int64_t blocks,
                  void* stream) {
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(data);
  const long long mis = (long long)(a & 15);
  const long long n_words = (mis + (long long)n + 15) / 16;
  long long grid = (n_words + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (grid > blocks) grid = blocks;
  read_floor_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(a - (uintptr_t)mis), n_words,
      (unsigned*)out);
  return (int)cudaGetLastError();
}

const char* df_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
