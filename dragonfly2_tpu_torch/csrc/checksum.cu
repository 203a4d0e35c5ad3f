// Piece checksums for the device sink, written by hand for Hopper (sm_90a).
//
// Both kernels fold a piece of little-endian 32-bit words w_i into
//   sum32 = sum(w_i) mod 2^32      xor32 = xor(w_i)
// which is the contract of dragonfly2_tpu/ops/checksum.py (checksum_numpy).
//
// df_chunk_checksums replaces _chunk_checksums_pallas
//   (dragonfly2_tpu/ops/checksum.py:67-130): (sum32, xor32) of n pieces.
// df_land_and_checksum replaces _land_checksum_pallas
//   (dragonfly2_tpu/ops/checksum.py:133-218): stores k pieces into their
//   slots of a flat buffer, in place, and folds each piece while it passes
//   through registers.
//
// Bound: both are memory bound. K1 reads each word once (4 bytes per two
// integer operations); K2 reads and writes each word once. The least time
// is bytes moved / the card's memory rate (3.35 TB/s on an H100 SXM).
// Design: the TPU ran a sequential grid and carried the partial sums in
// VMEM from one step to the next. Here blocks run in parallel and in no
// order, so each piece is cut into splits of 16-256 KiB, one block per
// (piece, split), about 16 blocks for each SM in all. Each thread loads 16
// bytes at a time, neighbouring threads on neighbouring addresses, four
// loads in flight; a warp-shuffle add tree and xor tree, then shared memory,
// reduce the block, and one atomicAdd / atomicXor per block combines the
// splits. Both operations are associative and commutative mod 2^32, so the
// result is bit-exact in any order. A piece start that is not 16-byte
// aligned (an odd piece size) takes a scalar head and tail inside the
// kernel. All offsets are 64-bit: a 5 GB buffer has byte offsets past 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSplitWords = int64_t(1) << 16;    // at most 256 KiB a block
constexpr int64_t kMinSplitWords = int64_t(1) << 12; // at least 16 KiB a block
constexpr int64_t kTargetBlocks = 132 * 16;          // 16 blocks per H100 SM
constexpr int64_t kMaxSplits = 65535;                // gridDim.y limit

__device__ __forceinline__ void fold4(const uint4 v, unsigned& s, unsigned& x) {
  s += v.x + v.y + v.z + v.w;
  x ^= v.x ^ v.y ^ v.z ^ v.w;
}

// Fold n words from src into this thread's partials; with kLand, also
// store them to dst. Vector loads need src (and dst) 16-byte aligned at the
// same phase; otherwise the whole range takes the scalar path.
template <bool kLand>
__device__ __forceinline__ void fold_range(const unsigned* __restrict__ src,
                                           unsigned* __restrict__ dst,
                                           int64_t n, unsigned& s, unsigned& x) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  bool vec = true;
  if (kLand) vec = ((sa ^ reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  int64_t head = vec ? (int64_t)(((16 - (sa & 15)) & 15) >> 2) : n;
  if (head > n) head = n;
  const int64_t t = threadIdx.x;
  const int64_t bd = blockDim.x;
  for (int64_t j = t; j < head; j += bd) {
    const unsigned w = src[j];
    if (kLand) dst[j] = w;
    s += w;
    x ^= w;
  }
  const int64_t nv = (n - head) >> 2;
  const uint4* __restrict__ vs = reinterpret_cast<const uint4*>(src + head);
  uint4* __restrict__ vd = kLand ? reinterpret_cast<uint4*>(dst + head) : nullptr;
  int64_t j = t;
  for (; j + 3 * bd < nv; j += 4 * bd) {
    const uint4 a = vs[j], b = vs[j + bd], c = vs[j + 2 * bd], d = vs[j + 3 * bd];
    if (kLand) {
      vd[j] = a;
      vd[j + bd] = b;
      vd[j + 2 * bd] = c;
      vd[j + 3 * bd] = d;
    }
    fold4(a, s, x);
    fold4(b, s, x);
    fold4(c, s, x);
    fold4(d, s, x);
  }
  for (; j < nv; j += bd) {
    const uint4 a = vs[j];
    if (kLand) vd[j] = a;
    fold4(a, s, x);
  }
  for (int64_t k = head + (nv << 2) + t; k < n; k += bd) {
    const unsigned w = src[k];
    if (kLand) dst[k] = w;
    s += w;
    x ^= w;
  }
}

// Reduce the block's partials and add them into *sum_out / *xor_out.
__device__ __forceinline__ void block_commit(unsigned s, unsigned x,
                                             unsigned* sum_out, unsigned* xor_out) {
  __shared__ unsigned ss[32], sx[32];
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    x ^= __shfl_xor_sync(0xffffffffu, x, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    ss[warp] = s;
    sx[warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    s = lane < nw ? ss[lane] : 0u;
    x = lane < nw ? sx[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      x ^= __shfl_xor_sync(0xffffffffu, x, off);
    }
    if (lane == 0) {
      atomicAdd(sum_out, s);
      atomicXor(xor_out, x);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
chunk_checksums_kernel(const unsigned* __restrict__ words, int64_t pw, int64_t chunk,
                       unsigned* sums, unsigned* xors) {
  const int64_t piece = blockIdx.x;
  const int64_t lo = (int64_t)blockIdx.y * chunk;
  if (lo >= pw) return;
  const int64_t n = (pw - lo < chunk) ? (pw - lo) : chunk;
  unsigned s = 0, x = 0;
  fold_range<false>(words + piece * pw + lo, nullptr, n, s, x);
  block_commit(s, x, sums + piece, xors + piece);
}

__global__ void __launch_bounds__(kThreads)
land_checksum_kernel(unsigned* __restrict__ buffer, int64_t n_slots,
                     const unsigned* __restrict__ pieces, const int* __restrict__ slots,
                     int64_t pw, int64_t chunk, unsigned* sums, unsigned* xors) {
  const int64_t i = blockIdx.x;
  const int64_t lo = (int64_t)blockIdx.y * chunk;
  if (lo >= pw) return;
  const int64_t slot = slots[i];
  if (slot < 0 || slot >= n_slots) return;  // callers validate; never write out of bounds
  const int64_t n = (pw - lo < chunk) ? (pw - lo) : chunk;
  unsigned s = 0, x = 0;
  fold_range<true>(pieces + i * pw + lo, buffer + slot * pw + lo, n, s, x);
  block_commit(s, x, sums + i, xors + i);
}

// Words per block: enough blocks to keep every SM busy (kTargetBlocks in
// all) but no fewer than kMinSplitWords nor more than kSplitWords, a
// multiple of 4 (so splits keep the piece's 16-byte phase), and few enough
// splits for gridDim.y.
int64_t split_words(int64_t pw, int64_t n) {
  int64_t chunk = (n * pw + kTargetBlocks - 1) / kTargetBlocks;
  if (chunk > kSplitWords) chunk = kSplitWords;
  if (chunk < kMinSplitWords) chunk = kMinSplitWords;
  const int64_t least = (pw + kMaxSplits - 1) / kMaxSplits;
  if (chunk < least) chunk = least;
  return (chunk + 3) & ~int64_t(3);
}

}  // namespace

extern "C" {

// sums/xors: n zero-initialised uint32 each. Returns a cudaError_t code.
int df_chunk_checksums(const void* words, int64_t n, int64_t pw, void* sums,
                       void* xors, void* stream) {
  if (n <= 0 || pw <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int64_t chunk = split_words(pw, n);
  const dim3 grid((unsigned)n, (unsigned)((pw + chunk - 1) / chunk));
  chunk_checksums_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, pw, chunk, (unsigned*)sums, (unsigned*)xors);
  return (int)cudaGetLastError();
}

// buffer: n_slots * pw words, updated in place. pieces: k * pw words.
// slots: k int32 slot indices. sums/xors: k zero-initialised uint32 each.
int df_land_and_checksum(void* buffer, int64_t n_slots, const void* pieces,
                         const void* slots, int64_t k, int64_t pw, void* sums,
                         void* xors, void* stream) {
  if (k <= 0 || pw <= 0 || k > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int64_t chunk = split_words(pw, k);
  const dim3 grid((unsigned)k, (unsigned)((pw + chunk - 1) / chunk));
  land_checksum_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (unsigned*)buffer, n_slots, (const unsigned*)pieces, (const int*)slots, pw,
      chunk, (unsigned*)sums, (unsigned*)xors);
  return (int)cudaGetLastError();
}

const char* df_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
