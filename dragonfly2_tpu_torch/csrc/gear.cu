// Gear-hash cut candidates for content-defined chunking, written by hand for
// Hopper (sm_90a).
//
// df_gear_candidates (K3) is the port's counterpart of the JAX package's
//   native host scan df_chunk_scan (dragonfly2_tpu/native/src/dfchunk.cc:46),
//   which dragonfly2_tpu/delta/chunker.py:153-173 selects. It is not a Pallas
//   kernel. For every position i in [ctx, n) of a region of n bytes r:
//     H[i] = sum_{j=0}^{min(31, i)} gear[r[i-j]] << j   (mod 2^32),
//   the gear recurrence h = 2h + gear[b], whose mod-2^32 form is a 32-byte
//   window, prefix-only at the region's start. Position i is a candidate when
//   the top mask_bits of H[i] are zero (H[i] < 2^(32 - mask_bits)). The kernel
//   appends each candidate's position to `out` in no order; the caller sorts
//   the few it gets. This is dragonfly2_tpu/delta/chunker.py's _scan_python.
//   Bound: bytes, n read once + 8 bytes a candidate written, over 3.35 TB/s. A
//   position costs a table lookup, a shift-add and a compare: at 3 operations
//   a byte the 32-bit rate bounds it far below the bytes.
//   Design: each thread owns a run of kRun positions. It reads the run as
//   16-byte words straight from device memory, kGroup words in flight, and
//   runs the recurrence over them after at most 31 bytes of warm-up before the
//   run: the window is 32 bytes, so the warm-up gives every hash of the run its
//   exact value (what dfchunk.cc does at the start of each of its streams).
//   The unrolled steps over a word only hash and set one bit of a hit mask a
//   hit; the hits are appended after the word. The warm-up and a group that
//   sticks out of the region (at its two ends) go byte by byte.
//   The 1 KiB gear table sits in shared memory. A candidate goes to the
//   block's list in shared memory (one shared atomicAdd); the block then
//   reserves its slots in `out` with one global atomicAdd and stores them.
//   Past kLocal candidates in a block (a small mask_bits) a thread reserves
//   its own slot in device memory. `count` ends as the number of candidates
//   whatever `cap` is; no slot at or past `cap` is written, and the wrapper
//   (dragonfly2_tpu_torch/ops/gear.py) launches again with room for all.
//   The region may start at any byte: the kernel reads the 16-byte words that
//   hold it and skips the bytes outside it. Offsets are 64-bit: a region may
//   hold more than 2^31 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // one gear table entry a thread to load
constexpr long long kRun = 256;      // positions a thread, a multiple of 16 * kGroup
constexpr int kGroup = 8;            // 16-byte words a thread keeps in flight
constexpr long long kWarm = 31;      // bytes before a run that reach its hashes
constexpr int kWindow = 32;
constexpr int kLocal = 1024;         // a block's candidate list in shared memory

// Byte b (0-15, a constant after unrolling) of a little-endian 16-byte word.
__device__ __forceinline__ unsigned byte_at(const uint4& v, int b) {
  const int k = b >> 2;
  const unsigned w = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  return (w >> ((b & 3) << 3)) & 0xffu;
}

// Append candidate p: to the block's list while it has room, else straight
// to a slot of `out`.
__device__ __forceinline__ void emit(long long p, unsigned* listed, long long* list,
                                     unsigned long long* count, long long* out,
                                     unsigned long long cap) {
  const unsigned i = atomicAdd(listed, 1u);
  if (i < kLocal) {
    list[i] = p;
  } else {
    const unsigned long long s = atomicAdd(count, 1ull);
    if (s < cap) out[s] = p;
  }
}

// Positions are counted from the 16-byte boundary at or before the region's
// first byte (`words`): the region's bytes are [mis, end), candidates are
// reported from `first` = mis + ctx on, as region positions (q - mis).
__global__ void __launch_bounds__(kThreads)
gear_scan_kernel(const uint4* __restrict__ words, long long mis, long long end,
                 long long first, const unsigned* __restrict__ gear_in,
                 unsigned limit, long long* __restrict__ out, unsigned long long cap,
                 unsigned long long* __restrict__ count) {
  __shared__ unsigned gear[256];
  __shared__ long long list[kLocal];
  __shared__ unsigned listed;
  __shared__ unsigned long long base;
  gear[threadIdx.x] = gear_in[threadIdx.x];
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();

  const long long q0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kRun;
  if (q0 < end) {
    const unsigned char* bytes = reinterpret_cast<const unsigned char*>(words);
    const long long q1 = q0 + kRun < end ? q0 + kRun : end;
    const long long lo = q0 > mis ? q0 : mis;   // the run's first byte of the region
    long long w = q0 - kWarm;                    // the first byte its hashes see
    if (w < mis) w = mis;
    unsigned h = 0;
    // Warm-up over [w, q0): no candidates.
#pragma unroll 1
    for (long long q = w; q < q0; ++q) h = (h << 1) + gear[__ldg(bytes + q)];
    for (long long g = q0; g < q1; g += 16 * kGroup) {
      if (g >= lo && g + 16 * kGroup <= q1) {
        // The whole group lies in the region. The unrolled steps only hash
        // and set a bit a hit; the rare hits are appended after each word,
        // so the loop's code stays small enough for the instruction cache.
        uint4 v[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) v[k] = __ldg(words + ((g >> 4) + k));
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          unsigned hits = 0;
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            h = (h << 1) + gear[byte_at(v[k], b)];
            hits |= (unsigned)(h < limit) << b;
          }
          while (hits) {
            const long long q = g + 16 * k + (__ffs(hits) - 1);
            hits &= hits - 1;
            if (q >= first) emit(q - mis, &listed, list, count, out, cap);
          }
        }
      } else {
        // A run's partial group at the region's edges: byte by byte.
        const long long stop = g + 16 * kGroup < q1 ? g + 16 * kGroup : q1;
#pragma unroll 1
        for (long long q = g > lo ? g : lo; q < stop; ++q) {
          h = (h << 1) + gear[__ldg(bytes + q)];
          if (h < limit && q >= first) emit(q - mis, &listed, list, count, out, cap);
        }
      }
    }
  }

  __syncthreads();
  const unsigned n_list = listed < (unsigned)kLocal ? listed : (unsigned)kLocal;
  if (threadIdx.x == 0) base = n_list ? atomicAdd(count, (unsigned long long)n_list) : 0ull;
  __syncthreads();
  for (unsigned i = threadIdx.x; i < n_list; i += kThreads) {
    const unsigned long long s = base + i;
    if (s < cap) out[s] = list[i];
  }
}

}  // namespace

extern "C" {

// data: n bytes on the card, at any alignment. gear: the 256 uint32 table.
// out: room for `cap` int64 positions. count: one uint64, zeroed by the
// caller; it ends as the number of candidates, which may exceed `cap` (then
// the slots past `cap` were not written). Returns a cudaError_t code.
int df_gear_candidates(const void* data, int64_t n, int64_t ctx, const void* gear,
                       int mask_bits, void* out, int64_t cap, void* count,
                       void* stream) {
  if (n <= 0 || ctx < 0 || ctx > n || ctx >= kWindow || mask_bits < 1 ||
      mask_bits > 31 || cap < 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(data);
  const long long mis = (long long)(a & 15);
  const long long end = mis + (long long)n;
  const long long per_block = (long long)kThreads * kRun;
  const long long blocks = (end + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gear_scan_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(a - (uintptr_t)mis), mis, end, mis + ctx,
      (const unsigned*)gear, 1u << (32 - mask_bits), (long long*)out,
      (unsigned long long)cap, (unsigned long long*)count);
  return (int)cudaGetLastError();
}

const char* df_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
