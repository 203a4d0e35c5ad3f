// Piece checksums for the device sink, written by hand for Hopper (sm_90a).
//
// Both kernels fold a piece of little-endian 32-bit words w_i into
//   sum32 = sum(w_i) mod 2^32      xor32 = xor(w_i)
// which is the contract of dragonfly2_tpu/ops/checksum.py (checksum_numpy).
// Both operations are associative and commutative mod 2^32, so any order
// of partial sums gives the same bits.
//
// df_chunk_checksums (K1) replaces _chunk_checksums_pallas
//   (dragonfly2_tpu/ops/checksum.py:67-130): (sum32, xor32) of n pieces.
//   Bound: bytes, n*pw*4 read once + 8n written, over 3.35 TB/s.
//   Design: the TPU ran a sequential grid and carried the partial sums in
//   VMEM from one step to the next. Here blocks run in parallel and in no
//   order, so each piece is cut into splits of 16-256 KiB, one block per
//   (piece, split), about 16 blocks for each SM in all. Each thread loads
//   16 bytes at a time, neighbouring threads on neighbouring addresses,
//   four loads in flight; a warp-shuffle add tree and xor tree, then shared
//   memory, reduce the block, and one atomicAdd / atomicXor per block
//   combines the splits into outputs the caller zeroed.
//
// df_land_and_checksum (K2) replaces _land_checksum_pallas
//   (dragonfly2_tpu/ops/checksum.py:133-218): stores k pieces into their
//   slots of a flat buffer, in place, and folds each piece on the way.
//   Bound: bytes, 2*k*pw*4 (each word read once, written once) + 12k (slot
//   in, sum and xor out) over 3.35 TB/s.
//   Design: one launch, no zeroed outputs, no atomics, no state between
//   calls (the sink worker and a feed may launch it on two streams at
//   once). A piece belongs to one thread block cluster of C blocks
//   (C <= 16); the cluster's blocks walk the piece side by side, and the
//   cluster combines their C partials through distributed shared memory,
//   where rank 0 stores the piece's result with a plain store: at sums[i],
//   or at sums[slot] when the caller passes the sink's per-slot arrays.
//   The piece's 16-byte-aligned middle moves by Hopper's 1-D bulk copies,
//   in chunks dealt round the cluster's blocks: in each block one thread
//   keeps a ring of stages in flight from the piece to shared memory
//   (cp.async.bulk ... mbarrier::complete_tx) and back out to the slot
//   (cp.async.bulk ... bulk_group), while every thread folds the arrived
//   stage from shared memory. So the bytes in flight cost no registers,
//   and each byte is read once from memory and written once. The
//   unaligned head and tail (at most 3 words each), a piece whose source
//   and slot differ in 16-byte phase, and every piece when the plan has no
//   stages go through registers (fold_range<true>, eight 16-byte loads in
//   flight a thread). The launch geometry (C, stages, threads) is planned
//   in Python: dragonfly2_tpu_torch/ops/checksum.py, _land_plan. On an
//   H100 at k=8 x 32 MiB a ring of two 16 KiB stages measured fastest;
//   deeper rings and L2 prefetches ahead of the ring measured slower.
//
// All offsets are 64-bit: a 5 GB buffer has byte offsets past 2^31.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSplitWords = int64_t(1) << 16;    // at most 256 KiB a block
constexpr int64_t kMinSplitWords = int64_t(1) << 12; // at least 16 KiB a block
constexpr int64_t kTargetBlocks = 132 * 16;          // 16 blocks per H100 SM
constexpr int64_t kMaxSplits = 65535;                // gridDim.y limit

constexpr int kLandMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxStages = 16;
constexpr int kMaxRingBytes = 200 * 1024;            // of the SM's 227 KB

__device__ __forceinline__ void fold4(const uint4 v, unsigned& s, unsigned& x) {
  s += v.x + v.y + v.z + v.w;
  x ^= v.x ^ v.y ^ v.z ^ v.w;
}

// Fold n words from src into this thread's partials; with kLand, also
// store them to dst. Thread t of bd threads takes every bd-th 16-byte word
// (every bd-th word where a scalar loop runs), kUnroll 16-byte loads in
// flight. Vector loads need src (and dst) 16-byte aligned at the same
// phase; otherwise the whole range takes the scalar path.
template <bool kLand, int kUnroll>
__device__ __forceinline__ void fold_range(const unsigned* __restrict__ src,
                                           unsigned* __restrict__ dst, int64_t n,
                                           unsigned& s, unsigned& x, int64_t t,
                                           int64_t bd) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  bool vec = true;
  if (kLand) vec = ((sa ^ reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  int64_t head = vec ? (int64_t)(((16 - (sa & 15)) & 15) >> 2) : n;
  if (head > n) head = n;
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
  for (; j + (kUnroll - 1) * bd < nv; j += kUnroll * bd) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = vs[j + u * bd];
    if (kLand) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) vd[j + u * bd] = v[u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fold4(v[u], s, x);
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

// Reduce the block's partials; thread 0 returns the block's totals.
__device__ __forceinline__ void block_reduce(unsigned& s, unsigned& x) {
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
  }
}

// Reduce the block's partials and add them into *sum_out / *xor_out.
__device__ __forceinline__ void block_commit(unsigned s, unsigned x,
                                             unsigned* sum_out, unsigned* xor_out) {
  block_reduce(s, x);
  if (threadIdx.x == 0) {
    atomicAdd(sum_out, s);
    atomicXor(xor_out, x);
  }
}

// ---- Hopper bulk copies and mbarriers (PTX) -------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, unsigned bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ---- K2: the stage ring ---------------------------------------------------

// Land this block's chunks of n words (a multiple of 4; src and dst
// 16-byte aligned), cut into chunks of stage_words and dealt round the
// cluster: chunks part, part + parts, part + 2 parts, ..., so that the
// blocks of a cluster walk the piece side by side. Each chunk passes
// through a ring of `stages` stages in shared memory and is folded there
// by every thread. `uses` counts the stages this block has filled so far,
// which gives each mbarrier's phase. Thread 0 issues every copy; a stage
// is refilled as soon as every thread has folded it and its store has
// read it (wait_group.read 0), so `stages` loads stay in flight.
__device__ __forceinline__ void bulk_range(const unsigned* src, unsigned* dst, int64_t n,
                                           int64_t part, int64_t parts,
                                           unsigned char* ring, uint64_t* full,
                                           int stage_words, int stages, uint32_t& uses,
                                           unsigned& s, unsigned& x) {
  const int64_t total = (n + stage_words - 1) / stage_words;
  const int64_t chunks = part < total ? (total - part + parts - 1) / parts : 0;
  if (chunks == 0) return;
  const int64_t stage_bytes = (int64_t)stage_words * 4;
  auto offset = [&](int64_t c) { return (part + c * parts) * stage_words; };
  auto chunk_words = [&](int64_t c) {
    const int64_t left = n - offset(c);
    return left < stage_words ? left : (int64_t)stage_words;
  };
  auto issue = [&](int64_t c) {
    const int st = (int)((uses + c) % stages);
    const unsigned bytes = (unsigned)(chunk_words(c) * 4);
    const uint32_t bar = smem_u32(&full[st]);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(ring + st * stage_bytes), src + offset(c), bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int64_t c = 0; c < chunks && c < stages; ++c) issue(c);
  }
  for (int64_t c = 0; c < chunks; ++c) {
    const uint32_t g = uses + (uint32_t)c;
    const int st = (int)(g % stages);
    unsigned char* stage = ring + st * stage_bytes;
    mbar_wait(smem_u32(&full[st]), (g / stages) & 1);
    const int64_t words = chunk_words(c);
    if (threadIdx.x == 0) bulk_store(dst + offset(c), smem_u32(stage), (unsigned)(words * 4));
    const uint4* v = reinterpret_cast<const uint4*>(stage);
    for (int64_t j = threadIdx.x; j < (words >> 2); j += blockDim.x) fold4(v[j], s, x);
    // This thread's reads of the stage come before the async proxy's next
    // write of it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0 && c + stages < chunks) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      issue(c + stages);
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  uses += (uint32_t)chunks;
}

// One cluster per piece (blockIdx.x = rank in the cluster); a cluster
// takes pieces blockIdx.y, blockIdx.y + gridDim.y, ... With a ring
// (stages > 0) and the piece and its slot at one 16-byte phase, the
// piece's aligned middle goes through the ring in chunks dealt round the
// cluster's blocks, and its head and tail (at most 3 words each) through
// registers; otherwise the whole piece goes through registers, the
// cluster's threads side by side over it.
__global__ void __launch_bounds__(kLandMaxThreads)
land_checksum_kernel(unsigned* __restrict__ buffer, int64_t n_slots,
                     const unsigned* __restrict__ pieces, const int* __restrict__ slots,
                     int64_t k, int64_t pw, int stage_words, int stages, unsigned* sums,
                     unsigned* xors, int scatter) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ unsigned part[2];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned csize = cluster.num_blocks();
  const int64_t first = (int64_t)rank * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)csize * blockDim.x;
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(smem_u32(&full[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t uses = 0;
  for (int64_t i = blockIdx.y; i < k; i += gridDim.y) {
    const int64_t slot = slots[i];
    const bool in_range = slot >= 0 && slot < n_slots;  // never write out of bounds
    unsigned s = 0, x = 0;
    if (in_range) {
      const unsigned* src = pieces + i * pw;
      unsigned* dst = buffer + slot * pw;
      const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
      if (stages > 0 && ((sa ^ reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
        int64_t head = (int64_t)(((16 - (sa & 15)) & 15) >> 2);
        if (head > pw) head = pw;
        const int64_t mid = ((pw - head) >> 2) << 2;
        fold_range<true, 8>(src, dst, head, s, x, first, stride);
        fold_range<true, 8>(src + head + mid, dst + head + mid, pw - head - mid, s, x,
                            first, stride);
        bulk_range(src + head, dst + head, mid, rank, csize, ring, full, stage_words,
                   stages, uses, s, x);
      } else {
        fold_range<true, 8>(src, dst, pw, s, x, first, stride);
      }
    }
    block_reduce(s, x);
    if (threadIdx.x == 0) {
      part[0] = s;
      part[1] = x;
    }
    cluster.sync();
    if (rank == 0 && threadIdx.x == 0) {
      for (unsigned r = 1; r < csize; ++r) {
        const unsigned* p = cluster.map_shared_rank(part, r);
        s += p[0];
        x ^= p[1];
      }
      if (!scatter) {
        sums[i] = s;   // 0, 0 for a slot out of range
        xors[i] = x;
      } else if (in_range) {
        sums[slot] = s;
        xors[slot] = x;
      }
    }
    cluster.sync();  // rank 0 has read every partial before they change
  }
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

__global__ void __launch_bounds__(kThreads)
chunk_checksums_kernel(const unsigned* __restrict__ words, int64_t pw, int64_t chunk,
                       unsigned* sums, unsigned* xors) {
  const int64_t piece = blockIdx.x;
  const int64_t lo = (int64_t)blockIdx.y * chunk;
  if (lo >= pw) return;
  const int64_t n = (pw - lo < chunk) ? (pw - lo) : chunk;
  unsigned s = 0, x = 0;
  fold_range<false, 4>(words + piece * pw + lo, nullptr, n, s, x, threadIdx.x,
                      blockDim.x);
  block_commit(s, x, sums + piece, xors + piece);
}

// The launch configuration of K2 for a plan. The kernel's attributes (the
// largest ring, clusters of up to 16 blocks) are set once per device.
cudaError_t land_config(int cluster, int grid_y, int threads, int smem,
                        cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  static std::atomic<uint64_t> configured{0};  // one bit per device
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const uint64_t bit = uint64_t(1) << (device & 63);
  if (!(configured.load() & bit)) {
    e = cudaFuncSetAttribute(land_checksum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxRingBytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(land_checksum_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    configured.fetch_or(bit);
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)cluster, (unsigned)grid_y, 1);
  cfg->blockDim = dim3((unsigned)threads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

bool land_plan_ok(int cluster, int grid_y, int stage_words, int stages, int threads) {
  return cluster >= 1 && cluster <= kMaxCluster && grid_y >= 1 && grid_y <= 65535 &&
         threads >= 32 && threads <= kLandMaxThreads && threads % 32 == 0 &&
         (stages == 0 || (stages >= 2 && stages <= kMaxStages && stage_words > 0 &&
                          stage_words % 4 == 0 &&
                          (int64_t)stages * stage_words * 4 <= kMaxRingBytes));
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
// slots: k int32 slot indices. The plan: a cluster of `cluster` blocks of
// `threads` threads a piece, `grid_y` clusters side by side, a ring of
// `stages` stages of `stage_words` words a block (0 stages: registers
// only). With scatter = 0, sums/xors hold k uint32 each and get piece i's
// result at [i]; with scatter = 1 they hold n_slots each and get it at
// [slots[i]]. Nothing needs zeroing. Returns a cudaError_t code.
int df_land_and_checksum(void* buffer, int64_t n_slots, const void* pieces,
                         const void* slots, int64_t k, int64_t pw, int cluster,
                         int grid_y, int stage_words, int stages, int threads, void* sums,
                         void* xors, int scatter, void* stream) {
  if (k <= 0 || pw <= 0 || !land_plan_ok(cluster, grid_y, stage_words, stages, threads))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      land_config(cluster, grid_y, threads, stages * stage_words * 4, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  cfg.stream = (cudaStream_t)stream;
  e = cudaLaunchKernelEx(&cfg, land_checksum_kernel, (unsigned*)buffer, n_slots,
                         (const unsigned*)pieces, (const int*)slots, k, pw, stage_words,
                         stages, (unsigned*)sums, (unsigned*)xors, scatter);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks of K2 the card holds at once with
// `threads` threads and a ring of `smem` bytes a block; negative: the
// cudaError_t code, negated.
int df_land_max_active_clusters(int cluster, int threads, int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = land_config(cluster, cluster, threads, smem, &cfg, &attr);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, land_checksum_kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

const char* df_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
