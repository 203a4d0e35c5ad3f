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
//
// Bound: bytes, n read once + 8 bytes a candidate written, over 3.35 TB/s.
//   A position costs a table lookup, a shift-add and a test: at 3 operations
//   a byte the card's int32 rate bounds it below the bytes, but only by ~1.3x.
//
// What held the kernel's first design back, timed on the card with
//   tools/gear_variants.py (PERF.md §6): each thread re-hashed
//   the 31 bytes before its run from device memory, one dependent load a
//   byte: more than half of its time at 64 MiB and a third at 8 MiB. Its
//   lanes read 256 bytes apart, its one copy of the table made lanes collide
//   on banks, and a 64 KiB block put 1 MiB on 17 SMs.
//
// What bounds this design: at 64 MiB device memory (its tiles alone, with no
//   hashing, take 1.1x the time of csrc/read_floor.cu's plain read of the
//   same words, the kernel 1.25x). At the manifest's 8 MiB + 31 B and below,
//   a launch's fixed ~2 us and the latency of one tile a warp: a warp hashes
//   only once its tile has landed, and a block that holds a candidate ends
//   one global atomic later. Cutting the steps a byte (a fifth fewer lookups,
//   a quarter fewer operations) or halving a lane's serial chain moved
//   neither (PERF.md §6).
//
// Design:
//   - Tiles in shared memory, read coalesced. Each warp walks its own tiles
//     of kTile bytes (a run of kRun bytes a lane) with a ring of kStages
//     stages: cp.async brings neighbouring 16-byte words to neighbouring
//     lanes, and the 32 bytes before the tile (its halo) with them, while the
//     warp hashes the stage before. Warps meet only at __syncwarp in the
//     loop. The words of the region are read from the one at or before its
//     first byte up to the one that holds its last, never beyond.
//   - No warm-up from device memory. A lane's run starts in shared memory;
//     the 32-byte window state at its start comes from the 32 bytes before
//     it there (the lane before's last two words, or the halo), two words of
//     16 unrolled steps with no test.
//   - No bank conflicts. A lane's run sits kRunWords + 1 words after the
//     lane before's, so the 8 lanes of a 16-byte access phase fall on 8
//     different groups of 4 banks. The table has one copy a lane: entry e of
//     lane c's copy is the word at byte e * 256 + 4c of a 64 KiB-aligned
//     block (half of it unused), so every lane of a lookup hits its own bank
//     and one byte_perm of a data word and the table's address makes the
//     lookup's address. The upper half of a block's warps fill the table
//     while the lower half's first tiles are on their way.
//   - A step is a byte_perm, a lookup, a shift-add and a third of a min: the
//     16 hashes of a word are tested together (min < limit). The rare word
//     with a candidate is hashed again from its saved state with a hit mask;
//     at the region's ragged ends bytes before its first are never hashed
//     and positions at or past its end never reported.
//   - Every SM busy: one block of kWarps warps an SM (its shared memory
//     holds the block alone), the grid min(tiles, SMs), tiles dealt to the
//     blocks first; a lane takes the long run while a region gives every SM
//     at least kWarps / 2 tiles of it, else the short one. 8 MiB + 31 B so
//     spreads over 132 SMs with 15-16 warps each, 1 MiB + 31 B with 3-4;
//     past that each warp loops.
//   - Candidates: the block's list in shared memory (one shared atomicAdd a
//     candidate), then one global atomicAdd a block for its slots. Past
//     kLocal in a block a lane reserves its own slot in device memory.
//     `count` ends as the number of candidates whatever `cap` is; no slot at
//     or past `cap` is written, and the wrapper
//     (dragonfly2_tpu_torch/ops/gear.py) launches again with room for all.
//   Offsets are 64-bit: a region may hold more than 2^31 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;           // one block an SM
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;           // a warp's ring
constexpr unsigned kTableBytes = 1u << 16;   // entry e, lane c: byte e*256 + 4c
constexpr int kLocal = 512;          // a block's candidate list in shared memory
constexpr int kMaxDevices = 64;
// 16-byte words of a lane's run: the long run while the region gives at
// least half the warps of every SM a tile of it, else the short one.
constexpr int kLongRunWords = 8;
constexpr int kShortRunWords = 4;

// The shapes that follow from a lane's run of kRunWords words.
template <int kRunWords>
struct Geometry {
  static_assert(kRunWords >= 2 && (kRunWords & (kRunWords - 1)) == 0,
                "a run holds the two words of its successor's warm-up, and "
                "tiles split evenly into runs");
  static constexpr long long kRun = 16 * kRunWords;          // bytes a lane
  static constexpr long long kTile = 32 * kRun;              // bytes a warp's tile
  static constexpr int kLaneWords = kRunWords + 1;           // a run and its pad
  static constexpr int kStageWords = 33 * kLaneWords;        // the halo's slot, 32 runs
};

static_assert(256 * 8 % (kThreads / 2) == 0 && kThreads >= 128,
              "half the threads bring the table in and fill it evenly");

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

__device__ __forceinline__ void copy16(uint4* dst, const uint4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// The word at tile word g lands at its lane's run: lane g / kRunWords (slot
// 1 + lane; slot 0 is the halo's), word g % kRunWords.
template <int kRunWords>
__device__ __forceinline__ int slot_of(int g) {
  return (g / kRunWords + 1) * Geometry<kRunWords>::kLaneWords + g % kRunWords;
}

// Bring tile j (word-space bytes [j*kTile, (j+1)*kTile)) and its halo into a
// stage: the words below n_words only.
template <int kRunWords>
__device__ __forceinline__ void load_tile(uint4* stage, const uint4* __restrict__ words,
                                          long long n_words, long long j, int lane) {
  const long long w0 = j * (Geometry<kRunWords>::kTile / 16);
#pragma unroll
  for (int k = 0; k < kRunWords; ++k) {
    const int g = lane + 32 * k;
    if (w0 + g < n_words) copy16(stage + slot_of<kRunWords>(g), words + w0 + g);
  }
  if (lane < 2 && j > 0) copy16(stage + kRunWords - 2 + lane, words + w0 - 2 + lane);
}

// The shared-memory address of byte b's gear word: `off` is the table's
// address (64 KiB-aligned) plus the lane's offset 4 * lane, so one byte_perm
// makes it: bytes 0, 2 and 3 from `off`, byte 1 the data byte (the entry).
__device__ __forceinline__ unsigned entry_at(const uint4& v, unsigned off, int b) {
  const unsigned w = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
  return __byte_perm(w, off, 0x7604u | ((b & 3) << 4));
}

__device__ __forceinline__ unsigned lookup(unsigned at) {
  unsigned g;
  asm("ld.shared.u32 %0, [%1];" : "=r"(g) : "r"(at));
  return g;
}

// 16 gear steps over the bytes of v, in order; the min of the 16 hashes.
template <bool kTest>
__device__ __forceinline__ unsigned hash_word(const uint4& v, unsigned& h, unsigned off) {
  unsigned m = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    h = (h << 1) + lookup(entry_at(v, off, b));
    if (kTest) m = min(m, h);
  }
  return m;
}

// The region's first word (word-space position 0), which only lane 0 of
// tile 0 hashes: its bytes before `mis` are not the region's, so they look
// up the zero word kept at byte 128 of each table row (lane 0's pad) and
// stay out of the min.
__device__ __forceinline__ unsigned first_word(const uint4& v, unsigned& h, unsigned off,
                                               long long mis) {
  unsigned m = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    h = (h << 1) + lookup(entry_at(v, off, b) + (b < mis ? 128u : 0u));
    if (b >= mis) m = min(m, h);
  }
  return m;
}

// A word whose hashes reach under `limit`, again from state h, its bytes
// from `from` on: the 16 steps unrolled set a bit a hit, and every hit at a
// position in [first, end) is a candidate, reported as a region position
// (q - mis).
__device__ __forceinline__ void exact_word(const uint4& v, unsigned h, int from, long long p,
                                          long long mis, long long first, long long end,
                                          unsigned limit, unsigned off, unsigned* listed,
                                          long long* list, unsigned long long* count,
                                          long long* out, unsigned long long cap) {
  unsigned hits = 0;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const unsigned next = (h << 1) + lookup(entry_at(v, off, b));
    h = b >= from ? next : h;
    hits |= (unsigned)(b >= from && h < limit) << b;
  }
  while (hits) {
    const long long q = p + (__ffs(hits) - 1);
    hits &= hits - 1;
    if (q >= first && q < end) emit(q - mis, listed, list, count, out, cap);
  }
}

// Positions are counted from the 16-byte boundary at or before the region's
// first byte (`words`): the region's bytes are [mis, end), its words
// [0, n_words), candidates are reported from `first` = mis + ctx on, as
// region positions (q - mis).
template <int kRunWords>
__global__ void __launch_bounds__(kThreads, 1)
gear_scan_kernel(const uint4* __restrict__ words, long long n_words, long long mis,
                 long long end, long long first, long long tiles,
                 const unsigned* __restrict__ gear_in, unsigned limit,
                 long long* __restrict__ out, unsigned long long cap,
                 unsigned long long* __restrict__ count) {
  extern __shared__ uint4 smem[];
  __shared__ __align__(16) unsigned gear_s[256];
  __shared__ long long list[kLocal];
  __shared__ unsigned listed;
  __shared__ unsigned long long base;
  using G = Geometry<kRunWords>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // The table sits at the first 64 KiB boundary of the shared window past
  // the dynamic memory's start, so that its address is one byte_perm away
  // (entry_at); the warps' stages fill the memory before and after it.
  const unsigned start = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned table_at = (start + kTableBytes - 1) & ~(kTableBytes - 1);
  const unsigned off = table_at | 4u * lane;
  uint4* table_rows = smem + (table_at - start) / 16;   // a row of 16 words an entry
  const int ahead = (int)((table_at - start) / (16 * G::kStageWords));   // stages before it
  auto stage_of = [&](int s) {
    const int i = warp * kStages + s;
    return i < ahead ? smem + i * G::kStageWords
                     : table_rows + kTableBytes / 16 + (i - ahead) * G::kStageWords;
  };
  {
    // The host refuses a device whose blocks cannot hold the worst case
    // (smem_need), so this never fires; it is an assertion, never quietly
    // wrong.
    unsigned dyn;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
    const int behind = kWarps * kStages - ahead;
    if (table_at + kTableBytes + 16u * G::kStageWords * (behind > 0 ? behind : 0) > start + dyn)
      __trap();
  }
  // Tiles are dealt to the blocks first, then to the warps of a block.
  const long long j0 = blockIdx.x + (long long)gridDim.x * warp;
  const long long step = (long long)gridDim.x * kWarps;

  // The table and the first tiles side by side. The upper half of the
  // warps, which get the last tiles (and none while a region is small),
  // bring the 1 KiB table in (cp.async), wait for it among themselves and
  // fill the 32 copies, and only then ask for their tiles, while the lower
  // half ask for theirs at once: the tiles then land in two waves, and
  // hashing starts on the first while the second is on its way. Thread t of
  // the upper half fills copies 4g..4g+3 (g = t % 8) of entries t / 8 + 32k,
  // one 16-byte store each, 8 neighbouring threads on the 8 16-byte words of
  // a row (no bank conflicts).
  if (warp >= kWarps / 2) {
    const int t = threadIdx.x - kThreads / 2;
    if (t < 64)
      copy16(reinterpret_cast<uint4*>(gear_s) + t, reinterpret_cast<const uint4*>(gear_in) + t);
    commit();
    asm volatile("cp.async.wait_group 0;\n" ::);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads / 2));
#pragma unroll
    for (int k = 0; k < 256 * 8 / (kThreads / 2); ++k) {
      const int e = (t >> 3) + k * (kThreads / 16);
      const unsigned g = gear_s[e];
      table_rows[e * 16 + (t & 7)] = make_uint4(g, g, g, g);
      if ((t & 7) == 0) table_rows[e * 16 + 8].x = 0u;   // see first_word
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (j0 + s * step < tiles)
      load_tile<kRunWords>(stage_of(s), words, n_words, j0 + s * step, lane);
    commit();
  }
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();

  int stage = 0;
  for (long long j = j0; j < tiles; j += step) {
    const long long jn = j + (kStages - 1) * step;
    int next = stage + kStages - 1;
    if (next >= kStages) next -= kStages;
    if (jn < tiles) load_tile<kRunWords>(stage_of(next), words, n_words, jn, lane);
    commit();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncwarp();

    const uint4* tile = stage_of(stage);
    const long long q0 = j * G::kTile + lane * G::kRun;   // the run's first byte
    if (q0 < end) {
      const uint4* run = tile + (lane + 1) * G::kLaneWords;
      unsigned h = 0;
      if (q0 > 0) {
        // The 32 bytes before the run: the window state at its start.
        hash_word<false>(run[-3], h, off);
        hash_word<false>(run[-2], h, off);
      }
      // The words whose hashes reach under the limit, and the state before
      // each (registers: w is a constant in the unrolled loop).
      unsigned slow = 0, before[kRunWords] = {};
#pragma unroll
      for (int w = 0; w < kRunWords; ++w) {
        if (q0 + 16 * w >= end) break;
        before[w] = h;
        const unsigned m = w == 0 && q0 == 0 ? first_word(run[0], h, off, mis)
                                             : hash_word<true>(run[w], h, off);
        if (m < limit) slow |= 1u << w;
      }
      while (slow) {
        const int w = __ffs(slow) - 1;
        slow &= slow - 1;
        unsigned h0 = 0;
#pragma unroll
        for (int i = 0; i < kRunWords; ++i) h0 = i == w ? before[i] : h0;
        const long long p = q0 + 16 * w;
        exact_word(run[w], h0, p == 0 ? (int)mis : 0, p, mis, first, end, limit, off, &listed,
                   list, count, out, cap);
      }
    }
    __syncwarp();
    if (++stage == kStages) stage = 0;
  }
  asm volatile("cp.async.wait_all;\n" ::);

  __syncthreads();
  const unsigned n_list = listed < (unsigned)kLocal ? listed : (unsigned)kLocal;
  if (threadIdx.x == 0) base = n_list ? atomicAdd(count, (unsigned long long)n_list) : 0ull;
  __syncthreads();
  for (unsigned i = threadIdx.x; i < n_list; i += kThreads) {
    const unsigned long long s = base + i;
    if (s < cap) out[s] = list[i];
  }
}

// The run of a region that ends at word-space byte `end`, on a card of `sms`
// SMs.
int run_words(long long end, int sms) {
  const long long long_tiles = (end + Geometry<kLongRunWords>::kTile - 1) /
                               Geometry<kLongRunWords>::kTile;
  return long_tiles >= (long long)sms * (kWarps / 2) ? kLongRunWords : kShortRunWords;
}

// A device's SM count and the dynamic shared memory of each kernel: all
// that a block may have beside the kernel's static shared memory, the
// kernel's attribute set to it once (above 48 KB a launch needs it).
struct Device {
  int sms, long_bytes, short_bytes;
};

// The most dynamic shared memory a block of gear_scan_kernel<kRunWords> can
// need, wherever the dynamic memory starts: the stages before the table
// leave less than one stage unused below its 64 KiB boundary (or, when all
// of them fit there, the table starts under 64 KiB in), then the table and
// the stages after it.
template <int kRunWords>
constexpr long long smem_need() {
  constexpr long long stage = 16 * Geometry<kRunWords>::kStageWords;
  constexpr long long stages = (long long)(kWarps * kStages + 1) * stage;
  return (stages > kTableBytes ? stages : kTableBytes) + kTableBytes;
}

// Sets the kernel's dynamic shared memory to all the block may have beside
// its static memory; cudaErrorInvalidValue if that is below smem_need, so
// that no launch runs short.
template <int kRunWords>
cudaError_t dynamic_bytes(int optin, int& bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gear_scan_kernel<kRunWords>);
  if (err != cudaSuccess) return err;
  bytes = optin - (int)attr.sharedSizeBytes;
  if (bytes < smem_need<kRunWords>()) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(gear_scan_kernel<kRunWords>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The current device's; nullptr on error, with the code in `err`.
const Device* current_device(cudaError_t& err) {
  static Device devices[kMaxDevices];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return nullptr;
  if (dev < 0 || dev >= kMaxDevices) {
    err = cudaErrorInvalidDevice;
    return nullptr;
  }
  Device& d = devices[dev];
  if (d.sms == 0) {
    int optin = 0, sms = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = dynamic_bytes<kLongRunWords>(optin, d.long_bytes);
    if (err == cudaSuccess) err = dynamic_bytes<kShortRunWords>(optin, d.short_bytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return nullptr;
    d.sms = sms;
  }
  return &d;
}

template <int kRunWords>
void launch(const void* data, long long n, long long ctx, const void* gear, int mask_bits,
            void* out, long long cap, void* count, int sms, int bytes, cudaStream_t stream) {
  using G = Geometry<kRunWords>;
  const uintptr_t a = reinterpret_cast<uintptr_t>(data);
  const long long mis = (long long)(a & 15);
  const long long end = mis + n;
  const long long tiles = (end + G::kTile - 1) / G::kTile;
  const long long blocks = tiles < sms ? tiles : sms;
  gear_scan_kernel<kRunWords><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      reinterpret_cast<const uint4*>(a - (uintptr_t)mis), (end + 15) / 16, mis, end,
      mis + ctx, tiles, (const unsigned*)gear, 1u << (32 - mask_bits), (long long*)out,
      (unsigned long long)cap, (unsigned long long*)count);
}

}  // namespace

extern "C" {

// data: n bytes on the card, at any alignment. gear: the 256 uint32 table,
// 16-byte aligned. out: room for `cap` int64 positions. count: one uint64,
// zeroed by the caller; it ends as the number of candidates, which may
// exceed `cap` (then the slots past `cap` were not written). One launch on
// `stream`, on the current device. Returns a cudaError_t code.
int df_gear_candidates(const void* data, int64_t n, int64_t ctx, const void* gear,
                       int mask_bits, void* out, int64_t cap, void* count,
                       void* stream) {
  if (n <= 0 || ctx < 0 || ctx > n || ctx >= 32 || mask_bits < 1 ||
      mask_bits > 31 || cap < 0 || (reinterpret_cast<uintptr_t>(gear) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const Device* d = current_device(err);
  if (d == nullptr) return (int)err;
  const long long end = (long long)(reinterpret_cast<uintptr_t>(data) & 15) + n;
  if (run_words(end, d->sms) == kLongRunWords)
    launch<kLongRunWords>(data, n, ctx, gear, mask_bits, out, cap, count, d->sms,
                          d->long_bytes, (cudaStream_t)stream);
  else
    launch<kShortRunWords>(data, n, ctx, gear, mask_bits, out, cap, count, d->sms,
                           d->short_bytes, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The geometry K3 takes for a region of n bytes that starts on a 16-byte
// boundary, for tests at its edges: a warp's tile and a lane's run, in
// bytes. Returns a cudaError_t code.
int df_gear_geometry(int64_t n, int64_t* tile, int64_t* run) {
  cudaError_t err;
  const Device* d = current_device(err);
  if (d == nullptr) return (int)err;
  const bool long_run = run_words(n, d->sms) == kLongRunWords;
  *tile = long_run ? Geometry<kLongRunWords>::kTile : Geometry<kShortRunWords>::kTile;
  *run = long_run ? Geometry<kLongRunWords>::kRun : Geometry<kShortRunWords>::kRun;
  return 0;
}

const char* df_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
