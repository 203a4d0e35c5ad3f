// The port's host library: CRC-32C and the store's fused checksum-and-I/O
// calls, built with the host C++ compiler (not nvcc) by
// dragonfly2_tpu_torch/ops/_build.py and bound with ctypes by
// dragonfly2_tpu_torch/pkg/dfhost.py.
//
// The functions and their results are those of the JAX package's native
// library (dragonfly2_tpu/native/src/dfnative.cc, df_crc32c through
// df_hash_pieces_crc), so a piece digest the port writes equals the one the
// JAX daemon writes for the same bytes, bit for bit:
//
//   * df_crc32c — CRC-32C (Castagnoli, reflected 0x82F63B78, init and
//     final xor 0xFFFFFFFF), chained through `init`: SSE4.2's crc32
//     instruction where the CPU has it, a slice-by-8 table elsewhere.
//   * df_write_piece_crc / df_write_chunk_crc — checksum while pwrite()ing,
//     1 MiB at a time, so a piece's bytes are walked once for both; the
//     chunk form continues a crc across the wire chunks of one piece.
//   * df_read_piece_crc — pread and checksum in one pass.
//   * df_hash_pieces_crc — a table of per-piece crcs of an open file,
//     read and hashed by a pool of threads.
//
// Every call is a plain C function: ctypes releases the interpreter lock
// around it, so piece writes on the daemon's worker threads run in
// parallel. I/O errors return -errno; nothing here throws.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <errno.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// CRC-32C
// ---------------------------------------------------------------------------

static uint32_t g_crc_table[8][256];
static std::atomic<bool> g_crc_table_ready{false};

static void crc32c_init_table() {
  bool expected = false;
  static std::atomic<bool> building{false};
  if (g_crc_table_ready.load(std::memory_order_acquire)) return;
  if (building.compare_exchange_strong(expected, true)) {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t crc = i;
      for (int j = 0; j < 8; j++)
        crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
      g_crc_table[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int s = 1; s < 8; s++)
        g_crc_table[s][i] = (g_crc_table[s - 1][i] >> 8) ^
                            g_crc_table[0][g_crc_table[s - 1][i] & 0xFF];
    g_crc_table_ready.store(true, std::memory_order_release);
  } else {
    while (!g_crc_table_ready.load(std::memory_order_acquire)) {
    }
  }
}

static uint32_t crc32c_sw(const uint8_t* p, size_t n, uint32_t crc) {
  crc32c_init_table();
  crc = ~crc;
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    v ^= crc;
    crc = g_crc_table[7][v & 0xFF] ^ g_crc_table[6][(v >> 8) & 0xFF] ^
          g_crc_table[5][(v >> 16) & 0xFF] ^ g_crc_table[4][(v >> 24) & 0xFF] ^
          g_crc_table[3][(v >> 32) & 0xFF] ^ g_crc_table[2][(v >> 40) & 0xFF] ^
          g_crc_table[1][(v >> 48) & 0xFF] ^ g_crc_table[0][(v >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) crc = g_crc_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

#if defined(__x86_64__) || defined(__i386__)
__attribute__((target("sse4.2"))) static uint32_t crc32c_hw(const uint8_t* p,
                                                              size_t n,
                                                              uint32_t crc) {
  crc = ~crc;
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    crc = (uint32_t)__builtin_ia32_crc32di(crc, v);
    p += 8;
    n -= 8;
  }
  while (n--) crc = __builtin_ia32_crc32qi(crc, *p++);
  return ~crc;
}

static bool have_sse42() {
  static int cached = -1;
  if (cached < 0) cached = __builtin_cpu_supports("sse4.2") ? 1 : 0;
  return cached == 1;
}
#endif

uint32_t df_crc32c(const uint8_t* data, size_t len, uint32_t init) {
#if defined(__x86_64__) || defined(__i386__)
  if (have_sse42()) return crc32c_hw(data, len, init);
#endif
  return crc32c_sw(data, len, init);
}

// The table path alone, whatever the CPU: the tests hold both paths of
// df_crc32c to the same answers.
uint32_t df_crc32c_table(const uint8_t* data, size_t len, uint32_t init) {
  return crc32c_sw(data, len, init);
}

// ---------------------------------------------------------------------------
// Fused checksum + write: 1 MiB blocks stay in the cache between the hash
// and the pwrite. Returns 0, or -errno on an I/O failure.
// ---------------------------------------------------------------------------

static int write_crc(int fd, uint64_t offset, const uint8_t* data, size_t len,
                     uint32_t init, uint32_t* crc_out) {
  const size_t BLOCK = 1 << 20;
  uint32_t crc = init;
  size_t done = 0;
  while (done < len) {
    size_t n = len - done < BLOCK ? len - done : BLOCK;
    crc = df_crc32c(data + done, n, crc);
    size_t w = 0;
    while (w < n) {
      ssize_t r = pwrite(fd, data + done + w, n - w, (off_t)(offset + done + w));
      if (r < 0) {
        if (errno == EINTR) continue;
        return -errno;
      }
      w += (size_t)r;
    }
    done += n;
  }
  if (crc_out) *crc_out = crc;
  return 0;
}

int df_write_piece_crc(int fd, uint64_t offset, const uint8_t* data, size_t len,
                       uint32_t* crc_out) {
  return write_crc(fd, offset, data, len, 0, crc_out);
}

// The crc continues from `init`: a receive loop lands each wire chunk as it
// arrives and has the piece's digest at its last chunk.
int df_write_chunk_crc(int fd, uint64_t offset, const uint8_t* data,
                       size_t len, uint32_t init, uint32_t* crc_out) {
  return write_crc(fd, offset, data, len, init, crc_out);
}

// Read up to `len` bytes and checksum what was read, in one pass. Returns
// the bytes read (short at end of file) or -errno.
int64_t df_read_piece_crc(int fd, uint64_t offset, uint8_t* out, size_t len,
                          uint32_t* crc_out) {
  size_t done = 0;
  while (done < len) {
    ssize_t r = pread(fd, out + done, len - done, (off_t)(offset + done));
    if (r < 0) {
      if (errno == EINTR) continue;
      return -(int64_t)errno;
    }
    if (r == 0) break;
    done += (size_t)r;
  }
  if (crc_out) *crc_out = df_crc32c(out, done, 0);
  return (int64_t)done;
}

// ---------------------------------------------------------------------------
// Per-piece crcs of an open file, by `n_threads` workers (<= 0: one a
// hardware thread). A read past the end of the file is -EIO. Returns 0 or
// the first -errno met.
// ---------------------------------------------------------------------------

int df_hash_pieces_crc(int fd, const uint64_t* offsets, const uint64_t* sizes,
                       uint32_t* crcs_out, size_t n, int n_threads) {
  if (n == 0) return 0;
  unsigned hw = std::thread::hardware_concurrency();
  size_t workers = n_threads > 0 ? (size_t)n_threads : (hw ? hw : 4);
  if (workers > n) workers = n;
  std::atomic<size_t> next{0};
  std::atomic<int> err{0};
  auto work = [&]() {
    std::vector<uint8_t> buf;
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n || err.load()) break;
      size_t sz = (size_t)sizes[i];
      if (buf.size() < sz) buf.resize(sz);
      size_t done = 0;
      while (done < sz) {
        ssize_t r =
            pread(fd, buf.data() + done, sz - done, (off_t)(offsets[i] + done));
        if (r < 0) {
          if (errno == EINTR) continue;
          err.store(-errno);
          return;
        }
        if (r == 0) {
          err.store(-EIO);
          return;
        }
        done += (size_t)r;
      }
      crcs_out[i] = df_crc32c(buf.data(), sz, 0);
    }
  };
  if (workers == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (size_t w = 0; w < workers; w++) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }
  return err.load();
}

}  // extern "C"
