"""Build and bind the port's CUDA kernels: ``csrc/checksum.cu`` (K1, K2)
and ``csrc/gear.cu`` (K3), and K3's yardstick ``csrc/read_floor.cu`` (a
plain coalesced read of the same bytes, timed beside K3, on no path).

``nvcc`` compiles each source into a shared library of its own with a
plain C interface, bound with ``ctypes``: every pointer and the stream as
``c_void_p``, every size as ``c_int64``. A library goes into ``build/`` at
the repository root, named by its source's name and a hash of the source
and the flags, so an edited source rebuilds and an unchanged one loads at
once. It is built at first use, never at import; each library has a lock
of its own, so ``library()``, ``gear_library()`` and
``read_floor_library()`` called on three threads run their nvcc at once. A missing compiler or a failed compile raises
``KernelBuildError`` carrying nvcc's own output, and a launch that returns
a CUDA error raises ``KernelLaunchError``: there is no fallback. Both are ``KernelError``, which the device sink manager never
turns into a disk-only landing.

The host library ``csrc/host/dfhost.cc`` (CRC-32C and the task store's
fused checksum-and-I/O calls, ``pkg/dfhost.py``) is built the same way by
the host C++ compiler (``g++``, or ``$CXX``), on any machine: its library
is named by a hash of its source and its flags too, a missing compiler or
a failed compile raises ``HostBuildError``, and nothing falls back to
Python.

Run ``python -m dragonfly2_tpu_torch.ops._build`` to build ahead of time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "checksum.cu")        # K1, K2
GEAR_SOURCE = os.path.join(_PKG_DIR, "csrc", "gear.cu")       # K3
READ_FLOOR_SOURCE = os.path.join(_PKG_DIR, "csrc", "read_floor.cu")
SOURCES = (SOURCE, GEAR_SOURCE, READ_FLOOR_SOURCE)
HOST_SOURCE = os.path.join(_PKG_DIR, "csrc", "host", "dfhost.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")

_locks: dict[str, threading.Lock] = {}  # source -> the lock of its build
_log_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}      # source -> its loaded library
build_log = ""          # nvcc's output of the builds this process made
build_logs: dict[str, str] = {}         # source -> nvcc's output, if built
build_seconds = 0.0     # this process's builds and loads, summed


class KernelError(RuntimeError):
    """A fault of the port's own kernels, never of the environment."""


class KernelBuildError(KernelError):
    """The CUDA kernels could not be built or loaded."""


class KernelLaunchError(KernelError):
    """A kernel launcher returned a CUDA error."""


class HostBuildError(KernelBuildError):
    """The host library could not be built or loaded."""


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.access(cand, os.X_OK) else None


def cxx_path() -> str | None:
    return shutil.which(os.environ.get("CXX") or "g++")


def library_path(source: str = SOURCE) -> str:
    flags = HOST_FLAGS if source == HOST_SOURCE else NVCC_FLAGS
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def compile_source(out: str, source: str = SOURCE) -> str:
    """Build ``source`` into the shared library ``out``; the compiler's
    output."""
    if source == HOST_SOURCE:
        compiler, flags, error = cxx_path(), HOST_FLAGS, HostBuildError
        if compiler is None:
            raise HostBuildError(
                "g++ not found (PATH, CXX): the host library cannot be built")
    else:
        compiler, flags, error = nvcc_path(), NVCC_FLAGS, KernelBuildError
        if compiler is None:
            raise KernelBuildError(
                "nvcc not found (PATH, CUDA_HOME/bin): the CUDA kernels "
                "cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, source],
                              capture_output=True, text=True)
        log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            name = os.path.basename(compiler)
            raise error(f"{name} failed (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)   # atomic: concurrent builds agree
        return log
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(source: str, bind) -> ctypes.CDLL:
    """The library of ``source``, built first if missing, loaded once and
    handed to ``bind`` to declare its launchers."""
    global build_log, build_seconds
    with _log_lock:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        t0 = time.perf_counter()
        path = library_path(source)
        log = compile_source(path, source) if not os.path.exists(path) else ""
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            error = HostBuildError if source == HOST_SOURCE \
                else KernelBuildError
            raise error(f"cannot load {path}: {e}") from e
        if source != HOST_SOURCE:
            lib.df_error_string.argtypes = [ctypes.c_int]
            lib.df_error_string.restype = ctypes.c_char_p
        bind(lib)
        _libs[source] = lib
        with _log_lock:
            build_log = "\n".join(x for x in (build_log, log) if x)
            build_logs[source] = log
            build_seconds += time.perf_counter() - t0
        return lib


def _bind_checksum(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.df_chunk_checksums.argtypes = [p, i64, i64, p, p, p]
    lib.df_chunk_checksums.restype = i32
    # buffer, n_slots, pieces, slots, k, pw, the LandPlan's five fields,
    # sums, xors, scatter, stream
    lib.df_land_and_checksum.argtypes = [
        p, i64, p, p, i64, i64, i32, i32, i32, i32, i32, p, p, i32, p]
    lib.df_land_and_checksum.restype = i32
    lib.df_land_max_active_clusters.argtypes = [i32, i32, i32]
    lib.df_land_max_active_clusters.restype = i32


def _bind_gear(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # data, n, ctx, gear, mask_bits, out, cap, count, stream
    lib.df_gear_candidates.argtypes = [p, i64, i64, p, i32, p, i64, p, p]
    lib.df_gear_candidates.restype = i32
    lib.df_gear_geometry.argtypes = [i64, p, p]
    lib.df_gear_geometry.restype = i32


def _bind_read_floor(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # data, n, out, blocks, stream
    lib.df_read_floor.argtypes = [p, i64, p, i64, p]
    lib.df_read_floor.restype = i32


def _bind_host(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    u32, u64, size = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_size_t
    # data, len, init
    lib.df_crc32c.argtypes = [p, size, u32]
    lib.df_crc32c.restype = u32
    lib.df_crc32c_table.argtypes = [p, size, u32]
    lib.df_crc32c_table.restype = u32
    # fd, offset, data, len, crc_out
    lib.df_write_piece_crc.argtypes = [i32, u64, p, size, p]
    lib.df_write_piece_crc.restype = i32
    # fd, offset, data, len, init, crc_out
    lib.df_write_chunk_crc.argtypes = [i32, u64, p, size, u32, p]
    lib.df_write_chunk_crc.restype = i32
    # fd, offset, out, len, crc_out
    lib.df_read_piece_crc.argtypes = [i32, u64, p, size, p]
    lib.df_read_piece_crc.restype = i64
    # fd, offsets, sizes, crcs_out, n, n_threads
    lib.df_hash_pieces_crc.argtypes = [i32, p, p, p, size, i32]
    lib.df_hash_pieces_crc.restype = i32


def library() -> ctypes.CDLL:
    """The loaded K1/K2 library, building it first if needed."""
    return _load(SOURCE, _bind_checksum)


def gear_library() -> ctypes.CDLL:
    """The loaded K3 library, building it first if needed."""
    return _load(GEAR_SOURCE, _bind_gear)


def read_floor_library() -> ctypes.CDLL:
    """The loaded read floor (K3's yardstick), building it first if
    needed."""
    return _load(READ_FLOOR_SOURCE, _bind_read_floor)


def host_library() -> ctypes.CDLL:
    """The loaded host library (``csrc/host/dfhost.cc``), building it
    first with the host C++ compiler if needed."""
    return _load(HOST_SOURCE, _bind_host)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.df_error_string(code).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {code}: {msg}")


if __name__ == "__main__":
    library()
    gear_library()
    read_floor_library()
    host_library()
    for source in (*SOURCES, HOST_SOURCE):
        print(library_path(source))
    print(build_log)
