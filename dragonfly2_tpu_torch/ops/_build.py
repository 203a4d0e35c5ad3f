"""Build and bind the port's CUDA kernels (``csrc/checksum.cu``).

``nvcc`` compiles the source into a shared library with a plain C
interface, bound with ``ctypes``: every pointer and the stream as
``c_void_p``, every size as ``c_int64``. The library goes into ``build/``
at the repository root, named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads at once. It is built at
first use, never at import. A missing compiler or a failed compile raises
``KernelBuildError`` carrying nvcc's own output, and a launch that returns
a CUDA error raises ``KernelLaunchError``: there is no fallback. Both are
``KernelError``, which the device sink manager never turns into a
disk-only landing.

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

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "checksum.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""          # nvcc's output of the build this process made or loaded
build_seconds = 0.0


class KernelError(RuntimeError):
    """A fault of the port's own kernels, never of the environment."""


class KernelBuildError(KernelError):
    """The CUDA kernels could not be built or loaded."""


class KernelLaunchError(KernelError):
    """A kernel launcher returned a CUDA error."""


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.access(cand, os.X_OK) else None


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"checksum-{digest.hexdigest()[:16]}.so")


def _compile(out: str) -> str:
    nvcc = nvcc_path()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH, CUDA_HOME/bin): the CUDA kernels cannot "
            "be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)   # atomic: concurrent builds agree
        return log
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        import time

        t0 = time.perf_counter()
        path = library_path()
        build_log = _compile(path) if not os.path.exists(path) else ""
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.df_chunk_checksums.argtypes = [p, i64, i64, p, p, p]
        lib.df_chunk_checksums.restype = ctypes.c_int
        lib.df_land_and_checksum.argtypes = [p, i64, p, p, i64, i64, p, p, p]
        lib.df_land_and_checksum.restype = ctypes.c_int
        lib.df_error_string.argtypes = [ctypes.c_int]
        lib.df_error_string.restype = ctypes.c_char_p
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.df_error_string(code).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {code}: {msg}")


if __name__ == "__main__":
    library()
    print(library_path())
    print(build_log)
