"""Build and register the CUDA traversal library (ops/csrc/traverse.cu).

The library is compiled with ``nvcc`` from the committed source into
``<checkout>/build/``, under a lock, with the source's hash in the file
name: an edited source builds a new library, an unchanged one is reused.
Build it ahead of time with

    python -m physically_based_ray_tracer_tpu.ops.cuda_ffi

On a machine with a GPU backend a missing toolchain or a failed build
raises; nothing falls back to another engine.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
SOURCE = os.path.join(PKG_DIR, "ops", "csrc", "traverse.cu")
BUILD_DIR = os.path.join(REPO_DIR, "build")
CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")

CLOSEST_TARGET = "pbrt_trace_closest"
ANY_TARGET = "pbrt_trace_any"

_lock = threading.Lock()
_registered = False


def source_digest() -> str:
    with open(SOURCE, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libpbrt_traverse_{source_digest()}.so")


def nvcc_path() -> str | None:
    cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    return cand if os.path.exists(cand) else shutil.which("nvcc")


def nvcc_command(nvcc: str, out: str) -> list[str]:
    """The one compile line. FMA contraction is off (--fmad=false) and fast
    math is not used: see the header of traverse.cu."""
    import jax.ffi

    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", out, SOURCE]


def build() -> str:
    """Compile the library if this source has not been built yet; returns
    its path. Raises RuntimeError when nvcc is missing or fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found (looked in {CUDA_HOME}/bin and on PATH): the "
            "CUDA traversal kernel cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".traverse.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):       # built by another process meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(nvcc_command(nvcc, tmp), capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed building the CUDA traversal "
                               f"kernel:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def gpu_backend_present() -> bool:
    import jax

    try:
        return len(jax.devices("gpu")) > 0
    except RuntimeError:
        return False


def ensure_registered() -> None:
    """Build (if needed), load and register both FFI targets for CUDA."""
    global _registered
    with _lock:
        if _registered:
            return
        import jax

        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            CLOSEST_TARGET, jax.ffi.pycapsule(lib.PbrtTraceClosest),
            platform="CUDA")
        jax.ffi.register_ffi_target(
            ANY_TARGET, jax.ffi.pycapsule(lib.PbrtTraceAny), platform="CUDA")
        _registered = True


if __name__ == "__main__":
    t0 = time.perf_counter()
    path = build()
    print(f"{path} ({time.perf_counter() - t0:.1f} s)")
