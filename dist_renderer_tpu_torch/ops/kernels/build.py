"""Build and load the port's CUDA kernels.

The sources in ``dist_renderer_tpu_torch/csrc/`` are compiled with nvcc
into one shared library with a plain C interface, loaded with ctypes. The
build runs at first use, into ``dist_renderer_tpu_torch/.kernel_build/<hash>/``
(listed in .gitignore), keyed by a hash of the sources and the flags, so a
fresh checkout builds itself and an edited source rebuilds. A failed
build raises with nvcc's output.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false``: no automatic
multiply-add contraction, so every product and sum in the march step
rounds where the plain PyTorch version rounds, and the two march kernels
(which share the step code) stay bit-identical to each other. Products
the kernels mean to fuse are written as ``fmaf``. No ``-use_fast_math``:
the march relies on +-3e38 sentinels, IEEE division and an accurate tanh.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, ".kernel_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: (argtypes) -> int (a cudaError_t, 0 = success)
SIGNATURES = {
    "drt_sphere_trace_persistent": [
        _P, _I, _I, _P, _P, _I, _P, _I, _I, _F, _F, _F, _F, _I, _I, _P, _P],
    "drt_queue_seed": [_P, _I, _P, _P, _P, _P],
    "drt_queue_generation": [
        _P, _I, _I, _P, _P, _I, _P, _I, _I, _F, _F, _F, _F, _I, _I,
        _P, _P, _P, _P, _P, _P],
    "drt_precise_sdg": [_P, _P, _I, _P, _P, _P, _I, _P, _P],
}


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded shared library: one attribute per C entry point, plus
    the compiler's resource report and the build time."""

    def __init__(self, path: str, build_log: str, build_seconds: float):
        self.path = path
        self.build_log = build_log
        self.build_seconds = build_seconds
        self._dll = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)

    def call(self, name: str, *args) -> None:
        """Call a C entry point; raise on a nonzero cudaGetLastError()."""
        err = getattr(self, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


_LIB = None


def load() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, "libdrt_kernels.so")
    log_path = os.path.join(out_dir, "build.log")
    seconds = 0.0
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        cu = [s for s in _sources() if s.endswith(".cu")]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                "nvcc failed building the CUDA kernels:\n"
                + " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        with open(log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    with open(log_path) as f:
        log = f.read()
    _LIB = KernelLibrary(lib_path, log, seconds)
    return _LIB


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
