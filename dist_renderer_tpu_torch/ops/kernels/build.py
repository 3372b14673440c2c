"""Build and load the port's CUDA kernels.

The sources in ``dist_renderer_tpu_torch/csrc/`` are compiled with nvcc,
one process per ``.cu`` file, all at once, and linked into one shared
library with a plain C interface, loaded with ctypes. The
build runs at first use, into ``dist_renderer_tpu_torch/.kernel_build/<hash>/``
(listed in .gitignore), keyed by a hash of the sources and the flags, so a
fresh checkout builds itself and an edited source rebuilds. A failed
build raises with nvcc's output.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false``: no automatic
multiply-add contraction, so every product and sum in the march step
rounds where the plain PyTorch version rounds, and the march kernels
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
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures: (argtypes) -> int (a cudaError_t, 0 = success)
SIGNATURES = {
    "drt_sphere_trace_persistent": [
        _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _F, _F, _F, _F, _I, _I, _P, _P],
    "drt_sphere_trace_grid": [
        _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _F, _F, _F, _F, _I, _I, _P, _P],
    "drt_sphere_trace_batched": [
        _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _F, _F, _F, _F, _I, _I, _P, _P],
    "drt_queue_seed": [_P, _I, _P, _P, _P, _P],
    "drt_queue_generation": [
        _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _F, _F, _F, _F, _I, _I,
        _P, _P, _P, _P, _P, _P],
    "drt_march_in_order": [
        _P, _I, _I, _P, _P, _I, _P, _I, _I, _F, _F, _F, _F, _I, _I, _P, _P],
    "drt_precise_sdg": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "drt_precise_value": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "drt_precise_bias_grads": [
        _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
        _P, _P, _P],
    "drt_precise_smem": [_P, _I],
    "drt_dot_in_order": [_P, _P, _P, _I, _I, _I, _P],
    "drt_point_eval": [_P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P],
    "drt_point_eval_banked": [
        _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P],
    "drt_point_mlp_smem": [_I],
    "drt_march_mma_smem": [_I],
    # the TPU probe scripts' kernels (ops/kernels/probes.py, mlp_chain.py)
    "drt_probe_empty": [_P, _P, _P],
    "drt_probe_scratch": [_P, _P, _I, _I, _P],
    "drt_probe_scalar_while": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "drt_probe_index_loop": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "drt_probe_vec_while": [_P, _P, _I, _P],
    "drt_probe_dma_loop": [_P, _P, _P, _I, _P],
    "drt_probe_copy": [_P, _P, _L, _P],
    "drt_probe_add_one": [_P, _P, _L, _P],
    "drt_probe_small_mm": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "drt_probe_compact": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "drt_probe_f32dot": [_P, _P, _P, _I, _I, _I, _P],
    "drt_probe_roll": [_P, _P, _I, _I, _I, _P],
    "drt_probe_scan": [_P, _P, _I, _I, _I, _P],
    "drt_mlp_chain_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    "drt_mlp_chain_int8": [_P, _P, _P, _I, _I, _I, _I, _P],
    "drt_mlp_chain_smem": [_I, _I],
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
        work = tempfile.mkdtemp(dir=out_dir)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # one nvcc per source, all started together, then one link
        objs, procs = [], []
        for src in (s for s in _sources() if s.endswith(".cu")):
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        steps = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
        if all(rc == 0 for _, _, rc in steps):
            tmp = os.path.join(work, "libdrt_kernels.so")
            cmd = [nvcc, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            steps.append((cmd, proc.stdout, proc.returncode))
        seconds = time.perf_counter() - t0
        log = "".join(out for _, out, _ in steps)
        failed = [(cmd, out) for cmd, out, rc in steps if rc != 0]
        if failed:
            shutil.rmtree(work, ignore_errors=True)
            raise RuntimeError("nvcc failed building the CUDA kernels:\n" + "".join(
                " ".join(cmd) + "\n" + out for cmd, out in failed))
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        shutil.rmtree(work, ignore_errors=True)
    with open(log_path) as f:
        log = f.read()
    _LIB = KernelLibrary(lib_path, log, seconds)
    return _LIB


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
