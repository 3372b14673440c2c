"""ctypes loader for the native mesh kernels (native/mesh_kernels.cpp,
the repository's native/libmeshkernels.so): marching tetrahedra, area-
weighted surface sampling and BVH ray casting on the host.

The port's own copy of the JAX package's ``eval/native.py``. It rebuilds
the library with native/build.sh (g++) when the .so is missing or older
than its source; every function returns None when the library is
unavailable, and callers then take the numpy versions in eval/mesh.py.
This is host triangle work, not a port of a TPU kernel."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _native_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
    )


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = os.path.join(_native_dir(), "libmeshkernels.so")
        src = os.path.join(_native_dir(), "mesh_kernels.cpp")
        if not os.path.exists(so) or (
            os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so)
        ):
            try:
                subprocess.run(
                    ["sh", os.path.join(_native_dir(), "build.sh")],
                    check=True, capture_output=True, timeout=120,
                )
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.mt_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mt_build.restype = ctypes.c_int
        lib.mt_take.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
        ]
        lib.mt_take.restype = ctypes.c_int
        lib.mesh_sample_surface.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
        ]
        lib.mesh_sample_surface.restype = ctypes.c_int
        lib.rc_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        lib.rc_build.restype = ctypes.c_int
        lib.rc_cast.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ]
        lib.rc_cast.restype = ctypes.c_int
        lib.rc_free.argtypes = []
        lib.rc_free.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def marching_tetrahedra_native(
    grid: np.ndarray, bound: float = 1.0, iso: float = 0.0
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native MT; returns None when the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    g = np.ascontiguousarray(grid, np.float32)
    r = g.shape[0]
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mt_build(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        r, ctypes.c_float(bound), ctypes.c_float(iso),
        ctypes.byref(nv), ctypes.byref(nf),
    )
    if rc != 0:
        return None
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int64)
    rc = lib.mt_take(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return verts, faces


def sample_mesh_surface_native(
    verts: np.ndarray, faces: np.ndarray, n: int, seed: int = 0
) -> Optional[np.ndarray]:
    lib = load_library()
    if lib is None or len(faces) == 0:
        return None
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    out = np.empty((n, 3), np.float32)
    rc = lib.mesh_sample_surface(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
        n, seed or 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out if rc == 0 else None


def raycast_depth_native(
    verts: np.ndarray, faces: np.ndarray,
    origins: np.ndarray, dirs: np.ndarray,
) -> Optional[np.ndarray]:
    """BVH-raycast hit distances (inf = miss); None when unavailable.

    Serializes on a module-level BVH (mesh_kernels.cpp keeps one global),
    so builds+casts run under the loader lock."""
    lib = load_library()
    if lib is None or len(faces) == 0:
        return None
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    o = np.ascontiguousarray(origins, np.float32)
    d = np.ascontiguousarray(dirs, np.float32)
    out = np.empty((len(o),), np.float32)
    with _LOCK:
        rc = lib.rc_build(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
        )
        if rc != 0:
            return None
        rc = lib.rc_cast(
            o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(o),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        lib.rc_free()
    return out if rc == 0 else None
