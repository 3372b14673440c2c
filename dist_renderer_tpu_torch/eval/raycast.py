"""Mesh raycasting: OBJ input and depth maps of triangle meshes.

Counterpart of the JAX package's ``eval/raycast.py``: the renderer of
meshes behind dataset preprocessing (``tasks/preprocess_shapenet.py``),
a host BVH raycaster (native/mesh_kernels.cpp through ``eval/native.py``)
with a chunked numpy Moller-Trumbore version beside it, and the camera
plumbing that gives depth and mask maps in the sphere tracer's frame, so
mesh renders and SDF renders compare pixel for pixel. Host work: no card
kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader: v and f records, polygons fan-triangulated,
    the ``f v/vt/vn`` index forms and negative indices accepted. The
    inverse of eval.mesh.save_obj. Returns (verts [V, 3] float32, faces
    [T, 3] int64)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) for p in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int64).reshape(-1, 3))


def raycast_depth_numpy(verts: np.ndarray, faces: np.ndarray,
                        origins: np.ndarray, dirs: np.ndarray,
                        tri_chunk: int = 2048) -> np.ndarray:
    """Brute-force Moller-Trumbore over chunks of triangles: the nearest
    hit distance of each ray [N] (inf = miss)."""
    a = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - a
    e2 = verts[faces[:, 2]] - a
    best = np.full((len(origins),), np.inf, np.float32)
    for s in range(0, len(faces), tri_chunk):
        aa, u, w = a[s:s + tri_chunk], e1[s:s + tri_chunk], e2[s:s + tri_chunk]
        p = np.cross(dirs[:, None, :], w[None, :, :])        # [N, T, 3]
        det = np.einsum("tj,ntj->nt", u, p)
        inv = 1.0 / np.where(np.abs(det) < 1e-12, np.inf, det)
        sv = origins[:, None, :] - aa[None, :, :]
        uu = np.einsum("ntj,ntj->nt", sv, p) * inv
        q = np.cross(sv, u[None, :, :])
        vv = np.einsum("nj,ntj->nt", dirs, q) * inv
        t = np.einsum("tj,ntj->nt", w, q) * inv
        ok = (uu >= 0) & (uu <= 1) & (vv >= 0) & (uu + vv <= 1) & (t > 1e-6)
        best = np.minimum(best, np.where(ok, t, np.inf).min(axis=1).astype(np.float32))
    return best


def raycast_depth(verts: np.ndarray, faces: np.ndarray, origins: np.ndarray,
                  dirs: np.ndarray, use_native: bool = True) -> np.ndarray:
    """Hit distances [N] (inf = miss): the native BVH where its library
    loads, else (or with use_native=False) the numpy version."""
    if use_native:
        from dist_renderer_tpu_torch.eval.native import raycast_depth_native

        out = raycast_depth_native(verts, faces, origins, dirs)
        if out is not None:
            return out
    return raycast_depth_numpy(verts, faces, origins, dirs)


def render_mesh_depth(verts: np.ndarray, faces: np.ndarray, camera: Camera,
                      img_hw: Tuple[int, int], use_native: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Depth and mask maps [H, W] of a mesh under the tracer's camera
    model (the rays of ``pixel_rays`` on the camera's device, cast on the
    host). The depth is the distance along the pixel ray, as render()
    gives it, 0 where missed."""
    h, w = img_hw
    origins, dirs = pixel_rays(camera, h, w)
    t = raycast_depth(verts, faces, origins.cpu().numpy(), dirs.cpu().numpy(),
                      use_native)
    mask = np.isfinite(t)
    depth = np.where(mask, t, 0.0).astype(np.float32)
    return depth.reshape(h, w), mask.reshape(h, w)


def deepsdf_normalization(verts: np.ndarray, buffer: float = 1.03
                          ) -> Tuple[np.ndarray, float]:
    """DeepSDF's unit-sphere normalization: the offset is the bounding
    box's center and the scale maps the farthest vertex to radius
    1/buffer; normalized vertices are (v - offset) * scale, the convention
    data.datasets.ShapeNetDepthDataset applies to observations (depth *
    scale, T' = (T + R offset) * scale)."""
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    offset = ((lo + hi) / 2.0).astype(np.float32)
    radius = float(np.linalg.norm(verts - offset, axis=1).max())
    return offset, 1.0 / (buffer * max(radius, 1e-12))
