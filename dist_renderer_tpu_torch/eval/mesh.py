"""Mesh extraction from a neural SDF by marching tetrahedra.

Counterpart of the JAX package's ``eval/mesh.py``. The SDF grid is the
device's part: ``sdf_grid`` makes the grid points on the device and
evaluates one x-slab of R^2 points per call (the JAX package's
``lax.map`` over slabs), e.g. through K5 with
``ops.kernels.mlp_eval.make_pallas_point_fn``. K5's value at a point does
not depend on how points are grouped into launches, so the grid does not
either. The triangle assembly is host numpy, or the native C++ kernels
(``eval/native.py``) where they load: each cube splits into 6 tetrahedra,
each tetrahedron emits 0-2 triangles by its sign pattern, and shared
vertices merge by edge, a watertight triangulation of the zero set.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# 6-tetrahedra decomposition of the unit cube (corner indices 0..7 with
# corner c = (x + 2y + 4z) bit layout).
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int32,
)
_CUBE = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
    np.int32,
)


def default_device() -> torch.device:
    """Where grid and sample points are made when the caller names no
    device: the current CUDA card. Without a card it raises: an entry point
    runs on the CPU only when the caller asks for it with device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: pass device='cpu' to "
                           "evaluate on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@torch.no_grad()
def sdf_grid(sdf_fn: Callable[[torch.Tensor], torch.Tensor],
             resolution: int = 128, bound: float = 1.0, chunk: int = 65536,
             device=None) -> np.ndarray:
    """Evaluate the SDF on a dense grid -> numpy [R, R, R], indexed
    (x, y, z) over linspace(-bound, bound, R).

    The points are made on ``device`` (default: default_device()), one
    x-slab of R^2 points per sdf_fn call, so nothing is uploaded and one
    slab is live at a time; the values come back to the host once.
    ``chunk`` is kept for the JAX package's signature and has no effect."""
    dev = torch.device(device) if device is not None else default_device()
    xs = torch.linspace(-bound, bound, resolution, dtype=torch.float32, device=dev)
    yy, zz = torch.meshgrid(xs, xs, indexing="ij")
    grid = torch.empty((resolution, resolution * resolution), dtype=torch.float32,
                       device=dev)
    for i in range(resolution):
        pts = torch.stack([xs[i].expand_as(yy), yy, zz], dim=-1).reshape(-1, 3)
        grid[i] = sdf_fn(pts).reshape(-1)
    return grid.cpu().numpy().reshape(resolution, resolution, resolution)


def marching_tetrahedra(
    grid: np.ndarray, bound: float = 1.0, iso: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """grid [R,R,R] SDF values -> (vertices [V,3], faces [F,3]).

    Vectorized numpy: enumerate all cube cells, split into tets, classify
    sign patterns, emit interpolated triangles. Shared vertices are merged
    by exact edge identity so the mesh is consistent."""
    r = grid.shape[0]
    xs = np.linspace(-bound, bound, r, dtype=np.float32)

    # cell origins
    ii, jj, kk = np.meshgrid(
        np.arange(r - 1), np.arange(r - 1), np.arange(r - 1), indexing="ij"
    )
    cells = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)  # [C,3]

    # corner values/ids per cell [C,8]
    corner_idx = cells[:, None, :] + _CUBE[None, :, :]
    vals = grid[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    # quick reject: cells with no sign change
    keep = ~((vals > iso).all(axis=1) | (vals < iso).all(axis=1))
    cells, corner_idx, vals = cells[keep], corner_idx[keep], vals[keep]
    if cells.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # linear corner ids for vertex dedup
    lin = (
        corner_idx[..., 0] * r * r + corner_idx[..., 1] * r + corner_idx[..., 2]
    )  # [C,8]

    tris = []  # list of [T,3,2] edge endpoints as linear corner ids
    for tet in _TETS:
        tv = vals[:, tet]                      # [C,4]
        tl = lin[:, tet]                       # [C,4]
        inside = tv < iso                      # [C,4]
        code = (
            inside[:, 0].astype(np.int32)
            + inside[:, 1] * 2
            + inside[:, 2] * 4
            + inside[:, 3] * 8
        )

        def emit(mask, edges):
            if not mask.any():
                return
            e = np.array(edges, np.int32)      # [n_tri, 3, 2] corner pairs
            la = tl[mask][:, e[..., 0]]        # [M, n_tri, 3]
            lb = tl[mask][:, e[..., 1]]
            tris.append(np.stack([la, lb], axis=-1).reshape(-1, 3, 2))

        # single-corner-inside cases (one triangle), corner order chosen so
        # duplicate-winding doesn't matter for chamfer/eval use
        for c, others in ((0, (1, 2, 3)), (1, (0, 3, 2)), (2, (0, 1, 3)), (3, (0, 2, 1))):
            m = code == (1 << c)
            emit(m, [[(c, others[0]), (c, others[1]), (c, others[2])]])
            m = code == (15 ^ (1 << c))  # single corner OUTSIDE
            emit(m, [[(c, others[0]), (c, others[2]), (c, others[1])]])

        # two-in/two-out cases (two triangles forming a quad)
        for (a, b), (c, d) in (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2))):
            m = code == ((1 << a) | (1 << b))
            emit(m, [
                [(a, c), (a, d), (b, c)],
                [(b, c), (a, d), (b, d)],
            ])
            m = code == ((1 << c) | (1 << d))
            emit(m, [
                [(c, a), (d, a), (c, b)],
                [(c, b), (d, a), (d, b)],
            ])

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri_edges = np.concatenate(tris, axis=0)   # [T,3,2] linear corner ids

    # dedup vertices by (min,max) corner pair
    e_lo = np.minimum(tri_edges[..., 0], tri_edges[..., 1])
    e_hi = np.maximum(tri_edges[..., 0], tri_edges[..., 1])
    ekey = e_lo.astype(np.int64) * (r**3) + e_hi.astype(np.int64)
    uniq, inv = np.unique(ekey.reshape(-1), return_inverse=True)
    faces = inv.reshape(-1, 3)

    # vertex positions: interpolate along each unique edge
    u_lo = (uniq // (r**3)).astype(np.int64)
    u_hi = (uniq % (r**3)).astype(np.int64)

    def corner_pos(linidx):
        i = linidx // (r * r)
        j = (linidx // r) % r
        k = linidx % r
        return np.stack([xs[i], xs[j], xs[k]], axis=-1)

    # values at unique corners from the grid
    def corner_val(linidx):
        i = linidx // (r * r)
        j = (linidx // r) % r
        k = linidx % r
        return grid[i, j, k]

    va, vb = corner_val(u_lo), corner_val(u_hi)
    t = np.clip((iso - va) / np.where(vb - va == 0, 1e-12, vb - va), 0.0, 1.0)
    verts = corner_pos(u_lo) + t[:, None] * (corner_pos(u_hi) - corner_pos(u_lo))

    # drop degenerate faces
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[ok]


def assemble_mesh(grid: np.ndarray, bound: float = 1.0, use_native: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, str]:
    """Triangle assembly of an SDF grid -> (verts, faces, route): the
    native C++ kernels when ``use_native`` and the library loads (route
    "native"), else numpy (route "numpy")."""
    if use_native:
        from dist_renderer_tpu_torch.eval.native import marching_tetrahedra_native

        out = marching_tetrahedra_native(grid, bound)
        if out is not None:
            return out[0], out[1], "native"
    verts, faces = marching_tetrahedra(grid, bound)
    return verts, faces, "numpy"


def extract_mesh(sdf_fn: Callable[[torch.Tensor], torch.Tensor],
                 resolution: int = 128, bound: float = 1.0,
                 use_native: bool = True, device=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """SDF -> (verts, faces): the grid on ``device`` (sdf_grid), the
    triangles on the host (assemble_mesh)."""
    grid = sdf_grid(sdf_fn, resolution, bound, device=device)
    verts, faces, _ = assemble_mesh(grid, bound, use_native)
    return verts, faces


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def sample_mesh_surface(
    verts: np.ndarray, faces: np.ndarray, n: int, seed: int = 0
) -> np.ndarray:
    """Uniform-by-area sampling of points on a triangle mesh (for chamfer)."""
    rng = np.random.RandomState(seed)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    p = areas / max(areas.sum(), 1e-12)
    idx = rng.choice(len(faces), size=n, p=p)
    u = rng.rand(n, 1)
    v = rng.rand(n, 1)
    flip = (u + v) > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    return (a[idx] + u * (b[idx] - a[idx]) + v * (c[idx] - a[idx])).astype(np.float32)
