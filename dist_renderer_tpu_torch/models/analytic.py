"""Analytic SDFs: closed-form shapes for tests, ground truth in
evaluation, and the sphere-tracer's exact depths and normals.

Counterpart of the JAX package's ``models/analytic.py``. Each oracle has
the signature of a bound decoder, ``sdf_fn(latent, points[..., 3]) ->
sdf[...]`` (the latent ignored or used as a shape parameter), so it drops
into the renderer wherever a neural decoder does. Every function runs on
the device of the points it gets.
"""

from __future__ import annotations

import torch


def sphere_sdf(radius: float = 0.5, center=(0.0, 0.0, 0.0)):
    c = torch.as_tensor(center, dtype=torch.float32)

    def f(latent, points):
        del latent
        return torch.linalg.norm(points - c.to(points.device), dim=-1) - radius

    return f


def box_sdf(half_extents=(0.4, 0.3, 0.2)):
    b = torch.as_tensor(half_extents, dtype=torch.float32)

    def f(latent, points):
        del latent
        q = torch.abs(points) - b.to(points.device)
        outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
        inside = torch.clamp(q.max(dim=-1).values, max=0.0)
        return outside + inside

    return f


def torus_sdf(major: float = 0.4, minor: float = 0.15):
    def f(latent, points):
        del latent
        qx = torch.sqrt(points[..., 0] ** 2 + points[..., 2] ** 2) - major
        return torch.sqrt(qx ** 2 + points[..., 1] ** 2) - minor

    return f


def round_union(f1, f2, k: float = 0.1):
    """Smooth union: a composite shape to stress overshoot correction."""

    def f(latent, points):
        d1, d2 = f1(latent, points), f2(latent, points)
        h = torch.clamp(0.5 + 0.5 * (d2 - d1) / k, 0.0, 1.0)
        return d2 + (d1 - d2) * h - k * h * (1.0 - h)

    return f


def _latent_sphere(latent, points):
    return torch.linalg.norm(points, dim=-1) - latent[..., 0]


def latent_sphere_sdf():
    """Sphere whose radius is latent[0]: for a centered sphere, depth =
    |c| - r along a center ray, so d depth / d r = -1 (the gradient
    checks' closed form). A module-level function, so it pickles (to the
    ranks of parallel/mesh.run_ranks)."""
    return _latent_sphere


def analytic_sphere_depth(origins, dirs, radius: float):
    """Closed-form hit distance of rays and a sphere at the origin; -1
    where missed."""
    b = (origins * dirs).sum(dim=-1)
    c = (origins * origins).sum(dim=-1) - radius ** 2
    disc = b * b - c
    hit = disc >= 0.0
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    return torch.where(hit & (t > 0), t, torch.full_like(t, -1.0))
