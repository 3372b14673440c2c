"""Chamfer-distance evaluation: the symmetric chamfer between an optimized
shape's surface samples and the ground truth's (DIST's and DeepSDF's
quality metric).

Counterpart of the JAX package's ``eval/chamfer.py``. The pairwise
minimum is a dense product, chunked over the first point set so that
30k x 30k never materializes, on the device of the points; no KD-tree.
Surface samples come from projecting random points onto the zero set
along the SDF's gradient; their draws come from a ``torch.Generator``,
so they differ from the JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from dist_renderer_tpu_torch.eval.mesh import default_device


def _min_sq_dists(a: torch.Tensor, b: torch.Tensor, chunk: int = 1024
                  ) -> torch.Tensor:
    """min over b of ||a_i - b_j||^2, chunked over a. a [N,3], b [M,3].
    The JAX package's expansion |a|^2 - 2 a.b + |b|^2, clamped at 0."""
    b_sq = torch.sum(b * b, dim=-1)
    mins = []
    for i in range(0, a.shape[0], chunk):
        ac = a[i:i + chunk]
        d = torch.sum(ac * ac, dim=-1)[:, None] - 2.0 * ac @ b.T + b_sq[None, :]
        mins.append(d.min(dim=-1).values)
    return torch.clamp(torch.cat(mins), min=0.0)


def chamfer_distance(points_a: torch.Tensor, points_b: torch.Tensor,
                     squared: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric chamfer: (mean_a min_b d, mean_b min_a d, their sum).

    squared=True matches DeepSDF/DIST's convention of reporting mean
    squared distances; False gives mean euclidean distances."""
    d_ab = _min_sq_dists(points_a, points_b)
    d_ba = _min_sq_dists(points_b, points_a)
    if not squared:
        d_ab, d_ba = torch.sqrt(d_ab), torch.sqrt(d_ba)
    a2b, b2a = d_ab.mean(), d_ba.mean()
    return a2b, b2a, a2b + b2a


def sample_surface_points(sdf_fn: Callable[[torch.Tensor], torch.Tensor],
                          n: int = 30000,
                          generator: Optional[torch.Generator] = None,
                          iters: int = 8, keep_band: float = 1e-3,
                          device=None) -> torch.Tensor:
    """Sample points on the zero set of an SDF by gradient-descent
    projection of uniform random seeds in [-1, 1]^3 (``iters`` steps p <-
    p - f(p) grad f / |grad f|): chamfer on surface samples when no mesh
    is needed. Points that end outside |sdf| < keep_band are replaced by
    random survivors. The seeds and the replacement draws come from
    ``generator`` (a CPU torch.Generator; default: seed 0); the points
    live on ``device`` (default: eval.mesh.default_device())."""
    dev = torch.device(device) if device is not None else default_device()
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    p = (torch.rand((n, 3), generator=gen) * 2.0 - 1.0).to(dev)
    with torch.enable_grad():
        for _ in range(iters):
            pp = p.detach().requires_grad_(True)
            s = sdf_fn(pp)
            (g,) = torch.autograd.grad(s.sum(), pp)
            g = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-8)
            p = (pp - s[:, None] * g).detach()
    with torch.no_grad():
        ok = torch.abs(sdf_fn(p)) < keep_band
    # replace failures with random good points
    idx_ok = torch.nonzero(ok).reshape(-1)
    count = idx_ok.shape[0]
    if count == 0:
        idx_ok = torch.zeros((1,), dtype=torch.int64, device=dev)
    choice = torch.randint(0, max(count, 1), (n,), generator=gen).to(dev)
    return torch.where(ok[:, None], p, p[idx_ok[choice]])


def chamfer_vs_analytic(pred_sdf_fn: Callable, gt_sdf_fn: Callable,
                        n: int = 20000,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> float:
    """Convenience: symmetric chamfer between two SDFs' surfaces, both
    sampled with draws from ``generator`` (default: seed 0)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    pa = sample_surface_points(pred_sdf_fn, n, gen, device=device)
    pb = sample_surface_points(gt_sdf_fn, n, gen, device=device)
    return float(chamfer_distance(pa, pb)[2])
