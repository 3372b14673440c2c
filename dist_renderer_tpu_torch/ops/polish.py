"""Full-decoder Newton polish for raw batched marches.

Counterpart of the JAX package's ``ops/polish.py``. The batched path
(``render_batched_c2f``) returns the march depth directly, with no
differentiable composition to re-anchor it; marched on a distilled proxy
that depth keeps the proxy's error (a few 1e-3). ``polish_depth_batched``
runs safeguarded fp32 Newton iterations of the full decoder at the
marched hit points, each one fused value + directional-derivative
evaluation (``make_precise_sdg``: K3 on the card), on a hit-first bucket
of each frame. It can also return the full decoder's residual |f| at the
final point, which certifies hits against the full field (a proxy false
hit keeps a residual the polish cannot shrink).

Forward only (no gradient): the differentiable paths polish inside
``render_rays``' composition.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import Params


@torch.no_grad()
def polish_depth_batched(
    params: Params,
    dcfg: DecoderConfig,
    latents: torch.Tensor,          # [F, L]
    origins: torch.Tensor,          # [F, N, 3] (or [F, 1, 3])
    dirs: torch.Tensor,             # [F, N, 3]
    depth: torch.Tensor,            # [F, N] march depth (proxy or full)
    hit: torch.Tensor,              # [F, N] bool
    iters: int = 2,
    bucket_frac: int = 4,
    block: int = 512,
    min_denom: float = 1e-2,
    max_step: float = 0.05,
    use_kernel: bool = True,
    return_residual: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Newton-polish batched hit depths against the full decoder.

    Each frame's rays sort hits first (a stable sort) into a bucket of
    N // bucket_frac rays rounded up to ``block``; each iteration is one
    fused value + gradient evaluation, with the composition's safeguards:
    the denominator clamped front-facing (<= -min_denom), the step
    clamped to +-max_step, a step taken only where the slope is off the
    clamp and accepted only where |f| does not grow (a false hit cannot
    diverge). Hits beyond the bucket keep their march depth.

    Returns the polished depth [F, N]; with return_residual also the full
    decoder's |f| at each ray's final point (+inf on misses). CUDA
    tensors launch K3; CPU tensors, or use_kernel=False, run its plain
    version."""
    from dist_renderer_tpu_torch.ops.kernels.recompute import make_precise_sdg

    f, n = depth.shape
    bucket = min(((n // bucket_frac + block - 1) // block) * block, n)
    sdg = make_precise_sdg(params, dcfg, block, use_kernel)
    idx_b = torch.sort((~hit).to(torch.int32), dim=1, stable=True).indices[:, :bucket]
    idx3 = idx_b[..., None].expand(f, bucket, 3)
    o_b = torch.gather(origins.expand(f, n, 3), 1, idx3)
    v_b = torch.gather(dirs, 1, idx3)
    d_b = torch.gather(depth, 1, idx_b)
    hit_b = torch.gather(hit, 1, idx_b)

    def one_frame(z, o, v, d, h):
        s, dd, _ = sdg(z, o + d[:, None] * v, v)
        best = s.abs()
        resid = best
        for _ in range(iters):
            step = torch.clamp(s / torch.clamp(dd, max=-min_denom), -max_step, max_step)
            ok = h & (dd < -min_denom)
            d_try = torch.where(ok, d - step, d)
            s2, dd2, _ = sdg(z, o + d_try[:, None] * v, v)
            accept = ok & (s2.abs() <= best)
            d = torch.where(accept, d_try, d)
            s = torch.where(accept, s2, s)
            dd = torch.where(accept, dd2, dd)
            best = torch.minimum(best, s2.abs())
            resid = torch.where(accept, s2.abs(), resid)
        return d, torch.where(h, resid, torch.full_like(resid, float("inf")))

    polished = [one_frame(latents[i], o_b[i], v_b[i], d_b[i], hit_b[i])
                for i in range(f)]
    d_pol = torch.where(hit_b, torch.stack([p[0] for p in polished]), d_b)
    depth_out = depth.scatter(1, idx_b, d_pol)
    if not return_residual:
        return depth_out
    res_full = torch.full_like(depth, float("inf")).scatter(
        1, idx_b, torch.stack([p[1] for p in polished]))
    return depth_out, res_full
