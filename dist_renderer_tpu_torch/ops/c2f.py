"""The coarse-to-fine classification pipeline: a coarse pyramid of
strided marches, then a 3x3-window classification of every fine ray.

  - all 3x3 coarse neighbors hit -> INTERIOR: seed at (min neighbor
    depth - backoff), a tight 0.2x backoff where the window is depth-flat;
  - no neighbor hit -> SKIP: never marched; its margin anchor is the
    coarse min-SDF depth;
  - mixed -> RIM: full march.

A step-capped coarse ray that is still unresolved counts as a hit for the
skip decision, so no fine ray is ever wrongly skipped.

The JAX package's 3x3 SAME ``reduce_window`` becomes ``F.max_pool2d(3, 1,
1)``, whose padding is -inf: the neutral element of a max. Min-reductions
run as -max_pool2d(-x), which pads x with +inf, the neutral element of a
min; boolean OR / AND run as max / min over 0/1 values.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dist_renderer_tpu_torch.utils.profiling import annotate


class C2FMaps(NamedTuple):
    """Full-resolution per-pixel planning maps, all [F, H, W]."""

    seed: torch.Tensor      # fine seed depth (NaN = start at sphere entry)
    hit_any: torch.Tensor   # bool: any coarse neighbor hit-or-unresolved
    hit_all: torch.Tensor   # bool: all coarse neighbors strictly hit
    anchor: torch.Tensor    # coarse min-SDF depth (miss-ray margin anchor)
    margin: torch.Tensor    # coarse min-SDF value (skip-ray silhouette)
    width: torch.Tensor     # coarse 3x3 depth range (diagnostics)


def _max3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x[:, None], 3, 1, 1)[:, 0]


def default_windows(grid: torch.Tensor, op: str) -> torch.Tensor:
    """3x3 SAME window reduce over [F, hc, wc]; op in min/max/or/and."""
    if op == "max":
        return _max3(grid)
    if op == "min":
        return -_max3(-grid)
    g = grid.to(torch.float32)
    if op == "or":
        return _max3(g) > 0.5
    if op == "and":
        return -_max3(-g) > 0.5
    raise ValueError(f"unknown window op {op!r}")


def classify_pyramid(
    trace_level: Callable,
    o_g: torch.Tensor,          # [F, H, W, 3]
    v_g: torch.Tensor,          # [F, H, W, 3]
    strides: Sequence[int],     # coarse levels, coarsest first
    backoff: float,
    windows: Callable = default_windows,
) -> Optional[C2FMaps]:
    """Run the coarse pyramid and build full-res classification maps.

    trace_level(o, v, seed, active, stride) -> object with [F, R] fields
    .depth .hit .unresolved .depth_at_min .min_sdf; seed is None at the
    coarsest level. Returns None when ``strides`` is empty."""
    f, h, w = o_g.shape[:3]
    dev = o_g.device
    maps: Optional[C2FMaps] = None
    prev_stride = 0

    def resample(g, s_from, s_to):
        jr = (torch.arange(h // s_to, device=dev) * s_to) // s_from
        jc = (torch.arange(w // s_to, device=dev) * s_to) // s_from
        return g[:, jr][:, :, jc]

    for stride in strides:
        with annotate(f"drt.plan.level{stride}"):
            hh, ww = h // stride, w // stride
            o_l = o_g[:, ::stride, ::stride].reshape(f, -1, 3)
            v_l = v_g[:, ::stride, ::stride].reshape(f, -1, 3)
            down = lambda g: resample(g, prev_stride, stride)
            if maps is None:
                seed = None
                active = torch.ones((f, hh * ww), dtype=torch.bool, device=dev)
            else:
                # coarse rays whose parent neighborhood missed never re-march;
                # their margin anchor travels down in the seed slot
                seed = down(maps.seed).reshape(f, -1)
                active = down(maps.hit_any).reshape(f, -1)
                seed = torch.where(active, seed, down(maps.anchor).reshape(f, -1))
            res = trace_level(o_l, v_l, seed, active, stride)

            seedable = res.hit | res.unresolved
            inf = torch.full_like(res.depth, float("inf"))
            depth_grid = torch.where(seedable, res.depth, inf).reshape(f, hh, ww)
            hitish = seedable.reshape(f, hh, ww)
            strict = res.hit.reshape(f, hh, ww)

            dmin = windows(depth_grid, "min")
            dmax = windows(torch.where(torch.isfinite(depth_grid), depth_grid,
                                       torch.full_like(depth_grid, -float("inf"))),
                           "max")
            hit_any = windows(hitish, "or")
            hit_all = windows(strict, "and")

            rng = dmax - dmin
            bo = torch.where(rng < backoff, torch.full_like(rng, 0.2 * backoff),
                             torch.full_like(rng, backoff))
            # margin/anchor come from the last level at which a ray actually
            # marched (a level-skipped ray's tracer output is a sentinel)
            new_anchor = res.depth_at_min.reshape(f, hh, ww)
            new_margin = res.min_sdf.reshape(f, hh, ww)
            if maps is not None:
                act_g = active.reshape(f, hh, ww)
                new_anchor = torch.where(act_g, new_anchor, down(maps.anchor))
                new_margin = torch.where(act_g, new_margin, down(maps.margin))
            nan = torch.full_like(dmin, float("nan"))
            maps = C2FMaps(
                seed=torch.where(torch.isfinite(dmin), dmin - bo, nan),
                hit_any=hit_any,
                hit_all=hit_all,
                anchor=new_anchor,
                margin=new_margin,
                width=torch.where(torch.isfinite(rng), rng,
                                  torch.full_like(rng, float("inf"))),
            )
            prev_stride = stride

    if maps is None:
        return None
    # one upsample to full resolution: pixel i reads coarse cell i // stride
    up = lambda g: g.repeat_interleave(prev_stride, 1).repeat_interleave(
        prev_stride, 2)
    with annotate("drt.plan.maps"):
        return C2FMaps(*(up(g) for g in maps))


def warm_maps(depth: torch.Tensor, hitish: torch.Tensor,
              anchor: torch.Tensor, margin: torch.Tensor,
              img_hw: Tuple[int, int], backoff: float, dilate: int = 4,
              windows: Callable = default_windows) -> C2FMaps:
    """Classification maps from the previous optimizer iteration's trace
    instead of a coarse pyramid (inputs [F, H*W]: depth, hit-or-unresolved,
    min-SDF depth and value). The same contract as classify_pyramid's
    output, from stride-1 windows: interior = 3x3 all-hit (seeded at the
    window minimum - backoff), skip = nothing hit within a
    (2*dilate+1)^2 window; the dilation is the safety margin for the
    silhouette's motion between iterations. Unresolved rays count as hits,
    so none is wrongly skipped."""
    f = depth.shape[0]
    h, w = img_hw
    inf = torch.full_like(depth, float("inf"))
    dg = torch.where(hitish, depth, inf).reshape(f, h, w)
    hg = hitish.reshape(f, h, w)
    dmin = windows(dg, "min")
    dmax = windows(torch.where(torch.isfinite(dg), dg,
                               torch.full_like(dg, -float("inf"))), "max")
    hit_all = windows(hg, "and")
    hit_any = hg
    for _ in range(max(dilate, 1)):  # iterated 3x3 OR = (2k+1)^2 dilation
        hit_any = windows(hit_any, "or")
    rng = dmax - dmin
    bo = torch.where(rng < backoff, torch.full_like(rng, 0.2 * backoff),
                     torch.full_like(rng, backoff))
    nan = torch.full_like(dmin, float("nan"))
    return C2FMaps(
        seed=torch.where(torch.isfinite(dmin), dmin - bo, nan),
        hit_any=hit_any, hit_all=hit_all,
        anchor=anchor.reshape(f, h, w), margin=margin.reshape(f, h, w),
        width=torch.where(torch.isfinite(rng), rng,
                          torch.full_like(rng, float("inf"))),
    )


def plan_from_maps(maps: C2FMaps) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten maps into the per-ray plan (key, init_depth, skip), each
    [F, H*W]. key: 0 = rim, 1 = interior, 2 = skip."""
    f = maps.seed.shape[0]
    seed = maps.seed.reshape(f, -1)
    hit_any = maps.hit_any.reshape(f, -1)
    hit_all = maps.hit_all.reshape(f, -1)
    anchor = maps.anchor.reshape(f, -1)
    skip = ~hit_any
    rim = hit_any & ~hit_all
    key = torch.where(rim, 0, torch.where(hit_all, 1, 2)).to(torch.int32)
    init_depth = torch.where(skip, anchor, seed)
    return key, init_depth, skip
