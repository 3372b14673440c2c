"""The plain sphere tracers: the masked dense march (``sphere_trace``) and
the live-ray compaction march (``sphere_trace_compact``), generic over any
point function ``sdf_fn(points [N, 3]) -> sdf [N]``; plus the march result
record and live-ray telemetry shared with the kernel paths.

Counterpart of the JAX package's ``ops/tracer.py``. Its ``while_loop``s
become Python loops that end when no ray is live: one host sync per step,
the same exit as JAX's loop condition. The bracket-secant step
(``march_step``) is elementwise fp32 and follows the JAX step operation
for operation, so on the same ``sdf`` input the two give the same bits.

Both tracers run without autograd by design: the renderer recomputes the
differentiable quantities at the traced points.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from dist_renderer_tpu_torch.config import MarchConfig
from dist_renderer_tpu_torch.ops.camera import dot3, ray_sphere_entry

_INF = float("inf")


class TraceResult(NamedTuple):
    """Per-ray march outcome (all [N] unless noted)."""

    depth: torch.Tensor        # converged hit distance (valid where hit)
    hit: torch.Tensor          # bool: ray converged onto the surface
    min_sdf: torch.Tensor      # running min of sdf along the march
    depth_at_min: torch.Tensor  # distance at which min_sdf was observed
    last_sdf: torch.Tensor     # sdf at the final evaluated point
    steps_used: torch.Tensor   # scalar: most steps any ray took
    live_counts: torch.Tensor  # live-ray telemetry (per step / per outer round)
    unresolved: torch.Tensor   # bool: still live when the budget ended
    steps_per_ray: Optional[torch.Tensor] = None  # [N] int32 steps each ray took
    bracketed: Optional[torch.Tensor] = None      # [N] bool: owns a bracket


def live_counts_from_steps(steps_per_ray: torch.Tensor,
                           max_steps: int) -> torch.Tensor:
    """live_counts[k] = #rays active at the start of step k+1 =
    #{i: steps_i > k}. The histogram has max_steps + 1 fixed bins, so
    the host reads nothing from the device (a CUDA graph can hold it)."""
    s = torch.clamp(steps_per_ray.to(torch.int64), 0, max_steps).reshape(-1)
    hist = torch.zeros(max_steps + 1, dtype=torch.int64, device=s.device)
    hist.index_add_(0, s, torch.ones_like(s))
    c = torch.cumsum(hist, 0)
    return (c[-1] - c[:-1]).to(torch.int32)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[i]] = i, so x[perm][inv] == x."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


class RayState(NamedTuple):
    """Dense per-ray march state. d_lo/f_lo track the last outside
    sample, d_hi/f_hi the first inside sample; once both are finite the
    surface is bracketed and stepping switches to guarded secant."""

    d: torch.Tensor
    active: torch.Tensor
    hit: torch.Tensor
    d_lo: torch.Tensor
    f_lo: torch.Tensor
    d_hi: torch.Tensor
    f_hi: torch.Tensor
    min_sdf: torch.Tensor
    d_at_min: torch.Tensor
    last_sdf: torch.Tensor
    steps: torch.Tensor          # per-ray step count (int32)
    exhausted_open: torch.Tensor  # hit the step cap without a bracket


def _init_state(n: int, d0: torch.Tensor, active: torch.Tensor) -> RayState:
    d0 = d0.to(torch.float32)
    full = lambda v: torch.full((n,), v, dtype=torch.float32, device=d0.device)
    no = torch.zeros((n,), dtype=torch.bool, device=d0.device)
    return RayState(
        d=d0, active=active, hit=no, d_lo=full(-_INF), f_lo=full(_INF),
        d_hi=full(_INF), f_hi=full(-_INF), min_sdf=full(_INF), d_at_min=d0,
        last_sdf=full(_INF),
        steps=torch.zeros((n,), dtype=torch.int32, device=d0.device),
        exhausted_open=no,
    )


def march_step(s: RayState, sdf: torch.Tensor, origins: torch.Tensor,
               dirs: torch.Tensor, t_near: torch.Tensor,
               far_bound: torch.Tensor, march: MarchConfig) -> RayState:
    """One synchronized march update given sdf at the current points.
    A pure function of (state, sdf), shared by both tracers."""
    f = sdf.to(torch.float32)
    where = torch.where

    better = s.active & (f < s.min_sdf)
    min_sdf = where(better, f, s.min_sdf)
    d_at_min = where(better, s.d, s.d_at_min)

    # bracket update with the current sample
    outside = f > 0.0
    d_lo = where(s.active & outside, s.d, s.d_lo)
    f_lo = where(s.active & outside, f, s.f_lo)
    d_hi = where(s.active & ~outside, s.d, s.d_hi)
    f_hi = where(s.active & ~outside, f, s.f_hi)
    bracketed = torch.isfinite(d_lo) & torch.isfinite(d_hi)
    width = d_hi - d_lo

    converged = s.active & ((torch.abs(f) < march.convergence_eps)
                            | (bracketed & (width < march.depth_eps)))

    # next position: aggressive step until bracketed, then guarded secant
    d_aggr = s.d + march.alpha * f
    denom = f_hi - f_lo
    secant = (d_lo * f_hi - d_hi * f_lo) / where(
        denom == 0.0, torch.ones_like(denom), denom)
    lo_g = d_lo + 0.05 * width
    hi_g = d_hi - 0.05 * width
    secant = torch.minimum(torch.maximum(secant, lo_g), hi_g)
    secant = where(torch.isfinite(secant), secant, 0.5 * (d_lo + d_hi))
    # started-inside rays (no d_lo yet): a plain backward step pulls them out
    d_back = s.d + f
    d_next = where(bracketed, secant, where(outside, d_aggr, d_back))

    steps = s.steps + s.active.to(torch.int32)
    exhausted = steps >= march.max_steps
    escaped = (~bracketed) & ((d_next > far_bound)
                              | (d_next < t_near - march.far_margin))
    missed = s.active & ~converged & (escaped | exhausted)
    # exhausted-but-bracketed rays: accept the bracket midpoint as the hit
    salvaged = s.active & ~converged & exhausted & bracketed
    missed = missed & ~salvaged
    converged = converged | salvaged

    still = s.active & ~converged & ~missed
    return RayState(
        d=where(still, d_next, where(salvaged, 0.5 * (d_lo + d_hi), s.d)),
        active=still, hit=s.hit | converged,
        d_lo=d_lo, f_lo=f_lo, d_hi=d_hi, f_hi=f_hi,
        min_sdf=min_sdf, d_at_min=d_at_min,
        last_sdf=where(s.active, f, s.last_sdf), steps=steps,
        exhausted_open=s.exhausted_open
        | (s.active & ~converged & exhausted & ~bracketed),
    )


def _ray_init(origins, dirs, march: MarchConfig, init_depth,
              init_active=None):
    t_near, t_far, enters = ray_sphere_entry(origins, dirs,
                                             march.sphere_radius, 0.0)
    far_bound = t_far + march.far_margin
    t_closest = torch.clamp(-dot3(origins, dirs), min=0.0)
    d0 = torch.where(enters, t_near, t_closest).to(torch.float32)
    if init_depth is not None:
        seeded = torch.isfinite(init_depth) & enters
        d0 = torch.where(seeded, torch.maximum(init_depth, t_near), d0)
    active = enters if init_active is None else (enters & init_active)
    return t_near, far_bound, active, enters, t_closest, d0


def _finalize(out: RayState, origins, dirs, march, enters, t_closest,
              steps_used, live_counts) -> TraceResult:
    p_closest = origins + t_closest[:, None] * dirs
    geo_margin = torch.linalg.norm(p_closest, dim=-1) - march.sphere_radius
    min_sdf = torch.where(enters, out.min_sdf, geo_margin)
    min_sdf = torch.where(torch.isinf(min_sdf), geo_margin, min_sdf)
    return TraceResult(
        depth=out.d, hit=out.hit, min_sdf=min_sdf, depth_at_min=out.d_at_min,
        last_sdf=out.last_sdf, steps_used=steps_used, live_counts=live_counts,
        unresolved=out.active | out.exhausted_open, steps_per_ray=out.steps,
    )


def _take(s: RayState, idx: torch.Tensor) -> RayState:
    return RayState(*(a[idx] for a in s))


def _put(s: RayState, idx: torch.Tensor, part: RayState) -> RayState:
    return RayState(*(a.index_put((idx,), b) for a, b in zip(s, part)))


@torch.no_grad()
def sphere_trace(sdf_fn: Callable[[torch.Tensor], torch.Tensor],
                 origins: torch.Tensor, dirs: torch.Tensor,
                 march: MarchConfig,
                 init_depth: Optional[torch.Tensor] = None,
                 init_active: Optional[torch.Tensor] = None) -> TraceResult:
    """Masked dense march: every ray advances each step until all converge
    or terminate; the loop ends once no ray is live.

    init_depth: optional [N] per-ray starting distance (NaN = no seed).
    init_active: optional [N] bool; rays marked False never march (the
    coarse-to-fine skip class) and keep their depth at init_depth."""
    n = origins.shape[0]
    t_near, far_bound, active0, enters, t_closest, d0 = _ray_init(
        origins, dirs, march, init_depth, init_active)
    s = _init_state(n, d0, active0)
    live = torch.zeros((march.max_steps,), dtype=torch.int32,
                       device=origins.device)
    k = 0
    while k < march.max_steps and bool(s.active.any()):
        f = sdf_fn(origins + s.d[:, None] * dirs)
        live[k] = s.active.sum()
        s = march_step(s, f, origins, dirs, t_near, far_bound, march)
        k += 1
    return _finalize(s, origins, dirs, march, enters, t_closest,
                     torch.tensor(k, dtype=torch.int32), live)


@torch.no_grad()
def sphere_trace_compact(sdf_fn: Callable[[torch.Tensor], torch.Tensor],
                         origins: torch.Tensor, dirs: torch.Tensor,
                         march: MarchConfig,
                         init_depth: Optional[torch.Tensor] = None,
                         bucket_frac: int = 4, inner_steps: int = 16,
                         init_active: Optional[torch.Tensor] = None
                         ) -> TraceResult:
    """Sphere trace with fixed-width live-ray compaction: while any ray is
    live, sort live rays first (stable), march the first
    max(N / bucket_frac, min(N, 256)) of them for up to ``inner_steps``
    steps, and scatter their state back. Live rays beyond the bucket wait
    for a later round, so the result never depends on how fast the live
    set shrinks."""
    n = origins.shape[0]
    bucket = max(n // bucket_frac, min(n, 256))
    max_outer = (n // bucket + 1) * (
        (march.max_steps + inner_steps - 1) // inner_steps) + 2
    t_near, far_bound, active0, enters, t_closest, d0 = _ray_init(
        origins, dirs, march, init_depth, init_active)
    s = _init_state(n, d0, active0)
    live = torch.zeros((max_outer,), dtype=torch.int32, device=origins.device)
    outer = 0
    while outer < max_outer and bool(s.active.any()):
        idx = torch.sort((~s.active).to(torch.int32), stable=True).indices[:bucket]
        o_b, v_b = origins[idx], dirs[idx]
        near_b, far_b = t_near[idx], far_bound[idx]
        sub = _take(s, idx)
        k = 0
        while k < inner_steps and bool(sub.active.any()):
            f = sdf_fn(o_b + sub.d[:, None] * v_b)
            sub = march_step(sub, f, o_b, v_b, near_b, far_b, march)
            k += 1
        live[outer] = s.active.sum()
        s = _put(s, idx, sub)
        outer += 1
    return _finalize(s, origins, dirs, march, enters, t_closest,
                     s.steps.max(), live)
