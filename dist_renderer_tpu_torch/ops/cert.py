"""Probe-bracket certification of proxy-claimed hits, and dense probing of
proxy near-misses (the "band"): the proxy verify stage's alternative to a
full-decoder re-march (the JAX package's ``ops/cert.py``).

The verify stage of ``render_batched_c2f`` re-marches the full decoder
from the proxy's answers: hits seeded at (proxy depth - backoff), band
rays from the sphere entry. Neither class needs a march:

HIT CERTIFICATION: a proxy hit whose depth is within +-delta of the true
surface is certified by TWO full-decoder evaluations,

    f_a = f(o + a.v), a = max(d_proxy - delta, t_near)
    f_b = f(o + b.v), b = d_proxy + delta

    f_a > 0 >= f_b  =>  the full field crosses zero in [a, b]: a HIT, at
    the secant point (the regula-falsi estimate the march itself takes
    from a fresh bracket of this width), refined by ``refine`` rounds of
    one evaluation each. Anything else DEMOTES the ray: the caller
    re-marches it seeded at d - delta (verify_mode="march"'s treatment),
    so a proxy false hit, or a depth error beyond delta, still ends in a
    full-decoder march verdict. delta is the caller's proxy_backoff, about
    the proxy's error p99, so demotions are the rare tail.

BAND PROBING: a proxy miss with a margin under proxy_band needs a genuine
hit/miss verdict and an accurate near-zero margin for silhouette losses.
The proxy's argmin depth t_m locates the field's dip; THREE full-decoder
evaluations at t_m - w, t_m + w and t_m fit a parabola through it:

    margin = the parabola's vertex value (the smallest sample where the
    fit is not convex or the vertex leaves the window).

Where the estimated minimum is <= promote_eps (callers pass about the
proxy's error p99, the estimate's own error bound) the full field may
cross where the proxy missed: the ray is PROMOTED to a seeded re-march at
(t_vertex - delta), whose verdict is exact. If |f_proxy - f_full| <= e
everywhere, the full field at the proxy's argmin is within about 2e of
the true minimum however badly the argmin is placed (a quadratic dip's
value error kappa/2 dt^2 reaches e at dt = sqrt(2e/kappa)), and the
parabola removes the second-order term.

Both classes ride ONE hit-first static bucket per frame through the banked
point eval (K6, ``ops/kernels/mlp_eval.point_eval_banked``), with
positions split into two bf16 halves: the probes are spaced about 0.01
apart, some 2.5x the bf16 quantum at |p| ~ 1, and one bf16 half would put
neighbouring probes on the same lattice site.

Everything here is forward-only march machinery: gradients flow through
the renderer's recompute alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dist_renderer_tpu_torch.config import MarchConfig
from dist_renderer_tpu_torch.ops.camera import ray_sphere_entry
from dist_renderer_tpu_torch.ops.kernels import mlp_eval
from dist_renderer_tpu_torch.ops.kernels.batched_march import _round_up


class CertResult(NamedTuple):
    """Every field [F, N] in pixel order."""

    certified: torch.Tensor    # bool: the bracket is confirmed by the full field
    depth: torch.Tensor        # secant depth where certified, else the input
    f_inside: torch.Tensor     # the full decoder at probe b where certified
                               # (<= 0), else +inf
    overflow: torch.Tensor     # bool: candidates beyond the bucket; the caller
                               # routes them through the march fallback
    band_margin: torch.Tensor  # the dip-minimum estimate of band rays (+inf
                               # where not band-probed)
    band_tmin: torch.Tensor    # its depth (the anchor where not band-probed)
    promoted: torch.Tensor     # bool: band rays whose estimated dip reaches
                               # promote_eps: re-march seeded at tmin - delta


def _secant(lo, f_lo, hi, f_hi, clamp: bool):
    """The regula-falsi point of [lo, hi]: refinement PROBES keep the
    march's 5% interior clamp so the bracket strictly shrinks; the FINAL
    estimate is unclamped (a clamped final secant floors the error at 0.05
    of the window)."""
    denom = f_lo - f_hi
    t = f_lo / torch.where(denom == 0.0, 1.0, denom)
    t = torch.clamp(t, 0.05, 0.95) if clamp else torch.clamp(t, 0.0, 1.0)
    return lo + t * (hi - lo)


@torch.no_grad()
def certify_hits_batched(
    shared,                    # batched_march.SharedDecoder of the FULL decoder
    bank: torch.Tensor,        # [total, F_pad] full-decoder bias bank
    origins: torch.Tensor,     # [F, N, 3] or [F, 1, 3] (shared origin)
    dirs: torch.Tensor,        # [F, N, 3]
    depth: torch.Tensor,       # [F, N] proxy march depth
    seeded: torch.Tensor,      # [F, N] bool: proxy hits to certify
    march: MarchConfig,
    delta: float,
    block: int = 512,
    bucket_frac: int = 4,
    refine: int = 1,
    band: Optional[torch.Tensor] = None,    # [F, N] bool: proxy near-misses
    anchor: Optional[torch.Tensor] = None,  # [F, N] proxy argmin depth
                                            # (required with band)
    band_w: float = 0.02,      # band probe half-window
    promote_eps: float = 0.0,  # band rays whose estimated dip minimum is
                               # <= promote_eps re-march seeded: the vertex
                               # carries up to ~2x the PROXY's field error
                               # (its window is placed by the proxy), so a
                               # true hit with a shallow dip can read
                               # slightly positive. Pass about the proxy's
                               # error p99 (proxy_backoff's quantity); 0.0
                               # trusts the estimate exactly.
    use_kernel: bool = True,
) -> CertResult:
    """Certify proxy hits and probe band rays of F frames (see the module
    docstring). Each frame's candidates (seeded | band) are gathered
    hit-first into a bucket of K = round_up(max(N // bucket_frac, block),
    block) lanes by one stable sort; candidates beyond it come back as
    ``overflow``. Runs on the inputs' device; use_kernel=False runs K6's
    plain version."""
    f, n = depth.shape
    dev = depth.device
    if band is None:
        band = torch.zeros((f, n), dtype=torch.bool, device=dev)
        anchor = depth
    else:
        if anchor is None:
            raise ValueError("band probing requires the proxy argmin anchor")
        # the band's center probe rides the first refinement round
        refine = max(refine, 1)

    # the bucket: a block multiple >= block; gathered entries capped at N
    # (probe lanes beyond N are padded dead below)
    k = _round_up(max(n // bucket_frac, block), block)
    k_idx = min(k, n)
    cand = seeded | band

    # hit-first compaction: one stable sort of the candidate key per frame
    idx = torch.sort((~cand).to(torch.int32), dim=1, stable=True).indices[:, :k_idx]
    take2 = lambda a: torch.gather(a, 1, idx)
    take3 = lambda a: torch.gather(a, 1, idx[..., None].expand(f, k_idx, 3))
    v_b = take3(dirs)
    o_b = origins.expand(f, k_idx, 3) if origins.shape[1] == 1 else take3(origins)
    hit_b = take2(seeded)
    band_b = take2(band)
    act_b = hit_b | band_b
    d_b = torch.where(hit_b, take2(depth), take2(anchor))

    # overflow: candidates that did not fit the bucket
    in_bucket = torch.zeros((f, n), dtype=torch.bool, device=dev).scatter_(1, idx, True)
    overflow = cand & ~in_bucket

    t_near, _, _ = ray_sphere_entry(o_b.reshape(-1, 3), v_b.reshape(-1, 3),
                                    march.sphere_radius, 0.0)
    t_near = t_near.reshape(f, k_idx)
    w = torch.where(hit_b, delta, band_w)
    a = torch.maximum(d_b - w, t_near)
    b = d_b + w

    pad = k - k_idx  # sub-block frames: probe lanes padded with dead entries
    padf = lambda x: torch.nn.functional.pad(x, (0, pad)) if pad else x
    o_p = o_b.expand(f, k_idx, 3)
    if pad:
        o_p = torch.nn.functional.pad(o_p, (0, 0, 0, pad))
        v_p = torch.nn.functional.pad(v_b, (0, 0, 0, pad))
    else:
        v_p = v_b

    # probe layout: per frame, K a-probes then K b-probes. Blocks stay
    # frame-pure and hit-first, so the trailing tiles are dead and K6
    # skips them
    def probe(ts, live):
        """Full-decoder values at o + t v for each [F, K_idx] depth row of
        ts, laid out one after another in each frame -> [F, len(ts) * K]."""
        pts = torch.cat([o_p + padf(t)[..., None] * v_p for t in ts], dim=1)
        act = torch.cat([padf(live)] * len(ts), dim=1)
        fob = torch.arange(f, dtype=torch.int32, device=dev).repeat_interleave(
            len(ts) * k // block)
        return mlp_eval.point_eval_banked(
            shared, bank, fob, pts.reshape(-1, 3), act.reshape(-1), block=block,
            use_kernel=use_kernel).reshape(f, len(ts) * k)

    vals = probe([a, b], act_b)
    f_a = vals[:, :k_idx]
    f_b = vals[:, k:k + k_idx]

    cert_b = hit_b & (f_a > 0.0) & (f_b <= 0.0)

    # regula-falsi refinement: each round evaluates the full decoder at the
    # secant point and keeps the sign-preserving sub-bracket. Band rays
    # ride the FIRST round with their center probe at the proxy argmin
    f_c = torch.full_like(f_a, float("inf"))
    lo, f_lo, hi, f_hi = a, f_a, b, f_b
    for r in range(refine):
        m = _secant(lo, f_lo, hi, f_hi, clamp=True)
        if r == 0:
            m = torch.where(band_b, d_b, m)
        live_r = cert_b | band_b if r == 0 else cert_b
        f_m = probe([m], live_r)[:, :k_idx]
        if r == 0:
            f_c = torch.where(band_b, f_m, f_c)
        go_lo = f_m > 0.0
        lo = torch.where(cert_b & go_lo, m, lo)
        f_lo = torch.where(cert_b & go_lo, f_m, f_lo)
        hi = torch.where(cert_b & ~go_lo, m, hi)
        f_hi = torch.where(cert_b & ~go_lo, f_m, f_hi)

    d_cert_b = torch.where(cert_b, _secant(lo, f_lo, hi, f_hi, clamp=False), d_b)

    # the band margin: a parabola through (ta, f_a), (0, f_c), (tb, f_b) in
    # offsets from the anchor (ta and tb differ where the low probe met the
    # sphere-entry clamp), by Newton's divided differences; the vertex
    # value counts only where the fit is convex and the vertex lies in the
    # probe window, else the smallest sample stands
    ta = torch.clamp(a - d_b, max=-1e-6)
    tb = b - d_b
    have_c = torch.isfinite(f_c)
    d1 = (f_c - f_a) / (-ta)
    g2 = torch.where(have_c, f_b - f_c, 0.0) / tb
    d2 = (g2 - d1) / (tb - ta)
    x_v = ta / 2.0 - d1 / (2.0 * torch.where(d2 == 0.0, 1.0, d2))
    q_v = f_a + d1 * (x_v - ta) + d2 * (x_v - ta) * x_v
    convex = (d2 > 0.0) & (x_v >= ta) & (x_v <= tb) & have_c
    f_c_s = torch.where(have_c, f_c, float("inf"))
    min3 = torch.minimum(torch.minimum(f_a, f_b), f_c_s)
    marg_b = torch.where(convex, torch.minimum(q_v, min3), min3)
    t3 = torch.where(f_a <= torch.minimum(f_b, f_c_s), ta,
                     torch.where(f_b <= f_c_s, tb, 0.0))
    tmin_b = torch.where(band_b, d_b + torch.where(convex & (q_v < min3), x_v, t3), d_b)
    prom_b = band_b & (marg_b <= promote_eps)
    marg_b = torch.where(band_b, marg_b, float("inf"))

    # back to pixel order
    scat = lambda base, val: base.scatter(1, idx, val)
    inf = torch.full((f, n), float("inf"), dtype=torch.float32, device=dev)
    no = torch.zeros((f, n), dtype=torch.bool, device=dev)
    return CertResult(
        certified=scat(no, cert_b),
        depth=scat(depth, d_cert_b),
        f_inside=scat(inf, torch.where(cert_b, f_b, float("inf"))),
        overflow=overflow,
        band_margin=scat(inf, marg_b),
        band_tmin=scat(anchor, tmin_b),
        promoted=scat(no, prom_b))
