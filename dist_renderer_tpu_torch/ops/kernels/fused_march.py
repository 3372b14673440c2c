"""The single-frame grid march (K1-grid), its multi-round driver and the
march function the renderer routes a frame's trace through.

K1-grid, ``sphere_trace_grid``, replaces the JAX package's
``ops/pallas/fused_march.py::pallas_sphere_trace`` (``_make_kernel``: a
grid of 512-ray blocks over the latent-folded decoder, per-layer bias
refs, a dead-block fast path). On a CUDA tensor it launches
``csrc/fused_march.cu``; on a CPU tensor, or with ``use_kernel=False``,
it runs the plain version, K1's ``march_rows_plain`` on the folded
layers. It runs K1's tensor-core tile march (``csrc/march_mma.cuh``, one
block per 64-ray tile) with the folded biases as a one-column bias bank,
so on the same rays it equals ``sphere_trace_persistent`` with that bank
bit for bit, and both equal the in-order plain version up to a near tie
the margin misses (``NEAR_TIE`` in batched_march.py).

``sphere_trace_rounds`` is the counterpart of ``pallas_sphere_trace_rounds``
(step-capped rounds without salvage, a stable difficulty re-pack between
rounds, live-prefix buckets with a full-width fallback, one unsort); the
JAX package's ``lax.cond``s become host decisions on the live count.
``FusedMarchFn`` is the counterpart of ``PallasMarchFn``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig
from dist_renderer_tpu_torch.models.folded import FoldedLayer
from dist_renderer_tpu_torch.ops.camera import dot3, ray_sphere_entry
from dist_renderer_tpu_torch.ops.kernels import build
from dist_renderer_tpu_torch.ops.kernels.batched_march import (
    POS_BIG, SharedDecoder, check_cuda_inputs, march_rows_plain, mma_march_args,
    pack_layers, pack_rays, ray_setup, trace_from_rows,
)
from dist_renderer_tpu_torch.ops.tracer import (
    TraceResult, inverse_permutation, live_counts_from_steps,
)


ROUND_CAPS = (4, 12)  # the rounds driver's step caps before its final round


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PackedFolded(NamedTuple):
    """One latent's folded decoder in K1's layout: the shared weights and
    the folded biases as one fp32 column [total, 1] at ``shared.offsets``."""

    shared: SharedDecoder
    bias: torch.Tensor


def pack_folded(folded: Sequence[FoldedLayer], cfg: DecoderConfig,
                shared: Optional[SharedDecoder] = None) -> PackedFolded:
    """Pack folded layers; ``shared`` reuses weights packed once for many
    latents (pack_shared of the same decoder)."""
    if shared is None:
        shared = pack_layers(folded, cfg.final_tanh)
    bias = torch.zeros((shared.total, 1), dtype=torch.float32,
                       device=folded[0].b.device)
    for (off, _), l in zip(shared.offsets, folded):
        bias[off:off + l.b.shape[0], 0] = l.b.to(torch.float32)
    return PackedFolded(shared, bias)


def grid_args(packed: PackedFolded, rays: torch.Tensor, march: MarchConfig,
              salvage: bool, out: torch.Tensor):
    """drt_sphere_trace_grid's arguments but the stream: the rays [16, N],
    the shared weights with their MMA layout, and the folded biases as a
    one-column bank (column 0 is read)."""
    return (build.ptr(rays), rays.shape[1],
            *mma_march_args(packed.shared, packed.bias), march.convergence_eps,
            march.depth_eps, march.alpha, march.far_margin, march.max_steps,
            int(salvage), build.ptr(out))


def grid_rows_cuda(packed: PackedFolded, origins, dirs, rs, march: MarchConfig,
                   salvage: bool) -> torch.Tensor:
    """K1-grid on the card: one launch, a block per 64-ray tile -> [8, N].
    A decoder whose shared-memory plan does not fit a block raises before
    the launch."""
    from dist_renderer_tpu_torch.ops.kernels.mlp_eval import check_mma_plan

    n = origins.shape[0]
    rays = pack_rays(origins, dirs, rs)
    check_cuda_inputs(packed.shared, packed.bias, rays)
    check_mma_plan(packed.shared, rays.device, march=True)
    out = torch.empty((8, n), dtype=torch.float32, device=rays.device)
    build.load().call("drt_sphere_trace_grid",
                      *grid_args(packed, rays, march, salvage, out),
                      build.stream_of(rays))
    sphere_trace_grid.launches += 1
    return out


def sphere_trace_grid(packed: PackedFolded, origins: torch.Tensor,
                      dirs: torch.Tensor, march: MarchConfig,
                      init_depth: Optional[torch.Tensor] = None,
                      init_active: Optional[torch.Tensor] = None,
                      salvage: bool = True,
                      use_kernel: bool = True) -> TraceResult:
    """K1-grid: the full bracket-secant trace of every active ray against
    one folded decoder. salvage=False leaves bracketed-but-unconverged
    rays at the step cap unresolved (a later round re-marches them)
    instead of taking the bracket midpoint. CUDA tensors launch the
    kernel; CPU tensors, or use_kernel=False, run the plain version. The
    TPU kernel's ``block`` (its grid's block width) has no counterpart:
    the CUDA grid is one block per 64-ray tile."""
    rs = ray_setup(origins, dirs, march, init_depth, init_active)
    if use_kernel and origins.is_cuda:
        out = grid_rows_cuda(packed, origins, dirs, rs, march, salvage)
    else:
        frame = torch.zeros((1,), dtype=torch.int64, device=origins.device)
        out = march_rows_plain(packed.shared, packed.bias, frame, origins,
                               dirs, rs, march, salvage, True)
    return trace_from_rows(out, rs, origins, dirs, march)


sphere_trace_grid.launches = 0


def _merge(full: torch.Tensor, r: int, part: torch.Tensor) -> torch.Tensor:
    """full with its first r entries replaced by part (out of place)."""
    return torch.cat([part, full[r:]]) if r < full.shape[0] else part


@torch.no_grad()
def sphere_trace_rounds(packed: PackedFolded, origins: torch.Tensor,
                        dirs: torch.Tensor, march: MarchConfig,
                        init_depth: Optional[torch.Tensor] = None,
                        block: int = 512,
                        init_active: Optional[torch.Tensor] = None,
                        round_caps: Tuple[int, ...] = ROUND_CAPS,
                        use_kernel: bool = True) -> TraceResult:
    """Multi-round straggler re-binning over K1-grid.

    Round i caps every live ray at round_caps[i] steps without salvage
    (bracketed-but-unconverged rays requeue); survivors re-pack live-first
    by difficulty (open, then bracketed, then dead; one stable sort) and
    later rounds march a live prefix (n/4, then n/8 in the final round,
    which has the full budget and salvage), or every ray when the live
    rays overflow the prefix. With init_active, round 0 marches the first
    n/2 rays when the live rays fit there (the renderer sorts the
    skip class last). Prefix sizes round up to ``block`` as in the JAX
    package; they change how many rays a launch holds, never a result."""
    n = origins.shape[0]
    dev = origins.device
    t_near, _, enters = ray_sphere_entry(origins, dirs, march.sphere_radius, 0.0)
    t_closest = torch.clamp(-dot3(origins, dirs), min=0.0)
    d0 = torch.where(enters, t_near, t_closest).to(torch.float32)
    if init_depth is not None:
        seeded = torch.isfinite(init_depth) & enters
        d0 = torch.where(seeded, torch.maximum(init_depth, t_near), d0)
    no = torch.zeros((n,), dtype=torch.bool, device=dev)
    inf = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    # per-ray state in the current order; pix is each ray's pixel index
    st = dict(
        o=origins, v=dirs, d=d0, pix=torch.arange(n, device=dev),
        seed=(init_depth if init_depth is not None
              else torch.full((n,), float("nan"), device=dev)),
        live=enters if init_active is None else (enters & init_active),
        hit=no, msdf=inf, dam=d0, lastf=inf,
        steps=torch.zeros((n,), dtype=torch.int32, device=dev),
        unres=no, started=no, brk=no,
    )

    def run_round(r: int, m: MarchConfig, salvage: bool):
        res = sphere_trace_grid(
            packed, st["o"][:r], st["v"][:r], m,
            torch.where(st["started"][:r], st["d"][:r], st["seed"][:r]),
            init_active=st["live"][:r], salvage=salvage,
            use_kernel=use_kernel)
        was = st["live"][:r]
        upd = lambda name, part: _merge(
            st[name], r, torch.where(was, part, st[name][:r]))
        st["d"] = upd("d", res.depth)
        st["hit"] = upd("hit", st["hit"][:r] | res.hit)
        st["msdf"] = upd("msdf", torch.minimum(st["msdf"][:r], res.min_sdf))
        better = was & (res.min_sdf <= st["msdf"][:r])
        st["dam"] = _merge(st["dam"], r, torch.where(
            better, res.depth_at_min, st["dam"][:r]))
        st["lastf"] = upd("lastf", res.last_sdf)
        st["steps"] = _merge(st["steps"], r, st["steps"][:r] + torch.where(
            was, res.steps_per_ray, torch.zeros_like(res.steps_per_ray)))
        st["unres"] = upd("unres", res.unresolved)
        st["started"] = _merge(st["started"], r, st["started"][:r] | was)
        st["brk"] = upd("brk", res.bracketed)
        st["live"] = upd("live", res.unresolved)

    def repack():
        key = torch.where(~st["live"], 2, torch.where(st["brk"], 1, 0))
        key_s, order = torch.sort(key.to(torch.int32), stable=True)
        for k in st:
            st[k] = st[k][order]
        st["live"] = key_s != 2

    def bucketed_round(bucket: int, m: MarchConfig, salvage: bool):
        # every live ray must receive every round's cap: fall back to the
        # full width when the live rays overflow the prefix
        fits = bucket < n and int(st["live"].sum()) <= bucket
        run_round(bucket if fits else n, m, salvage)

    if n == 0:
        raise ValueError("sphere_trace_rounds needs at least one ray")
    bucket0 = min(_round_up(max(n // 2, block), block), n)
    for ri, cap in enumerate(round_caps):
        m = dataclasses.replace(march, max_steps=min(cap, march.max_steps))
        if ri == 0:
            if init_active is None:
                run_round(n, m, False)
            else:
                bucketed_round(bucket0, m, False)
        else:
            repack()
            bucketed_round(min(_round_up(max(n // 4, block), block), n), m,
                           False)
    # the final round: the full budget, salvage on
    repack()
    bucketed_round(min(_round_up(max(n // 8, block), block), n), march, True)

    # one unsort back to pixel order
    inv = inverse_permutation(st["pix"])
    d, hit, msdf, dam, lastf, unres, steps = (
        st[k][inv] for k in ("d", "hit", "msdf", "dam", "lastf", "unres",
                             "steps"))
    # geometric sphere margin for rays whose march never sampled the SDF
    p_closest = origins + t_closest[:, None] * dirs
    geo = torch.linalg.norm(p_closest, dim=-1) - march.sphere_radius
    msdf = torch.where(enters, msdf, geo)
    msdf = torch.where(torch.isinf(msdf) | (msdf > POS_BIG / 2), geo, msdf)
    return TraceResult(
        depth=d, hit=hit, min_sdf=msdf, depth_at_min=dam, last_sdf=lastf,
        steps_used=steps.max(),
        live_counts=live_counts_from_steps(steps, march.max_steps),
        unresolved=unres, steps_per_ray=steps,
    )


class FusedMarchFn:
    """A march function for one latent that routes the whole trace
    through K1-grid: callable as the point function (the tracers' plain
    path, the renderer's normals), ``.trace`` (the rounds driver above
    ``2 * max(ROUND_CAPS)`` steps, else one K1-grid march), and
    ``.trace_frame`` (the coarse-to-fine batched pipeline, set by the
    march factory). ``proxy_march`` marks a distilled-proxy march."""

    proxy_march = False

    def __init__(self, packed: PackedFolded, point_fn, use_kernel: bool = True):
        self.packed = packed
        self.point_fn = point_fn
        self.use_kernel = use_kernel

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        return self.point_fn(p)

    def trace(self, origins, dirs, march: MarchConfig, init_depth=None,
              init_active=None) -> TraceResult:
        if march.max_steps > 2 * max(ROUND_CAPS):
            return sphere_trace_rounds(
                self.packed, origins, dirs, march, init_depth,
                init_active=init_active, use_kernel=self.use_kernel)
        return sphere_trace_grid(
            self.packed, origins, dirs, march, init_depth,
            init_active=init_active, use_kernel=self.use_kernel)
