"""Rendering: a no-grad march, then one differentiable recompute at the
traced surface points.

The march gives each ray its surface distance d* (or, for a miss, the
distance of its min-SDF sample); it runs outside the autograd graph. The
composition re-expresses the depth from one differentiable decoder
evaluation there, either as one unit marching step (``last_step``, DIST's
default: depth = d* + f) or as one implicit-function-theorem step
(``ift``):

    depth = d* - f(z, o + d* v) / <grad_x f, v>,

where the denominator and the normals are constants and the value f
carries the gradient to the latent and, through o and v, to the camera
pose.

The march goes one of three ways (``render``), as in the JAX package's
``ops/renderer.py``:

  - ``use_pallas`` + ``coarse_to_fine`` + ``c2f_classify`` with a march
    factory: the batched coarse-to-fine pipeline (``trace_frame``: K1, K2);
  - ``coarse_to_fine`` otherwise: ``c2f_plan`` (strided coarse levels and
    a 3x3 classification), then one seeded fine trace in class order;
  - else one trace of every ray.

Each trace goes through ``_trace``: a ``FusedMarchFn``'s K1-grid march
under ``use_pallas``, else the compaction tracer or the masked tracer on
the point function. The precise value comes from the fused recompute
kernel (K3, backward K4) under ``GradConfig(mode="ift",
recompute="pallas")``, else from ``sdf_fn`` by autograd.

``render_color_rays`` and ``SDFRendererColor`` texture a render with a
color decoder at the surface points (K5 forward, K4 backward through
``recompute.make_color_vjp``).

``use_pallas`` means what it means in the JAX package (route the march
through the fused kernels). Whether a kernel runs or its plain PyTorch
version is the separate ``use_kernel`` choice of the march factory and of
``make_precise_sdf`` (the counterpart of the JAX package's ``interpret``);
on a CPU tensor every wrapper runs its plain version.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from dist_renderer_tpu_torch.config import DecoderConfig, RenderConfig
from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul
from dist_renderer_tpu_torch.ops.camera import (
    Camera, dot3, pixel_rays, ray_sphere_entry,
)
from dist_renderer_tpu_torch.ops.kernels.batched_march import (
    geo_margin, pack_shared, render_batched_c2f,
)
from dist_renderer_tpu_torch.ops.tracer import (
    TraceResult, inverse_permutation, live_counts_from_steps, sphere_trace,
    sphere_trace_compact,
)
from dist_renderer_tpu_torch.utils.profiling import annotate


def _trace(march_fn, origins, dirs, cfg: RenderConfig, init_depth=None,
           init_active=None) -> TraceResult:
    """Dispatch: fused kernel march > compaction > masked tracer."""
    if cfg.use_pallas and hasattr(march_fn, "trace"):
        return march_fn.trace(origins, dirs, cfg.march, init_depth, init_active)
    if cfg.march.use_compaction:
        return sphere_trace_compact(
            march_fn, origins, dirs, cfg.march, init_depth,
            bucket_frac=cfg.march.bucket_frac,
            inner_steps=cfg.march.inner_steps, init_active=init_active)
    return sphere_trace(march_fn, origins, dirs, cfg.march, init_depth,
                        init_active)


class C2FPlan(NamedTuple):
    """Per-fine-ray plan from the coarse levels (all [N], constants)."""

    init_depth: torch.Tensor   # seed distance (NaN = start at sphere entry)
    init_active: torch.Tensor  # False = skip class (whole neighborhood missed)
    order: torch.Tensor        # class-sorted ray order; identity when
                               # classification is off
    margin: Optional[torch.Tensor] = None  # the coarse min-SDF margin, which
                                           # skip rays take (None: no skip)


def class_order(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, inv) of a stable sort of small-integer keys: x[order] is
    sorted and sorted[inv] == x. A stable sort gives the permutation of
    the JAX package's counting sort (ops/binning.py::counting_sort_perm)."""
    order = torch.sort(key, stable=True).indices
    return order, inverse_permutation(order)


@torch.no_grad()
def c2f_plan(march_fn, origins, dirs, cfg: RenderConfig) -> C2FPlan:
    """Coarse-to-fine planning: march strided sub-grids of the pixel
    lattice (ops/c2f.py::classify_pyramid), then classify every fine ray
    from its 3x3 coarse neighborhood: all hit -> interior (seeded just in
    front of the nearest coarse depth), none hit -> skip (never marched;
    its margin anchors at the coarse min-SDF depth), mixed -> rim (full
    march). With ``c2f_classify`` the rays come back ordered rim ->
    interior -> skip and each level marches in that order too; without
    it only the seeds are used."""
    from dist_renderer_tpu_torch.ops.c2f import classify_pyramid, plan_from_maps

    h, w = cfg.img_h, cfg.img_w
    n = h * w
    dev = origins.device
    coarse_cfg = dataclasses.replace(cfg, march=dataclasses.replace(
        cfg.march, max_steps=min(cfg.march.max_steps,
                                 cfg.march.c2f_coarse_steps)))

    def trace_level(o_l, v_l, seed, active, stride):
        o1, v1 = o_l[0], v_l[0]
        if seed is None:
            res = _trace(march_fn, o1, v1, coarse_cfg)
        elif cfg.march.c2f_classify:
            init, act = seed[0], active[0]
            key = torch.where(act & torch.isnan(init), 0,
                              torch.where(act, 1, 2)).to(torch.int32)
            order, inv = class_order(key)
            res_s = _trace(march_fn, o1[order], v1[order], coarse_cfg,
                           init[order], act[order])
            res = TraceResult(*(
                a[inv] if (a is not None and a.ndim and a.shape[0] == inv.shape[0])
                else a for a in res_s))
        else:
            res = _trace(march_fn, o1, v1, coarse_cfg, seed[0], active[0])
        return types.SimpleNamespace(
            depth=res.depth[None], hit=res.hit[None],
            unresolved=res.unresolved[None],
            depth_at_min=res.depth_at_min[None], min_sdf=res.min_sdf[None])

    maps = classify_pyramid(trace_level, origins.reshape(1, h, w, 3),
                            dirs.reshape(1, h, w, 3), cfg.c2f_strides_valid(),
                            cfg.march.c2f_backoff)
    everyone = torch.ones((n,), dtype=torch.bool, device=dev)
    identity = torch.arange(n, device=dev)
    if maps is None:  # no valid strides: no plan
        return C2FPlan(torch.full((n,), float("nan"), device=dev), everyone,
                       identity)
    if not cfg.march.c2f_classify:
        return C2FPlan(maps.seed.reshape(-1), everyone, identity)
    key, init_depth, skip = plan_from_maps(maps)
    order, _ = class_order(key[0])
    return C2FPlan(init_depth[0], ~skip[0], order, maps.margin.reshape(-1))


def c2f_seed_depth(march_fn, origins, dirs, cfg: RenderConfig) -> torch.Tensor:
    """The seed-only view of c2f_plan."""
    return c2f_plan(march_fn, origins, dirs, cfg).init_depth


class RenderOutput(NamedTuple):
    """Rendered maps. Flat [N] from render_rays; [H, W] from render()."""

    depth: torch.Tensor     # depth (background sentinel where miss)
    mask: torch.Tensor      # bool hit mask
    normal: torch.Tensor    # [*, 3] unit surface normal (0 where miss)
    min_sdf: torch.Tensor   # per-ray min-SDF margin (silhouette)
    points: torch.Tensor    # [*, 3] surface points
    trace: Optional[TraceResult]  # raw march diagnostics (None after c2f_plan)


class LazyMargin(torch.autograd.Function):
    """The margin of misses outside the compose bucket: the value is the
    one the march recorded, and the backward attaches the gradient of
    ``fn(latent, p)`` at each ray's anchor (the precise sdg, K3 forward
    and K4 backward, or the cheap decoder). Under a loss that ignores the
    margins autograd never calls it, which keeps a depth-only backward
    cheap."""

    @staticmethod
    def forward(ctx, latent, p_anchor, margin, fn):
        ctx.save_for_backward(latent, p_anchor)
        ctx.fn = fn
        return margin.clone()

    @staticmethod
    def backward(ctx, ct):
        latent, p_anchor = ctx.saved_tensors
        want_z, want_p = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            z = latent.detach().requires_grad_(want_z)
            p = p_anchor.detach().requires_grad_(want_p)
            s = ctx.fn(z, p)
            wrt = [x for x, want in ((z, want_z), (p, want_p)) if want]
            grads = iter(torch.autograd.grad(s, wrt, ct))
        gz = next(grads) if want_z else None
        gp = next(grads) if want_p else None
        return gz, gp, None, None


def _spatial_grad(fn, p: torch.Tensor) -> torch.Tensor:
    """grad_x fn at the points p [N, 3] (constants), one backward pass:
    each output depends on its own point only, so the gradient of the
    sum is every point's gradient."""
    with torch.enable_grad():
        pp = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(pp).sum(), pp)
    return g


_FD_OFFSETS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
               (0, 0, -1))


def render_rays(sdf_fn, latent: torch.Tensor, origins: torch.Tensor,
                dirs: torch.Tensor, cfg: RenderConfig, march_fn=None,
                init_depth: Optional[torch.Tensor] = None,
                init_active: Optional[torch.Tensor] = None,
                trace: Optional[TraceResult] = None) -> RenderOutput:
    """Trace + differentiable composition for a flat ray batch [N, 3].

    march_fn: optional point function for the no-grad march (the folded
    decoder, or a FusedMarchFn); without it the march evaluates ``sdf_fn``
    on the detached latent. init_depth, init_active: the march's seeds
    and the rays it marches at all (False: the c2f skip class, never
    marched). trace: a precomputed march result (then only the
    composition runs). depth, min_sdf and points carry gradients to
    ``latent`` and, through ``origins`` and ``dirs``, to whatever they were
    computed from; the mask and, but for finite-difference normals, the
    normals are constants.

    The spatial gradient (IFT denominator, normals) comes from the march
    function, unless it is a distilled proxy (``proxy_march``), whose
    slope carries model error: then from ``sdf_fn.cheap`` (else
    ``sdf_fn``) on the detached latent. The recompute runs on a hit-first
    bucket of n/compact_frac rays when the hits fit it, else at full
    width; with the fused recompute and no gradient wanted, the full width
    is K3 on the hits and K3's value alone on the misses (a miss keeps
    only its value: the same bits). Misses outside the bucket keep the
    trace's margin as the value
    with the decoder's gradient at their anchor (LazyMargin); rays that
    never enter the bounding sphere take the geometric distance as the
    value and keep the margin's gradient. With a proxy march and
    ``proxy_verify_hits`` "polish" (or "polish-all") the trace's proxy hits
    are unverified, and the Newton polish demotes the false ones (the
    mask is then the trace's hits less those); it needs
    ``GradConfig(mode="ift", polish_iters >= 2)``."""
    if trace is None:
        trace_fn = march_fn if march_fn is not None else (
            lambda p: sdf_fn(latent.detach(), p))
        with torch.no_grad():
            trace = _trace(trace_fn, origins.detach(), dirs.detach(), cfg,
                           init_depth, init_active)
    g = cfg.grad
    # proxy_verify_hits="polish": the proxy trace's confident hits skipped
    # the verify march, so the composition owns their verdict: the Newton
    # polish re-anchors depth on the full decoder, and a hit whose polish
    # walked and ended at a positive value above convergence_eps is a
    # proxy false hit, demoted to a miss (its margin becomes that value)
    demote = (cfg.march.proxy_verify_hits in ("polish", "polish-all")
              and getattr(march_fn, "proxy_march", False))
    if demote and (g.mode != "ift" or g.polish_iters < 2):
        raise ValueError(
            "proxy_verify_hits='polish' requires GradConfig(mode='ift', "
            "polish_iters >= 2): the demote verdict comes from the "
            "safeguarded Newton iterations, and mode='last_step' or "
            "polish_iters=1 runs none of them")
    # under demote an accepted step must shrink |f| geometrically: equal-|f|
    # steps through a flat pocket would walk the depth at no cost
    rho = 0.7 if demote else 1.0
    base = getattr(sdf_fn, "cheap", sdf_fn)
    use_march_g = march_fn is not None and not getattr(
        march_fn, "proxy_march", False)
    g_fn = march_fn if use_march_g else (lambda p: base(latent.detach(), p))
    # GradConfig.fused_dd: the value and the IFT denominator from one pass
    # of sdf_fn.with_dd (the tangent rides the value's forward pass), in
    # place of the fused recompute kernel or a separate spatial gradient
    fused_dd = g.mode == "ift" and g.fused_dd and hasattr(sdf_fn, "with_dd")
    use_sdg = (g.mode == "ift" and g.recompute == "pallas" and not g.fused_dd
               and cfg.normal_eps == 0.0 and hasattr(sdf_fn, "sdg_builder"))
    sdg = sdf_fn.sdg_builder(g.recompute_block) if use_sdg else None
    min_denom = g.ift_min_denom
    extra = max(g.polish_iters - 1, 0)

    def ift_depth(d0, s, dd, denom, hit, acc_any):
        """The IFT depth, and the hit mask after the demote: under it a
        flat-slope ray keeps its seed depth and no depth gradient (an IFT
        step through the clamped denominator is noise), and a hit whose
        Newton walked and ended above convergence_eps is a false dip."""
        if not demote:
            return d0 - s / denom, hit
        depth = d0 - torch.where(dd < -min_denom, s, 0.0 * s) / denom
        return depth, hit & ~(acc_any & (s.detach() > cfg.march.convergence_eps))

    def finish(depth, hit, normal_raw):
        depth = torch.where(hit, depth, torch.full_like(depth, cfg.background_depth))
        normal = normal_raw / torch.clamp(
            torch.linalg.norm(normal_raw, dim=-1, keepdim=True), min=1e-12)
        normal = torch.where(hit[:, None], normal, torch.zeros_like(normal))
        return depth, normal

    def compose_sdg(o, v, d0, anchor, hit):
        # one fused evaluation gives the value, the directional derivative
        # and the spatial gradient; extra Newton steps take a fresh
        # derivative each, accepted only off the denominator clamp and
        # where |f| does not grow
        vc = v.detach()
        with annotate("drt.compose.k3"):
            s, dd, gr = sdg(latent, o + anchor[:, None] * v, vc)
        denom = torch.clamp(dd, max=-min_denom)
        acc_any = torch.zeros_like(hit)
        for _ in range(extra):
            ok = hit & (dd < -min_denom)
            d_try = torch.where(ok, d0 - s.detach() / denom, d0)
            p_try = o + torch.where(hit, d_try, anchor)[:, None] * v
            with annotate("drt.compose.k3"):
                s2, dd2, g2 = sdg(latent, p_try, vc)
            accept = ok & (s2.detach().abs() <= rho * s.detach().abs())
            acc_any = acc_any | accept
            d0 = torch.where(accept, d_try, d0)
            s = torch.where(accept, s2, s)
            dd = torch.where(accept, dd2, dd)
            gr = torch.where(accept[:, None], g2, gr)
            denom = torch.clamp(dd, max=-min_denom)
        depth, hit = ift_depth(d0, s, dd, denom, hit, acc_any)
        depth, normal = finish(depth, hit, gr)
        return depth, s, normal, hit

    def compose_xla(o, v, d0, anchor, hit):
        p_surf = o + anchor[:, None] * v
        gr = None
        if fused_dd:
            s, dd = sdf_fn.with_dd(latent, p_surf, v.detach())
        else:
            s = sdf_fn(latent, p_surf)       # the precise value
        if g.mode == "ift":
            if not fused_dd:
                gr = _spatial_grad(g_fn, p_surf)
                dd = dot3(gr, v.detach())
            denom = torch.clamp(dd, max=-min_denom)  # front-facing: < 0
            # extra Newton steps with the frozen denominator, safeguarded:
            # only off the clamp, and only where |f| does not grow
            ok = hit & (dd < -min_denom)
            acc_any = torch.zeros_like(hit)
            for _ in range(extra):
                d_try = torch.where(ok, d0 - s.detach() / denom, d0)
                p_try = o + torch.where(hit, d_try, anchor)[:, None] * v
                s2 = sdf_fn(latent, p_try)
                accept = ok & (s2.detach().abs() <= rho * s.detach().abs())
                acc_any = acc_any | accept
                d0 = torch.where(accept, d_try, d0)
                s = torch.where(accept, s2, s)
                p_surf = torch.where(accept[:, None], p_try, p_surf)
                gr = None  # the normals are taken where the polish ended
            # the slope gate stays frozen at the seed here
            depth, hit = ift_depth(d0, s, dd, denom, hit, acc_any)
        else:  # "last_step": one unit marching step
            depth = d0 + s
        if cfg.normal_eps > 0.0:
            # central differences of the precise value (differentiable)
            offs = torch.tensor(_FD_OFFSETS, dtype=p_surf.dtype,
                                device=p_surf.device) * cfg.normal_eps
            probe = (p_surf[:, None, :] + offs[None]).reshape(-1, 3)
            sv = sdf_fn(latent, probe).reshape(-1, 6)
            gr = torch.stack([sv[:, 0] - sv[:, 1], sv[:, 2] - sv[:, 3],
                              sv[:, 4] - sv[:, 5]], dim=-1) / (2.0 * cfg.normal_eps)
        elif gr is None:
            gr = _spatial_grad(g_fn, p_surf)
        depth, normal = finish(depth, hit, gr)
        return depth, s, normal, hit

    with annotate("drt.compose"):
        compose = compose_sdg if use_sdg else compose_xla
        n = origins.shape[0]
        d0 = trace.depth
        anchor = torch.where(trace.hit, d0, trace.depth_at_min)
        frac = g.compact_frac
        bucket = 0
        if frac > 0 and n >= g.compact_min:
            bucket = min(((n // frac + 511) // 512) * 512, n)
        want_grad = torch.is_grad_enabled() and (latent.requires_grad
                                                 or origins.requires_grad
                                                 or dirs.requires_grad)
        # the bucket choice is a host decision: one device sync per frame
        hits = None
        if 0 < bucket < n:
            with annotate("drt.compose.read"):
                hits = int(trace.hit.sum())
        fits = hits is not None and hits <= bucket
        # overflowed, and no gradient wanted: the full width keeps only the
        # precise value of a miss (its margin), so the hits take K3 and the
        # misses K3's value alone, the same bits
        split = hits is not None and not fits and use_sdg and not want_grad
        if fits or split:
            # hit-first stable order: hits, then misses in pixel order; the
            # bucket's rays, or the hits alone where they overflow it
            order = torch.sort((~trace.hit).to(torch.int32), stable=True).indices
            idx_b = (order[:bucket if fits else hits],)
            d_b, s_b, n_b, h_b = compose(origins[idx_b], dirs[idx_b], d0[idx_b],
                                         anchor[idx_b], trace.hit[idx_b])
            margins = trace.min_sdf
            if split:
                # the misses: the precise value alone, the full width's margin
                idx_m = (order[hits:],)
                with annotate("drt.compose.value"):
                    margins = margins.index_put(idx_m, sdg.value(
                        latent, origins[idx_m] + anchor[idx_m][:, None] * dirs[idx_m]))
            elif want_grad:
                # misses outside the bucket keep the margin the march
                # recorded, with the decoder's gradient at their anchor
                if use_sdg:
                    dirs_c = dirs.detach()
                    fn = lambda z, p: sdg(z, p, dirs_c)[0]
                else:
                    fn = base
                margins = LazyMargin.apply(latent, origins + anchor[:, None] * dirs,
                                           margins, fn)
            # the composed rays take the precise value (scatters out of
            # place, for autograd)
            min_sdf = margins.index_put(idx_b, s_b)
            depth = torch.full((n,), cfg.background_depth, dtype=d_b.dtype,
                               device=d_b.device).index_put(idx_b, d_b)
            normal = torch.zeros((n, 3), dtype=n_b.dtype,
                                 device=n_b.device).index_put(idx_b, n_b)
            # the rays outside the composed ones are misses whenever it is used
            mask = torch.zeros_like(trace.hit).index_put(idx_b, h_b)
        else:
            depth, min_sdf, normal, mask = compose(origins, dirs, d0, anchor,
                                                   trace.hit)

        # rays that never enter the bounding sphere: the geometric margin as
        # the value, the decoder eval's gradient kept (it pulls back a shape
        # that pokes past the sphere during a fit)
        o_c, v_c = origins.detach(), dirs.detach()
        _, _, enters = ray_sphere_entry(o_c, v_c, cfg.march.sphere_radius, 0.0)
        t_c = torch.clamp(-dot3(o_c, v_c), min=0.0)
        geo = geo_margin(o_c, v_c, t_c, cfg.march)
        min_sdf = torch.where(enters, min_sdf, geo + min_sdf - min_sdf.detach())
        return RenderOutput(depth=depth, mask=mask, normal=normal,
                            min_sdf=min_sdf, points=origins + depth[:, None] * dirs,
                            trace=trace)


def render_color_rays(sdf_fn, color_fn, latent: torch.Tensor,
                      latent_color: torch.Tensor, origins: torch.Tensor,
                      dirs: torch.Tensor, cfg: RenderConfig, march_fn=None,
                      init_depth: Optional[torch.Tensor] = None
                      ) -> Tuple[RenderOutput, torch.Tensor]:
    """Textured render of a flat ray batch: render_rays, then the color
    decoder ``color_fn(latent_color, points)`` at the surface points (the
    reference's SDFRenderer_color.render_color); misses are 0. The RGB
    [N, 3] carries gradients to both latents and, through the surface
    points' depth, to the geometry and the pose."""
    out = render_rays(sdf_fn, latent, origins, dirs, cfg, march_fn, init_depth)
    rgb = color_fn(latent_color, out.points)
    rgb = torch.where(out.mask[:, None], rgb, torch.zeros_like(rgb))
    return out, rgb


def warm_from_trace(trace: TraceResult) -> Tuple[torch.Tensor, ...]:
    """The warm-start state (depth, hitish, anchor, margin) the next
    optimizer iteration's render classifies from instead of the coarse
    pyramid (ops/c2f.py::warm_maps). Unresolved rays count as hits, so a
    step-capped ray is never wrongly skipped next iteration."""
    return (trace.depth.detach(), (trace.hit | trace.unresolved).detach(),
            trace.depth_at_min.detach(), trace.min_sdf.detach())


def render_with_warm(sdf_fn, latent, camera, cfg, march_fn_factory, carry,
                     refresh: int):
    """One warm-started render inside an optimization loop.

    carry = (step, warm_state), threaded through utils.optim.fit's carry;
    every ``refresh`` steps the full coarse pyramid runs (the warm maps'
    dilation bounds per-step silhouette motion, not drift). Returns
    (RenderOutput, next carry); differentiable like render()."""
    k, wstate = carry
    warm = None if k % refresh == 0 else wstate
    out = render(sdf_fn, latent, camera, cfg, march_fn_factory, warm)
    return out, (k + 1, warm_from_trace(out.trace))


def render(sdf_fn, latent: torch.Tensor, camera: Camera,
           cfg: RenderConfig = RenderConfig(),
           march_fn_factory: Optional[Callable] = None,
           warm: Optional[Tuple[torch.Tensor, ...]] = None) -> RenderOutput:
    """Full-frame render: camera -> [H, W] maps (depth, mask, normal,
    silhouette margin, points).

    march_fn_factory: optional (latent,) -> march function builder for
    the no-grad march (make_march_factory). warm: optional
    warm_from_trace(previous out.trace); the trace_frame path classifies
    from it instead of the coarse pyramid (other paths ignore it).

    Differentiable: depth, min_sdf and points carry gradients to
    ``latent`` and to the camera's R and T when they require grad; the
    march runs under ``torch.no_grad()`` on a detached latent. Float32
    products run in full fp32 (TF32 off), which the precise value's
    accuracy needs."""
    with annotate("drt.render"):
        return _render(sdf_fn, latent, camera, cfg, march_fn_factory, warm)


def _render(sdf_fn, latent, camera, cfg, march_fn_factory, warm) -> RenderOutput:
    set_fp32_matmul()
    with annotate("drt.setup"):
        origins, dirs = pixel_rays(camera, cfg.img_h, cfg.img_w)
    march_fn = (march_fn_factory(latent.detach())
                if march_fn_factory is not None else None)
    if (cfg.use_pallas and cfg.march.coarse_to_fine and cfg.march.c2f_classify
            and march_fn is not None and hasattr(march_fn, "trace_frame")):
        with torch.no_grad():
            trace = march_fn.trace_frame(origins.detach(), dirs.detach(),
                                         cfg.march, (cfg.img_h, cfg.img_w),
                                         warm=warm)
        out = render_rays(sdf_fn, latent, origins, dirs, cfg,
                          march_fn=march_fn, trace=trace)
    elif cfg.march.coarse_to_fine and cfg.c2f_strides_valid():
        mf = march_fn if march_fn is not None else (
            lambda p: sdf_fn(latent.detach(), p))
        plan = c2f_plan(mf, origins.detach(), dirs.detach(), cfg)
        perm = plan.order
        inv = inverse_permutation(perm)
        with torch.no_grad():
            trace = _trace(mf, origins[perm].detach(), dirs[perm].detach(), cfg,
                           plan.init_depth[perm], plan.init_active[perm])
        if plan.margin is not None:
            # skip rays never sample the SDF: their margin is the coarse
            # level's, as the batched path's merge_skip gives it (the
            # tracer's stand-in, the distance of the closest approach to
            # the bounding sphere, is negative for every ray through it)
            trace = trace._replace(min_sdf=torch.where(
                plan.init_active[perm], trace.min_sdf, plan.margin[perm]))
        out_p = render_rays(sdf_fn, latent, origins[perm], dirs[perm], cfg,
                            march_fn=march_fn, trace=trace)
        out = RenderOutput(
            depth=out_p.depth[inv], mask=out_p.mask[inv],
            normal=out_p.normal[inv], min_sdf=out_p.min_sdf[inv],
            points=out_p.points[inv], trace=None)
    else:
        out = render_rays(sdf_fn, latent, origins, dirs, cfg, march_fn=march_fn)
    hw = (cfg.img_h, cfg.img_w)
    return RenderOutput(
        depth=out.depth.reshape(hw), mask=out.mask.reshape(hw),
        normal=out.normal.reshape(hw + (3,)), min_sdf=out.min_sdf.reshape(hw),
        points=out.points.reshape(hw + (3,)), trace=out.trace,
    )


def make_march_factory(params, dcfg: DecoderConfig, cfg: RenderConfig,
                       march_params=None, march_dcfg=None,
                       use_kernel: bool = True):
    """Build the (latent,) -> march function factory: the latent-folded
    decoder in the render's compute dtype, wrapped as a ``FusedMarchFn``
    under ``cfg.use_pallas`` (K1-grid ``.trace`` and the batched
    coarse-to-fine ``.trace_frame``).

    march_params/march_dcfg: an optional distilled proxy decoder sharing
    the latent space. trace_frame marches the proxy and verifies with a
    full-decoder march; ``.trace`` and the plain tracers march the proxy
    alone (use GradConfig.polish_iters >= 2 so the full-decoder Newton in
    the composition re-anchors depth). The march function carries
    ``proxy_march`` so the renderer takes no derivative from a proxy.

    use_kernel=False runs every kernel's plain version on any device. The
    weights are packed once, here, for every frame the factory renders."""
    from dist_renderer_tpu_torch.models.folded import PointFn, fold_latent
    from dist_renderer_tpu_torch.ops.kernels.fused_march import (
        FusedMarchFn, pack_folded,
    )

    is_proxy = march_params is not None
    mparams = march_params if is_proxy else params
    mdcfg = (march_dcfg or dcfg) if is_proxy else dcfg
    packed = None
    if cfg.use_pallas:
        packed = (pack_shared(params, dcfg),
                  pack_shared(mparams, mdcfg) if is_proxy else None)
    proxy = (mparams, mdcfg) if is_proxy else None

    def factory(z):
        with annotate("drt.setup"):
            folded = fold_latent(mparams, z, mdcfg)
            point_fn = PointFn(folded, mdcfg, cfg.dtype)
            point_fn.proxy_march = is_proxy
            if not cfg.use_pallas:
                return point_fn
            mf = FusedMarchFn(pack_folded(folded, mdcfg, packed[1] or packed[0]),
                              point_fn, use_kernel=use_kernel)
        mf.proxy_march = is_proxy

        def trace_frame(origins, dirs, march, img_hw, warm=None):
            """Single-frame plan + march through the batched c2f pipeline
            (F=1). Assumes the pinhole shared-origin layout render()
            produces. warm: optional flat [N] (depth, hitish, anchor,
            margin) from the previous iteration (warm_from_trace); it
            replaces the coarse pyramid."""
            vh = march.proxy_verify_hits
            st = render_batched_c2f(
                params, dcfg, z[None], origins[None, :1], dirs[None], img_hw,
                march, strides=march.c2f_strides,
                coarse_steps=march.c2f_coarse_steps,
                backoff=march.c2f_backoff, shared_origin=True,
                return_anchor=True, return_steps=True, return_last=True,
                scheduler=march.scheduler, queue_caps=march.queue_caps,
                queue_dense_frac=march.queue_dense_frac,
                warm=None if warm is None else tuple(a[None] for a in warm),
                proxy=proxy, proxy_backoff=march.proxy_backoff,
                proxy_band=march.proxy_band,
                verify_mode=march.proxy_verify_mode,
                verify_band=march.proxy_verify_band,
                # "polish-all" is a batched trace + finalize contract (its
                # weak candidates need finalize_hits_batched); a frame
                # maps it to "polish" and compose() finalizes the hits
                verify_hits="polish" if vh == "polish-all" else vh,
                verify_round_caps=march.proxy_verify_caps,
                verify_gen_caps=march.proxy_verify_caps_queue,
                proxy_block=march.proxy_block_width,
                use_kernel=use_kernel, packed=packed,
            )
            steps = st.steps[0]
            return TraceResult(
                depth=st.depth[0], hit=st.hit[0], min_sdf=st.min_sdf[0],
                depth_at_min=st.depth_at_min[0], last_sdf=st.last_sdf[0],
                steps_used=steps.max(),
                live_counts=live_counts_from_steps(steps, march.max_steps),
                unresolved=st.unresolved[0], steps_per_ray=steps,
            )

        mf.trace_frame = trace_frame
        return mf

    return factory


@torch.no_grad()
def finalize_hits_batched(
    params,
    dcfg: DecoderConfig,
    latents: torch.Tensor,         # [F, L]
    origins: torch.Tensor,         # [F, N, 3] (or [F, 1, 3])
    dirs: torch.Tensor,            # [F, N, 3]
    depth: torch.Tensor,           # [F, N] trace depth (proxy-valued hits)
    hit: torch.Tensor,             # [F, N] trace hit flags (unverified)
    msdf: torch.Tensor,            # [F, N] trace min-SDF margins
    *,
    convergence_eps: float,
    background_depth: float = 10.0,
    ift_min_denom: float = 1e-2,
    polish_iters: int = 2,
    compact_frac: int = 4,
    weak: Optional[torch.Tensor] = None,   # [F, N] polish-all candidates
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-decoder hit finalize for a trace of render_batched_c2f(
    verify_hits="polish" or "polish-all"), whose confident proxy hits
    carry proxy depth and an unverified flag: compose()'s demote, frame
    by frame, on the trace alone.

    Each hit takes polish_iters - 1 safeguarded Newton steps on the full
    decoder's value and directional derivative (decoder_apply_with_dd,
    with the JAX package's roundings): a step only
    on a real front-facing slope (dd < -ift_min_denom), accepted only
    where |f| shrinks by 0.7, and the final extrapolation only on a real
    slope. A hit whose Newton walked and ended at f > convergence_eps is a
    proxy false hit and is demoted; a stalled one keeps the proxy verdict.
    A ``weak`` candidate (a polish-all band ray on the hit channel) keeps
    the hit only if its final f is within convergence_eps.

    Returns (depth, hit, msdf): hits carry re-anchored depth (background
    where demoted) and their polished value as the margin; every ray that
    is not a hit keeps its trace depth and margin. When every frame's hits
    fit an N // compact_frac bucket (one host decision on the largest
    per-frame hit count) only a hit-first bucket of each frame is
    evaluated, else every ray. The two give the same result up to the
    GEMMs' sums, whose order the card's GEMM picks by shape (on the CPU
    bit for bit). Under ``batched_march.host_free()`` both are evaluated
    and the choice is made on the device, with no host read and the eager
    call's bits. (The JAX package's bucketed branch also resets the depth
    of misses to the background and overwrites the margins of the misses
    that pad the bucket; its full-width branch does neither.)"""
    from dist_renderer_tpu_torch.models.decoder import decoder_apply_with_dd
    from dist_renderer_tpu_torch.ops.kernels.march_body import in_host_free

    set_fp32_matmul()
    f, n = depth.shape
    bucket = max(n // compact_frac, 1)
    origins = origins.expand(f, n, 3)
    if weak is None:
        weak = torch.zeros_like(hit)

    def polish(z, o, v, d, h, w):
        fdd = lambda p: decoder_apply_with_dd(params, z, p, v, dcfg)
        s, dd = fdd(o + d[:, None] * v)
        denom = torch.clamp(dd, max=-ift_min_denom)
        acc_any = torch.zeros_like(h)
        for _ in range(max(polish_iters - 1, 0)):
            ok = h & (dd < -ift_min_denom)
            d_try = torch.where(ok, d - s / denom, d)
            s2, dd2 = fdd(o + d_try[:, None] * v)
            accept = ok & (s2.abs() <= 0.7 * s.abs())
            acc_any = acc_any | accept
            d = torch.where(accept, d_try, d)
            s = torch.where(accept, s2, s)
            dd = torch.where(accept, dd2, dd)
            denom = torch.clamp(dd, max=-ift_min_denom)
        d_fin = d - torch.where(dd < -ift_min_denom, s, torch.zeros_like(s)) / denom
        h_new = h & ~((acc_any | w) & (s > convergence_eps))
        d_fin = torch.where(h_new, d_fin, torch.full_like(d_fin, background_depth))
        return d_fin, h_new, s

    def branch(bucketed):
        outs = []
        for i in range(f):
            d, h, m = depth[i], hit[i], msdf[i]
            sel = (torch.sort((~h).to(torch.int32), stable=True).indices[:bucket]
                   if bucketed else torch.arange(n, device=d.device))
            hs = h[sel]
            d_f, h_f, s_f = polish(latents[i], origins[i][sel], dirs[i][sel], d[sel],
                                   hs, weak[i][sel])
            outs.append((d.index_put((sel,), torch.where(hs, d_f, d[sel])),
                         h.index_put((sel,), h_f),
                         m.index_put((sel,), torch.where(hs, s_f, m[sel]))))
        return tuple(torch.stack(x) for x in zip(*outs))

    with annotate("drt.finalize"):
        if not in_host_free():
            with annotate(".read"):
                fits = int(hit.sum(dim=1).max()) <= bucket
            return branch(fits)
        # both branches, the choice made on the device: the eager call's bits
        fits = hit.sum(dim=1).max() <= bucket
        return tuple(torch.where(fits, a, b) for a, b in zip(branch(True), branch(False)))


class SDFRenderer:
    """OO wrapper mirroring the reference's ``SDFRenderer`` class API:
    constructed from a decoder + intrinsics + image size; ``render`` takes
    (latent, R, T) and passes gradients to those that require grad.

    ``device`` (default: the decoder weights' device; for an analytic
    ``sdf_fn`` without weights, the current CUDA card, raising without
    one unless given device="cpu") is where the camera, the latent and
    every render live; intrinsics, poses and latents may come as numpy
    arrays or tensors on any device. use_kernel=False runs every
    kernel's plain version."""

    def __init__(self, decoder_params, intrinsic, img_hw: Tuple[int, int] = (256, 256),
                 decoder_cfg: DecoderConfig = DecoderConfig(),
                 cfg: Optional[RenderConfig] = None, sdf_fn=None,
                 device=None, use_kernel: bool = True):
        from dist_renderer_tpu_torch.eval.mesh import default_device
        from dist_renderer_tpu_torch.models.decoder import make_precise_sdf

        if device is None:
            device = (default_device() if decoder_params is None
                      else decoder_params["layers"][0]["w"].device)
        self.device = torch.device(device)
        self.K = self._tensor(intrinsic)
        base = cfg or RenderConfig()
        self.cfg = dataclasses.replace(base, img_h=img_hw[0], img_w=img_hw[1])
        self.march_fn_factory = None
        if sdf_fn is None:
            sdf_fn = make_precise_sdf(decoder_params, decoder_cfg, use_kernel)
            self.march_fn_factory = make_march_factory(
                decoder_params, decoder_cfg, self.cfg, use_kernel=use_kernel)
        self.sdf_fn = sdf_fn

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def render(self, latent, R, T, warm=None) -> RenderOutput:
        cam = Camera(K=self.K, R=self._tensor(R), T=self._tensor(T))
        return render(self.sdf_fn, self._tensor(latent), cam, self.cfg,
                      self.march_fn_factory, warm)

    def render_depth(self, latent, R, T) -> torch.Tensor:
        return self.render(latent, R, T).depth

    def render_normal(self, latent, R, T) -> torch.Tensor:
        return self.render(latent, R, T).normal

    def render_silhouette(self, latent, R, T) -> torch.Tensor:
        return self.render(latent, R, T).min_sdf


class SDFRendererColor:
    """Wrapper mirroring the reference's ``SDFRenderer_color``: an
    SDFRenderer's geometry and march, textured by ``color_fn(latent_color,
    points) -> RGB`` (``recompute.make_color_vjp`` for the differentiable
    color head)."""

    def __init__(self, sdf_renderer: SDFRenderer, color_fn):
        self.base = sdf_renderer
        self.color_fn = color_fn

    def render_color(self, latent, latent_color, R, T):
        """-> (the flat RenderOutput, RGB [H, W, 3]); differentiable to
        both latents and to R and T where they require grad."""
        base, cfg = self.base, self.base.cfg
        set_fp32_matmul()
        cam = Camera(K=base.K, R=base._tensor(R), T=base._tensor(T))
        origins, dirs = pixel_rays(cam, cfg.img_h, cfg.img_w)
        z = base._tensor(latent)
        march_fn = (base.march_fn_factory(z.detach())
                    if base.march_fn_factory is not None else None)
        out, rgb = render_color_rays(base.sdf_fn, self.color_fn, z,
                                     base._tensor(latent_color), origins, dirs,
                                     cfg, march_fn)
        return out, rgb.reshape(cfg.img_h, cfg.img_w, 3)
