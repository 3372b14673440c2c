"""Rendering: a no-grad coarse-to-fine march, then one precise recompute
at the traced surface points.

The march (ops/kernels/batched_march.py::render_batched_c2f) gives each
ray its surface distance d* (or, for a miss, the distance of its min-SDF
sample). The composition re-expresses the depth with one implicit-
function-theorem step on the precise decoder,

    depth = d* - f(z, o + d* v) / <grad_x f, v>,

from the fused recompute kernel (K3), which also gives the normals.

Forward only in this slice: ``render`` runs under ``torch.no_grad()``.
Gradients to the latent and the pose arrive with the recompute backward
kernel (ROADMAP: K4, the fwd+bwd slice).

Ported path: ``use_pallas`` + ``coarse_to_fine`` + ``c2f_classify`` with a
march factory (the ``trace_frame`` path), composed with
``GradConfig(mode="ift", recompute="pallas")``. Other configurations raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from dist_renderer_tpu_torch.config import DecoderConfig, RenderConfig
from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul
from dist_renderer_tpu_torch.ops.camera import (
    Camera, dot3, pixel_rays, ray_sphere_entry,
)
from dist_renderer_tpu_torch.ops.kernels.batched_march import (
    geo_margin, not_ported, pack_shared, render_batched_c2f,
)
from dist_renderer_tpu_torch.ops.tracer import TraceResult, live_counts_from_steps


class RenderOutput(NamedTuple):
    """Rendered maps. Flat [N] from render_rays; [H, W] from render()."""

    depth: torch.Tensor     # depth (background sentinel where miss)
    mask: torch.Tensor      # bool hit mask
    normal: torch.Tensor    # [*, 3] unit surface normal (0 where miss)
    min_sdf: torch.Tensor   # per-ray min-SDF margin (silhouette)
    points: torch.Tensor    # [*, 3] surface points
    trace: TraceResult      # raw march diagnostics


def render_rays(sdf_fn, latent: torch.Tensor, origins: torch.Tensor,
                dirs: torch.Tensor, cfg: RenderConfig,
                trace: Optional[TraceResult] = None) -> RenderOutput:
    """Composition for a flat ray batch [N, 3] on a precomputed trace.

    The precise recompute runs on a hit-first bucket of n/compact_frac
    rays when the hits fit it (misses keep the trace's margin), else at
    full width."""
    if trace is None:
        not_ported("render_rays without a precomputed trace", "A4/A5")
    use_sdg = (cfg.grad.mode == "ift" and cfg.grad.recompute == "pallas"
               and not cfg.grad.fused_dd and cfg.normal_eps == 0.0
               and hasattr(sdf_fn, "sdg_builder"))
    if not use_sdg:
        not_ported("the non-fused composition (xla recompute, last-step, "
                   "finite-difference normals)", "A5")
    if cfg.grad.polish_iters > 1:
        not_ported("extra Newton polish iterations (polish_iters > 1)", "A9")
    sdg = sdf_fn.sdg_builder(cfg.grad.recompute_block,
                             use_kernel=cfg.use_pallas)
    min_denom = cfg.grad.ift_min_denom

    def compose(o, v, d0, anchor, hit):
        s, dd, g = sdg(latent, o + anchor[:, None] * v, v)
        depth = d0 - s / torch.clamp(dd, max=-min_denom)
        depth = torch.where(hit, depth, torch.full_like(depth, cfg.background_depth))
        normal = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                                 min=1e-12)
        normal = torch.where(hit[:, None], normal, torch.zeros_like(normal))
        return depth, s, normal

    n = origins.shape[0]
    d0 = trace.depth
    anchor = torch.where(trace.hit, d0, trace.depth_at_min)
    frac = cfg.grad.compact_frac
    bucket = 0
    if frac > 0 and n >= cfg.grad.compact_min:
        bucket = min(((n // frac + 511) // 512) * 512, n)
    # the bucket choice is a host decision: one device sync per frame
    if 0 < bucket < n and int(trace.hit.sum()) <= bucket:
        # hit-first stable order: hits, then misses in pixel order
        order = torch.sort((~trace.hit).to(torch.int32), stable=True).indices
        idx_b = order[:bucket]
        take = lambda a: a[idx_b]
        d_b, s_b, n_b = compose(take(origins), take(dirs), take(d0),
                                take(anchor), take(trace.hit))
        # misses outside the bucket keep the margin the march recorded;
        # misses inside it take the precise value at their anchor
        min_sdf = trace.min_sdf.clone()
        min_sdf[idx_b] = s_b
        depth = torch.full((n,), cfg.background_depth, dtype=d_b.dtype,
                           device=d_b.device)
        depth[idx_b] = d_b
        normal = torch.zeros((n, 3), dtype=n_b.dtype, device=n_b.device)
        normal[idx_b] = n_b
    else:
        depth, min_sdf, normal = compose(origins, dirs, d0, anchor, trace.hit)

    # rays that never enter the bounding sphere: the geometric margin
    _, _, enters = ray_sphere_entry(origins, dirs, cfg.march.sphere_radius, 0.0)
    t_c = torch.clamp(-dot3(origins, dirs), min=0.0)
    min_sdf = torch.where(enters, min_sdf,
                          geo_margin(origins, dirs, t_c, cfg.march))
    return RenderOutput(depth=depth, mask=trace.hit, normal=normal,
                        min_sdf=min_sdf, points=origins + depth[:, None] * dirs,
                        trace=trace)


@torch.no_grad()
def render(sdf_fn, latent: torch.Tensor, camera: Camera,
           cfg: RenderConfig = RenderConfig(),
           march_fn_factory: Optional[Callable] = None) -> RenderOutput:
    """Full-frame render: camera -> [H, W] maps (depth, mask, normal,
    silhouette margin, points).

    Forward only: runs under ``torch.no_grad()``. Gradients to the latent
    and pose arrive with the recompute backward kernel (ROADMAP K4).
    Float32 products run in full fp32 (TF32 off), which the precise
    value's accuracy needs."""
    set_fp32_matmul()
    origins, dirs = pixel_rays(camera, cfg.img_h, cfg.img_w)
    march_fn = march_fn_factory(latent) if march_fn_factory is not None else None
    if not (cfg.march.coarse_to_fine and cfg.march.c2f_classify
            and march_fn is not None and hasattr(march_fn, "trace_frame")):
        not_ported("rendering without the coarse-to-fine trace_frame "
                    "path (plain and compaction tracers)", "A4/A5")
    trace = march_fn.trace_frame(origins, dirs, cfg.march,
                                 (cfg.img_h, cfg.img_w))
    out = render_rays(sdf_fn, latent, origins, dirs, cfg, trace=trace)
    hw = (cfg.img_h, cfg.img_w)
    return RenderOutput(
        depth=out.depth.reshape(hw), mask=out.mask.reshape(hw),
        normal=out.normal.reshape(hw + (3,)), min_sdf=out.min_sdf.reshape(hw),
        points=out.points.reshape(hw + (3,)), trace=out.trace,
    )


class MarchFn(NamedTuple):
    """The march handle a factory returns for one latent: ``trace_frame``
    runs the coarse-to-fine pipeline (proxy + verify when the factory has
    a proxy) and returns a TraceResult."""

    trace_frame: Callable


def make_march_factory(params, dcfg: DecoderConfig, cfg: RenderConfig,
                       march_params=None, march_dcfg=None):
    """Build the (latent,) -> MarchFn factory for the march. With
    march_params/march_dcfg (a distilled proxy sharing the latent space)
    the pyramid and fine march run on the proxy and a full-decoder verify
    march re-derives depth and the hit mask. The weights are packed once,
    here, for every frame the factory renders."""
    is_proxy = march_params is not None
    proxy = (march_params, march_dcfg or dcfg) if is_proxy else None
    packed = (pack_shared(params, dcfg),
              pack_shared(*proxy) if is_proxy else None)

    def factory(z):
        def trace_frame(origins, dirs, march, img_hw):
            """Single-frame plan + march through the batched c2f pipeline
            (F=1). Assumes the pinhole shared-origin layout render()
            produces."""
            vh = march.proxy_verify_hits
            st = render_batched_c2f(
                params, dcfg, z[None], origins[None, :1], dirs[None], img_hw,
                march, strides=march.c2f_strides,
                coarse_steps=march.c2f_coarse_steps,
                backoff=march.c2f_backoff, scheduler=march.scheduler,
                queue_caps=march.queue_caps,
                queue_dense_frac=march.queue_dense_frac, proxy=proxy,
                proxy_backoff=march.proxy_backoff,
                proxy_band=march.proxy_band,
                verify_mode=march.proxy_verify_mode,
                verify_band=march.proxy_verify_band,
                verify_hits="polish" if vh == "polish-all" else vh,
                verify_gen_caps=march.proxy_verify_caps_queue,
                proxy_block=march.proxy_block_width,
                use_kernel=cfg.use_pallas, packed=packed,
            )
            steps = st.steps[0]
            return TraceResult(
                depth=st.depth[0], hit=st.hit[0], min_sdf=st.min_sdf[0],
                depth_at_min=st.depth_at_min[0], last_sdf=st.last_sdf[0],
                steps_used=steps.max(),
                live_counts=live_counts_from_steps(steps, march.max_steps),
                unresolved=st.unresolved[0], steps_per_ray=steps,
            )

        return MarchFn(trace_frame)

    return factory


class SDFRenderer:
    """OO wrapper mirroring the reference's ``SDFRenderer`` class API:
    constructed from a decoder + intrinsics + image size; ``render`` takes
    (latent, R, T).

    ``device`` (default: the decoder weights' device, else the CPU) is
    where the camera, the latent and every render live; intrinsics, poses
    and latents may come as numpy arrays or tensors on any device."""

    def __init__(self, decoder_params, intrinsic, img_hw: Tuple[int, int] = (256, 256),
                 decoder_cfg: DecoderConfig = DecoderConfig(),
                 cfg: Optional[RenderConfig] = None, sdf_fn=None,
                 device=None):
        from dist_renderer_tpu_torch.models.decoder import make_precise_sdf

        if device is None:
            device = ("cpu" if decoder_params is None
                      else decoder_params["layers"][0]["w"].device)
        self.device = torch.device(device)
        self.K = self._tensor(intrinsic)
        base = cfg or RenderConfig()
        self.cfg = dataclasses.replace(base, img_h=img_hw[0], img_w=img_hw[1])
        self.march_fn_factory = None
        if sdf_fn is None:
            sdf_fn = make_precise_sdf(decoder_params, decoder_cfg)
            self.march_fn_factory = make_march_factory(
                decoder_params, decoder_cfg, self.cfg)
        self.sdf_fn = sdf_fn

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def render(self, latent, R, T) -> RenderOutput:
        cam = Camera(K=self.K, R=self._tensor(R), T=self._tensor(T))
        return render(self.sdf_fn, self._tensor(latent), cam, self.cfg,
                      self.march_fn_factory)

    def render_depth(self, latent, R, T) -> torch.Tensor:
        return self.render(latent, R, T).depth

    def render_normal(self, latent, R, T) -> torch.Tensor:
        return self.render(latent, R, T).normal

    def render_silhouette(self, latent, R, T) -> torch.Tensor:
        return self.render(latent, R, T).min_sdf
