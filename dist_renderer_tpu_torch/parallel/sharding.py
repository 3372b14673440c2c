"""Sharded renders and the sharded fit step on a DeviceMesh.

Counterpart of the JAX package's ``parallel/sharding.py``, with its five
functions, names and arguments. There one controller runs shard_map; here
every rank of the process group calls the same function on the same
whole inputs, works on its own slice, and the outputs meet in gathers
(``mesh.gather``), so every rank returns the whole result.

  - The march is parallel over rays: each rank marches its ray shard
    with no communication, and its loops end when its own rays converge.
  - Frames and views shard over the "latents" axis.
  - The only collectives: the batched render's halo rows (one boundary
    coarse row per level and window), the gathers of the outputs, and in
    the fit step the latent gradient's sum over the rays axis and the
    loss's over the world.

``use_kernel`` is the per-call counterpart of the JAX package's
``interpret``: False runs every kernel's plain version on any device; on
a CPU tensor the plain versions run regardless. The renders are forward
only (their gathers carry no gradient); ``make_sharded_fit_step`` is the
differentiable sharded path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from dist_renderer_tpu_torch.config import LossConfig, MarchConfig, RenderConfig
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.renderer import RenderOutput, render_rays
from dist_renderer_tpu_torch.parallel.mesh import (
    all_reduce, axis_index, axis_size, gather, latent_sharding,
    pad_to_multiple, ray_sharding,
)
from dist_renderer_tpu_torch.utils import losses as L

_MAPS = ("depth", "mask", "normal", "min_sdf", "points")


@torch.no_grad()
def render_frame_sharded(sdf_fn: Callable, latent: torch.Tensor, camera: Camera,
                         cfg: RenderConfig, mesh, ray_axis: str = "rays"
                         ) -> RenderOutput:
    """One frame with its pixels sharded over ``ray_axis``: each rank runs
    render_rays on its slice. Ray counts that do not divide the axis are
    padded with dummy rays (origin 0, direction 1.0: they march harmlessly
    and are trimmed), so any image size runs on any mesh. [H, W] maps,
    trace None."""
    k = axis_size(mesh, ray_axis)
    n_rays = cfg.img_h * cfg.img_w
    origins, dirs = pixel_rays(camera, cfg.img_h, cfg.img_w)
    pad = pad_to_multiple(n_rays, k) - n_rays
    if pad:
        origins = torch.cat([origins, origins.new_zeros((pad, 3))])
        dirs = torch.cat([dirs, dirs.new_ones((pad, 3))])
    out = render_rays(sdf_fn, latent, ray_sharding(origins, mesh, ray_axis),
                      ray_sharding(dirs, mesh, ray_axis), cfg)
    hw = (cfg.img_h, cfg.img_w)
    full = {f: gather(getattr(out, f), mesh, ray_axis)[:n_rays] for f in _MAPS}
    return RenderOutput(
        depth=full["depth"].reshape(hw), mask=full["mask"].reshape(hw),
        normal=full["normal"].reshape(hw + (3,)),
        min_sdf=full["min_sdf"].reshape(hw),
        points=full["points"].reshape(hw + (3,)), trace=None)


@torch.no_grad()
def render_views_sharded(sdf_fn: Callable, latent: torch.Tensor,
                         origins: torch.Tensor,   # [V, N, 3]
                         dirs: torch.Tensor,      # [V, N, 3]
                         cfg: RenderConfig, mesh, view_axis: str = "latents"
                         ) -> RenderOutput:
    """A multi-view render with the views sharded over ``view_axis``; the
    latent is shared, each rank renders its views with no communication.
    Fields [V, N(, 3)], trace None."""
    k = axis_size(mesh, view_axis)
    if origins.shape[0] % k:
        raise ValueError(f"{origins.shape[0]} views not divisible by {k} shards")
    outs = [render_rays(sdf_fn, latent, o, v, cfg)
            for o, v in zip(latent_sharding(origins, mesh, view_axis),
                            latent_sharding(dirs, mesh, view_axis))]
    return RenderOutput(
        **{f: gather(torch.stack([getattr(o, f) for o in outs]), mesh, view_axis)
           for f in _MAPS}, trace=None)


@torch.no_grad()
def trace_sharded_pallas(packed, origins: torch.Tensor, dirs: torch.Tensor,
                         march: MarchConfig, mesh, ray_axis: str = "rays",
                         block: int = 512, use_kernel: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The K1-grid march (``sphere_trace_grid``) on each rank's ray shard
    of [N, 3] rays, with no communication during the march. packed: a
    ``fused_march.PackedFolded`` on every rank. Returns (depth, hit,
    min_sdf) [N]. ``block`` only steered the TPU's scheduling."""
    from dist_renderer_tpu_torch.ops.kernels.fused_march import sphere_trace_grid

    del block
    r = sphere_trace_grid(packed, ray_sharding(origins, mesh, ray_axis),
                          ray_sharding(dirs, mesh, ray_axis), march,
                          use_kernel=use_kernel)
    return tuple(gather(x, mesh, ray_axis) for x in (r.depth, r.hit, r.min_sdf))


def halo_windows(mesh, ray_axis: str) -> Callable:
    """The 3x3 window reduce of ``classify_pyramid`` on a horizontal band
    of the coarse grid [F, hc, wc]: the band axis is extended by the
    neighbours' boundary rows (one gather of every band's first and last
    row over ``ray_axis``), the lane axis padded; missing rows at the true
    image edges and the lane padding take each op's identity (+inf for
    min, -inf for max, False for or, True for and). That is the
    single-device SAME window (``c2f.default_windows``) value for value,
    so the sharded plan equals the single-device plan."""
    k = axis_size(mesh, ray_axis)
    i = axis_index(mesh, ray_axis)

    def max3(x):
        # every op reduces as a max, whose identity is -inf
        edge = torch.full_like(x[:, :1], -float("inf"))
        top = bot = edge
        if k > 1:
            rows = gather(torch.stack([x[:, 0], x[:, -1]]), mesh, ray_axis)
            if i > 0:
                top = rows[2 * i - 1][:, None]    # the band above's last row
            if i < k - 1:
                bot = rows[2 * i + 2][:, None]    # the band below's first row
        ext = torch.cat([top, x, bot], dim=1)
        return F.max_pool2d(ext[:, None], 3, 1, padding=(0, 1))[:, 0]

    def windows(grid: torch.Tensor, op: str) -> torch.Tensor:
        if op == "max":
            return max3(grid)
        if op == "min":
            return -max3(-grid)
        g = grid.to(torch.float32)
        if op == "or":
            return max3(g) > 0.5
        if op == "and":
            return -max3(-g) > 0.5
        raise ValueError(f"unknown window op {op!r}")

    return windows


@torch.no_grad()
def render_batched_c2f_sharded(
    params,
    dcfg,
    latents: torch.Tensor,         # [F, L]
    origins: torch.Tensor,         # [F, H*W, 3] (or [F, 1, 3]) row-major pixel rays
    dirs: torch.Tensor,            # [F, H*W, 3]
    img_hw: Tuple[int, int],
    march: MarchConfig,
    mesh,
    frame_axis: str = "latents",
    ray_axis: str = "rays",
    block: int = 512,
    strides: Tuple[int, ...] = (16, 4),
    coarse_steps: int = 16,
    backoff: float = 0.05,
    use_kernel: bool = True,
    round_caps: Tuple[int, ...] = (4, 12),
    shared_origin: bool = False,
    scheduler: str = "rounds",
    queue_caps: Tuple[int, ...] = (1, 2, 6, 16),
    queue_dense_frac: float = 0.5,
    persistent: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batched coarse-to-fine render (``render_batched_c2f``) on a 2-D
    mesh: frames shard over ``frame_axis`` (each rank folds its own bias
    bank), each frame's rays over ``ray_axis`` as horizontal image bands.
    The classification needs each coarse cell's 3x3 neighbourhood, so the
    bands exchange one boundary coarse row per level and window
    (``halo_windows``): the sharded plan is the single-device plan. The
    march itself has no communication.

    Coarse levels march on K1 (K1-multi with persistent=False); the fine
    march runs on ``scheduler``: "rounds" (``fine_march_rounds``: K1, or
    K1-multi with persistent=False), "queue" (K2, each band walking its
    own queue) or "auto" (the queue where each rank holds one frame). Both
    are one uninterrupted full-budget march, so the plan decides the
    result. Skip rays take the coarse margin.

    Restrictions (ValueError): the frames divide over ``frame_axis``, and
    some stride s > 1 of ``strides`` divides the band (H / mesh[ray_axis])
    and W, with H divisible by s * mesh[ray_axis]; only such strides are
    used. Returns (depth, hit, min_sdf), each [F, H*W]. ``block`` rounds
    the rounds scheduler's prefix widths; ``queue_dense_frac`` only
    steered the TPU's scheduling."""
    from dist_renderer_tpu_torch.ops.c2f import classify_pyramid, plan_from_maps
    from dist_renderer_tpu_torch.ops.kernels.batched_march import (
        batched_trace_padded, fine_march_rounds, fold_bias_bank, pack_shared,
    )
    from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march

    if scheduler not in ("rounds", "queue", "auto"):
        raise ValueError(f"scheduler must be 'rounds', 'queue' or 'auto', "
                         f"got {scheduler!r}")
    h, w = img_hw
    n_rb = axis_size(mesh, ray_axis)
    n_fb = axis_size(mesh, frame_axis)
    f = latents.shape[0]
    if f % n_fb:
        raise ValueError(f"{f} frames not divisible by {n_fb}")
    h_loc = h // n_rb
    valid = tuple(s for s in strides
                  if s > 1 and h_loc % s == 0 and w % s == 0 and h % (s * n_rb) == 0)
    if not valid:
        raise ValueError(f"no stride of {strides} divides band {h_loc}x{w} "
                         f"({n_rb} ray shards of a {h}x{w} image)")
    shared = pack_shared(params, dcfg)
    coarse_march = dataclasses.replace(march, max_steps=min(march.max_steps,
                                                            coarse_steps))
    lat = latent_sharding(latents, mesh, frame_axis)
    f_loc = lat.shape[0]
    band = lambda a: ray_sharding(latent_sharding(a, mesh, frame_axis), mesh,
                                  ray_axis, dim=1)
    o = band(origins.expand(f, h * w, 3))
    v = band(dirs)
    bank = fold_bias_bank(params, lat, dcfg, shared)

    def trace_level(o_l, v_l, seed, active, stride):
        return batched_trace_padded(shared, bank, o_l, v_l, coarse_march, seed,
                                    active, block, True, use_kernel, persistent)

    maps = classify_pyramid(trace_level, o.reshape(f_loc, h_loc, w, 3),
                            v.reshape(f_loc, h_loc, w, 3), valid, backoff,
                            windows=halo_windows(mesh, ray_axis))
    key, init_depth, skip = plan_from_maps(maps)
    o_in = o[:, :1] if shared_origin else o
    if scheduler == "auto":
        scheduler = "queue" if f_loc == 1 else "rounds"
    if scheduler == "queue":
        st = queue_march(shared, bank, o_in, v, key, init_depth, march,
                         block=block, gen_caps=queue_caps,
                         dense_frac=queue_dense_frac, use_kernel=use_kernel)
    else:
        st = fine_march_rounds(shared, bank, o_in, v, key, init_depth, march,
                               block=block, round_caps=round_caps,
                               use_kernel=use_kernel, persistent=persistent)
    msdf = torch.where(skip, maps.margin.reshape(f_loc, -1), st.min_sdf)
    return tuple(gather(gather(x, mesh, ray_axis, dim=1), mesh, frame_axis)
                 for x in (st.depth, st.hit, msdf))


def local_loss(sdf_fn: Callable, cfg: RenderConfig, loss_cfg: LossConfig,
               lat: torch.Tensor,     # [b, L]
               o: torch.Tensor,       # [b, n, 3]
               v: torch.Tensor,       # [b, n, 3]
               d: torch.Tensor,       # [b, n]
               m: torch.Tensor        # [b, n] bool
               ) -> torch.Tensor:
    """The fit objective of one (shapes, rays) tile: per shape, the
    weighted depth, silhouette and latent-prior terms of its rays here,
    summed over the shapes."""
    total = lat.new_zeros(())
    for b in range(lat.shape[0]):
        out = render_rays(sdf_fn, lat[b], o[b], v[b], cfg)
        total = total + (
            loss_cfg.w_depth * L.depth_loss(out.depth, d[b], m[b], out.mask)
            + loss_cfg.w_silhouette * L.silhouette_loss(out.min_sdf, m[b])
            + loss_cfg.w_latent_reg * L.latent_reg(lat[b]))
    return total


def make_sharded_fit_step(sdf_fn: Callable, cfg: RenderConfig,
                          loss_cfg: LossConfig, mesh,
                          latents: torch.Tensor,      # [B, L], every rank
                          latent_axis: str = "latents", ray_axis: str = "rays",
                          optimizer: Callable = None):
    """The multi-rank step of batched latent fitting: many shapes at once,
    each shape's rays sharded.

    Latents [B, L] shard over ``latent_axis``: this rank keeps its shard
    [b_loc, L] as the optimizer's parameter. Observations [B, N_rays]
    shard B over ``latent_axis`` and N over ``ray_axis``, so each rank
    owns a (b_loc, n_loc) tile and computes its ``local_loss``. After the
    backward, the shard's gradient sums over ``ray_axis`` only (a shape's
    rays live on several ranks; the latent axis needs no collective), and
    the loss over the whole world.

    optimizer: params -> torch.optim.Optimizer (default Adam, lr 1e-2:
    the JAX package's optax.adam(1e-2)). Returns (step, optimizer);
    step(origins, dirs, obs_depth, obs_mask) takes the whole batch on
    every rank and returns (this rank's updated shard, the global loss);
    ``gather_latents`` puts the shards together."""
    shard = latent_sharding(latents, mesh, latent_axis).detach().clone()
    shard.requires_grad_(True)
    opt = (optimizer or (lambda p: torch.optim.Adam(p, lr=1e-2)))([shard])
    ray_group = mesh.get_group(ray_axis)
    tile = lambda a: ray_sharding(latent_sharding(a, mesh, latent_axis), mesh,
                                  ray_axis, dim=1)

    def step(origins, dirs, obs_depth, obs_mask):
        opt.zero_grad(set_to_none=True)
        loss = local_loss(sdf_fn, cfg, loss_cfg, shard, tile(origins), tile(dirs),
                          tile(obs_depth), tile(obs_mask))
        loss.backward()
        shard.grad = all_reduce(shard.grad, ray_group)
        opt.step()
        return shard.detach().clone(), all_reduce(loss.detach())

    return step, opt


def gather_latents(shard: torch.Tensor, mesh, latent_axis: str = "latents"
                   ) -> torch.Tensor:
    """The whole [B, L] latents from every rank's shard."""
    return gather(shard, mesh, latent_axis)
