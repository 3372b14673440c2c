"""Single-depth shape completion: optimize a latent code so the render
matches one observed (partial) depth map.

Observation sources:
  --data ROOT [--instance I]  an on-disk observation through
      data/datasets.py's ShapeNetDepthDataset (depth.npy, mask, camera.json
      [, normalization.npz]);
  (default) the decoder's own latent rendered from the default camera,
      the left ``--partial`` of the image columns kept.
The fit starts from the zero latent.

    python -m dist_renderer_tpu_torch.tasks.depth_completion --fast --img 256 --steps 50
    python -m dist_renderer_tpu_torch.tasks.depth_completion --data data/synth/depth
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from dist_renderer_tpu_torch.config import OptimConfig
from dist_renderer_tpu_torch.data.datasets import ShapeNetDepthDataset
from dist_renderer_tpu_torch.eval.chamfer import (
    chamfer_distance, sample_surface_points,
)
from dist_renderer_tpu_torch.eval.mesh import extract_mesh, save_obj
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
from dist_renderer_tpu_torch.models.folded import make_point_fn
from dist_renderer_tpu_torch.ops.camera import Camera
from dist_renderer_tpu_torch.ops.renderer import (
    make_march_factory, render, render_with_warm, warm_from_trace,
)
from dist_renderer_tpu_torch.tasks.common import (
    StepTimer, add_common_args, default_camera, load_task_decoder,
    make_render_cfg, task_device,
)
from dist_renderer_tpu_torch.utils import losses as L
from dist_renderer_tpu_torch.utils.optim import fit
from dist_renderer_tpu_torch.utils.viz import MetricsLogger, save_render_panel

CHAMFER_SAMPLES = 20000  # surface samples per shape for --mesh's chamfer


def main(argv=None):
    """Returns the FitResult; metrics["ms_per_step"] holds the median step
    time (synchronized)."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--partial", type=float, default=0.5,
                    help="fraction of image columns observed (partial depth)")
    ap.add_argument("--data", default=None,
                    help="ShapeNet-depth dataset root (ShapeNetDepthDataset "
                    "layout); omit to synthesize the observation")
    ap.add_argument("--instance", type=int, default=0,
                    help="dataset instance index (with --data)")
    ap.add_argument("--w-depth", type=float, default=10.0)
    ap.add_argument("--w-sil", type=float, default=1.0)
    ap.add_argument("--w-reg", type=float, default=1e-4)
    ap.add_argument("--vis-every", type=int, default=0)
    ap.add_argument("--mesh", action="store_true",
                    help="extract the fitted shape's mesh, with the chamfer "
                    "against the hidden complete shape")
    ap.add_argument("--mesh-res", type=int, default=128)
    ap.add_argument("--warm", type=int, default=0,
                    help="warm-start refresh period N: reuse each "
                    "iteration's trace as the next one's seeds and "
                    "classification (skips the coarse pyramid), full "
                    "refresh every N steps; the trace_frame path only")
    args = ap.parse_args(argv)

    dev = task_device(args)
    params, gt_latent, dcfg = load_task_decoder(args)
    sdf_fn = make_precise_sdf(params, dcfg)
    obs = ShapeNetDepthDataset(args.data)[args.instance] if args.data else None
    if obs is not None:
        args.img = obs.depth.shape[0]
    cfg = make_render_cfg(args)
    if obs is not None:
        cfg = dataclasses.replace(cfg, img_h=obs.depth.shape[0],
                                  img_w=obs.depth.shape[1])
    use_warm = bool(args.warm) and cfg.use_pallas
    # the warm state is a trace: it needs the march factory's trace_frame
    factory = (make_march_factory(params, dcfg, cfg) if use_warm
               else (lambda z: make_point_fn(params, z, dcfg, cfg.dtype)))
    gt = None
    if obs is not None:
        # the observed depth, mask and camera; no hidden complete shape
        cam = Camera(*(t.to(dev) for t in obs.camera))
        obs_depth = torch.as_tensor(obs.depth, device=dev)
        obs_valid = torch.as_tensor(obs.valid, device=dev)
        obs_mask = torch.as_tensor(obs.mask, device=dev)
        col_mask = torch.ones(cfg.img_w, dtype=torch.bool, device=dev)
        print(f"observation: {obs.name} ({cfg.img_h}x{cfg.img_w}, "
              f"{int(obs.valid.sum())} valid depth px) from {args.data}")
    else:
        cam = default_camera(args.img, device=dev)
        # synthesize the observation from the decoder's latent, a partial strip
        with torch.no_grad():
            gt = render(sdf_fn, gt_latent, cam, cfg, factory)
        col_mask = torch.arange(args.img, device=dev) < int(args.img * args.partial)
        obs_valid = gt.mask & col_mask[None, :]
        obs_depth = torch.where(obs_valid, gt.depth, torch.zeros_like(gt.depth))
        obs_mask = obs_valid  # silhouette supervision only where seen

    os.makedirs(args.out, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out, "metrics.csv"))

    def _obj(z, out):
        ld = L.depth_loss(out.depth, obs_depth, obs_valid, out.mask)
        ls = L.silhouette_loss(
            torch.where(col_mask[None, :], out.min_sdf, 0.0 * out.min_sdf),
            obs_mask)
        lr_ = L.latent_reg(z)
        total = args.w_depth * ld + args.w_sil * ls + args.w_reg * lr_
        return total, {"depth": ld, "sil": ls, "reg": lr_}

    def loss_fn(z):
        return _obj(z, render(sdf_fn, z, cam, cfg, factory))

    def loss_fn_warm(z, carry):
        # iteration k's trace seeds iteration k+1; the coarse pyramid is
        # skipped between refreshes
        out, carry = render_with_warm(sdf_fn, z, cam, cfg, factory, carry,
                                      args.warm)
        total, aux = _obj(z, out)
        aux["carry"] = carry
        return total, aux

    z0 = torch.zeros_like(gt_latent)  # cold start (the mean latent)
    warm_carry = None
    if use_warm:
        with torch.no_grad():
            warm_carry = (1, warm_from_trace(render(sdf_fn, z0, cam, cfg,
                                                    factory).trace))
    timer = StepTimer()

    def callback(step, z, loss):
        timer(step, z, loss)
        logger.log(step, loss=loss)
        if args.vis_every and step % args.vis_every == 0:
            with torch.no_grad():
                out = render(sdf_fn, z, cam, cfg, factory)
            save_render_panel(os.path.join(args.out, f"iter{step:05d}.png"),
                              out, obs_depth)

    res = fit(loss_fn_warm if use_warm else loss_fn, z0,
              OptimConfig(lr=args.lr, steps=args.steps,
                          checkpoint_every=args.checkpoint_every),
              checkpoint_dir=args.checkpoint_dir,
              log_every=max(args.steps // 10, 1) if args.vis_every else 0,
              callback=callback, carry_init=warm_carry)
    res.metrics["ms_per_step"] = timer.median_ms()

    with torch.no_grad():
        out = render(sdf_fn, res.variables, cam, cfg, factory)
    save_render_panel(os.path.join(args.out, "final.png"), out, obs_depth)
    last = (f"{float(res.loss_history[-1]):.5f}" if len(res.loss_history)
            else "(no step run)")
    if gt is not None:
        # quality: full-image depth error against the (hidden) complete render
        err = float(L.depth_loss(out.depth, gt.depth, gt.mask, out.mask))
        lat_err = float(torch.linalg.norm(res.variables - gt_latent))
        print(f"final: loss {last}  full-depth L1 {err:.5f}  |z - z_gt| "
              f"{lat_err:.4f}  ms/step (median) {res.metrics['ms_per_step']:.1f}")
    else:
        # observed data: no hidden complete shape; the fit on what was seen
        err = float(L.depth_loss(out.depth, obs_depth, obs_valid, out.mask))
        print(f"final: loss {last}  observed-depth L1 {err:.5f}  ms/step "
              f"(median) {res.metrics['ms_per_step']:.1f}")

    if args.mesh:
        # the fitted shape's mesh, and (when the observation was
        # synthesized) its chamfer against the hidden complete shape
        fitted = lambda p: sdf_fn(res.variables, p)
        verts, faces = extract_mesh(fitted, resolution=args.mesh_res, device=dev)
        obj = os.path.join(args.out, "fitted.obj")
        save_obj(obj, verts, faces)
        msg = f"mesh: {len(verts)} verts {len(faces)} faces -> {obj}"
        if gt is not None:
            pa = sample_surface_points(fitted, CHAMFER_SAMPLES,
                                       torch.Generator().manual_seed(0), device=dev)
            pb = sample_surface_points(lambda p: sdf_fn(gt_latent, p),
                                       CHAMFER_SAMPLES,
                                       torch.Generator().manual_seed(1), device=dev)
            ch = float(chamfer_distance(pa, pb)[2])
            res.metrics["chamfer"] = ch
            msg += f"  chamfer-sq vs GT {ch:.2e}"
        print(msg)
    logger.close()
    return res


if __name__ == "__main__":
    main()
