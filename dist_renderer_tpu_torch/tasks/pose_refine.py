"""Camera pose estimation by render-and-compare: the decoder and latent
are frozen and the extrinsics are the optimization variables, through a
continuous rotation parameterization (so3 or rot6d). Gradients reach the
pose through the ray origins and directions in the differentiable
recompute.

The observation is the decoder's own render from the default camera; the
fit starts from that pose perturbed by ``--rot-err-deg`` about a seeded
axis and ``--trans-err`` of seeded translation noise.

    python -m dist_renderer_tpu_torch.tasks.pose_refine --fast --img 256 --steps 100
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from dist_renderer_tpu_torch.config import OptimConfig
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
from dist_renderer_tpu_torch.models.folded import make_point_fn
from dist_renderer_tpu_torch.ops.camera import (
    Camera, camera_from_pose, pixel_rays, pose_from_camera, so3_exp,
)
from dist_renderer_tpu_torch.ops.kernels.batched_march import not_ported
from dist_renderer_tpu_torch.ops.renderer import (
    make_march_factory, render, render_rays, render_with_warm, warm_from_trace,
)
from dist_renderer_tpu_torch.tasks.common import (
    StepTimer, add_common_args, default_camera, load_task_decoder,
    make_render_cfg, task_device,
)
from dist_renderer_tpu_torch.utils import losses as L
from dist_renderer_tpu_torch.utils.optim import fit
from dist_renderer_tpu_torch.utils.viz import MetricsLogger, save_render_panel


def perturbation(seed: int = 3):
    """(axis draw [3], translation draw [3]): standard normal draws from a
    seeded generator; the axis is normalized by the caller."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(3, generator=gen), torch.randn(3, generator=gen)


def main(argv=None):
    """Returns (FitResult, rotation error in degrees, translation error);
    the FitResult's metrics["ms_per_step"] holds the median step time."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--param", default="so3", choices=["so3", "rot6d"])
    ap.add_argument("--data", default=None,
                    help="ShapeNet-depth dataset root (not ported)")
    ap.add_argument("--instance", type=int, default=0)
    ap.add_argument("--rot-err-deg", type=float, default=10.0,
                    help="initial rotation perturbation")
    ap.add_argument("--trans-err", type=float, default=0.1)
    ap.add_argument("--w-depth", type=float, default=10.0)
    ap.add_argument("--w-sil", type=float, default=1.0)
    ap.add_argument("--warm", type=int, default=0,
                    help="warm-start refresh period N: reuse each "
                    "iteration's trace as the next one's seeds and "
                    "classification, full refresh every N steps (the "
                    "trace_frame path only)")
    # pose needs a hotter schedule than latent fitting
    ap.set_defaults(lr=3e-2, steps=300)
    args = ap.parse_args(argv)
    if args.data:
        not_ported("pose_refine --data (data/datasets.py)", "A10")

    dev = task_device(args)
    params, latent, dcfg = load_task_decoder(args)
    cfg = make_render_cfg(args)
    sdf_fn = make_precise_sdf(params, dcfg)
    march_fn = make_point_fn(params, latent, dcfg, cfg.dtype)
    # the ground-truth camera and observation
    cam_gt = default_camera(args.img, device=dev)
    o, v = pixel_rays(cam_gt, args.img, args.img)
    with torch.no_grad():
        gt = render_rays(sdf_fn, latent, o, v, cfg, march_fn)
    obs_depth, obs_valid, obs_mask = gt.depth, gt.mask, gt.mask
    hw = (args.img, args.img)

    # perturb the pose
    axis, noise = perturbation()
    axis = (axis / torch.linalg.norm(axis)).to(dev)
    R0 = so3_exp(axis * math.radians(args.rot_err_deg)) @ cam_gt.R
    T0 = cam_gt.T + args.trans_err * noise.to(dev)
    pose0 = pose_from_camera(Camera(K=cam_gt.K, R=R0, T=T0), args.param)

    os.makedirs(args.out, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out, "metrics.csv"))

    def _obj(out):
        ld = L.depth_loss(out.depth, obs_depth, obs_valid, out.mask)
        ls = L.silhouette_loss(out.min_sdf, obs_mask)
        return args.w_depth * ld + args.w_sil * ls, {"depth": ld, "sil": ls}

    def loss_fn(pose):
        cam = camera_from_pose(pose, cam_gt.K, args.param)
        oo, vv = pixel_rays(cam, args.img, args.img)
        return _obj(render_rays(sdf_fn, latent, oo, vv, cfg, march_fn))

    warm_carry = None
    use_warm = bool(args.warm) and cfg.use_pallas
    if use_warm:
        # the warm path rides the full render() (trace_frame), so the
        # previous iteration's trace replaces the coarse pyramid
        factory = make_march_factory(params, dcfg, cfg)

        def loss_fn_warm(pose, carry):
            cam = camera_from_pose(pose, cam_gt.K, args.param)
            out, carry = render_with_warm(sdf_fn, latent, cam, cfg, factory,
                                          carry, args.warm)
            # render() returns [H, W] maps; the observation is flat [N]
            out = out._replace(depth=out.depth.reshape(-1),
                               mask=out.mask.reshape(-1),
                               min_sdf=out.min_sdf.reshape(-1))
            total, aux = _obj(out)
            aux["carry"] = carry
            return total, aux

        with torch.no_grad():
            out0 = render(sdf_fn, latent,
                          camera_from_pose(pose0, cam_gt.K, args.param), cfg,
                          factory)
        warm_carry = (1, warm_from_trace(out0.trace))

    timer = StepTimer()
    res = fit(loss_fn_warm if use_warm else loss_fn, pose0,
              OptimConfig(lr=args.lr, steps=args.steps), callback=timer,
              carry_init=warm_carry)
    res.metrics["ms_per_step"] = timer.median_ms()
    for s, l in enumerate(res.loss_history.tolist()):
        logger.log(s, loss=l)

    cam_f = camera_from_pose(res.variables, cam_gt.K, args.param)
    cos = (float(torch.trace(cam_f.R.T @ cam_gt.R)) - 1.0) / 2.0
    rot_err = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    t_err = float(torch.linalg.norm(cam_f.T - cam_gt.T))
    oo, vv = pixel_rays(cam_f, args.img, args.img)
    with torch.no_grad():
        out = render_rays(sdf_fn, latent, oo, vv, cfg, march_fn)
    out = out._replace(depth=out.depth.reshape(hw), mask=out.mask.reshape(hw),
                       normal=out.normal.reshape(hw + (3,)),
                       min_sdf=out.min_sdf.reshape(hw))
    save_render_panel(os.path.join(args.out, "final.png"), out,
                      obs_depth.reshape(hw))
    print(f"final: loss {float(res.loss_history[-1]):.5f}  rot err "
          f"{rot_err:.3f} deg (init {args.rot_err_deg})  trans err "
          f"{t_err:.4f} (init ~{args.trans_err})  ms/step (median) "
          f"{res.metrics['ms_per_step']:.1f}")
    logger.close()
    return res, rot_err, t_err


if __name__ == "__main__":
    main()
