"""Multi-view reconstruction: silhouette + photometric consistency over a
ring of views; the gradients of every view accumulate on one shared
latent.

The observations are synthesized: the decoder's own latent rendered from
each view, textured by a fixed random color decoder so that photometric
consistency has a signal. The fit starts from the zero latent.

    python -m dist_renderer_tpu_torch.tasks.multiview --fast --img 128 --views 8
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from dist_renderer_tpu_torch.config import OptimConfig
from dist_renderer_tpu_torch.eval.mesh import extract_mesh, save_obj
from dist_renderer_tpu_torch.models.color_decoder import (
    color_apply, init_color_params, make_color_config,
)
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
from dist_renderer_tpu_torch.models.folded import make_point_fn
from dist_renderer_tpu_torch.ops.camera import pixel_rays
from dist_renderer_tpu_torch.ops.kernels.batched_march import not_ported
from dist_renderer_tpu_torch.ops.renderer import render_rays
from dist_renderer_tpu_torch.tasks.common import (
    StepTimer, add_common_args, load_task_decoder, make_render_cfg,
    ring_cameras, task_device,
)
from dist_renderer_tpu_torch.utils import losses as L
from dist_renderer_tpu_torch.utils.optim import fit
from dist_renderer_tpu_torch.utils.viz import (
    MetricsLogger, colorize_depth, panel, save_image,
)


def main(argv=None):
    """Returns the FitResult; metrics["ms_per_step"] holds the median step
    time."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--data", default=None,
                    help="PMO-style multi-view dataset root (not ported)")
    ap.add_argument("--instance", type=int, default=0)
    ap.add_argument("--w-sil", type=float, default=1.0)
    ap.add_argument("--w-photo", type=float, default=1.0)
    ap.add_argument("--w-reg", type=float, default=1e-4)
    ap.add_argument("--mesh", action="store_true",
                    help="extract the reconstructed mesh")
    ap.add_argument("--mesh-res", type=int, default=128)
    args = ap.parse_args(argv)
    if args.data:
        not_ported("multiview --data (data/datasets.py)", "A10")

    dev = task_device(args)
    params, gt_latent, dcfg = load_task_decoder(args)
    sdf_fn = make_precise_sdf(params, dcfg)
    cfg = make_render_cfg(args)
    cams = ring_cameras(args.img, args.views, device=dev)
    rays = [pixel_rays(c, cfg.img_h, cfg.img_w) for c in cams]
    hw = (cfg.img_h, cfg.img_w)

    def render_view(z, o, v):
        # the march folds a detached latent, as render() does
        return render_rays(sdf_fn, z, o, v, cfg,
                           make_point_fn(params, z.detach(), dcfg, cfg.dtype))

    # synthesize the observations: masks and images textured by a fixed
    # random color decoder
    ccfg = make_color_config(latent_size=dcfg.latent_size,
                             hidden_dims=(64,) * 4, latent_in=())
    cparams = init_color_params(torch.Generator().manual_seed(7), ccfg, dev)
    z_color = torch.zeros(dcfg.latent_size, device=dev)
    with torch.no_grad():
        gt_out = [render_view(gt_latent, o, v) for o, v in rays]
    gt_imgs = [torch.where(g.mask[:, None],
                           color_apply(cparams, z_color, g.points, ccfg), 0.0)
               for g in gt_out]
    obs_masks = [g.mask for g in gt_out]

    os.makedirs(args.out, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out, "metrics.csv"))

    def loss_fn(z):
        outs = [render_view(z, o, v) for o, v in rays]
        ls = torch.stack([L.silhouette_loss(out.min_sdf, m)
                          for out, m in zip(outs, obs_masks)]).mean()
        # photometric: view i's surface points projected into view i+1
        photo = []
        for i in range(args.views):
            j = (i + 1) % args.views
            photo.append(L.photometric_loss(
                outs[i].points, outs[i].mask, gt_imgs[i].reshape(hw + (3,)),
                cams[i], gt_imgs[j].reshape(hw + (3,)), cams[j]))
        lp = torch.stack(photo).mean()
        total = args.w_sil * ls + args.w_photo * lp + args.w_reg * L.latent_reg(z)
        return total, {"sil": ls, "photo": lp}

    timer = StepTimer()
    res = fit(loss_fn, torch.zeros_like(gt_latent),
              OptimConfig(lr=args.lr, steps=args.steps), callback=timer)
    res.metrics["ms_per_step"] = timer.median_ms()
    for s, l in enumerate(res.loss_history.tolist()):
        logger.log(s, loss=l)

    with torch.no_grad():
        outs = [render_view(res.variables, o, v) for o, v in rays]
    imgs = [colorize_depth(out.depth.reshape(hw), out.mask.reshape(hw))
            for out in outs[:4]]
    save_image(os.path.join(args.out, "final_views.png"), panel(imgs))
    # silhouette IoU of the fitted render against the observed masks
    iou = float(torch.stack([
        (out.mask & m).sum() / torch.clamp((out.mask | m).sum(), min=1)
        for out, m in zip(outs, obs_masks)]).mean())
    summary = {"final_loss": float(res.loss_history[-1]), "mask_iou": iou,
               "latent_err": float(torch.linalg.norm(res.variables - gt_latent)),
               "ms_per_step": res.metrics["ms_per_step"]}
    print(f"final: loss {summary['final_loss']:.5f}  mask IoU {iou:.4f}  "
          f"|z - z_gt| {summary['latent_err']:.4f}  ms/step (median) "
          f"{summary['ms_per_step']:.1f}")
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh)
    if args.mesh:
        verts, faces = extract_mesh(lambda p: sdf_fn(res.variables, p),
                                    resolution=args.mesh_res, device=dev)
        obj = os.path.join(args.out, "reconstructed.obj")
        save_obj(obj, verts, faces)
        print(f"mesh: {len(verts)} verts {len(faces)} faces -> {obj}")
    logger.close()
    return res


if __name__ == "__main__":
    main()
