"""Quantitative evaluation: the symmetric chamfer distance of a decoder's
shape against the analytic ground truth (--shape), per instance and
aggregated; optionally the render-space metrics against the same ground
truth rendered by the same pipeline.

    python -m dist_renderer_tpu_torch.tasks.evaluate --img 64 --instances 3
    python -m dist_renderer_tpu_torch.tasks.evaluate --mesh-based --image-metrics
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from dist_renderer_tpu_torch.config import MarchConfig, RenderConfig
from dist_renderer_tpu_torch.eval.chamfer import chamfer_distance, sample_surface_points
from dist_renderer_tpu_torch.eval.mesh import extract_mesh, sample_mesh_surface
from dist_renderer_tpu_torch.eval.native import sample_mesh_surface_native
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
from dist_renderer_tpu_torch.ops.renderer import render
from dist_renderer_tpu_torch.tasks.common import (
    add_common_args, analytic_shape, load_task_decoder, ring_cameras, task_device,
)

MESH_RES = 96  # --mesh-based's grid resolution


def _image_metrics(args, pred_fn, gt_fn, dev):
    """Render-space quality against the ground truth, both rendered by the
    same pipeline over a ring of cameras (so only the geometry differs):
    depth L1 and normal cosine error on pixels both hit, silhouette IoU
    over the frame; the reference's depth, normal and silhouette axes."""
    cfg = RenderConfig(img_h=args.img, img_w=args.img,
                       march=MarchConfig(max_steps=args.march_steps))
    p_sdf = lambda z, p: pred_fn(p)
    g_sdf = lambda z, p: gt_fn(p)
    z = torch.zeros((1,), device=dev)
    d_l1, n_err, iou = [], [], []
    with torch.no_grad():
        for cam in ring_cameras(args.img, args.views, device=dev):
            po = render(p_sdf, z, cam, cfg)
            go = render(g_sdf, z, cam, cfg)
            both = po.mask & go.mask
            nb = torch.clamp(both.sum(), min=1)
            d_l1.append(float(torch.where(both, (po.depth - go.depth).abs(),
                                          0.0).sum() / nb))
            cos = (po.normal * go.normal).sum(dim=-1)
            n_err.append(float(torch.where(both, 1.0 - cos, 0.0).sum() / nb))
            iou.append(float((po.mask & go.mask).sum()
                             / torch.clamp((po.mask | go.mask).sum(), min=1)))
    return {"depth_l1": float(np.mean(d_l1)),
            "normal_cos_err": float(np.mean(n_err)),
            "silhouette_iou": float(np.mean(iou))}


def main(argv=None):
    """Returns the aggregate metrics (and prints one JSON line per
    instance, then the aggregate)."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--instances", type=int, default=1)
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--latent-noise", type=float, default=0.0)
    ap.add_argument("--mesh-based", action="store_true",
                    help="sample the prediction through its marching-"
                    "tetrahedra mesh instead of SDF projection")
    ap.add_argument("--image-metrics", action="store_true",
                    help="also report render-space metrics against the GT "
                    "shape rendered by the same pipeline: masked depth L1, "
                    "normal cosine error, silhouette IoU")
    ap.add_argument("--views", type=int, default=4,
                    help="ring views for --image-metrics")
    args = ap.parse_args(argv)

    dev = task_device(args)
    params, base_latent, dcfg = load_task_decoder(args)
    gt = analytic_shape(args.shape)
    gt_fn = lambda p: gt(None, p)
    psdf = make_precise_sdf(params, dcfg)

    gen = torch.Generator().manual_seed(0)
    results = []
    for i in range(args.instances):
        noise = torch.randn(base_latent.shape, generator=gen).to(dev)
        z = base_latent + args.latent_noise * noise
        pred_fn = lambda p, _z=z: psdf(_z, p)

        if args.mesh_based:
            verts, faces = extract_mesh(pred_fn, resolution=MESH_RES, device=dev)
            pa = sample_mesh_surface_native(verts, faces, args.samples, seed=i)
            if pa is None:
                pa = sample_mesh_surface(verts, faces, args.samples, seed=i)
            pa = torch.as_tensor(pa, device=dev)
        else:
            pa = sample_surface_points(pred_fn, args.samples, gen, device=dev)
        pb = sample_surface_points(gt_fn, args.samples, gen, device=dev)
        a2b, b2a, total = chamfer_distance(pa, pb)
        results.append({"instance": i, "chamfer_pred_to_gt": float(a2b),
                        "chamfer_gt_to_pred": float(b2a),
                        "chamfer_sym": float(total)})
        if args.image_metrics:
            results[-1].update(_image_metrics(args, pred_fn, gt_fn, dev))
        print(json.dumps(results[-1]))

    agg = {
        "category": args.shape,
        "n": len(results),
        "chamfer_sym_mean": float(np.mean([r["chamfer_sym"] for r in results])),
        "chamfer_sym_median": float(np.median([r["chamfer_sym"] for r in results])),
    }
    if args.image_metrics:
        for k in ("depth_l1", "normal_cos_err", "silhouette_iou"):
            agg[f"{k}_mean"] = float(np.mean([r[k] for r in results]))
    print(json.dumps(agg))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chamfer.json"), "w") as f:
            json.dump({"per_instance": results, "aggregate": agg}, f, indent=2)
    return agg


if __name__ == "__main__":
    main()
