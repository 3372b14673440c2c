"""Write synthetic datasets in the two on-disk layouts the loaders read
(data/datasets.py): the depth-completion layout (view 0's depth, mask,
camera and latent) and the PMO multi-view layout (every ring view's
shaded-normal image and mask as PNGs, and the cameras), one directory
per instance. Each instance's latent is the decoder's latent plus
``--latent-noise`` N(0, 1) from a seeded generator; the renders run on
the card unless --cpu is given.

    python -m dist_renderer_tpu_torch.tasks.make_synthetic_data --out data/synth \\
        --instances 4 --views 6 --img 128
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from dist_renderer_tpu_torch.data.datasets import camera_to_json
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
from dist_renderer_tpu_torch.ops.renderer import make_march_factory, render
from dist_renderer_tpu_torch.tasks.common import (
    add_common_args, load_task_decoder, make_render_cfg, ring_cameras, task_device,
)
from dist_renderer_tpu_torch.utils.viz import save_image


def main(argv=None):
    """Returns the output root."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--latent-noise", type=float, default=0.03)
    args = ap.parse_args(argv)

    dev = task_device(args)
    params, base_latent, dcfg = load_task_decoder(args)
    cfg = make_render_cfg(args)
    sdf_fn = make_precise_sdf(params, dcfg)
    factory = make_march_factory(params, dcfg, cfg)
    cams = ring_cameras(args.img, args.views, device=dev)
    gen = torch.Generator().manual_seed(0)

    depth_root = os.path.join(args.out, "depth")
    mv_root = os.path.join(args.out, "multiview")
    for i in range(args.instances):
        noise = torch.randn(base_latent.shape, generator=gen).to(dev)
        z = base_latent + args.latent_noise * noise
        name = f"inst{i:04d}"

        # the depth-completion layout: view 0, and the known latent
        d_dir = os.path.join(depth_root, name)
        os.makedirs(d_dir, exist_ok=True)
        with torch.no_grad():
            out = render(sdf_fn, z, cams[0], cfg, factory)
        np.save(os.path.join(d_dir, "depth.npy"), out.depth.cpu().numpy().astype(np.float32))
        np.save(os.path.join(d_dir, "mask.npy"), out.mask.cpu().numpy())
        np.save(os.path.join(d_dir, "latent.npy"), z.cpu().numpy().astype(np.float32))
        with open(os.path.join(d_dir, "camera.json"), "w") as f:
            json.dump(camera_to_json(cams[0]), f)

        # the PMO multi-view layout
        m_dir = os.path.join(mv_root, name)
        os.makedirs(m_dir, exist_ok=True)
        for vi, cam in enumerate(cams):
            with torch.no_grad():
                out = render(sdf_fn, z, cam, cfg, factory)
            m = out.mask.cpu().numpy()
            n = out.normal.cpu().numpy()
            save_image(os.path.join(m_dir, f"view{vi:02d}.png"),
                       (((n + 1) / 2) * m[..., None] * 255).astype(np.uint8))
            save_image(os.path.join(m_dir, f"mask{vi:02d}.png"),
                       (m * 255).astype(np.uint8))
        with open(os.path.join(m_dir, "cameras.json"), "w") as f:
            json.dump([camera_to_json(c) for c in cams], f)
        print(f"{name}: depth + {args.views} views written")
    print(f"done: {args.instances} instances under {args.out}")
    return args.out


if __name__ == "__main__":
    main()
