"""Render demo: depth / normal / silhouette maps from a decoder, a latent
and a camera, one panel PNG per view.

    python -m dist_renderer_tpu_torch.tasks.render_demo --img 256 --out out/demo
"""

from __future__ import annotations

import argparse
import os
import time

from dist_renderer_tpu_torch.eval.mesh import extract_mesh, save_obj
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
from dist_renderer_tpu_torch.models.folded import make_point_fn
from dist_renderer_tpu_torch.ops.renderer import render
from dist_renderer_tpu_torch.tasks.common import (
    add_common_args, default_camera, load_task_decoder, make_render_cfg,
    synchronize, task_device,
)
from dist_renderer_tpu_torch.utils.viz import save_render_panel

MESH_RES = 128  # --mesh's grid resolution


def main(argv=None):
    """Returns the per-view render times in ms (synchronized)."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--views", type=int, default=1)
    ap.add_argument("--mesh", action="store_true", help="also extract an .obj")
    args = ap.parse_args(argv)

    dev = task_device(args)
    params, latent, dcfg = load_task_decoder(args)
    cfg = make_render_cfg(args)
    sdf_fn = make_precise_sdf(params, dcfg)
    factory = lambda z: make_point_fn(params, z, dcfg, cfg.dtype)

    os.makedirs(args.out, exist_ok=True)
    times = []
    for i in range(args.views):
        cam = default_camera(args.img, elev_azim=(
            20.0, 30.0 + 360.0 * i / max(args.views, 1)), device=dev)
        t0 = time.perf_counter()
        out = render(sdf_fn, latent, cam, cfg, factory)
        synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        path = os.path.join(args.out, f"view{i:02d}.png")
        save_render_panel(path, out)
        print(f"view {i}: {times[-1]:.1f} ms, {int(out.mask.sum())} hit px -> {path}")

    if args.mesh:
        verts, faces = extract_mesh(lambda p: sdf_fn(latent, p),
                                    resolution=MESH_RES, device=dev)
        obj = os.path.join(args.out, "shape.obj")
        save_obj(obj, verts, faces)
        print(f"mesh: {len(verts)} verts, {len(faces)} faces -> {obj}")
    return times


if __name__ == "__main__":
    main()
