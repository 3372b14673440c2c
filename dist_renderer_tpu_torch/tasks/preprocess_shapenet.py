"""Preprocessing: depth-completion and multi-view datasets rendered from
meshes.

Counterpart of the JAX package's ``tasks/preprocess_shapenet.py`` (the
reference's ShapeNet preprocessing, whose depth renders come from
external renderers). Each mesh is raycast by the host BVH
(``eval/raycast.py``), DeepSDF's unit-sphere normalization is computed,
and both on-disk layouts that ``data/datasets.py`` reads are written:

  depth completion:  <out>/depth/<mesh>_v<k>/{depth.npy, mask.npy,
                     camera.json, normalization.npz}
  multi-view (PMO):  <out>/multiview/<mesh>/{view*.png, mask*.png,
                     cameras.json, normalization.npz}   (shaded renders)

Cameras are in the mesh's own frame with the normalization beside them,
as published DeepSDF assets are. PNGs come from the stdlib writer
(``utils/viz.png_bytes``). The camera rays are made on the card, or on
the CPU with --cpu (``tasks/common.task_device``); the casting runs on
the host.

    python -m dist_renderer_tpu_torch.tasks.preprocess_shapenet \\
        --meshes path/with/objs --out data/shapenet --views 6 --img 256
"""

from __future__ import annotations

import argparse
import json
import os
import zlib

import numpy as np

from dist_renderer_tpu_torch.data.datasets import camera_to_json
from dist_renderer_tpu_torch.eval.raycast import (
    deepsdf_normalization, load_obj, raycast_depth, render_mesh_depth,
)
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.utils.viz import png_bytes


def ring_cameras_around(center: np.ndarray, radius: float, img: int,
                        n_views: int, elevation: float = 0.35,
                        jitter: float = 0.0, seed: int = 0, device="cpu") -> list:
    """A ring of cameras around ``center`` (the mesh's own frame). jitter
    > 0 moves each view's azimuth, elevation and distance by a fraction
    of their nominal values (a real rig is not a perfect ring), drawn
    from ``np.random.RandomState(seed)``, as the JAX package draws them."""
    rng = np.random.RandomState(seed)
    cams = []
    for k in range(n_views):
        az = 2.0 * np.pi * k / max(n_views, 1)
        el, r = elevation, radius
        if jitter > 0.0:
            az += jitter * rng.uniform(-np.pi, np.pi) / max(n_views, 1)
            el += jitter * rng.uniform(-0.5, 0.5)
            r *= 1.0 + jitter * rng.uniform(-0.2, 0.2)
        eye = center + r * np.array(
            [np.cos(az) * np.cos(el), np.sin(el), np.sin(az) * np.cos(el)],
            np.float32)
        cams.append(Camera.looking_at(tuple(eye), tuple(center), focal=img * 1.2,
                                      img_hw=(img, img), device=device))
    return cams


def _write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def preprocess_mesh(obj_path: str, out_root: str, views: int, img: int,
                    write_depth: bool = True, write_multiview: bool = True,
                    use_native: bool = True, camera_jitter: float = 0.0,
                    device=None) -> dict:
    """One mesh -> dataset instances; returns a summary dict. ``device``:
    where the camera rays are made (default: the CUDA card; without one it
    raises unless given device="cpu")."""
    from dist_renderer_tpu_torch.models.pretrain import resolve_device

    device = resolve_device(device)
    name = os.path.splitext(os.path.basename(obj_path))[0]
    verts, faces = load_obj(obj_path)
    if len(faces) == 0:
        raise ValueError(f"{obj_path}: no faces")
    offset, scale = deepsdf_normalization(verts)
    # a ring in the mesh's own frame, far enough to see the whole object;
    # a stable per-mesh seed (Python's str hash is salted per process)
    cams = ring_cameras_around(offset, 2.5 / scale, img, views,
                               jitter=camera_jitter,
                               seed=zlib.crc32(name.encode()) & 0x7FFFFFFF,
                               device=device)
    summary = {"name": name, "views": views, "instances": []}
    if write_depth:
        for k, cam in enumerate(cams):
            depth, mask = render_mesh_depth(verts, faces, cam, (img, img), use_native)
            inst = f"{name}_v{k:02d}"
            d = os.path.join(out_root, "depth", inst)
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, "depth.npy"), depth)
            np.save(os.path.join(d, "mask.npy"), mask)
            with open(os.path.join(d, "camera.json"), "w") as f:
                json.dump(camera_to_json(cam), f)
            np.savez(os.path.join(d, "normalization.npz"),
                     offset=offset, scale=np.float32(scale))
            summary["instances"].append(inst)

    if write_multiview:
        m_dir = os.path.join(out_root, "multiview", name)
        os.makedirs(m_dir, exist_ok=True)
        cams_json = []
        for k, cam in enumerate(cams):
            o, v = pixel_rays(cam, img, img)
            t = raycast_depth(verts, faces, o.cpu().numpy(), v.cpu().numpy(),
                              use_native)
            mask = np.isfinite(t).reshape(img, img)
            # headlight shading from the depth slope: a Lambertian-like
            # stand-in texture, as the synthetic generator's
            d_img = np.where(np.isfinite(t), t, 0.0).reshape(img, img)
            gy, gx = np.gradient(d_img)
            shade = 1.0 / np.sqrt(1.0 + 25.0 * (gx ** 2 + gy ** 2))
            rgb = np.stack([shade] * 3, axis=-1) * mask[..., None] * 255
            _write_png(os.path.join(m_dir, f"view{k:02d}.png"), rgb.astype(np.uint8))
            _write_png(os.path.join(m_dir, f"mask{k:02d}.png"),
                       (mask * 255).astype(np.uint8))
            cams_json.append(camera_to_json(cam))
        with open(os.path.join(m_dir, "cameras.json"), "w") as f:
            json.dump(cams_json, f)
        # multi-view consumers read the normalization from the depth layout
        # or work in the mesh's frame; it is recorded here too
        np.savez(os.path.join(m_dir, "normalization.npz"),
                 offset=offset, scale=np.float32(scale))
    return summary


def main(argv=None):
    from dist_renderer_tpu_torch.tasks.common import task_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--meshes", required=True,
                    help="directory of .obj meshes (or a single .obj)")
    ap.add_argument("--out", default="data/shapenet")
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--no-depth", action="store_true")
    ap.add_argument("--no-multiview", action="store_true")
    ap.add_argument("--no-native", action="store_true",
                    help="cast with the numpy raycaster")
    ap.add_argument("--camera-jitter", type=float, default=0.0,
                    help="perturb the camera ring (0.3 = a realistic rig)")
    ap.add_argument("--cpu", action="store_true",
                    help="make the rays on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = task_device(args)

    if os.path.isfile(args.meshes):
        objs = [args.meshes]
    else:
        objs = sorted(os.path.join(args.meshes, f)
                      for f in os.listdir(args.meshes) if f.endswith(".obj"))
    if not objs:
        raise SystemExit(f"no .obj meshes under {args.meshes}")
    summaries = []
    for p in objs:
        s = preprocess_mesh(p, args.out, args.views, args.img,
                            write_depth=not args.no_depth,
                            write_multiview=not args.no_multiview,
                            use_native=not args.no_native,
                            camera_jitter=args.camera_jitter, device=device)
        print(f"{s['name']}: {len(s['instances'])} depth instances"
              + ("" if args.no_multiview else f" + {args.views} views"))
        summaries.append(s)
    print(f"done: {len(objs)} meshes -> {args.out}")
    return summaries


if __name__ == "__main__":
    main()
