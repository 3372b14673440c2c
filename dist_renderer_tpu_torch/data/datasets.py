"""Dataset loaders: ShapeNet depth renders and PMO-style multi-view sets.

Counterpart of the JAX package's ``data/datasets.py`` (the reference's
``core/dataset/``): per-instance depth maps, masks, cameras and DeepSDF
normalization for depth completion; images, masks and cameras of V views
for multi-view reconstruction (Lin et al. CVPR 2019's PMO layout). The
loaders read the on-disk layouts, which ``tasks/make_synthetic_data.py``
writes (the JAX package's writer too); ``SyntheticShapeDataset`` renders
the same observation tuples from a decoder.

Observations hold numpy arrays and a ``Camera`` of float32 CPU tensors;
a task moves the camera to its device. PNGs are read by the stdlib reader
in ``utils/viz.py`` (8-bit gray, RGB or RGBA), not by an image library.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dist_renderer_tpu_torch.ops.camera import Camera
from dist_renderer_tpu_torch.utils.viz import read_png


class DepthObservation(NamedTuple):
    """One depth-completion observation."""

    depth: np.ndarray        # [H, W] float32, 0 where invalid
    valid: np.ndarray        # [H, W] bool
    mask: np.ndarray         # [H, W] bool silhouette
    camera: Camera
    name: str
    latent: Optional[np.ndarray] = None   # the instance's known latent (pose
                                          # estimation freezes the shape)


class MultiViewObservation(NamedTuple):
    """One multi-view sample: V views of one object."""

    images: np.ndarray       # [V, H, W, 3] float32 in [0, 1]
    masks: np.ndarray        # [V, H, W] bool
    cameras: List[Camera]
    name: str


def camera_from_json(c) -> Camera:
    """{"K": 3x3, "R": 3x3, "T": 3} -> a Camera of float32 CPU tensors."""
    return Camera(K=torch.tensor(c["K"], dtype=torch.float32),
                  R=torch.tensor(c["R"], dtype=torch.float32),
                  T=torch.tensor(c["T"], dtype=torch.float32))


def camera_to_json(cam: Camera) -> dict:
    return {k: getattr(cam, k).detach().cpu().numpy().tolist() for k in ("K", "R", "T")}


def _load_norm_params(path: str) -> Tuple[np.ndarray, float]:
    """DeepSDF normalization npz: the offset and scale that map the mesh
    into the unit sphere."""
    with np.load(path) as d:
        return np.asarray(d["offset"]).reshape(3), float(d["scale"])


def _instances(root: str, what: str, hint: str) -> List[str]:
    if not os.path.isdir(root):
        raise FileNotFoundError(f"{what} root {root} not found; {hint}")
    return sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))


class ShapeNetDepthDataset:
    """The depth-completion layout, one directory per instance:

        <root>/<instance>/depth.npy         [H, W] float32 (0 = invalid)
        <root>/<instance>/mask.npy|png      silhouette
        <root>/<instance>/camera.json       {"K": 3x3, "R": 3x3, "T": 3}
        <root>/<instance>/normalization.npz offset + scale (optional)
        <root>/<instance>/latent.npy        the known latent (optional)

    With normalization.npz the depth and camera move into DeepSDF's
    normalized coordinates: depth * scale, T' = (T + R offset) * scale."""

    def __init__(self, root: str):
        self.root = root
        self.instances = _instances(
            root, "ShapeNet depth",
            "make one with tasks/make_synthetic_data.py or use SyntheticShapeDataset")

    def __len__(self) -> int:
        return len(self.instances)

    def __getitem__(self, i: int) -> DepthObservation:
        inst = self.instances[i]
        d = os.path.join(self.root, inst)
        depth = np.load(os.path.join(d, "depth.npy")).astype(np.float32)
        mask_p = os.path.join(d, "mask.npy")
        if os.path.exists(mask_p):
            mask = np.load(mask_p).astype(bool)
        else:
            mask = read_png(os.path.join(d, "mask.png")) > 127
        with open(os.path.join(d, "camera.json")) as f:
            camera = camera_from_json(json.load(f))
        norm_p = os.path.join(d, "normalization.npz")
        if os.path.exists(norm_p):
            offset, scale = _load_norm_params(norm_p)
            depth = depth * scale
            off = torch.tensor(offset, dtype=torch.float32)
            camera = camera._replace(T=(camera.T + camera.R @ off) * scale)
        lat_p = os.path.join(d, "latent.npy")
        latent = np.load(lat_p) if os.path.exists(lat_p) else None
        return DepthObservation(depth, depth > 0, mask, camera, inst, latent)


class PMOMultiViewDataset:
    """A PMO-style multi-view layout:

        <root>/<instance>/view{i:02d}.png   RGB (or RGBA; alpha dropped)
        <root>/<instance>/mask{i:02d}.png   silhouette (gray)
        <root>/<instance>/cameras.json      [{"K":..., "R":..., "T":...}, ...]
    """

    def __init__(self, root: str):
        self.root = root
        self.instances = _instances(root, "PMO",
                                    "use SyntheticShapeDataset for runs without data")

    def __len__(self) -> int:
        return len(self.instances)

    def __getitem__(self, i: int) -> MultiViewObservation:
        inst = self.instances[i]
        d = os.path.join(self.root, inst)
        with open(os.path.join(d, "cameras.json")) as f:
            cameras = [camera_from_json(c) for c in json.load(f)]
        images, masks = [], []
        for v in range(len(cameras)):
            img = read_png(os.path.join(d, f"view{v:02d}.png"))
            images.append(img[..., :3].astype(np.float32) / 255.0)
            masks.append(read_png(os.path.join(d, f"mask{v:02d}.png")) > 127)
        return MultiViewObservation(np.stack(images), np.stack(masks), cameras, inst)


class SyntheticShapeDataset:
    """Observations rendered from a decoder (or an analytic SDF), the same
    tuples the loaders give, for runs without data. Renders run on
    ``device`` (default: the CUDA card; without one it raises unless given
    device="cpu"); the observations come back as numpy arrays and CPU
    cameras."""

    def __init__(self, sdf_fn, latents: np.ndarray, img: int = 128, n_views: int = 8,
                 march_fn_factory=None, render_cfg=None, device=None):
        from dist_renderer_tpu_torch.config import MarchConfig, RenderConfig
        from dist_renderer_tpu_torch.models.pretrain import resolve_device

        self.sdf_fn = sdf_fn
        self.latents = latents
        self.img = img
        self.n_views = n_views
        self.factory = march_fn_factory
        self.device = resolve_device(device)
        self.cfg = render_cfg or RenderConfig(img_h=img, img_w=img,
                                              march=MarchConfig(max_steps=50))

    def __len__(self) -> int:
        return len(self.latents)

    def _render(self, i: int, cam: Camera):
        from dist_renderer_tpu_torch.ops.renderer import render

        z = torch.as_tensor(np.asarray(self.latents[i], np.float32), device=self.device)
        cam_d = Camera(*(t.to(self.device) for t in cam))
        with torch.no_grad():
            return z, render(self.sdf_fn, z, cam_d, self.cfg, self.factory)

    def depth_observation(self, i: int, view: int = 0) -> DepthObservation:
        from dist_renderer_tpu_torch.tasks.common import ring_cameras

        cam = ring_cameras(self.img, max(self.n_views, 1))[view]
        _, out = self._render(i, cam)
        depth = out.depth.cpu().numpy()
        mask = out.mask.cpu().numpy()
        return DepthObservation(depth, mask.copy(), mask, cam, f"synthetic{i:04d}")

    def multiview_observation(self, i: int, color_fn=None) -> MultiViewObservation:
        """color_fn(latent, points [N, 3]) -> RGB [N, 3] textures the hits;
        without one, the shaded normals ((n + 1) / 2) stand in."""
        from dist_renderer_tpu_torch.tasks.common import ring_cameras

        cams = ring_cameras(self.img, self.n_views)
        images, masks = [], []
        for cam in cams:
            z, out = self._render(i, cam)
            m = out.mask.cpu().numpy()
            if color_fn is not None:
                with torch.no_grad():
                    rgb = color_fn(z, out.points.reshape(-1, 3)).cpu().numpy()
                rgb = rgb.reshape(self.img, self.img, 3) * m[..., None]
            else:
                rgb = ((out.normal.cpu().numpy() + 1) / 2) * m[..., None]
            images.append(rgb.astype(np.float32))
            masks.append(m)
        return MultiViewObservation(np.stack(images), np.stack(masks), cams,
                                    f"synthetic{i:04d}")


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0) -> Iterator[List]:
    """Fixed-size batches of dataset items in a seeded order
    (``np.random.RandomState(seed).shuffle``, as the JAX package draws
    it); the last partial batch is dropped."""
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    for start in range(0, len(idx) - batch_size + 1, batch_size):
        yield [dataset[int(i)] for i in idx[start:start + batch_size]]
