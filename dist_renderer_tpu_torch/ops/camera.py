"""Pinhole camera model and ray generation (x_cam = R @ x_world + T)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Camera(NamedTuple):
    """Pinhole camera. K: [3,3] intrinsics; R: [3,3], T: [3]."""

    K: torch.Tensor
    R: torch.Tensor
    T: torch.Tensor

    @property
    def center(self) -> torch.Tensor:
        """Camera center in world coordinates: c = -R^T T."""
        return -self.R.T @ self.T

    @staticmethod
    def looking_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                   focal: float = 300.0, img_hw: Tuple[int, int] = (256, 256),
                   device="cpu") -> "Camera":
        """Camera at `eye` looking at `target` (OpenCV convention: +z
        forward, +x right, +y down in the camera frame)."""
        f32 = torch.float32
        eye = torch.as_tensor(eye, dtype=f32, device=device)
        target = torch.as_tensor(target, dtype=f32, device=device)
        up = torch.as_tensor(up, dtype=f32, device=device)
        fwd = target - eye
        fwd = fwd / torch.linalg.norm(fwd)
        right = torch.linalg.cross(fwd, up)
        right = right / torch.linalg.norm(right)
        down = torch.linalg.cross(fwd, right)
        R = torch.stack([right, down, fwd], dim=0)
        T = -R @ eye
        h, w = img_hw
        K = torch.tensor(
            [[focal, 0.0, (w - 1) / 2.0], [0.0, focal, (h - 1) / 2.0],
             [0.0, 0.0, 1.0]], dtype=f32, device=device)
        return Camera(K=K, R=R, T=T)


def pixel_rays(camera: Camera, img_h: int, img_w: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(origins [H*W, 3], unit dirs [H*W, 3]) in world space; the origin is
    the camera center broadcast per ray."""
    dev = camera.K.device
    ys = torch.arange(img_h, dtype=torch.float32, device=dev)
    xs = torch.arange(img_w, dtype=torch.float32, device=dev)
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], dim=-1).reshape(-1, 3)
    d_cam = pix @ torch.linalg.inv(camera.K).T
    d_world = d_cam @ camera.R
    d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    origins = camera.center[None, :].expand(d_world.shape)
    return origins, d_world


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row dot product of [..., 3] arrays, summed in a fixed order
    (x, then y, then z) so the result does not depend on the batch size."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_sphere_entry(origins: torch.Tensor, dirs: torch.Tensor,
                     radius: float = 1.0, margin: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intersect rays with the bounding sphere. Returns (t_near, t_far,
    hit); rays missing the sphere get t_near = t_far = 0 and hit=False."""
    r = radius + margin
    b = dot3(origins, dirs)
    c = dot3(origins, origins) - r * r
    disc = b * b - c
    hit = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_near = torch.clamp(-b - sq, min=0.0)
    t_far = -b + sq
    hit = hit & (t_far > 0.0)
    t_near = torch.where(hit, t_near, torch.zeros_like(t_near))
    t_far = torch.where(hit, t_far, torch.zeros_like(t_far))
    return t_near, t_far, hit
