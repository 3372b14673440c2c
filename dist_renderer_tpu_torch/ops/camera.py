"""Pinhole camera model, ray generation (x_cam = R @ x_world + T) and the
rotation parameterizations that make a pose an optimization variable."""

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


# Rotation parameterizations for pose optimization: the pose becomes a
# flat vector the fit steps on; each helper is differentiable by autograd.

def _hat(w: torch.Tensor) -> torch.Tensor:
    """[3] -> the skew matrix [w]_x, built by stacking (differentiable)."""
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (Rodrigues) -> rotation matrix; safe at ||w|| -> 0."""
    theta = torch.linalg.norm(w)
    theta2 = theta * theta
    small = theta < 1e-6
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    wx = _hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * wx + b * (wx @ wx)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle (principal branch). Handles both the
    theta -> 0 and theta -> pi singularities (near pi the vee formula
    loses its precision; the axis then comes from the symmetric part)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    cos = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    vee = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin = torch.sin(theta)
    scale = torch.where(theta < 1e-6, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.where(sin == 0, torch.ones_like(sin), sin)))
    w_gen = scale * vee
    # near pi: R + R^T = 2 cos I + 2 (1 - cos) n n^T, so the columns of
    # B = (R + R^T)/2 - cos I are (1 - cos) n_i n; take the largest
    B = 0.5 * (R + R.T) - cos * eye
    k = torch.argmax(torch.sum(B * B, dim=0))
    axis = B[:, k]
    axis = axis / torch.clamp(torch.linalg.norm(axis), min=1e-12)
    # sign: align with vee (~ 2 sin(theta) n while theta < pi)
    sign = torch.where(torch.dot(axis, vee) < 0.0, -1.0, 1.0)
    w_pi = theta * axis * sign
    return torch.where(cos < -0.9, w_pi, w_gen)


def rot6d_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation parameterization (Zhou et al., CVPR 2019):
    two 3-vectors -> a Gram-Schmidt orthonormal frame (rows)."""
    a1, a2 = x[..., :3], x[..., 3:6]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    return torch.cat([R[..., 0, :], R[..., 1, :]], dim=-1)


def camera_from_pose(pose: torch.Tensor, K: torch.Tensor,
                     param: str = "so3") -> Camera:
    """A Camera from a flat pose vector (the pose-optimization variable).
    param="so3": pose = [w(3), T(3)]; param="rot6d": pose = [r6(6), T(3)]."""
    if param == "so3":
        R, T = so3_exp(pose[:3]), pose[3:6]
    elif param == "rot6d":
        R, T = rot6d_to_matrix(pose[:6]), pose[6:9]
    else:
        raise ValueError(f"unknown pose parameterization: {param}")
    return Camera(K=K, R=R, T=T)


def pose_from_camera(camera: Camera, param: str = "so3") -> torch.Tensor:
    if param == "so3":
        return torch.cat([so3_log(camera.R), camera.T])
    if param == "rot6d":
        return torch.cat([matrix_to_rot6d(camera.R), camera.T])
    raise ValueError(f"unknown pose parameterization: {param}")


def project(camera: Camera, points: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points [..., 3] -> pixel coordinates (u, v) [..., 2] and the
    camera-frame depth z [...]."""
    pc = points @ camera.R.T + camera.T
    z = pc[..., 2]
    uvw = pc @ camera.K.T
    uv = uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=1e-8)
    return uv, z
