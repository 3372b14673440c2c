"""Inverse-rendering losses: masked L1/L2 depth, DIST's min-SDF
silhouette loss, the latent prior, and the multi-view photometric
consistency loss through depth-based cross-view warping.

Counterpart of the JAX package's ``utils/losses.py``: plain functions of
tensors -> scalar, differentiable by autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from dist_renderer_tpu_torch.ops.camera import Camera, project


def masked_l1(pred: torch.Tensor, target, mask: torch.Tensor) -> torch.Tensor:
    """Mean L1 over valid pixels; safe when the mask is empty."""
    m = mask.to(pred.dtype)
    denom = torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(torch.abs(pred - target) * m) / denom


def masked_l2(pred: torch.Tensor, target, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(pred.dtype)
    denom = torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(((pred - target) ** 2) * m) / denom


def depth_loss(pred_depth: torch.Tensor, obs_depth: torch.Tensor,
               obs_valid: torch.Tensor,
               pred_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-L1 depth loss over pixels both observed and rendered."""
    valid = obs_valid if pred_mask is None else (obs_valid & pred_mask)
    return masked_l1(pred_depth, obs_depth, valid)


def silhouette_loss(min_sdf: torch.Tensor, obs_mask: torch.Tensor,
                    margin: float = 0.0) -> torch.Tensor:
    """DIST's min-SDF silhouette loss: inside the observed mask the ray
    should reach the surface (penalize min_sdf > 0); outside, the shape
    must clear the ray (penalize min_sdf < margin)."""
    inside = obs_mask.to(min_sdf.dtype)
    outside = 1.0 - inside
    loss_in = torch.clamp(min_sdf, min=0.0) * inside
    loss_out = torch.clamp(margin - min_sdf, min=0.0) * outside
    return torch.mean(loss_in + loss_out)


def latent_reg(latent: torch.Tensor) -> torch.Tensor:
    """DeepSDF latent prior ||z||^2."""
    return torch.sum(latent ** 2)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Differentiable bilinear sampling. img [H, W, C]; uv [N, 2] in pixel
    coordinates (u = x, v = y); out-of-bounds clamps to the border."""
    h, w = img.shape[0], img.shape[1]
    u = torch.clamp(uv[:, 0], 0.0, w - 1.001)
    v = torch.clamp(uv[:, 1], 0.0, h - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    u1, v1 = u0 + 1, v0 + 1
    fu = (u - u0.to(u.dtype))[:, None]
    fv = (v - v0.to(v.dtype))[:, None]
    return (img[v0, u0] * (1 - fu) * (1 - fv) + img[v0, u1] * fu * (1 - fv)
            + img[v1, u0] * (1 - fu) * fv + img[v1, u1] * fu * fv)


def photometric_loss(surface_points: torch.Tensor, hit_mask: torch.Tensor,
                     img_i: torch.Tensor, cam_i: Camera,
                     img_j: torch.Tensor, cam_j: Camera) -> torch.Tensor:
    """Multi-view photometric consistency: surface points [N, 3] recovered
    from view i are projected into views i and j ([H, W, C] images) and
    the sampled colors must agree, on view-i hits in front of camera j and
    inside its image. Gradients reach the geometry through the points."""
    uv_i, _ = project(cam_i, surface_points)
    uv_j, z_j = project(cam_j, surface_points)
    ci = bilinear_sample(img_i, uv_i)
    cj = bilinear_sample(img_j, uv_j)
    h, w = img_j.shape[0], img_j.shape[1]
    in_j = ((uv_j[:, 0] >= 0) & (uv_j[:, 0] <= w - 1)
            & (uv_j[:, 1] >= 0) & (uv_j[:, 1] <= h - 1) & (z_j > 0))
    m = (hit_mask & in_j).to(ci.dtype)[:, None]
    denom = torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(torch.abs(ci - cj) * m) / denom


def normal_loss(pred_normal: torch.Tensor, obs_normal: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity over valid pixels."""
    cos = torch.sum(pred_normal * obs_normal, dim=-1)
    m = mask.to(cos.dtype)
    denom = torch.clamp(torch.sum(m), min=1.0)
    return torch.sum((1.0 - cos) * m) / denom
