"""Fit a DeepSDF decoder to an analytic SDF, and the ``w{i}``/``b{i}``/
``latent`` npz layout its weights are kept in.

Counterpart of the JAX package's ``models/pretrain.py``: DeepSDF-style
training (Park et al. CVPR 2019), an L1 loss on clamped SDF targets at
points drawn uniformly in the bounding cube and near the surface. The
JAX package runs the whole loop as one compiled ``lax.scan``; here it is
a Python loop of the same steps. Random draws come from a
``torch.Generator`` (its numbers differ from ``jax.random``'s for the
same seed) on its own device, and move to the training device.
"""

from __future__ import annotations

import os
import warnings
import zipfile
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import (
    Params, decoder_apply, init_decoder_params, numpy_f32, params_from_numpy,
    set_fp32_matmul,
)

SdfFn = Callable[[torch.Tensor], torch.Tensor]


def resolve_device(device) -> torch.device:
    """``device``, or the CUDA card when None (raising without one)."""
    from dist_renderer_tpu_torch.eval.mesh import default_device

    return torch.device(device) if device is not None else default_device()


def uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    """Uniform draws in [lo, hi) from ``gen`` on its device, moved to
    ``device``."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return (lo + (hi - lo) * u).to(device)


def normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def project_to_surface(sdf_fn: SdfFn, p: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Move points onto sdf_fn's zero set: ``iters`` steps of p -= s(p) *
    grad s(p) / |grad s(p)| (the gradient norm floored at 1e-8)."""
    p = p.detach()
    for _ in range(iters):
        with torch.enable_grad():
            q = p.requires_grad_(True)
            s = sdf_fn(q)
            (g,) = torch.autograd.grad(s.sum(), q)
        g = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-8)
        p = (q - s[:, None] * g).detach()
    return p


def sample_training_points(gen: torch.Generator, sdf_fn: SdfFn, n: int,
                           surface_frac: float = 0.5, noise: float = 0.02,
                           device="cpu") -> torch.Tensor:
    """[n, 3] training points: uniform in [-1, 1]^3, and near the surface
    (uniform in [-0.8, 0.8]^3 projected by ``project_to_surface``, then
    jittered by ``noise`` N(0, 1))."""
    n_surf = int(n * surface_frac)
    unif = uniform(gen, (n - n_surf, 3), -1.0, 1.0, device)
    p = project_to_surface(sdf_fn, uniform(gen, (n_surf, 3), -0.8, 0.8, device))
    p = p + noise * normal(gen, p.shape, device)
    return torch.cat([unif, p], dim=0)


def clamped_l1(pred: torch.Tensor, target: torch.Tensor, clamp: float) -> torch.Tensor:
    """mean |pred - clamp(target)|: DeepSDF's truncation on the target
    only (clamping the prediction too would zero the gradient wherever a
    saturated-tanh init reads beyond the clamp)."""
    return torch.mean(torch.abs(pred - torch.clamp(target, -clamp, clamp)))


def fit_decoder_to_sdf(target_sdf: SdfFn, dcfg: DecoderConfig = DecoderConfig(),
                       latent: Optional[torch.Tensor] = None, steps: int = 2000,
                       batch: int = 8192, lr: float = 5e-4,
                       gen: Optional[torch.Generator] = None, clamp: float = 0.1,
                       device=None, losses: Optional[list] = None
                       ) -> Tuple[Params, torch.Tensor]:
    """Train decoder weights so f(z0, x) ~= clamp(target_sdf(x)); returns
    (params, z0) on ``device`` (default: the CUDA card; without one it
    raises unless given device="cpu").

    z0 is ``latent`` or 0.1 N(0, 1). Each step draws ``batch`` points
    (``sample_training_points``) and takes one Adam step on the clamped L1
    of the bf16-compute decoder (``decoder_apply(..., torch.bfloat16)``:
    bf16 operands, fp32 sums). ``gen`` (default: seed 0 on ``device``)
    makes every draw. ``losses``, when given, receives each step's loss
    as a 0-d tensor (no host wait)."""
    set_fp32_matmul()
    device = resolve_device(device)
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    params = init_decoder_params(gen, dcfg, device)
    z0 = (latent.to(device) if latent is not None
          else 0.1 * normal(gen, (dcfg.latent_size,), device))
    leaves = [t.requires_grad_(True) for l in params["layers"] for t in (l["w"], l["b"])]
    opt = torch.optim.Adam(leaves, lr=lr)
    for _ in range(steps):
        pts = sample_training_points(gen, target_sdf, batch, device=device)
        with torch.no_grad():
            tgt = target_sdf(pts)
        loss = clamped_l1(decoder_apply(params, z0, pts, dcfg, torch.bfloat16),
                          tgt, clamp)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if losses is not None:
            losses.append(loss.detach())
    for t in leaves:
        t.requires_grad_(False)
    return params, z0


def save_params_npz(path: str, params: Params, latent: torch.Tensor) -> None:
    """Write the ``w{i}``/``b{i}``/``latent`` npz layout (float32)."""
    flat = {}
    for i, layer in enumerate(params["layers"]):
        flat[f"w{i}"] = numpy_f32(layer["w"])
        flat[f"b{i}"] = numpy_f32(layer["b"])
    flat["latent"] = numpy_f32(latent)
    np.savez(path, **flat)


def load_params_npz(path: str, device="cpu") -> Tuple[Params, torch.Tensor]:
    """-> (params, latent [L]) as fp32 tensors on ``device``."""
    with np.load(path) as data:
        layers = []
        i = 0
        while f"w{i}" in data:
            layers.append({"w": data[f"w{i}"], "b": data[f"b{i}"]})
            i += 1
        latent = np.asarray(data["latent"], np.float32)
    return (params_from_numpy({"layers": layers}, device),
            torch.as_tensor(latent, device=device))


def get_or_fit_cached(cache_path: str, target_sdf: SdfFn,
                      dcfg: DecoderConfig = DecoderConfig(), steps: int = 2000,
                      device=None, **kw) -> Tuple[Params, torch.Tensor]:
    """Load a fitted decoder from ``cache_path``, or fit one and write it
    there (a cache that cannot be read is refitted; one that cannot be
    written is warned about)."""
    device = resolve_device(device)
    if os.path.exists(cache_path):
        try:
            return load_params_npz(cache_path, device)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
            warnings.warn(f"decoder cache {cache_path} unreadable ({e!r}); refitting")
    params, z0 = fit_decoder_to_sdf(target_sdf, dcfg, steps=steps, device=device, **kw)
    try:
        save_params_npz(cache_path, params, z0)
    except OSError as e:
        warnings.warn(f"could not write decoder cache {cache_path}: {e!r}")
    return params, z0
