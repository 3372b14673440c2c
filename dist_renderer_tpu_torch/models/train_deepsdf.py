"""Multi-shape DeepSDF training: the decoder's weights and a per-shape
latent table optimized together (Park et al. CVPR 2019, the auto-decoder)

    L = mean_s |clamp(f(z_s, x)) - clamp(sdf_s(x))| + latent_reg ||z_s||^2

from analytic SDF oracles or from point / SDF sample arrays (DeepSDF's
SdfSamples npz, pos / neg rows of x, y, z, sdf).

Counterpart of the JAX package's ``models/train_deepsdf.py``. Its
``optax.multi_transform`` is one ``torch.optim.Adam`` with two parameter
groups (the decoder at ``lr``, the latent table at ``latent_lr``); its
scanned loop is a Python loop of the same steps, its ``lax.switch`` over
the oracles a loop over the batch's shapes (``analytic_batch``). Draws
come from a ``torch.Generator`` on its own device and move to the
training device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import (
    Params, decoder_apply, init_decoder_params, set_fp32_matmul,
)
from dist_renderer_tpu_torch.models.pretrain import (
    normal, resolve_device, sample_training_points,
)

ShapeFn = Callable[[torch.Tensor], torch.Tensor]


def auto_decoder_loss(params: Params, latents: torch.Tensor, shape_idx: torch.Tensor,
                      pts: torch.Tensor, tgt: torch.Tensor, dcfg: DecoderConfig,
                      latent_reg: float, clamp: float,
                      clamp_pred: bool) -> torch.Tensor:
    """The batch's loss: for each of its B shapes (``shape_idx`` [B] into
    the latent table), the mean over its P points (``pts`` [B, P, 3],
    targets ``tgt`` [B, P]) of |pred - clamp(tgt)|, the prediction
    clamped too when ``clamp_pred``, plus latent_reg ||z||^2; averaged
    over the shapes. The decoder runs in bf16 compute (bf16 operands,
    fp32 sums) over all B * P points at once."""
    b, p = tgt.shape
    z = latents[shape_idx]                                   # [B, L]
    pred = decoder_apply(params, z.repeat_interleave(p, dim=0), pts.reshape(-1, 3),
                         dcfg, torch.bfloat16).reshape(b, p)
    if clamp_pred:
        pred = torch.clamp(pred, -clamp, clamp)
    per = torch.abs(pred - torch.clamp(tgt, -clamp, clamp)).mean(dim=1)
    return torch.mean(per + latent_reg * torch.sum(z * z, dim=1))


def make_optimizer(params: Params, latents: torch.Tensor, lr: float,
                   latent_lr: float) -> torch.optim.Adam:
    """One Adam, two parameter groups: the decoder's layers at ``lr``,
    the latent table at ``latent_lr``."""
    leaves = [t for l in params["layers"] for t in (l["w"], l["b"])]
    return torch.optim.Adam([{"params": leaves, "lr": lr},
                             {"params": [latents], "lr": latent_lr}])


def _init(gen: torch.Generator, dcfg: DecoderConfig, n_shapes: int, device):
    params = init_decoder_params(gen, dcfg, device)
    latents = 0.01 * normal(gen, (n_shapes, dcfg.latent_size), device)
    for l in params["layers"]:
        l["w"].requires_grad_(True)
        l["b"].requires_grad_(True)
    return params, latents.requires_grad_(True)


def _train(loss_of_step, params: Params, latents: torch.Tensor, steps: int, lr: float,
           latent_lr: float) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    opt = make_optimizer(params, latents, lr, latent_lr)
    losses: List[torch.Tensor] = []
    for _ in range(steps):
        loss = loss_of_step()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    for l in params["layers"]:
        l["w"].requires_grad_(False)
        l["b"].requires_grad_(False)
    history = torch.stack(losses) if losses else torch.zeros((0,))
    return params, latents.detach(), history


def analytic_batch(gen: torch.Generator, shape_fns: Sequence[ShapeFn],
                   batch_shapes: int, points_per_shape: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step's draw: ``batch_shapes`` shape indices (with replacement)
    and, for each, ``points_per_shape`` training points on its oracle
    (``sample_training_points``) with their targets. Returns (idx [B],
    points [B, P, 3], targets [B, P]). The indices go to the host to pick
    the oracles: one wait a step, on a device the sampling's small
    launches leave idle most of the time (PERF.md §5)."""
    idx = torch.randint(0, len(shape_fns), (batch_shapes,), generator=gen,
                        device=gen.device)
    pts, tgt = [], []
    for i in idx.tolist():
        p = sample_training_points(gen, shape_fns[i], points_per_shape, device=device)
        with torch.no_grad():
            tgt.append(shape_fns[i](p))
        pts.append(p)
    return idx.to(device), torch.stack(pts), torch.stack(tgt)


def train_deepsdf_analytic(shape_fns: Sequence[ShapeFn],
                           dcfg: DecoderConfig = DecoderConfig(), steps: int = 3000,
                           batch_shapes: int = 4, points_per_shape: int = 4096,
                           lr: float = 5e-4, latent_lr: float = 1e-3,
                           latent_reg: float = 1e-4, clamp: float = 0.1,
                           gen: Optional[torch.Generator] = None, device=None
                           ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """Train the decoder and a latent table against analytic SDF oracles
    ``shape_fns`` (points [..., 3] -> sdf). Each step draws
    ``batch_shapes`` shapes (with replacement) and, for each,
    ``points_per_shape`` points (``sample_training_points`` on its
    oracle). Returns (params, latents [S, L], losses [steps]) on
    ``device`` (default: the CUDA card; without one it raises unless
    given device="cpu"); ``gen`` defaults to seed 0 there."""
    set_fp32_matmul()
    device = resolve_device(device)
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    n_shapes = len(shape_fns)
    batch_shapes = min(batch_shapes, n_shapes)
    params, latents = _init(gen, dcfg, n_shapes, device)

    def step_loss():
        idx, pts, tgt = analytic_batch(gen, shape_fns, batch_shapes, points_per_shape,
                                       device)
        return auto_decoder_loss(params, latents, idx, pts, tgt, dcfg, latent_reg,
                                 clamp, clamp_pred=False)

    return _train(step_loss, params, latents, steps, lr, latent_lr)


def sample_bank(samples: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-shape [N_s, 4] sample arrays -> (bank [S, max N_s, 4] padded
    with zeros, counts [S])."""
    n_max = max(s.shape[0] for s in samples)
    bank = np.zeros((len(samples), n_max, 4), np.float32)
    counts = np.zeros((len(samples),), np.int64)
    for i, s in enumerate(samples):
        bank[i, : s.shape[0]] = s
        counts[i] = s.shape[0]
    return bank, counts


def train_deepsdf_samples(samples: Sequence[np.ndarray],
                          dcfg: DecoderConfig = DecoderConfig(), steps: int = 3000,
                          batch_shapes: int = 4, points_per_shape: int = 4096,
                          lr: float = 5e-4, latent_lr: float = 1e-3,
                          latent_reg: float = 1e-4, clamp: float = 0.1,
                          gen: Optional[torch.Generator] = None, device=None
                          ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """Train from precomputed SDF samples, one [N, 4] array (x, y, z,
    sdf) per shape, padded into one bank (``sample_bank``). Each step
    draws ``batch_shapes`` shapes and, for each, ``points_per_shape`` rows
    as randint(0, 2^30) % count; the prediction is clamped as the target
    is. Returns (params, latents [S, L], losses [steps])."""
    set_fp32_matmul()
    device = resolve_device(device)
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    bank_np, counts_np = sample_bank(samples)
    bank = torch.tensor(bank_np, device=device)
    counts = torch.tensor(counts_np, device=device)
    n_shapes = len(samples)
    batch_shapes = min(batch_shapes, n_shapes)
    params, latents = _init(gen, dcfg, n_shapes, device)

    def step_loss():
        idx = torch.randint(0, n_shapes, (batch_shapes,), generator=gen,
                            device=gen.device).to(device)
        draw = torch.randint(0, 1 << 30, (batch_shapes, points_per_shape),
                             generator=gen, device=gen.device).to(device)
        rows = bank[idx[:, None], draw % counts[idx][:, None]]   # [B, P, 4]
        return auto_decoder_loss(params, latents, idx, rows[..., :3], rows[..., 3],
                                 dcfg, latent_reg, clamp, clamp_pred=True)

    return _train(step_loss, params, latents, steps, lr, latent_lr)
