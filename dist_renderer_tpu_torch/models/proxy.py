"""Distilled proxy decoder: a small latent-conditioned MLP that stands in
for the full DeepSDF decoder in the non-differentiable march. A verify
stage re-marches the full decoder from proxy-derived seeds
(ops/kernels/batched_march.py::render_batched_c2f), so depth and the hit
mask stay full-decoder results.

Counterpart of the JAX package's ``models/proxy.py``: distillation (a
Python loop of the JAX package's scanned steps, draws from a
``torch.Generator``), the near-surface error report, the proxy files
(weights plus the measured error quantiles, one layout for both
packages) and the verify-stage margins derived from them. The full
decoder's targets are its fp32 value, where the JAX package takes its
bf16x3 split (a TPU workaround).
"""

from __future__ import annotations

import os
import warnings
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import (
    Params, decoder_apply, init_decoder_params, numpy_f32, params_from_numpy,
    set_fp32_matmul,
)
from dist_renderer_tpu_torch.models.pretrain import normal, project_to_surface, uniform


def default_proxy_cfg(dcfg: DecoderConfig, width: int = 256,
                      depth: int = 4) -> DecoderConfig:
    """Proxy architecture: the full decoder's latent size and output
    activations, a narrow straight trunk with no skip concat."""
    return DecoderConfig(
        latent_size=dcfg.latent_size,
        hidden_dims=(width,) * depth,
        latent_in=(),
        xyz_in_all=False,
        use_tanh=dcfg.use_tanh,
        final_tanh=dcfg.final_tanh,
        clamp_dist=dcfg.clamp_dist,
    )


def _sample_batch(gen: torch.Generator, full_fn, z: torch.Tensor, batch: int,
                  surface_frac: float, noise_scales: Tuple[float, ...],
                  device) -> torch.Tensor:
    """Training points for one latent: uniform in the radius-1.1 ball
    (rays march slightly past the unit sphere), and near the full
    decoder's zero set (uniform in [-0.9, 0.9]^3, five projection steps,
    then jittered at a scale drawn from ``noise_scales``)."""
    n_surf = int(batch * surface_frac)
    n_unif = batch - n_surf
    u = normal(gen, (n_unif, 3), device)
    u = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-9)
    unif = u * (1.1 * uniform(gen, (n_unif, 1), 0.0, 1.0, device) ** (1.0 / 3.0))
    p = project_to_surface(lambda q: full_fn(z, q),
                           uniform(gen, (n_surf, 3), -0.9, 0.9, device), iters=5)
    scales = torch.tensor(noise_scales, dtype=torch.float32, device=device)
    pick = torch.randint(0, len(noise_scales), (n_surf, 1), generator=gen,
                         device=gen.device).to(device)
    p = p + scales[pick] * normal(gen, p.shape, device)
    return torch.cat([unif, p], dim=0)


def _full_fn(params: Params, dcfg: DecoderConfig):
    return lambda z, p: decoder_apply(params, z, p, dcfg)


def distill_proxy(params: Params, dcfg: DecoderConfig, latents: torch.Tensor,
                  proxy_cfg: Optional[DecoderConfig] = None, steps: int = 4000,
                  batch: int = 8192, lr: float = 1e-3,
                  gen: Optional[torch.Generator] = None,
                  latent_jitter: float = 0.0, surface_frac: float = 0.75,
                  noise_scales: Tuple[float, ...] = (0.05, 0.01, 2e-3),
                  near_weight: float = 3.0, near_band: float = 0.02,
                  losses: Optional[list] = None) -> Tuple[Params, DecoderConfig]:
    """Train a small proxy decoder to mimic the full one, on the device
    the full decoder's params live on.

    Each step draws one latent of the bank ``latents`` [K, L] (plus
    ``latent_jitter`` N(0, 1), so per-frame latent jitter downstream stays
    in support), ``batch`` points (``_sample_batch``), and takes one Adam
    step on the L1 between the bf16-compute proxy and the full decoder's
    fp32 value, weighted 1 + ``near_weight`` where |target| <
    ``near_band`` (where the march's convergence and hit classification
    read the field). The lr decays on a cosine to 0.01 lr over ``steps``
    (optax's ``cosine_decay_schedule(lr, steps, alpha=0.01)``). ``gen``
    (default: seed 7 on that device) makes every draw; ``losses``, when
    given, receives each step's loss as a 0-d tensor."""
    set_fp32_matmul()
    pcfg = proxy_cfg or default_proxy_cfg(dcfg)
    if pcfg.latent_size != dcfg.latent_size:
        raise ValueError("the proxy must share the full decoder's latent space")
    device = params["layers"][0]["w"].device
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(7)
    proxy = init_decoder_params(gen, pcfg, device)
    lat_bank = torch.atleast_2d(latents).to(device)
    full_fn = _full_fn(params, dcfg)
    leaves = [t.requires_grad_(True) for l in proxy["layers"] for t in (l["w"], l["b"])]
    opt = torch.optim.Adam(leaves, lr=lr)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps,
                                                       eta_min=0.01 * lr)
    for _ in range(steps):
        pick = torch.randint(0, lat_bank.shape[0], (1,), generator=gen,
                             device=gen.device).to(device)
        z = lat_bank[pick][0]
        if latent_jitter > 0.0:
            z = z + latent_jitter * normal(gen, z.shape, device)
        pts = _sample_batch(gen, full_fn, z, batch, surface_frac, noise_scales, device)
        with torch.no_grad():
            tgt = full_fn(z, pts)
        pred = decoder_apply(proxy, z, pts, pcfg, torch.bfloat16)
        w = 1.0 + near_weight * (tgt.abs() < near_band).float()
        loss = torch.sum(w * torch.abs(pred - tgt)) / torch.sum(w)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if losses is not None:
            losses.append(loss.detach())
    for t in leaves:
        t.requires_grad_(False)
    return proxy, pcfg


def proxy_error_report(params: Params, dcfg: DecoderConfig, proxy: Params,
                       pcfg: DecoderConfig, latents: torch.Tensor,
                       gen: Optional[torch.Generator] = None, n: int = 16384,
                       band: float = 0.02) -> Dict[str, float]:
    """Quantiles of |proxy - full| over near-surface points of every
    latent of the bank (``n`` each, jittered at ``band`` and ``band / 4``,
    kept where |full| < band): the number that predicts the march's
    fidelity. ``gen`` defaults to seed 3 on the decoder's device."""
    set_fp32_matmul()
    device = params["layers"][0]["w"].device
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(3)
    full_fn = _full_fn(params, dcfg)
    errs = []
    for z in torch.atleast_2d(latents).to(device):
        pts = _sample_batch(gen, full_fn, z, n, 1.0, (band, band / 4), device)
        with torch.no_grad():
            tgt = full_fn(z, pts)
            pred = decoder_apply(proxy, z, pts, pcfg, torch.bfloat16)
        errs.append((pred - tgt).abs()[tgt.abs() < band].cpu().numpy())
    e = np.concatenate(errs)
    return {"p50": float(np.percentile(e, 50)), "p95": float(np.percentile(e, 95)),
            "p99": float(np.percentile(e, 99)), "max": float(e.max()),
            "n": int(e.size)}


def save_proxy_npz(path: str, proxy: Params, pcfg: DecoderConfig,
                   err_report: Optional[Dict[str, float]] = None) -> None:
    """The JAX package's proxy file: w{i}/b{i}, the architecture, and the
    measured error quantiles (p50, p95, p99, max) when given; the
    verify-stage margins are a property of this proxy's error."""
    flat = {}
    for i, layer in enumerate(proxy["layers"]):
        flat[f"w{i}"] = numpy_f32(layer["w"])
        flat[f"b{i}"] = numpy_f32(layer["b"])
    flat["hidden_dims"] = np.asarray(pcfg.hidden_dims, np.int64)
    flat["latent_size"] = np.asarray(pcfg.latent_size, np.int64)
    flat["latent_in"] = np.asarray(pcfg.latent_in, np.int64)
    flat["flags"] = np.asarray([pcfg.use_tanh, pcfg.final_tanh, pcfg.xyz_in_all],
                               np.int64)
    if err_report is not None:
        flat["err_quantiles"] = np.asarray(
            [err_report["p50"], err_report["p95"], err_report["p99"],
             err_report["max"]], np.float64)
    np.savez(path, **flat)


def load_proxy_meta(path: str) -> Optional[Dict[str, float]]:
    """Error-report quantiles stored with the weights (None when the file
    carries none)."""
    with np.load(path) as data:
        if "err_quantiles" not in data:
            return None
        q = data["err_quantiles"]
        return {"p50": float(q[0]), "p95": float(q[1]), "p99": float(q[2]),
                "max": float(q[3])}


def proxy_march_margins(err_report: Dict[str, float],
                        convergence_eps: float) -> Tuple[float, float]:
    """(proxy_backoff, proxy_band) for a proxy with this measured error:
    backoff ~ p99 of the error (never below 2x eps, so a demoted false hit
    re-samples the field dip behind its claimed depth); band ~ error max +
    2.5x eps (a proxy miss can only be a real hit where the proxy read less
    than its own worst error plus the convergence ball)."""
    backoff = max(float(err_report["p99"]), 2.0 * convergence_eps)
    band = float(err_report["max"]) + 2.5 * convergence_eps
    return backoff, band


def load_proxy_npz(path: str, device="cpu") -> Tuple[Params, DecoderConfig]:
    with np.load(path) as data:
        layers = []
        i = 0
        while f"w{i}" in data:
            layers.append({"w": data[f"w{i}"], "b": data[f"b{i}"]})
            i += 1
        flags = data["flags"]
        pcfg = DecoderConfig(
            latent_size=int(data["latent_size"]),
            hidden_dims=tuple(int(d) for d in data["hidden_dims"]),
            latent_in=tuple(int(d) for d in data["latent_in"]),
            use_tanh=bool(flags[0]),
            final_tanh=bool(flags[1]),
            xyz_in_all=bool(flags[2]),
        )
    return params_from_numpy({"layers": layers}, device), pcfg


def get_or_distill_cached(cache_path: str, params: Params, dcfg: DecoderConfig,
                          latents: torch.Tensor, **kw) -> Tuple[Params, DecoderConfig]:
    """Load a distilled proxy from ``cache_path`` (onto the full decoder's
    device), or distill one, measure its error and write both there."""
    device = params["layers"][0]["w"].device
    if os.path.exists(cache_path):
        try:
            return load_proxy_npz(cache_path, device)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
            warnings.warn(f"proxy cache {cache_path} unreadable ({e!r}); re-distilling")
    proxy, pcfg = distill_proxy(params, dcfg, latents, **kw)
    rep = proxy_error_report(params, dcfg, proxy, pcfg, latents)
    try:
        save_proxy_npz(cache_path, proxy, pcfg, err_report=rep)
    except OSError as e:
        warnings.warn(f"could not write proxy cache {cache_path}: {e!r}")
    return proxy, pcfg
