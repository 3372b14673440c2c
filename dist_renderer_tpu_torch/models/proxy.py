"""Distilled proxy decoder: a small latent-conditioned MLP that stands in
for the full DeepSDF decoder in the non-differentiable march. A verify
stage re-marches the full decoder from proxy-derived seeds
(ops/kernels/batched_march.py::render_batched_c2f), so depth and the hit
mask stay full-decoder results.

This module reads the JAX package's proxy files (weights plus the measured
near-surface error quantiles) and derives the verify-stage margins from
them. Distillation itself is not ported yet (ROADMAP A8).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import Params, params_from_numpy


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
