"""Color decoder: c_phi(z_tex, x) -> RGB at surface points.

Counterpart of the JAX package's ``models/color_decoder.py``: the DeepSDF
trunk (same layer-dim rules, so weights carry across with
``params_from_numpy``) with a 3-channel sigmoid output.
"""

from __future__ import annotations

import numpy as np
import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import Params, round_bf16


def make_color_config(latent_size: int = 256, hidden_dims=(512,) * 8,
                      latent_in=(4,)) -> DecoderConfig:
    """Color decoder config: the SDF trunk, a 3-channel sigmoid output."""
    return DecoderConfig(latent_size=latent_size,
                         hidden_dims=tuple(hidden_dims),
                         latent_in=tuple(latent_in), final_tanh=False)


def color_layer_dims(cfg: DecoderConfig):
    dims = list(cfg.layer_dims)
    d_in, _ = dims[-1]
    dims[-1] = (d_in, 3)
    return tuple(dims)


def init_color_params(generator: torch.Generator, cfg: DecoderConfig,
                      device="cpu", dtype: torch.dtype = torch.float32) -> Params:
    """He-style init from a seeded torch.Generator, weights and biases in
    ``dtype``. Its numbers differ from the JAX package's for the same
    seed; weights made there carry across with params_from_numpy."""
    layers = []
    for d_in, d_out in color_layer_dims(cfg):
        w = torch.randn((d_in, d_out), generator=generator, dtype=dtype) * float(
            np.sqrt(2.0 / d_in))
        layers.append({"w": w.to(device),
                       "b": torch.zeros(d_out, dtype=dtype, device=device)})
    return {"layers": layers}


def color_apply(params: Params, latent: torch.Tensor, points: torch.Tensor,
                cfg: DecoderConfig, compute_dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """[..., 3] points -> [..., 3] RGB in [0, 1], fp32. With bf16 compute
    every product takes bf16-rounded operands with fp32 sums, and the
    bias add stays fp32 (the JAX package's ``_matmul``)."""
    cast = round_bf16 if compute_dtype == torch.bfloat16 else (lambda a: a)
    shape = points.shape[:-1]
    x = points.reshape(-1, 3).to(torch.float32)
    z = latent.reshape(1, -1).to(torch.float32).expand(x.shape[0], -1)
    inp = torch.cat([z, x], dim=-1)
    h = inp
    n_layers = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        if i in cfg.latent_in:
            h = torch.cat([h, inp], dim=-1)
        w, b = (layer[k].to(torch.float32) for k in ("w", "b"))
        h = cast(h) @ cast(w) + b
        if i < n_layers - 1:
            h = torch.relu(h)
    return torch.sigmoid(h).reshape(shape + (3,))
