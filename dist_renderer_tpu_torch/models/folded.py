"""Latent-folded decoder fast path.

During a march the latent z is constant across all points and steps, so
its contribution to every layer that sees it (layer 0 and each skip-concat
layer) is a fixed vector: fold z @ W_z into the bias once per frame, and
the per-point work drops to x @ W_x (3 columns) plus the hidden chain:

    h' = h @ Wh + x @ Wx + (b + z @ Wz)

The fold is an fp32 product (TF32 off), the counterpart of the JAX
package's fold.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import Params, round_bf16


class FoldedLayer(NamedTuple):
    wh: Optional[torch.Tensor]   # [Dh, out] hidden-input weights (None for layer 0)
    wx: Optional[torch.Tensor]   # [3, out] xyz weights (None if layer sees no x)
    b: torch.Tensor              # [out] bias with the z-contribution folded in


def fold_latent(params: Params, latent: torch.Tensor,
                cfg: DecoderConfig = DecoderConfig()) -> List[FoldedLayer]:
    """Fold the latent [L] into per-layer biases."""
    L = cfg.latent_size
    layers = []
    n_layers = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        w, b = layer["w"], layer["b"]
        if i == 0:
            wz, wx = w[:L], w[L:L + 3]
            layers.append(FoldedLayer(wh=None, wx=wx, b=b + latent @ wz))
        elif i in cfg.latent_in:
            dh = w.shape[0] - L - 3
            wh, wz, wx = w[:dh], w[dh:dh + L], w[dh + L:]
            layers.append(FoldedLayer(wh=wh, wx=wx, b=b + latent @ wz))
        elif cfg.xyz_in_all and i < n_layers - 1:
            dh = w.shape[0] - 3
            layers.append(FoldedLayer(wh=w[:dh], wx=w[dh:], b=b))
        else:
            layers.append(FoldedLayer(wh=w, wx=None, b=b))
    return layers


def folded_apply(folded: List[FoldedLayer], points: torch.Tensor,
                 cfg: DecoderConfig = DecoderConfig(),
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Evaluate the folded decoder at points [..., 3] -> sdf [...]. With
    bf16 compute the hidden products take bf16-rounded inputs (fp32
    accumulation); the 3-wide x product stays fp32."""
    shape = points.shape[:-1]
    x = points.reshape(-1, 3).to(torch.float32)
    cast = round_bf16 if compute_dtype == torch.bfloat16 else (lambda a: a)
    h = None
    n_layers = len(folded)
    for i, layer in enumerate(folded):
        acc = torch.zeros((x.shape[0], layer.b.shape[0]), dtype=torch.float32,
                          device=x.device)
        if layer.wh is not None:
            acc = acc + cast(h) @ cast(layer.wh)
        if layer.wx is not None:
            acc = acc + x @ layer.wx
        h = acc + layer.b
        if i == n_layers - 1:
            if cfg.use_tanh:
                h = torch.tanh(h)
        else:
            h = torch.relu(h)
    sdf = h[..., 0]
    if cfg.final_tanh:
        sdf = torch.tanh(sdf)
    return sdf.reshape(shape)


def make_point_fn(params: Params, latent: torch.Tensor,
                  cfg: DecoderConfig = DecoderConfig(),
                  compute_dtype: torch.dtype = torch.float32):
    """Bind (params, latent) -> point function for the tracer hot loop."""
    folded = fold_latent(params, latent, cfg)
    return lambda p: folded_apply(folded, p, cfg, compute_dtype)
