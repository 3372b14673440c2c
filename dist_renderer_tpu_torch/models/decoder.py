"""DeepSDF latent-conditioned MLP decoder on plain torch tensors.

Params keep the JAX package's layout, ``{"layers": [{"w": [in, out],
"b": [out]}, ...]}``, so weights carry across with ``params_from_numpy``.

Precision: the JAX package's precise value path uses a bf16x3 split
(``_matmul_split``) because fp32 products were not available on its TPU
compile service. Its counterpart here is a plain fp32 product with TF32
switched off (``torch.backends.*.allow_tf32 = False``, set by
``decoder_apply``'s callers through ``set_fp32_matmul``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dist_renderer_tpu_torch.config import DecoderConfig

Params = Dict[str, Any]


def set_fp32_matmul() -> None:
    """Make float32 products full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def params_from_numpy(params_np: Params, device="cpu") -> Params:
    """Carry a params tree (numpy, JAX or torch leaves) to fp32 torch
    tensors on ``device``."""
    return {
        "layers": [
            {
                "w": torch.tensor(np.array(l["w"], np.float32), device=device),
                "b": torch.tensor(np.array(l["b"], np.float32), device=device),
            }
            for l in params_np["layers"]
        ]
    }


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 (nearest-even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, K] @ b [K, M] in fp32: the one product of the kernels' plain
    versions (march_body.mlp_apply, recompute.precise_sdg_plain). Their
    operands are bf16-valued, so every term is exact in fp32 and results
    differ from the CUDA kernels' only by the order of the k sum."""
    return a @ b


def decoder_apply(
    params: Params,
    latent: torch.Tensor,
    points: torch.Tensor,
    cfg: DecoderConfig = DecoderConfig(),
) -> torch.Tensor:
    """Evaluate f_theta(z, x) -> sdf in fp32 for latent [L] or [N, L] and
    points [..., 3]; returns [...]."""
    pts_shape = points.shape[:-1]
    x = points.reshape(-1, 3).to(torch.float32)
    n = x.shape[0]
    z = latent.reshape(-1, latent.shape[-1]).to(torch.float32).expand(n, -1)
    inp = torch.cat([z, x], dim=-1)
    h = inp
    n_layers = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        if i in cfg.latent_in:
            h = torch.cat([h, inp], dim=-1)
        elif cfg.xyz_in_all and 0 < i < n_layers - 1:
            h = torch.cat([h, x], dim=-1)
        h = h @ layer["w"] + layer["b"]
        if i == n_layers - 1:
            if cfg.use_tanh:
                h = torch.tanh(h)
        else:
            h = torch.relu(h)
    sdf = h[..., 0]
    if cfg.final_tanh:
        sdf = torch.tanh(sdf)
    return sdf.reshape(pts_shape)


class PreciseSDF:
    """(latent, points) -> sdf with the fp32 value, plus the sibling the
    renderer reads: ``sdg_builder`` (the fused value + spatial-gradient
    kernel, ops/kernels/recompute.py).

    Forward only in this port slice: gradients through the renderer arrive
    with the recompute backward kernel."""

    def __init__(self, params: Params, cfg: DecoderConfig):
        self.params = params
        self.cfg = cfg
        self._packed = None  # kernel weight layout, packed at first use

    def __call__(self, latent, points):
        return decoder_apply(self.params, latent, points, self.cfg)

    def sdg_builder(self, block: int = 512, use_kernel: bool = True):
        """(latent, points, dirs) -> (s, dd, g): precise value, directional
        derivative <g, dirs> and spatial gradient, one fused evaluation.
        use_kernel=False runs the plain PyTorch version on any device."""
        from dist_renderer_tpu_torch.ops.kernels.recompute import (
            fold_bias_precise, pack_precise, precise_sdg_call,
        )

        if self._packed is None:
            self._packed = pack_precise(self.params, self.cfg)
        packed = self._packed

        def sdg(latent, points, dirs):
            if latent.ndim != 1:
                raise ValueError(
                    "precise_sdg folds ONE latent per call (got shape "
                    f"{tuple(latent.shape)})")
            biases = fold_bias_precise(self.params, latent, self.cfg, packed)
            return precise_sdg_call(packed, biases, points, dirs, block,
                                    use_kernel=use_kernel)

        return sdg


def make_precise_sdf(params: Params,
                     cfg: DecoderConfig = DecoderConfig()) -> PreciseSDF:
    return PreciseSDF(params, cfg)
