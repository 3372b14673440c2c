"""Decoder weight files: the ``w{i}``/``b{i}``/``latent`` npz layout the
JAX package writes (``models/pretrain.py::save_params_npz``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dist_renderer_tpu_torch.models.decoder import Params, params_from_numpy


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
