"""Checkpoint I/O: DeepSDF experiment directories to and from the port's
params, and the saved state of an optimization loop.

Counterpart of the JAX package's ``models/checkpoint.py``. A DeepSDF
experiment directory holds ``specs.json`` (the architecture),
``ModelParameters/<checkpoint>.pth`` (the weights) and
``LatentCodes/<checkpoint>.pth`` (one latent per training shape); the
reader takes the published layout (weight-normed ``weight_g`` /
``weight_v`` layers, the ``module.`` prefix of a DataParallel save) and
the plain one this module writes. Weight norm folds into a plain weight
at load time: the renderer only ever evaluates a frozen decoder.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import Params, numpy_f32


def read_specs(experiment_dir: str) -> DecoderConfig:
    """DeepSDF ``specs.json`` -> DecoderConfig."""
    with open(os.path.join(experiment_dir, "specs.json")) as f:
        specs = json.load(f)
    ns = specs.get("NetworkSpecs", {})
    return DecoderConfig(
        latent_size=int(specs.get("CodeLength", 256)),
        hidden_dims=tuple(ns.get("dims", [512] * 8)),
        latent_in=tuple(ns.get("latent_in", [4])),
        xyz_in_all=bool(ns.get("xyz_in_all", False)),
        use_tanh=bool(ns.get("use_tanh", False)),
        clamp_dist=float(specs.get("ClampingDistance", 0.1)),
    )


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """w = g * v / ||v|| with the norm over each output row (PyTorch's
    weight_norm, dim=0, on an [out, in] weight)."""
    norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1, keepdims=True)
    return (g.reshape(-1, 1) * v.reshape(v.shape[0], -1) / norm).reshape(v.shape)


def convert_torch_state_dict(state_dict: Dict[str, Any], cfg: DecoderConfig,
                             device="cpu") -> Params:
    """A DeepSDF decoder state_dict -> params on ``device``.

    Takes weight-normed (``linN.weight_g`` / ``linN.weight_v``) or plain
    (``linN.weight``) layers, with or without a ``module.`` or
    ``decoder.`` prefix. PyTorch stores a linear weight as [out, in]; the
    params hold [in, out]. The folding runs in numpy, as the JAX
    package's does, so both packages load the same bits."""
    sd = {}
    for k, val in state_dict.items():
        for pref in ("module.", "decoder."):
            if k.startswith(pref):
                k = k[len(pref):]
        sd[k] = val
    layers = []
    for i, (d_in, d_out) in enumerate(cfg.layer_dims):
        base = f"lin{i}"
        if f"{base}.weight_v" in sd:
            w = fold_weight_norm(numpy_f32(sd[f"{base}.weight_g"]),
                                 numpy_f32(sd[f"{base}.weight_v"]))
        elif f"{base}.weight" in sd:
            w = numpy_f32(sd[f"{base}.weight"])
        else:
            raise KeyError(f"missing weights for layer {base} in state_dict")
        if w.shape != (d_out, d_in):
            raise ValueError(
                f"layer {i}: weight shape {w.shape} != expected {(d_out, d_in)}")
        layers.append({
            "w": torch.tensor(np.ascontiguousarray(w.T), device=device),
            "b": torch.tensor(numpy_f32(sd[f"{base}.bias"]), device=device)})
    return {"layers": layers}


def _load(path: str):
    """torch.load of a DeepSDF file onto the CPU. Their contents are dicts
    of tensors and numbers, which the safe loader takes; a file holding
    other objects is refused rather than unpickled."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_decoder(experiment_dir: str, checkpoint: str = "latest",
                 device="cpu") -> Tuple[Params, DecoderConfig]:
    """Load a DeepSDF experiment directory's decoder (the reference's
    ``load_decoder``) onto ``device``."""
    cfg = read_specs(experiment_dir)
    data = _load(os.path.join(experiment_dir, "ModelParameters", f"{checkpoint}.pth"))
    sd = data["model_state_dict"] if "model_state_dict" in data else data
    return convert_torch_state_dict(sd, cfg, device), cfg


def load_latent_codes(experiment_dir: str, checkpoint: str = "latest",
                      device="cpu") -> torch.Tensor:
    """The per-shape latent table [num_shapes, code_len]: from the
    ``{"latent_codes": {"weight": T}}`` container (an nn.Embedding's
    state_dict) or the older bare tensor (``{"latent_codes": T}`` or T,
    possibly [N, 1, L])."""
    data = _load(os.path.join(experiment_dir, "LatentCodes", f"{checkpoint}.pth"))
    lat = data["latent_codes"] if isinstance(data, dict) and "latent_codes" in data \
        else data
    if isinstance(lat, dict) and "weight" in lat:
        lat = lat["weight"]
    arr = numpy_f32(lat)
    return torch.tensor(arr.reshape(arr.shape[0], -1), device=device)


def save_deepsdf_experiment(experiment_dir: str, params: Params, cfg: DecoderConfig,
                            latents: Optional[torch.Tensor] = None,
                            checkpoint: str = "latest") -> None:
    """Write params (and a latent table) as a DeepSDF experiment
    directory: specs.json, ModelParameters/<checkpoint>.pth with plain
    ``linN.weight`` [out, in] / ``linN.bias`` tensors, and
    LatentCodes/<checkpoint>.pth as ``{"latent_codes": {"weight": T}}``.
    The tensors are written from the CPU, so the files load anywhere."""
    os.makedirs(os.path.join(experiment_dir, "ModelParameters"), exist_ok=True)
    specs = {
        "Description": "exported by dist_renderer_tpu_torch",
        "CodeLength": cfg.latent_size,
        "ClampingDistance": cfg.clamp_dist,
        "NetworkArch": "deep_sdf_decoder",
        "NetworkSpecs": {
            "dims": list(cfg.hidden_dims),
            "latent_in": list(cfg.latent_in),
            "xyz_in_all": cfg.xyz_in_all,
            "use_tanh": cfg.use_tanh,
            "dropout": [],
            "dropout_prob": 0.0,
            "norm_layers": [],
            "weight_norm": False,
            "latent_dropout": False,
        },
    }
    with open(os.path.join(experiment_dir, "specs.json"), "w") as f:
        json.dump(specs, f, indent=2)
    sd = {}
    for i, layer in enumerate(params["layers"]):
        sd[f"lin{i}.weight"] = torch.tensor(numpy_f32(layer["w"]).T.copy())
        sd[f"lin{i}.bias"] = torch.tensor(numpy_f32(layer["b"]))
    torch.save({"model_state_dict": sd},
               os.path.join(experiment_dir, "ModelParameters", f"{checkpoint}.pth"))
    if latents is not None:
        os.makedirs(os.path.join(experiment_dir, "LatentCodes"), exist_ok=True)
        torch.save({"latent_codes": {"weight": torch.tensor(numpy_f32(latents))}},
                   os.path.join(experiment_dir, "LatentCodes", f"{checkpoint}.pth"))


# The saved state of an optimization loop (utils/optim.py's fit):
# <path>/step_<n>.pt, one file a step.

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(path)) if m)


def save_state(path: str, state: Any, step: int) -> None:
    """Save ``state`` (tensors, numbers and dicts, lists or tuples of
    them) as step ``step`` under the directory ``path``, one torch.save
    file a step. The file is written under a temporary name and renamed,
    so a reader never sees a half-written step. The JAX package's
    ``save_state`` writes orbax checkpoints: the two packages' state files
    are not interchangeable, by design."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step}.pt")
    tmp = final + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, final)


def restore_state(path: str, template: Any, step: Optional[int] = None,
                  device="cpu") -> Tuple[Any, int]:
    """(state, step) of the latest saved step under ``path`` (or of
    ``step``), its tensors on ``device``; (template, 0) when nothing was
    saved."""
    if step is None:
        steps = _steps(path)
        if not steps:
            return template, 0
        step = steps[-1]
    state = torch.load(os.path.join(path, f"step_{step}.pt"), map_location=device,
                       weights_only=True)
    return state, step
