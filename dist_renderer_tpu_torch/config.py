"""Unified dataclass config tree (PyTorch port).

The same frozen dataclasses, field names and defaults as
``dist_renderer_tpu/config.py``, so a config written for one package reads
the same in the other. Differences:

  - ``RenderConfig.dtype`` returns a torch dtype;
  - ``RenderConfig.use_pallas`` keeps its name and means "run the
    hand-written CUDA kernels" (on a CPU tensor every kernel wrapper runs
    its plain PyTorch version regardless);
  - options that only steer the TPU's scheduling (block widths, queue
    capacities, dense fractions) are accepted and documented as inert
    where the port reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """DeepSDF decoder architecture (mirror of specs.json "NetworkSpecs"):
    8 hidden layers x 512, latent 256, skip-concat of the network input at
    layer 4, final tanh."""

    latent_size: int = 256
    hidden_dims: Tuple[int, ...] = (512,) * 8
    latent_in: Tuple[int, ...] = (4,)
    xyz_in_all: bool = False
    use_tanh: bool = False
    final_tanh: bool = True
    clamp_dist: float = 0.1
    dropout_prob: float = 0.0

    @property
    def input_dim(self) -> int:
        return self.latent_size + 3

    @property
    def layer_dims(self) -> Tuple[Tuple[int, int], ...]:
        """(in_dim, out_dim) per linear layer, replicating DeepSDF's rule:
        a layer feeding a skip-concat layer has its output shrunk so that
        concat([h, input]) lands back on the configured width."""
        dims = (self.input_dim,) + self.hidden_dims + (1,)
        out = []
        n_layers = len(dims) - 1
        for l in range(n_layers):
            in_dim = dims[l]
            out_dim = dims[l + 1]
            if (l + 1) in self.latent_in and (l + 1) < n_layers:
                out_dim = out_dim - dims[0]
            if self.xyz_in_all and 0 < l < n_layers - 1 and l not in self.latent_in:
                in_dim = in_dim + 3
            if l in self.latent_in:
                in_dim = dims[l]  # concat already accounted for by previous shrink
            out.append((in_dim, out_dim))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Sphere-tracing schedule. Field meanings follow the JAX package's
    MarchConfig; the port's notes on each are inline."""

    max_steps: int = 50
    alpha: float = 1.5
    convergence_eps: float = 5e-5
    depth_eps: float = 1e-5
    sphere_radius: float = 1.0
    far_margin: float = 0.05
    use_compaction: bool = False
    bucket_frac: int = 4
    inner_steps: int = 16
    coarse_to_fine: bool = False
    c2f_strides: Tuple[int, ...] = (4,)
    c2f_backoff: float = 0.05
    c2f_coarse_steps: int = 24
    c2f_classify: bool = True
    scheduler: str = "auto"          # "queue" | "rounds" | "auto" (queue at F=1)
    queue_caps: Tuple[int, ...] = (1, 2, 6, 16)   # work-queue generation caps
    queue_dense_frac: float = 0.5    # TPU scheduling only: no effect in the port
    proxy_backoff: float = 0.015
    proxy_verify_mode: str = "march"
    proxy_verify_hits: str = "march"
    proxy_verify_band: str = "march"
    proxy_band: float = 0.02
    proxy_verify_caps: Optional[Tuple[int, ...]] = (2, 4, 12)
    proxy_verify_caps_queue: Optional[Tuple[int, ...]] = None
    proxy_block_width: Optional[int] = 1024   # TPU scheduling only


@dataclasses.dataclass(frozen=True)
class GradConfig:
    """Backward-pass mode for the tracer. The port renders forward-only in
    this slice; the fields are read by the forward composition."""

    mode: str = "last_step"
    ift_min_denom: float = 1e-2
    polish_iters: int = 1
    compact_frac: int = 0
    compact_min: int = 16384
    fused_dd: bool = False
    recompute_block: int = 512       # TPU scheduling only
    recompute: str = "pallas"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level render configuration."""

    img_h: int = 256
    img_w: int = 256
    march: MarchConfig = dataclasses.field(default_factory=MarchConfig)
    grad: GradConfig = dataclasses.field(default_factory=GradConfig)
    normal_eps: float = 0.0
    background_depth: float = 0.0
    compute_dtype: str = "float32"
    use_pallas: bool = False         # the hand-written CUDA kernel path

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def c2f_strides_valid(self) -> Tuple[int, ...]:
        """Coarse-to-fine strides that evenly divide this image size."""
        return tuple(
            s for s in self.march.c2f_strides
            if s > 1 and self.img_h % s == 0 and self.img_w % s == 0
        )


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Inverse-rendering loss weights."""

    w_depth: float = 10.0
    w_silhouette: float = 1.0
    w_photometric: float = 1.0
    w_normal: float = 0.0
    w_latent_reg: float = 1e-4


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer harness for latent / pose fitting."""

    lr: float = 1e-2
    steps: int = 200
    lr_decay_steps: int = 100
    lr_decay_rate: float = 0.5
    checkpoint_every: int = 50


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Mesh layout for multi-device rendering."""

    mesh_axes: Tuple[str, ...] = ("latents", "rays")
    mesh_shape: Optional[Tuple[int, ...]] = None
