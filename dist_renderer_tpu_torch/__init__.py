"""PyTorch + CUDA port of dist_renderer_tpu: sphere-traced rendering of
latent-conditioned DeepSDF decoders, with the TPU package's Pallas kernels
rewritten by hand for NVIDIA Hopper (``ops/kernels/`` wrappers,
``csrc/`` sources). Imports torch, never jax."""

from dist_renderer_tpu_torch.config import (  # noqa: F401
    DecoderConfig, GradConfig, MarchConfig, RenderConfig,
)
