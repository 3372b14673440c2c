"""Shared task-driver plumbing: the common flags, the device, decoder
loading, camera setup and the render configuration.

Counterpart of the JAX package's ``tasks/common.py``. The tasks run on the
CUDA card unless ``--cpu`` is given; asked for the card where there is
none, they raise rather than carry on on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Tuple

import numpy as np
import torch

from dist_renderer_tpu_torch.config import (
    DecoderConfig, GradConfig, MarchConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.decoder import Params
from dist_renderer_tpu_torch.ops.camera import Camera
from dist_renderer_tpu_torch.ops.kernels.batched_march import not_ported

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--experiment-dir", default=None,
                    help="DeepSDF experiment dir (specs.json + ModelParameters)")
    ap.add_argument("--checkpoint", default="latest")
    ap.add_argument("--params-npz", default=None,
                    help="decoder params in the w{i}/b{i}/latent npz layout")
    ap.add_argument("--shape", default="torus",
                    choices=["sphere", "torus", "union"],
                    help="analytic shape of the cached fitted decoder used "
                    "when no checkpoint is given")
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100, help="optimization steps")
    ap.add_argument("--march-steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--out", default="out")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--fast", action="store_true",
                    help="c2f + compaction + bf16 march")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint dir for resume")
    ap.add_argument("--decoder-width", type=int, default=512,
                    help="hidden width of the cached fitted decoder")
    ap.add_argument("--decoder-depth", type=int, default=8)
    ap.add_argument("--latent-size", type=int, default=256)
    ap.add_argument("--fit-steps", type=int, default=1500,
                    help="training steps for fitting a decoder (not ported)")
    ap.add_argument("--recompute", default="pallas", choices=["xla", "pallas"],
                    help="differentiable recompute on the --fast path "
                    "(GradConfig.recompute): 'pallas' = the fused recompute "
                    "kernel, ops/kernels/recompute.py")
    ap.add_argument("--no-cache", action="store_true",
                    help="fit the fallback decoder instead of loading its cache")


def analytic_shape(name: str):
    """The analytic shape behind --shape: the fitted decoders' target and
    evaluate's ground truth, as (latent, points) -> sdf."""
    from dist_renderer_tpu_torch.models.analytic import (
        round_union, sphere_sdf, torus_sdf,
    )

    return {
        "sphere": sphere_sdf(0.5),
        "torus": torus_sdf(0.5, 0.18),
        "union": round_union(
            torus_sdf(0.55, 0.18), sphere_sdf(0.35, (0.0, 0.25, 0.0)), 0.08),
    }[name]


def task_device(args) -> torch.device:
    """The CUDA card, or the CPU with --cpu. No card without --cpu raises."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: the tasks run on the "
                           "card unless --cpu is given")
    return torch.device("cuda", torch.cuda.current_device())


def load_task_decoder(args) -> Tuple[Params, torch.Tensor, DecoderConfig]:
    """Resolve the decoder per the flags (npz > cached fitted decoder), on
    the task's device."""
    from dist_renderer_tpu_torch.models.pretrain import load_params_npz

    dev = task_device(args)
    if args.experiment_dir:
        not_ported("--experiment-dir (DeepSDF checkpoint I/O)", "A2")
    if args.params_npz:
        params, latent = load_params_npz(args.params_npz, dev)
        return params, latent, DecoderConfig()
    width, depth = args.decoder_width, args.decoder_depth
    dcfg = DecoderConfig(
        latent_size=args.latent_size, hidden_dims=(width,) * depth,
        latent_in=(depth // 2,) if depth >= 2 else ())
    cache = os.path.join(
        REPO_ROOT, f".task_decoder_{args.shape}_{width}x{depth}_{args.latent_size}.npz")
    if args.no_cache or not os.path.exists(cache):
        not_ported(f"fitting a decoder to the analytic {args.shape!r} "
                   f"(no cache at {os.path.basename(cache)}; give "
                   "--params-npz, or the committed torus 512x8/256)", "A11")
    params, latent = load_params_npz(cache, dev)
    return params, latent, dcfg


def make_render_cfg(args) -> RenderConfig:
    card = task_device(args).type == "cuda"
    march_kw = {}
    if args.fast:
        # convergence matched to the bf16 march's SDF noise (~2e-3); the
        # fp32 IFT step restores depth accuracy afterwards
        march_kw = dict(convergence_eps=2e-3, depth_eps=5e-4)
    return RenderConfig(
        img_h=args.img, img_w=args.img,
        march=MarchConfig(max_steps=args.march_steps,
                          coarse_to_fine=args.fast,
                          use_compaction=args.fast and not card, **march_kw),
        grad=GradConfig(mode="ift", compact_frac=4,
                        recompute=getattr(args, "recompute", "xla"))
        if args.fast else GradConfig(mode="last_step"),
        compute_dtype="bfloat16" if args.fast else "float32",
        use_pallas=args.fast and card,
    )


def default_camera(img: int, dist: float = 2.2, elev_azim=(20.0, 30.0),
                   device="cpu") -> Camera:
    el, az = np.radians(elev_azim[0]), np.radians(elev_azim[1])
    eye = dist * np.array([np.cos(el) * np.sin(az), np.sin(el),
                           -np.cos(el) * np.cos(az)])
    return Camera.looking_at(tuple(float(e) for e in eye), focal=img * 1.1,
                             img_hw=(img, img), device=device)


def ring_cameras(img: int, n_views: int = 8, dist: float = 2.2,
                 elev: float = 20.0, device="cpu") -> List[Camera]:
    """n cameras on a ring: the multi-view rig."""
    return [default_camera(img, dist, (elev, 360.0 * i / n_views), device)
            for i in range(n_views)]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """A fit callback stamping each step's end (the loss the callback
    receives is already on the host, so the device has finished it)."""

    def __init__(self):
        self.stamps = [time.perf_counter()]

    def __call__(self, step, variables, loss) -> None:
        self.stamps.append(time.perf_counter())

    def median_ms(self) -> float:
        ms = sorted(1e3 * (b - a) for a, b in zip(self.stamps, self.stamps[1:]))
        return ms[len(ms) // 2] if ms else float("nan")
