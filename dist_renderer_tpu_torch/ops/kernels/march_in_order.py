"""The in-order march: a witness for the march kernels, not a port of a
TPU kernel and no route. No path calls it.

``csrc/march_in_order.cu`` marches every ray as the routed march kernels
(K1, K1-multi, K1-grid, K2: ``csrc/march_mma.cuh`` on the tensor cores)
do, with each step's decoder evaluation on CUDA cores and every hidden
product summed in k order, the plain version's order with the in-order
product (``decoder.dot_f32_in_order``). The tensor-core kernels sum in
another order and sum again in k order only the values near a bf16
rounding boundary (``NEAR_TIE``, an empirical margin), so their bits equal
this march's on rays where the margin missed no tie: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them to it on millions of rays. It runs
only on the card (there is no CPU form: the plain version with the
in-order product is the CPU's witness).
"""

from __future__ import annotations

from typing import Optional

import torch

from dist_renderer_tpu_torch.config import MarchConfig
from dist_renderer_tpu_torch.ops.kernels import build
from dist_renderer_tpu_torch.ops.kernels.batched_march import (
    RaySetup, SharedDecoder, check_cuda_inputs, march_args, pack_rays, pad_frames,
    ray_setup, trace_from_rows, unpad_frames,
)
from dist_renderer_tpu_torch.ops.tracer import TraceResult


def march_rows_in_order(shared: SharedDecoder, bank: torch.Tensor,
                        rays_per_frame: int, origins: torch.Tensor,
                        dirs: torch.Tensor, rs: RaySetup, march: MarchConfig,
                        salvage: bool) -> torch.Tensor:
    """The in-order march of every ray on the card -> [8, N] rows, K1's
    (``march_rows_cuda``): ray r reads bank column r // rays_per_frame."""
    if not origins.is_cuda:
        raise ValueError("the in-order march runs on the card only")
    n = origins.shape[0]
    rays = pack_rays(origins, dirs, rs)
    check_cuda_inputs(shared, bank, rays)
    out = torch.empty((8, n), dtype=torch.float32, device=rays.device)
    build.load().call("drt_march_in_order", build.ptr(rays), n, rays_per_frame,
                      *march_args(shared, bank), march.convergence_eps,
                      march.depth_eps, march.alpha, march.far_margin,
                      march.max_steps, int(salvage), build.ptr(out),
                      build.stream_of(rays))
    return out


def trace_in_order(shared: SharedDecoder, bank: torch.Tensor, o: torch.Tensor,
                   v: torch.Tensor, march: MarchConfig, seed: Optional[torch.Tensor],
                   active: torch.Tensor, salvage: bool = True) -> TraceResult:
    """``batched_trace_padded``'s contract ([F, R, 3] rays of F frames,
    origins [F, R, 3] or [F, 1, 3], per-ray fields back [F, R],
    steps_per_ray padded) on the in-order march."""
    f, r = v.shape[0], v.shape[1]
    o_p, v_p, s_p, a_p, _, r_pad = pad_frames(o.expand(f, r, 3), v, seed, active)
    rs = ray_setup(o_p, v_p, march, s_p, a_p)
    rows = march_rows_in_order(shared, bank, r_pad, o_p, v_p, rs, march, salvage)
    return unpad_frames(trace_from_rows(rows, rs, o_p, v_p, march), f, r, r_pad)
