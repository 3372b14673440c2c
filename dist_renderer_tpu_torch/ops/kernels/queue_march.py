"""Work-queue fine march (K2): the whole generation schedule of a
fine-march stage.

Replaces the JAX package's ``ops/pallas/queue_march.py::queue_march``
(``_make_queue_kernel``). Semantically it is ONE full-budget
bracket-secant march (salvage on) of every ray with key != 2. Rays pause
at each generation's step cap and resume from their 12-float march carry
(march_body.Carry); because the step is Markov in the carry, the
generations are pure scheduling and the result equals one uninterrupted
march (K1) bit for bit.

On the card (``csrc/queue_march.cu``): a seed kernel writes every ray's
fresh carry in pixel order and compacts the active rays' pixel indices
into a dense queue (a warp ballot plus one atomicAdd per warp). Each
generation kernel marches the queued rays up to its cap, writes each
ray's carry back to its pixel slot and compacts the survivors into the
next generation's queue. The last generation has the full budget. The
queues hold one slot per ray, so they cannot overflow: the TPU's
overflow fallback has no counterpart here.

On a CPU tensor, or with ``use_kernel=False``, the wrapper runs the
plain version: the same generation schedule at full width with per-ray
masks (march_body.march_loop).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dist_renderer_tpu_torch.config import MarchConfig
from dist_renderer_tpu_torch.ops.kernels import build
from dist_renderer_tpu_torch.ops.kernels.batched_march import (
    POS_BIG, SharedDecoder, StageResult, check_cuda_inputs, geo_margin,
    march_args, pack_rays, pad_frames, plain_layers, ray_setup,
)
from dist_renderer_tpu_torch.ops.kernels.march_body import (
    Carry, make_carry, march_loop, mlp_apply, rows_from_carry,
)


def _caps(gen_caps, march: MarchConfig) -> Tuple[int, ...]:
    """Generation caps; the last generation runs the full budget, so no
    ray survives it."""
    return tuple(max(int(c), 1) for c in gen_caps) + (march.max_steps,)


def _rows_plain(shared, bank, frame_of_ray, o, v, rs, march, caps,
                single_frame) -> torch.Tensor:
    layers = plain_layers(shared, bank, frame_of_ray, single_frame)
    mlp = lambda p: mlp_apply(layers, p, shared.final_tanh)
    c = make_carry(rs.d0, rs.act0)
    g = 0
    while bool((c.act > 0.5).any()):
        cap = caps[min(g, len(caps) - 1)]
        c = march_loop(mlp, o, v, rs.near, rs.far, march, march.max_steps,
                       True, c, kmax=cap)
        g += 1
    return rows_from_carry(c)


def _rows_cuda(shared, bank, rays_per_frame, o, v, rs, march, caps):
    n = o.shape[0]
    rays = pack_rays(o, v, rs)
    check_cuda_inputs(shared, bank, rays)
    dev = rays.device
    state = torch.empty((12, n), dtype=torch.float32, device=dev)
    queues = torch.empty((2, max(n, 1)), dtype=torch.int32, device=dev)
    counts = torch.zeros(len(caps) + 1, dtype=torch.int32, device=dev)
    lib = build.load()
    stream = build.stream_of(rays)
    lib.call("drt_queue_seed", build.ptr(rays), n, build.ptr(state),
             build.ptr(queues[0]), build.ptr(counts[0:1]), stream)
    queue_march.launches += 1
    margs = march_args(shared, bank)
    for g, cap in enumerate(caps):
        lib.call("drt_queue_generation", build.ptr(rays), n, rays_per_frame,
                 *margs, march.convergence_eps, march.depth_eps, march.alpha,
                 march.far_margin, march.max_steps, cap, build.ptr(state),
                 build.ptr(queues[g % 2]), build.ptr(counts[g:g + 1]),
                 build.ptr(queues[(g + 1) % 2]),
                 build.ptr(counts[g + 1:g + 2]), stream)
        queue_march.launches += 1
    return rows_from_carry(Carry(*state.unbind(0)))


def queue_march(
    shared: SharedDecoder,
    bank: torch.Tensor,            # [total, F_pad]
    origins: torch.Tensor,         # [F, N, 3] or [F, 1, 3] (shared origin)
    dirs: torch.Tensor,            # [F, N, 3]
    key: torch.Tensor,             # [F, N] int: 0 rim / 1 interior / 2 skip
    init_depth: torch.Tensor,      # [F, N] seed (NaN = sphere entry)
    march: MarchConfig,
    block: int = 512,
    gen_caps: Tuple[int, ...] = (6, 16),
    qcap_frac: int = 2,
    dense_frac: float = 0.5,
    use_kernel: bool = True,
) -> StageResult:
    """K2: one full-budget march of every ray with key != 2, run as a
    generation schedule; fields in pixel order. CUDA tensors launch the
    kernels (``launches`` counts every launch); CPU tensors, or
    use_kernel=False, run the plain version. ``block``, ``qcap_frac`` and
    ``dense_frac`` only steered the TPU's scheduling and have no effect."""
    f, n = key.shape
    o_full = origins.expand(f, n, 3)
    o_p, v_p, seed_p, act_in, frame_of_ray, r_pad = pad_frames(
        o_full, dirs, init_depth, key != 2)
    rs = ray_setup(o_p, v_p, march, seed_p, act_in)
    caps = _caps(gen_caps, march)
    if use_kernel and origins.is_cuda:
        rows = _rows_cuda(shared, bank, r_pad, o_p, v_p, rs, march, caps)
    else:
        rows = _rows_plain(shared, bank, frame_of_ray, o_p, v_p, rs, march,
                           caps, f == 1)
    unflat = lambda x: x.reshape(f, r_pad)[:, :n]
    # geometric sphere margin for rays whose march never sampled the SDF
    geo = geo_margin(o_p, v_p, rs.t_closest, march)
    msdf = torch.where(rows[2] > POS_BIG / 2, geo, rows[2])
    return StageResult(
        depth=unflat(rows[0]), hit=unflat(rows[1]) > 0.5,
        min_sdf=unflat(msdf), depth_at_min=unflat(rows[3]),
        last_sdf=unflat(rows[4]), steps=unflat(rows[5]).to(torch.int32),
        unresolved=unflat(rows[6]) > 0.5,
    )


queue_march.launches = 0
