"""Multi-frame march: shared weights + a per-frame bias bank, the march
kernels K1 and K1-multi, the rounds scheduler and the coarse-to-fine
pipeline that drives them (``render_batched_c2f``).

After latent folding the decoder's big weight matrices are latent-
independent: frames differ only in the per-layer bias vectors
(b + z @ W_z). So one launch marches rays of many frames against shared
weights, each ray reading its frame's column of the bias bank.

K1, ``sphere_trace_persistent``, replaces the JAX package's
``ops/pallas/batched_march.py::pallas_sphere_trace_persistent``
(``csrc/batched_march.cu``: a persistent grid striding over 64-ray tiles);
K1-multi, ``sphere_trace_batched``, replaces ``pallas_sphere_trace_batched``
(``csrc/fused_march.cu``: one block per 64-ray tile). Both run the one
tensor-core tile march of every routed march kernel (``csrc/march_mma.cuh``
on ``csrc/point_mlp.cuh``'s body, the point evals' wgmma MLP with near
ties summed again in k order), as K1-grid and K2 do, so the four give the
same bits on the same rays. On a CUDA tensor each wrapper launches its
kernel; on a CPU tensor, or with ``use_kernel=False``, it runs the plain
version (``march_rows_plain``, built on ``march_body.march_loop``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig
from dist_renderer_tpu_torch.models.decoder import Params
from dist_renderer_tpu_torch.models.folded import fold_latent
from dist_renderer_tpu_torch.ops.camera import dot3, ray_sphere_entry
from dist_renderer_tpu_torch.ops.kernels import build
from dist_renderer_tpu_torch.ops.kernels.march_body import (  # noqa: F401 (host_free)
    POS_BIG, host_free, in_host_free, make_carry, march_loop, mlp_apply, rows_from_carry,
)
from dist_renderer_tpu_torch.ops.tracer import TraceResult, live_counts_from_steps
from dist_renderer_tpu_torch.utils.profiling import annotate, count, count_device

FRAME_TILE = 128  # bias-bank frame padding (the JAX package's layout)
TILE = 32         # frames pad to a multiple of this many rays (the plain
                  # version's layout; no kernel's block width)
MARCH_TILE = 64   # rows per tile of every march kernel (csrc/march_mma.cuh)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SharedDecoder(NamedTuple):
    """Latent-independent weights + static bias layout.

    whT/wxT/offsets/total/final_tanh match the JAX package's SharedDecoder
    ([out_p, in_p] / [out_p, 8] bf16). ``flat`` and ``table`` are the CUDA
    kernels' layout: every weight in one bf16 buffer, input-major
    ([in_p][out_p], x rows [3][out_p]) so a thread reads 8 consecutive
    outputs with one 16-byte load; ``table`` holds per layer
    (out_p, in_p, wh offset, wx offset, bias row offset), -1 = absent.
    ``tiles``: the hidden weights in the point evals' tensor-core layout
    (pack_mma_tiles), ``wrows`` the same weights row by row (pack_mma_rows)
    and ``wscale`` [total] fp32 each hidden output column's near-tie scale
    (pack_mma_scales)."""

    whT: Tuple[Optional[torch.Tensor], ...]
    wxT: Tuple[Optional[torch.Tensor], ...]
    offsets: Tuple[Tuple[int, int], ...]
    total: int
    final_tanh: bool
    flat: torch.Tensor
    table: Tuple[int, ...]
    tiles: torch.Tensor
    wrows: torch.Tensor
    wscale: torch.Tensor


# The point evals' weight stream (csrc/point_mlp.cuh): a layer's outputs
# run as N-chunks of these widths, each over K in tiles of this many bytes.
MMA_NT = (128, 64, 8)
MMA_STAGE_BYTES = 16384
# The tensor cores sum a hidden product in another order than the plain
# version's k order. Values within NEAR_TIE * 2^-24 * |w| |h| (L2 norms of
# the weight column and the input row) of a bf16 rounding boundary are
# summed again in k order (csrc/point_mlp.cuh). The margin is empirical,
# not a bound (fp32 sums of K terms can differ by ~K * 2^-24 * sum |w h|):
# a CPU model of the card's truncating accumulation read at most 4.4 such
# units on the bench 8x512 and the 8x512 color decoders, and on an H100
# NEAR_TIE = 2 missed no tie in 2.2e8 activations of each. Another decoder
# can miss one: that activation then moves by a bf16 rounding, within
# K5's bars against the plain version (99% within 1e-5, max 5e-3).
NEAR_TIE = 4.0


def mma_chunks(out_p: int):
    """[(n0, nt)]: a layer's output chunks in the kernels' order, the
    largest of MMA_NT that fits first."""
    chunks, n0 = [], 0
    while n0 < out_p:
        nt = next(w for w in MMA_NT if w <= out_p - n0)
        chunks.append((n0, nt))
        n0 += nt
    return chunks


def mma_tile_spans(whT):
    """Per hidden layer (layer index, [(n0, nt, k0, kt)]): the tiles of
    pack_mma_tiles in stream order, K padded to 16. The kernels stream
    every layer but the last, whose few outputs they sum in k order."""
    spans = []
    for li, w in enumerate(whT):
        if w is None:
            continue
        out_p, in_p = w.shape
        k16 = _round_up(in_p, 16)
        tiles = []
        for n0, nt in mma_chunks(out_p):
            kt_max = MMA_STAGE_BYTES // (2 * nt)
            tiles += [(n0, nt, k0, min(kt_max, k16 - k0)) for k0 in range(0, k16, kt_max)]
        spans.append((li, tiles))
    return spans


def pack_mma_tiles(whT) -> torch.Tensor:
    """The hidden weights ([out_p, in_p] bf16 per layer, None where a layer
    has none) as the point evals stream them: per layer, per N-chunk, per
    K-slice one contiguous tile W[n0:n0+nt, k0:k0+kt] stored [kt/8][nt][8]
    (the wgmma B operand's K-major core matrices, no swizzle), K padded to
    16 with zeros. A layer occupies out_p * round_up(in_p, 16) values."""
    parts = []
    for li, tiles in mma_tile_spans(whT):
        w = whT[li]
        out_p, in_p = w.shape
        wp = torch.zeros((out_p, _round_up(in_p, 16)), dtype=torch.bfloat16, device=w.device)
        wp[:, :in_p] = w
        for n0, nt, k0, kt in tiles:
            tile = wp[n0:n0 + nt, k0:k0 + kt]
            parts.append(tile.reshape(nt, kt // 8, 8).permute(1, 0, 2).reshape(-1))
    if not parts:
        return torch.zeros((0,), dtype=torch.bfloat16)
    return torch.cat(parts).contiguous()


def pack_mma_rows(whT) -> torch.Tensor:
    """The hidden weights row by row for the in-order recompute of near
    ties: per layer [out_p][round_up(in_p, 16)] bf16 (K padded with zeros),
    the layers at pack_mma_tiles' offsets, so one output's weights are one
    contiguous run."""
    parts = []
    for w in whT:
        if w is None:
            continue
        out_p, in_p = w.shape
        wp = torch.zeros((out_p, _round_up(in_p, 16)), dtype=torch.bfloat16, device=w.device)
        wp[:, :in_p] = w
        parts.append(wp.reshape(-1))
    if not parts:
        return torch.zeros((0,), dtype=torch.bfloat16)
    return torch.cat(parts).contiguous()


def pack_mma_scales(whT, offsets, total: int) -> torch.Tensor:
    """[total] fp32 at the bias rows (offsets): NEAR_TIE * 2^-24 * the L2
    norm of each hidden output column's bf16 weights, 0 where a layer has
    no hidden product."""
    dev = next(w.device for w in whT if w is not None) if any(
        w is not None for w in whT) else torch.device("cpu")
    scale = torch.zeros((total,), dtype=torch.float32, device=dev)
    for w, (off, out_p) in zip(whT, offsets):
        if w is not None:
            scale[off:off + out_p] = NEAR_TIE * 2.0 ** -24 * torch.linalg.vector_norm(
                w.to(torch.float32), dim=1)
    return scale


def pack_shared(params: Params, cfg: DecoderConfig) -> SharedDecoder:
    """Pack the z-independent parts (weights) + bias layout."""
    dev = params["layers"][0]["w"].device
    return pack_layers(fold_latent(
        params, torch.zeros(cfg.latent_size, device=dev), cfg), cfg.final_tanh)


def pack_layers(folded, final_tanh: bool) -> SharedDecoder:
    """Pack folded layers' weights (their biases are not read)."""
    whT, wxT, offsets, flat, table = [], [], [], [], []
    off = 0
    flat_len = 0
    prev_out_p = None
    bf16 = torch.bfloat16
    for l in folded:
        dev = l.b.device
        out_dim = l.b.shape[0]
        out_p = _round_up(out_dim, 8)
        wh_off = wx_off = -1
        in_p = 0
        if l.wh is not None:
            in_dim = l.wh.shape[0]
            in_p = prev_out_p if prev_out_p is not None else _round_up(in_dim, 8)
            w = torch.zeros((out_p, in_p), dtype=bf16, device=dev)
            w[:out_dim, :in_dim] = l.wh.T.to(bf16)
            whT.append(w)
            wh_off = flat_len
            flat.append(w.T.reshape(-1))
            flat_len += w.numel()
        else:
            whT.append(None)
        if l.wx is not None:
            w = torch.zeros((out_p, 8), dtype=bf16, device=dev)
            w[:out_dim, :3] = l.wx.T.to(bf16)
            wxT.append(w)
            wx_off = flat_len
            flat.append(w[:, :3].T.reshape(-1))
            flat_len += 3 * out_p
        else:
            wxT.append(None)
        table += [out_p, in_p, wh_off, wx_off, off]
        offsets.append((off, out_p))
        off += out_p
        prev_out_p = out_p
    return SharedDecoder(
        whT=tuple(whT), wxT=tuple(wxT), offsets=tuple(offsets),
        total=_round_up(off, 8), final_tanh=final_tanh,
        flat=torch.cat(flat).contiguous(), table=tuple(table),
        tiles=pack_mma_tiles(whT).to(flat[0].device),
        wrows=pack_mma_rows(whT).to(flat[0].device),
        wscale=pack_mma_scales(whT, offsets, _round_up(off, 8)).to(flat[0].device),
    )


def fold_bias_bank(params: Params, latents: torch.Tensor, cfg: DecoderConfig,
                   shared: SharedDecoder) -> torch.Tensor:
    """latents [F, L] -> bias bank [total, F_pad] fp32 (F padded to 128)."""
    f = latents.shape[0]
    f_pad = _round_up(f, FRAME_TILE)
    bank = torch.zeros((shared.total, f_pad), dtype=torch.float32,
                       device=latents.device)
    for i in range(f):
        for (off, _), l in zip(shared.offsets, fold_latent(params, latents[i], cfg)):
            bank[off:off + l.b.shape[0], i] = l.b.to(torch.float32)
    return bank


class RaySetup(NamedTuple):
    """Per-ray march inputs: seed depth, sphere bounds and active flag."""

    d0: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor
    act0: torch.Tensor      # fp32 0/1
    enters: torch.Tensor    # bool: the ray meets the bounding sphere
    t_closest: torch.Tensor


def ray_setup(origins, dirs, march: MarchConfig, init_depth=None,
              init_active=None) -> RaySetup:
    """Seeded and inactive init: start at the sphere entry (or the seed,
    never before the entry); rays that miss the sphere never march."""
    t_near, t_far, enters = ray_sphere_entry(origins, dirs,
                                             march.sphere_radius, 0.0)
    far_bound = t_far + march.far_margin
    t_closest = torch.clamp(-dot3(origins, dirs), min=0.0)
    d0 = torch.where(enters, t_near, t_closest)
    if init_depth is not None:
        seeded = torch.isfinite(init_depth) & enters
        d0 = torch.where(seeded, torch.maximum(init_depth, t_near), d0)
    active0 = enters if init_active is None else (enters & init_active)
    return RaySetup(d0, t_near, far_bound, active0.to(torch.float32), enters,
                    t_closest)


def geo_margin(origins, dirs, t_closest, march: MarchConfig) -> torch.Tensor:
    """Distance from the ray's closest approach to the bounding sphere."""
    p_c = origins + t_closest[:, None] * dirs
    return torch.linalg.norm(p_c, dim=-1) - march.sphere_radius


def plain_layers(shared: SharedDecoder, bank: torch.Tensor,
                 frame_of_ray: torch.Tensor, single_frame: bool):
    """Per-layer (wh [in_p, out_p], wx [3, out_p], bias) fp32 operands of
    march_body.mlp_apply; the bias is one row when every ray shares a
    frame, else gathered per ray."""
    layers = []
    for wh, wx, (off, out_p) in zip(shared.whT, shared.wxT, shared.offsets):
        if single_frame:
            bias = bank[off:off + out_p, int(frame_of_ray[0])][None, :]
        else:
            bias = bank[off:off + out_p, :].T[frame_of_ray]
        layers.append((
            None if wh is None else wh.to(torch.float32).T.contiguous(),
            None if wx is None else wx[:, :3].to(torch.float32).T.contiguous(),
            bias,
        ))
    return layers


def march_rows_plain(shared, bank, frame_of_ray, origins, dirs, rs: RaySetup,
                     march: MarchConfig, salvage: bool,
                     single_frame: bool) -> torch.Tensor:
    """Plain version of K1: one fresh full-budget march -> [8, N] rows."""
    layers = plain_layers(shared, bank, frame_of_ray, single_frame)
    mlp = lambda p: mlp_apply(layers, p, shared.final_tanh)
    outc = march_loop(mlp, origins, dirs, rs.near, rs.far, march,
                      march.max_steps, salvage, make_carry(rs.d0, rs.act0))
    return rows_from_carry(outc)


def check_cuda_inputs(shared: SharedDecoder, bank: torch.Tensor,
                      *tensors: torch.Tensor) -> None:
    """The kernels take contiguous fp32 CUDA tensors on one device."""
    dev = bank.device
    for t in (bank,) + tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError("CUDA kernel inputs must be CUDA tensors on one device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("CUDA kernel inputs must be contiguous float32")
    if shared.flat.dtype != torch.bfloat16 or shared.flat.device != dev:
        raise ValueError("packed weights must be bf16 on the rays' device")
    if bank.dim() != 2 or bank.shape[0] != shared.total:
        raise ValueError(f"bias bank must be [{shared.total}, F_pad]")


def march_args(shared: SharedDecoder, bank: torch.Tensor):
    """The (weights, layer table, n_layers, bank, bank stride, final_tanh)
    argument group every march entry point takes. The table lives in host
    memory; the C side copies it into the launch parameters."""
    n_layers = len(shared.offsets)
    tab = (ctypes.c_int * len(shared.table))(*shared.table)
    return (build.ptr(shared.flat), tab, n_layers, build.ptr(bank),
            bank.shape[1], int(shared.final_tanh))


def mma_march_args(shared: SharedDecoder, bank: torch.Tensor):
    """The (weights, MMA tiles, weight rows, near-tie scales, layer table,
    n_layers, bank, bank stride, final_tanh) argument group of the
    tensor-core march entry points (K1, K1-multi, K1-grid, K2)."""
    w, tab, n_layers, bank_ptr, stride, tanh = march_args(shared, bank)
    return (w, build.ptr(shared.tiles), build.ptr(shared.wrows),
            build.ptr(shared.wscale), tab, n_layers, bank_ptr, stride, tanh)


def pack_rays(origins, dirs, rs: RaySetup) -> torch.Tensor:
    """[16, N] fp32 ray rows: origin 0-2, dir 3-5, d0, near, far, active."""
    n = origins.shape[0]
    rays = torch.zeros((16, n), dtype=torch.float32, device=origins.device)
    rays[0:3] = origins.T
    rays[3:6] = dirs.T
    rays[6] = rs.d0
    rays[7] = rs.near
    rays[8] = rs.far
    rays[9] = rs.act0
    return rays


def march_rows_cuda(shared, bank, rays_per_frame: int, origins, dirs,
                    rs: RaySetup, march: MarchConfig, salvage: bool,
                    persistent: bool = True) -> torch.Tensor:
    """One launch on the card marches every ray -> [8, N] rows: K1 (the
    persistent grid: what fits on the card, each block striding over the
    64-ray tiles) or, with persistent=False, K1-multi (a block per tile).
    A decoder whose shared-memory plan does not fit a block raises before
    the launch."""
    from dist_renderer_tpu_torch.ops.kernels.mlp_eval import check_mma_plan

    n = origins.shape[0]
    rays = pack_rays(origins, dirs, rs)
    check_cuda_inputs(shared, bank, rays)
    check_mma_plan(shared, rays.device, march=True)
    out = torch.empty((8, n), dtype=torch.float32, device=rays.device)
    args = (build.ptr(rays), n, rays_per_frame, *mma_march_args(shared, bank),
            march.convergence_eps, march.depth_eps, march.alpha, march.far_margin,
            march.max_steps, int(salvage))
    build.load().call("drt_sphere_trace_persistent" if persistent
                      else "drt_sphere_trace_batched", *args, build.ptr(out),
                      build.stream_of(rays))
    if persistent:
        sphere_trace_persistent.launches += 1
    else:
        sphere_trace_batched.launches += 1
    return out


def _sphere_trace(shared, bank, frame_of_ray, origins, dirs, march,
                  init_depth, init_active, salvage, rays_per_frame,
                  use_kernel, persistent) -> TraceResult:
    rpf = origins.shape[0] if rays_per_frame is None else rays_per_frame
    rs = ray_setup(origins, dirs, march, init_depth, init_active)
    if use_kernel and origins.is_cuda:
        out = march_rows_cuda(shared, bank, rpf, origins, dirs, rs, march,
                              salvage, persistent)
    else:
        out = march_rows_plain(shared, bank, frame_of_ray, origins, dirs, rs,
                               march, salvage, rpf >= origins.shape[0])
    return trace_from_rows(out, rs, origins, dirs, march)


def sphere_trace_persistent(
    shared: SharedDecoder,
    bias_bank: torch.Tensor,       # [total, F_pad]
    frame_of_ray: torch.Tensor,    # [N] int (frame-major, rays_per_frame each)
    origins: torch.Tensor,         # [N, 3]
    dirs: torch.Tensor,            # [N, 3]
    march: MarchConfig,
    init_depth: Optional[torch.Tensor] = None,
    init_active: Optional[torch.Tensor] = None,
    block: int = 512,
    salvage: bool = True,
    rays_per_frame: Optional[int] = None,
    use_kernel: bool = True,
) -> TraceResult:
    """K1: full bracket-secant trace of every active ray, each ray against
    its frame's bias column. CUDA tensors launch the kernel; CPU tensors,
    or use_kernel=False, run the plain version. ``block`` only steered the
    TPU's scheduling and has no effect. ``rays_per_frame`` (default: all
    rays one frame) tells the kernel which bank column a ray reads:
    frame = index // rays_per_frame, which must agree with
    ``frame_of_ray``."""
    return _sphere_trace(shared, bias_bank, frame_of_ray, origins, dirs,
                         march, init_depth, init_active, salvage,
                         rays_per_frame, use_kernel, True)


sphere_trace_persistent.launches = 0


def sphere_trace_batched(
    shared: SharedDecoder,
    bias_bank: torch.Tensor,       # [total, F_pad]
    frame_of_ray: torch.Tensor,    # [N] int (frame-major, rays_per_frame each)
    origins: torch.Tensor,         # [N, 3]
    dirs: torch.Tensor,            # [N, 3]
    march: MarchConfig,
    init_depth: Optional[torch.Tensor] = None,
    init_active: Optional[torch.Tensor] = None,
    block: int = 512,
    salvage: bool = True,
    rays_per_frame: Optional[int] = None,
    use_kernel: bool = True,
) -> TraceResult:
    """K1-multi: K1's contract (``sphere_trace_persistent``) on a grid of
    one thread block per 64-ray tile (``csrc/fused_march.cu``), the
    counterpart of the JAX package's ``pallas_sphere_trace_batched``. The
    two kernels run one tile march (``csrc/march_mma.cuh``), so on the
    same rays they give the same bits; its plain version is K1's.
    salvage=False leaves bracketed-but-unconverged rays at the step cap
    unresolved."""
    return _sphere_trace(shared, bias_bank, frame_of_ray, origins, dirs,
                         march, init_depth, init_active, salvage,
                         rays_per_frame, use_kernel, False)


sphere_trace_batched.launches = 0


def trace_from_rows(out: torch.Tensor, rs: RaySetup, origins, dirs,
                    march: MarchConfig) -> TraceResult:
    """A march kernel's [8, N] output rows as a TraceResult; rays that
    never sampled the SDF take the geometric sphere margin."""
    geo = geo_margin(origins, dirs, rs.t_closest, march)
    min_sdf = torch.where(rs.enters, out[2], geo)
    min_sdf = torch.where(min_sdf > POS_BIG / 2, geo, min_sdf)
    steps_i = out[5].to(torch.int32)
    return TraceResult(
        depth=out[0], hit=out[1] > 0.5, min_sdf=min_sdf,
        depth_at_min=out[3], last_sdf=out[4], steps_used=steps_i.max(),
        live_counts=live_counts_from_steps(steps_i, march.max_steps),
        unresolved=out[6] > 0.5, steps_per_ray=steps_i,
        bracketed=out[7] > 0.5,
    )


def march_tile_steps(steps_per_ray: torch.Tensor) -> torch.Tensor:
    """[ceil(N / 64)] the steps each 64-row tile of a march kernel
    marched, its rows in this order (a range's rays, or one K2
    generation's queue with each ray's steps in it): the most of its rays'
    step counts (a tile steps while any of its rays is active). Times 64,
    summed, the lane-steps a launch spent on its steps_per_ray.sum()
    active ray-steps."""
    s = steps_per_ray.reshape(-1)
    pad = (-s.numel()) % MARCH_TILE
    if pad:
        s = torch.cat([s, s.new_zeros(pad)])
    return s.reshape(-1, MARCH_TILE).amax(dim=1)


def tile_frames(rows: torch.Tensor, rays_per_frame: int):
    """The frames of a march kernel's 64-row tiles whose rows are these ray
    or pixel indices in order (a range, or one K2 generation's queue):
    [T, 64] each row's frame (index // rays_per_frame), rows past the end
    taking row 0's, and [T] bool ``pure``, every row's frame equal to row
    0's. csrc/march_mma.cuh's rule: a pure tile stages one bias column a
    layer, an impure one reads a bias per row."""
    p = rows.reshape(-1).to(torch.int64)
    tiles = (p.numel() + MARCH_TILE - 1) // MARCH_TILE
    pad = tiles * MARCH_TILE - p.numel()
    if pad:
        p = torch.cat([p, p[(tiles - 1) * MARCH_TILE].expand(pad)])
    frames = (p // rays_per_frame).reshape(tiles, MARCH_TILE)
    return frames, (frames == frames[:, :1]).all(dim=1)


def pad_frames(o, v, seed, active):
    """[F, R, *] -> flat frame-major [F * r_pad, *] with each frame padded
    to a multiple of TILE = 32 rays, the plain version's layout (pad rays
    point along +1 and never march; the kernels' 64-ray tiles may straddle
    two frames). Returns (o, v, seed, active, frame_of_ray, r_pad)."""
    f, r = o.shape[0], o.shape[1]
    r_pad = _round_up(max(r, TILE), TILE)
    pad = r_pad - r
    dev = o.device

    def padded(x, value):
        if pad == 0:
            return x.reshape((f * r,) + x.shape[2:])
        fill = torch.full((f, pad) + x.shape[2:], value, dtype=x.dtype, device=dev)
        return torch.cat([x, fill], dim=1).reshape((f * r_pad,) + x.shape[2:])

    o_p = padded(o, 0.0)
    v_p = padded(v, 1.0)
    s_p = None if seed is None else padded(seed, float("nan"))
    a_p = padded(active, False)
    frame_of_ray = torch.arange(f, device=dev).repeat_interleave(r_pad)
    return o_p, v_p, s_p, a_p, frame_of_ray, r_pad


def batched_trace_padded(
    shared: SharedDecoder,
    bank: torch.Tensor,
    o: torch.Tensor,               # [F, R, 3]
    v: torch.Tensor,               # [F, R, 3]
    march: MarchConfig,
    seed: Optional[torch.Tensor],  # [F, R] or None
    active: torch.Tensor,          # [F, R] bool
    block: int = 512,
    salvage: bool = True,
    use_kernel: bool = True,
    persistent: bool = True,
) -> TraceResult:
    """Frame-major multi-frame trace; per-ray fields come back [F, R].
    steps_per_ray stays in the padded flat layout. persistent=True
    marches on K1, False on K1-multi (the same bits); use_kernel=False
    runs the plain version on any device."""
    f, r = o.shape[0], o.shape[1]
    o_p, v_p, s_p, a_p, frame_of_ray, r_pad = pad_frames(o, v, seed, active)
    trace = sphere_trace_persistent if persistent else sphere_trace_batched
    res = trace(shared, bank, frame_of_ray, o_p, v_p, march, s_p,
                init_active=a_p, block=block, salvage=salvage,
                rays_per_frame=r_pad, use_kernel=use_kernel)
    count_device("ray_steps", res.steps_per_ray)
    return unpad_frames(res, f, r, r_pad)


def unpad_frames(res: TraceResult, f: int, r: int, r_pad: int) -> TraceResult:
    """A trace of pad_frames' flat rays with its per-ray fields back
    [F, R]; steps_per_ray stays in the padded flat layout."""
    unflat = lambda x: x.reshape(f, r_pad)[:, :r]
    return TraceResult(
        depth=unflat(res.depth), hit=unflat(res.hit),
        min_sdf=unflat(res.min_sdf), depth_at_min=unflat(res.depth_at_min),
        last_sdf=unflat(res.last_sdf), steps_used=res.steps_used,
        live_counts=res.live_counts, unresolved=unflat(res.unresolved),
        steps_per_ray=res.steps_per_ray, bracketed=unflat(res.bracketed),
    )


def render_depth_batched(params: Params, dcfg: DecoderConfig,
                         latents: torch.Tensor,    # [F, L]
                         origins: torch.Tensor,    # [F, R, 3] (or [F, 1, 3])
                         dirs: torch.Tensor,       # [F, R, 3]
                         march: MarchConfig, block: int = 512,
                         use_kernel: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched depth and hit [F, R] of F frames: one K1-multi march of
    every ray from its sphere entry (the JAX package's config-#5 forward
    path). ``block`` only steered the TPU's scheduling."""
    f, r = dirs.shape[0], dirs.shape[1]
    shared = pack_shared(params, dcfg)
    bank = fold_bias_bank(params, latents, dcfg, shared)
    res = batched_trace_padded(
        shared, bank, origins.expand(f, r, 3), dirs, march, None,
        torch.ones((f, r), dtype=torch.bool, device=dirs.device), block,
        True, use_kernel, persistent=False)
    return res.depth, res.hit


class StageResult(NamedTuple):
    """A scheduler pass or a whole batched render, every field [F, N] in
    pixel order. The rounds scheduler fills only the optional fields its
    flags ask for (each rides its re-pack sorts); the work queue fills
    them all. ``weak`` marks verify_hits="polish-all"'s weak candidates
    (finalize_hits_batched's ``weak``)."""

    depth: torch.Tensor
    hit: torch.Tensor
    min_sdf: torch.Tensor
    depth_at_min: Optional[torch.Tensor] = None
    last_sdf: Optional[torch.Tensor] = None
    steps: Optional[torch.Tensor] = None
    unresolved: Optional[torch.Tensor] = None
    weak: Optional[torch.Tensor] = None


def _sort_fields(k: torch.Tensor, fields: dict):
    """Stable sort of every frame's row of k; the fields ride along."""
    k_s, idx = torch.sort(k, dim=1, stable=True)
    return k_s, {nm: torch.gather(a, 1, idx) for nm, a in fields.items()}


def _merge_cols(full: torch.Tensor, r: int, part: torch.Tensor) -> torch.Tensor:
    """full [F, W] with its first r columns replaced by part (out of place)."""
    return torch.cat([part, full[:, r:]], dim=1) if r < full.shape[1] else part


def fine_march_rounds(
    shared: SharedDecoder,
    bank: torch.Tensor,
    origins: torch.Tensor,         # [F, N, 3] or [F, 1, 3] (shared origin)
    dirs: torch.Tensor,            # [F, N, 3]
    key: torch.Tensor,             # [F, N] int: 0 rim / 1 interior / 2 skip
    init_depth: torch.Tensor,      # [F, N] seed (NaN = start at sphere entry)
    march: MarchConfig,
    block: int = 512,
    round_caps: Tuple[int, ...] = (4, 12),
    diag: Optional[dict] = None,
    live_frac: int = 2,
    return_anchor: bool = False,
    return_steps: bool = False,
    return_last: bool = False,
    return_unres: bool = False,
    difficulty_repack: Optional[bool] = None,
    use_kernel: bool = True,
    persistent: bool = True,
) -> StageResult:
    """Multi-round straggler-rebinned fine march (the JAX package's
    ``fine_march_rounds``); outputs in pixel order.

    Every frame's rays are class-sorted once (one stable sort on the key,
    the per-ray state gathered along). Round i caps every live ray at
    round_caps[i] steps without salvage; survivors re-pack live-first by
    difficulty (open, bracketed, dead; with difficulty_repack, default on
    at F >= 32, refined by the quantized |last SDF sample|), and the last
    round has the full budget and salvage. Each round re-seeds a fresh
    carry from the ray's depth. Rounds march a live prefix of each frame:
    the first N/live_frac columns, then N/4 and N/8, each rounded up to
    ``block``; where the live rays of some frame overflow a prefix the
    round marches the full width, so every live ray gets every round's
    cap and the results are a pure function of each ray's (seed, class,
    caps), whatever the layout. Those overflow guards are host decisions
    on the live count (one device sync each); under ``host_free()`` every
    round marches the full width instead, which gives the same bits and
    reads nothing on the host. One scatter on the carried pixel index
    un-sorts.

    Flags pick the optional outputs (each is a payload of every re-pack
    sort): return_anchor the depth of the min-SDF sample, return_steps
    the step counts, return_last the last SDF sample and the unresolved
    flag, return_unres the unresolved flag alone. diag: a dict that
    receives each round's per-tile residency, ``fine_r{i}_block_residency``
    (the steps of each 64-ray tile of the K1 or K1-multi launch, in its
    row order, ``march_tile_steps``: not comparable in size with the JAX
    package's 512-lane blocks). Telemetry leaves the widths as they are
    (the JAX package marches the full width under diag, because its
    prefix choice is traced): a round's residency covers the columns it
    marched. persistent=False marches every round on K1-multi instead of
    K1; use_kernel=False runs the plain version."""
    f, n = key.shape
    dev = key.device
    shared_origin = origins.shape[1] == 1
    pix = torch.arange(n, device=dev).expand(f, n)
    init0 = dict(vx=dirs[..., 0], vy=dirs[..., 1], vz=dirs[..., 2],
                 d=init_depth, pix=pix)
    if not shared_origin:
        init0.update(ox=origins[..., 0], oy=origins[..., 1], oz=origins[..., 2])
    if difficulty_repack is None:
        difficulty_repack = f >= 32
    carry_lsdf = difficulty_repack or return_last
    key_s, st0 = _sort_fields(key, init0)
    st0["live"] = key_s != 2
    st0["hit"] = torch.zeros((f, n), dtype=torch.bool, device=dev)
    st0["msdf"] = torch.full((f, n), float("inf"), device=dev)
    st0["brk"] = torch.zeros((f, n), dtype=torch.bool, device=dev)
    if return_anchor:
        st0["dam"] = torch.where(torch.isfinite(st0["d"]), st0["d"], 0.0)
    if return_steps:
        st0["stp"] = torch.zeros((f, n), dtype=torch.int32, device=dev)
    if carry_lsdf:
        st0["lsdf"] = torch.full((f, n), float("inf"), device=dev)
    out_fields = (["d", "hit", "msdf", "pix"]
                  + (["dam"] if return_anchor else [])
                  + (["stp"] if return_steps else [])
                  + (["lsdf"] if return_last else [])
                  + (["live"] if return_last or return_unres else []))

    def fit(bucket: int, width: int, live: torch.Tensor) -> int:
        """The columns a round marches: the bucket, unless the live rays
        of some frame overflow it."""
        if bucket >= width or in_host_free():
            return width
        with annotate(".read"):
            over = int(live.sum(dim=1).max()) > bucket
        return width if over else bucket

    def run_round(ri, s, r, m, salvage):
        """March the first r columns (current order); merge back."""
        with annotate(f".r{ri}"):
            v_r = torch.stack([s["vx"][:, :r], s["vy"][:, :r], s["vz"][:, :r]], -1)
            o_r = (origins.expand(f, r, 3) if shared_origin else torch.stack(
                [s["ox"][:, :r], s["oy"][:, :r], s["oz"][:, :r]], -1))
            res = batched_trace_padded(shared, bank, o_r, v_r, m, s["d"][:, :r],
                                       s["live"][:, :r], block, salvage,
                                       use_kernel, persistent)
            if diag is not None:
                diag[f"fine_r{ri}_block_residency"] = march_tile_steps(res.steps_per_ray)
            s = dict(s)
            was = s["live"][:, :r]
            upd = lambda full, part: _merge_cols(full, r, torch.where(was, part, full[:, :r]))
            if return_anchor:
                # keyed on the msdf before this round: the anchor of the
                # round that reached the min
                s["dam"] = upd(s["dam"], torch.where(
                    res.min_sdf <= s["msdf"][:, :r], res.depth_at_min, s["dam"][:, :r]))
            s["d"] = upd(s["d"], res.depth)
            s["hit"] = upd(s["hit"], s["hit"][:, :r] | res.hit)
            s["msdf"] = upd(s["msdf"], torch.minimum(s["msdf"][:, :r], res.min_sdf))
            s["brk"] = upd(s["brk"], res.bracketed)
            if return_steps:
                r_pad = res.steps_per_ray.shape[0] // f
                s["stp"] = upd(s["stp"], s["stp"][:, :r]
                               + res.steps_per_ray.reshape(f, r_pad)[:, :r])
            if carry_lsdf:
                s["lsdf"] = upd(s["lsdf"], res.last_sdf)
            s["live"] = upd(s["live"], res.unresolved)
            return s

    def repack(s):
        """Live-first re-pack by remaining work (one payload sort)."""
        with annotate(".repack"):
            if difficulty_repack:
                # the bin of |last SDF| among 4, 16 and 64 eps (a bucketize whose
                # bins need no copy to the device: the comparisons round each
                # bound to fp32, as a float32 bins tensor does)
                a = torch.nan_to_num(s["lsdf"], posinf=1e9).abs()
                qf = sum((a >= m * march.convergence_eps).long() for m in (4, 16, 64))
                k2 = torch.where(~s["live"], 99, torch.where(s["brk"], 4, 0) + qf)
            else:
                k2 = torch.where(~s["live"], 99, torch.where(s["brk"], 1, 0))
            k2_s, out = _sort_fields(k2.to(torch.int32),
                                     {nm: a for nm, a in s.items() if nm != "live"})
            out["live"] = k2_s < 99
            return out

    def rounds(width, st):
        """Every round and re-pack on the first `width` columns (every
        live ray lies there); the dead suffix rejoins at the end."""
        suffix = {nm: st[nm][:, width:] for nm in out_fields}
        st = {nm: a[:, :width] for nm, a in st.items()}
        for ri, cap in enumerate(round_caps):
            m = dataclasses.replace(march, max_steps=min(cap, march.max_steps))
            bucket = width
            if ri > 0:
                st = repack(st)
                bucket = min(_round_up(max(n // 4, block), block), width)
            st = run_round(ri, st, fit(bucket, width, st["live"]), m, False)
        # the final round: the full budget, salvage on
        st = repack(st)
        bucket = min(_round_up(max(n // 8, block), block), width)
        st = run_round(len(round_caps), st, fit(bucket, width, st["live"]),
                       march, True)
        return {nm: torch.cat([st[nm], suffix[nm]], dim=1) for nm in out_fields}

    prefix = min(_round_up(max(n // max(live_frac, 1), block), block), n)
    outd = rounds(fit(prefix, n, st0["live"]), st0)
    # one un-sort back to pixel order
    od = {nm: torch.empty_like(a).scatter_(1, outd["pix"], a)
          for nm, a in outd.items() if nm != "pix"}
    return StageResult(
        depth=od["d"], hit=od["hit"], min_sdf=od["msdf"],
        depth_at_min=od.get("dam"), last_sdf=od.get("lsdf"),
        steps=od.get("stp"), unresolved=od.get("live"))


def render_batched_c2f(
    params: Params,
    dcfg: DecoderConfig,
    latents: torch.Tensor,         # [F, L]
    origins: torch.Tensor,         # [F, H*W, 3] (or [F, 1, 3] shared origin)
    dirs: torch.Tensor,            # [F, H*W, 3]
    img_hw: Tuple[int, int],
    march: MarchConfig,
    block: int = 512,
    backoff: float = 0.05,
    coarse_steps: int = 16,
    strides: Tuple[int, ...] = (16, 4),
    round_caps: Tuple[int, ...] = (4, 12),
    shared_origin: bool = False,
    with_diag: bool = False,
    live_frac: int = 3,
    return_anchor: bool = False,
    return_steps: bool = False,
    return_last: bool = False,
    scheduler: str = "rounds",
    queue_caps: Tuple[int, ...] = (6, 16),
    queue_dense_frac: float = 0.5,
    warm=None,
    proxy: Optional[Tuple[Params, DecoderConfig]] = None,
    proxy_backoff: float = 0.015,
    proxy_band: float = 0.02,
    proxy_block: Optional[int] = None,
    proxy_verify: bool = True,
    proxy_band_w: float = 0.02,
    verify_mode: str = "march",
    verify_band: str = "march",
    verify_hits: str = "march",
    verify_round_caps: Optional[Tuple[int, ...]] = None,
    verify_gen_caps: Optional[Tuple[int, ...]] = None,
    difficulty_repack: Optional[bool] = None,
    use_kernel: bool = True,
    packed=None,
    persistent: bool = True,
):
    """Coarse-to-fine classified render of F frames (the JAX package's
    ``render_batched_c2f``): coarse levels (K1), classification
    (ops/c2f.py), the fine march, and with a proxy a full-decoder verify
    stage. The fine march runs on ``scheduler``: "rounds" (the default,
    ``fine_march_rounds`` on K1, or on K1-multi with persistent=False),
    "queue" (K2, one launch schedule equal to one uninterrupted march) or
    "auto" (the queue at F=1, else rounds). The rounds scheduler fills the
    optional StageResult fields its return_* flags ask for.

    With ``proxy`` the pyramid and the fine march run on the distilled
    proxy decoder and the verify stage re-marches the full decoder:
    verify_hits="march" confirms every proxy hit with a march seeded at
    (proxy depth - proxy_backoff) and re-marches near-miss band rays
    (margin < proxy_band) from the sphere entry and unresolved rays from
    their depth; clear misses keep the proxy's values. "polish" re-marches
    only band and unresolved rays: confident proxy hits keep the proxy's
    depth, and the caller finalizes them against the full decoder
    (render()'s compose() demote, or finalize_hits_batched). "polish-all"
    marches band rays of fine (non-skip) classes not at all: they ride
    the hit channel as weak candidates seeded at their proxy min-SDF depth
    (``weak``), for finalize_hits_batched(weak=...).
    verify_mode="cert" certifies proxy hits with two full-decoder probes
    and a regula-falsi round instead of the seeded march (ops/cert.py, on
    K6); verify_band="probe" gives band rays of fine classes a 3-probe
    parabola of half-width proxy_band_w at their proxy min-SDF depth
    instead of the re-march, under either verify_mode (with "march", the
    hybrid). Demoted hits, promoted band rays and bucket overflow re-march
    seeded; certified and probed rays take 3 steps.
    verify_round_caps / verify_gen_caps: the verify stage's cap schedules
    (default: round_caps / queue_caps). proxy_verify=False skips the
    verify stage and returns the proxy's trace, whose depth, hit mask and
    margins carry the proxy's error: a cost-attribution option for the
    diagnostics (its time against the verified render's is the verify
    stage's cost), not a production mode.

    with_diag=True returns (StageResult, diag), diag a dict of straggler
    telemetry under the JAX package's keys, each a tensor on the render's
    device (gathered with no wait for the card): per coarse level
    ``coarse{stride}_block_residency`` and ``coarse{stride}_ray_steps``
    ([F, rays of the level]); the plan ``plan_key``, ``plan_width``,
    ``plan_seed`` ([F, N]); each rounds-scheduler round of the fine
    stage ``fine_r{i}_block_residency`` (none on the queue, as in the JAX
    package); under cert or probe ``cert_frac``, ``cert_demoted``,
    ``cert_promoted``, ``cert_band_probed``; and of the verify stage
    ``verify_fine_r{i}_block_residency`` and ``verify_key``. A residency
    is the steps of each 64-row tile of the march launch in its row order
    (``march_tile_steps``), what the card's tile pays: not comparable in
    size with the JAX package's 512-lane blocks. Telemetry changes no
    bit of the render.

    shared_origin marks a pinhole layout (one origin per frame); origins
    of shape [F, 1, 3] mean the same. warm: optional (depth, hitish,
    anchor, margin), each [F, H*W], from the previous optimizer
    iteration's trace: the classification comes from them
    (ops/c2f.py::warm_maps) and the coarse pyramid is skipped. ``packed``
    optionally carries pre-packed weights, (shared, shared_proxy_or_None),
    so a caller rendering many frames packs once. persistent=False
    marches every level and round on K1-multi (the same bits as K1).
    use_kernel=False runs every kernel's plain version (on any device).
    block only rounds the rounds scheduler's prefix widths, as in the JAX
    package; proxy_block and queue_dense_frac only steered the TPU's
    scheduling and have no effect."""
    from dist_renderer_tpu_torch.ops.c2f import (
        classify_pyramid, plan_from_maps, warm_maps,
    )
    from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march

    if verify_mode not in ("march", "cert"):
        raise ValueError(f"verify_mode must be 'march' or 'cert', got {verify_mode!r}")
    if verify_band not in ("march", "probe"):
        raise ValueError(f"verify_band must be 'march' or 'probe', got {verify_band!r}")
    if verify_hits not in ("march", "polish", "polish-all"):
        raise ValueError(f"verify_hits must be 'march', 'polish' or 'polish-all', "
                         f"got {verify_hits!r}")
    if verify_hits != "march" and (verify_mode != "march" or verify_band != "march"):
        raise ValueError(
            "verify_hits='polish' composes only with verify_mode='march' and "
            "verify_band='march' (the cert/probe paths decide hits in-trace, "
            "which 'polish' defers to the caller)")
    if scheduler not in ("rounds", "queue", "auto"):
        raise ValueError(f"scheduler must be 'rounds', 'queue' or 'auto', "
                         f"got {scheduler!r}")
    with annotate("drt.batch"):
        f = origins.shape[0]
        h, w = img_hw
        n = h * w
        count("rays", f * n)
        if scheduler == "auto":
            scheduler = "queue" if f == 1 else "rounds"

        if packed is None:
            packed = (pack_shared(params, dcfg),
                      None if proxy is None else pack_shared(*proxy))
        shared, shared_p = packed
        with annotate("drt.setup"):
            bank = fold_bias_bank(params, latents, dcfg, shared)
            if proxy is not None:
                shared_m = shared_p
                bank_m = fold_bias_bank(proxy[0], latents, proxy[1], shared_m)
            else:
                shared_m, bank_m = shared, bank
        coarse_march = dataclasses.replace(
            march, max_steps=min(march.max_steps, coarse_steps))
        o_full = origins.expand(f, n, 3)
        diag = {} if with_diag else None

        def trace_level(o_l, v_l, seed, active, stride):
            res = batched_trace_padded(shared_m, bank_m, o_l, v_l, coarse_march,
                                       seed, active, block, True, use_kernel,
                                       persistent)
            if with_diag:
                r_pad = res.steps_per_ray.shape[0] // f
                diag[f"coarse{stride}_block_residency"] = march_tile_steps(
                    res.steps_per_ray)
                diag[f"coarse{stride}_ray_steps"] = res.steps_per_ray.reshape(
                    f, r_pad)[:, :o_l.shape[1]]
            return res

        if warm is not None:
            with annotate("drt.plan.maps"):
                maps = warm_maps(*warm, img_hw, backoff)
        else:
            maps = classify_pyramid(
                trace_level, o_full.reshape(f, h, w, 3), dirs.reshape(f, h, w, 3),
                tuple(s for s in strides if h % s == 0 and w % s == 0), backoff)

        if maps is None:  # no valid strides: plain batched march
            with annotate("drt.fine"):
                res = batched_trace_padded(
                    shared, bank, o_full, dirs, march, None,
                    torch.ones((f, n), dtype=torch.bool, device=dirs.device),
                    block, True, use_kernel, persistent)
            r_pad = res.steps_per_ray.shape[0] // f
            out = StageResult(res.depth, res.hit, res.min_sdf, res.depth_at_min,
                              res.last_sdf,
                              res.steps_per_ray.reshape(f, r_pad)[:, :n],
                              res.unresolved)
            return (out, diag) if with_diag else out

        with annotate("drt.plan.maps"):
            key, init_depth, skip = plan_from_maps(maps)
        if with_diag:
            diag.update(plan_key=key, plan_width=maps.width.reshape(f, n),
                        plan_seed=maps.seed.reshape(f, n))
        o_in = origins[:, :1] if shared_origin else origins
        verify = proxy is not None and proxy_verify

        def fine_stage(sh, bk, key_s, seed_s, stage_diag=None, want_anchor=False,
                       want_steps=False, want_last=False, want_unres=False,
                       caps=None, qcaps=None) -> StageResult:
            """One scheduler pass; the queue fills every field for free and
            records no telemetry."""
            if scheduler == "queue":
                return queue_march(sh, bk, o_in, dirs, key_s, seed_s, march,
                                   gen_caps=qcaps or queue_caps,
                                   use_kernel=use_kernel)
            return fine_march_rounds(
                sh, bk, o_in, dirs, key_s, seed_s, march, block=block,
                round_caps=caps or round_caps, diag=stage_diag,
                live_frac=live_frac, return_anchor=want_anchor,
                return_steps=want_steps, return_last=want_last,
                return_unres=want_unres, difficulty_repack=difficulty_repack,
                use_kernel=use_kernel, persistent=persistent)

        # band probing and polish-all's weak candidates need the proxy's
        # min-SDF depth
        need_anchor = verify and (verify_band == "probe" or verify_hits == "polish-all")
        with annotate("drt.fine"):
            st = merge_skip(
                fine_stage(shared_m, bank_m, key, init_depth, diag,
                           want_anchor=return_anchor or need_anchor,
                           want_steps=return_steps, want_last=return_last,
                           want_unres=verify),
                skip, maps.anchor.reshape(f, n), maps.margin.reshape(f, n))
        if not verify:
            return (st, diag) if with_diag else st

        cert = None
        with annotate("drt.verify.plan"):
            if verify_mode == "cert" or verify_band == "probe":
                cert, key2, seed2 = cert_plan(
                    shared, bank, o_in, dirs, st, skip, march, proxy_band,
                    proxy_backoff, proxy_band_w, verify_mode, verify_band == "probe",
                    block, use_kernel, diag)
            else:
                key2, seed2 = verify_plan(st, proxy_band, proxy_backoff, verify_hits,
                                          skip)
        vdiag = {} if with_diag else None
        with annotate("drt.verify"):
            v2 = fine_stage(shared, bank, key2, seed2, vdiag, want_anchor=return_anchor,
                            want_steps=return_steps, want_last=return_last,
                            caps=verify_round_caps, qcaps=verify_gen_caps)
        if with_diag:
            diag.update({f"verify_{k}": v for k, v in vdiag.items()})
            diag["verify_key"] = key2
        with annotate("drt.verify.merge"):
            out = verify_merge(st, v2, key2, cert, verify_hits, proxy_band, skip)
        return (out, diag) if with_diag else out


def verify_merge(st: StageResult, v2: StageResult, key2, cert, verify_hits: str,
                 proxy_band: float, skip) -> StageResult:
    """The verify stage's result: the proxy stage's trace st with the
    re-marched rays (key2 != 2) taken from v2, under cert or probe the
    certification's values (merge_cert), and under "polish-all" its weak
    candidates."""
    act2 = key2 != 2
    if cert is not None:
        return merge_cert(st, v2, act2, *cert)
    # non-verified rays keep their incoming values: clear misses and skips
    # in march mode, and in polish modes the confident proxy hits too,
    # which must reach the caller's finalize
    pick = lambda a, b: (None if a is None or b is None
                         else torch.where(act2, a, b))
    out = StageResult(
        depth=pick(v2.depth, st.depth), hit=pick(v2.hit, st.hit),
        min_sdf=pick(v2.min_sdf, st.min_sdf),
        depth_at_min=pick(v2.depth_at_min, st.depth_at_min),
        steps=(None if v2.steps is None or st.steps is None
               else st.steps + torch.where(act2, v2.steps, 0)))
    if v2.last_sdf is not None and st.last_sdf is not None:
        out = out._replace(last_sdf=pick(v2.last_sdf, st.last_sdf),
                           unresolved=act2 & v2.unresolved)
    if verify_hits == "polish-all":
        weak = band_rays(st, proxy_band) & ~skip & ~out.hit
        out = out._replace(depth=torch.where(weak, st.depth_at_min, out.depth),
                           hit=out.hit | weak, weak=weak)
    return out


def cert_plan(shared, bank, o_in, dirs, st: StageResult, skip, march: MarchConfig,
              proxy_band: float, proxy_backoff: float, band_w: float,
              verify_mode: str, probe_band: bool, block: int, use_kernel: bool,
              diag: Optional[dict] = None):
    """The verify stage of verify_mode="cert" or verify_band="probe"
    (ops/cert.py on K6) -> ((CertResult, probed_miss), key2, seed2).
    verify_mode="march" with probe_band is the hybrid: an all-False
    hit set makes every proxy hit "demoted", i.e. re-marched seeded at
    (depth - backoff), the march mode's treatment. Only band rays of fine
    classes are probed: a skip-class ray's anchor comes from a coarse
    level, which places its dip only to a coarse cell, so skip band rays
    keep the entry-seeded re-march. Demoted and overflowing hits and
    promoted band rays re-march seeded (key 1); unresolved rays continue
    from their depth and band rays left to the march start at the sphere
    entry (key 0); every other ray is skipped (key 2). diag, if given,
    receives the counts: cert_frac (certified share of the proxy's
    resolved hits), cert_demoted, cert_promoted, cert_band_probed."""
    from dist_renderer_tpu_torch.ops import cert as cert_mod

    seeded = st.hit & ~st.unresolved
    band = band_rays(st, proxy_band)
    probeable = band & ~skip
    cert = cert_mod.certify_hits_batched(
        shared, bank, o_in, dirs, st.depth,
        seeded if verify_mode == "cert" else torch.zeros_like(seeded), march,
        delta=proxy_backoff, block=block,
        # band-only probing fits a tighter bucket: band rays are a few % of N
        bucket_frac=4 if verify_mode == "cert" else 8,
        band=probeable if probe_band else None,
        anchor=st.depth_at_min if probe_band else None, band_w=band_w,
        # the dip estimate carries up to ~2x the proxy's field error: promote
        # whatever lies within backoff (~ its error p99) of zero
        promote_eps=proxy_backoff, use_kernel=use_kernel)
    hit_over = cert.overflow & seeded
    demoted = seeded & ~cert.certified & ~hit_over
    if probe_band:
        band_over = cert.overflow & probeable
        probed_miss = probeable & ~band_over & ~cert.promoted
        band_march = band_over | (band & skip)
    else:
        probed_miss = torch.zeros_like(band)
        band_march = band
    refit = hit_over | demoted | cert.promoted
    if diag is not None:
        diag.update(
            cert_frac=cert.certified.sum() / seeded.sum().clamp(min=1),
            cert_demoted=demoted.sum(), cert_promoted=cert.promoted.sum(),
            cert_band_probed=probed_miss.sum())
    key2 = torch.where(refit, 1, torch.where(st.unresolved | band_march, 0, 2))
    nan = torch.full_like(st.depth, float("nan"))
    seed2 = torch.where(cert.promoted, cert.band_tmin - proxy_backoff,
                        torch.where(hit_over | demoted, st.depth - proxy_backoff,
                                    torch.where(st.unresolved, st.depth, nan)))
    return (cert, probed_miss), key2.to(torch.int32), seed2


def merge_cert(st: StageResult, v2: StageResult, act2, cert, probed_miss) -> StageResult:
    """The verify stage's result under cert/probe: re-marched rays take
    the march's values; certified hits the secant depth and the inside
    probe's value (alone: a proxy running minimum would keep proxy error
    on a full-decoder answer); probed band misses the dip estimate and its
    depth; both count 3 steps. No ray left out of the re-march is
    unresolved."""
    certified = cert.certified
    pick = lambda a, b, c, d: torch.where(act2, a, torch.where(certified, b, torch.where(
        probed_miss, c, d)))
    out = StageResult(
        depth=torch.where(act2, v2.depth, torch.where(certified, cert.depth, st.depth)),
        hit=torch.where(act2, v2.hit, certified),
        min_sdf=pick(v2.min_sdf, cert.f_inside, cert.band_margin, st.min_sdf))
    if st.depth_at_min is not None and v2.depth_at_min is not None:
        out = out._replace(depth_at_min=pick(v2.depth_at_min, cert.depth,
                                             cert.band_tmin, st.depth_at_min))
    if st.steps is not None and v2.steps is not None:
        probed = torch.where(certified | probed_miss, 3, 0).to(st.steps.dtype)
        out = out._replace(steps=st.steps + torch.where(act2, v2.steps, probed))
    if st.last_sdf is not None and v2.last_sdf is not None:
        out = out._replace(
            last_sdf=pick(v2.last_sdf, cert.f_inside, cert.band_margin, st.last_sdf),
            unresolved=act2 & v2.unresolved)
    return out


def merge_skip(st: StageResult, skip, anchor, margin) -> StageResult:
    """Skip-class rays never marched: their margin, anchor and last sample
    come from the coarse level, and they are not unresolved."""
    keep = lambda a, b: None if a is None else torch.where(skip, b, a)
    return st._replace(
        min_sdf=keep(st.min_sdf, margin),
        depth_at_min=keep(st.depth_at_min, anchor),
        last_sdf=keep(st.last_sdf, margin),
        unresolved=None if st.unresolved is None else st.unresolved & ~skip,
    )


def band_rays(st: StageResult, proxy_band: float) -> torch.Tensor:
    """Near-miss rays of a proxy stage: neither hit nor unresolved, with
    a margin under proxy_band."""
    return ~(st.hit | st.unresolved) & (st.min_sdf < proxy_band)


def verify_plan(st: StageResult, proxy_band: float, proxy_backoff: float,
                verify_hits: str = "march", skip=None):
    """The verify stage's (key, seed) from a proxy stage result. "march":
    proxy hits re-march seeded at (depth - backoff), a ~2-evaluation
    confirmation (key 1); unresolved rays continue from their depth and
    near-miss band rays restart at the sphere entry (key 0); clear misses
    are skipped (key 2). "polish": band and unresolved rays only.
    "polish-all": unresolved rays and band rays of the skip class (whose
    coarse anchor localizes their dip only to a coarse cell) only."""
    band = band_rays(st, proxy_band)
    nan = torch.full_like(st.depth, float("nan"))
    cont = torch.where(st.unresolved, st.depth, nan)
    if verify_hits == "polish":
        key = torch.where(st.unresolved | band, 0, 2)
        return key.to(torch.int32), cont
    if verify_hits == "polish-all":
        key = torch.where(st.unresolved | (band & skip), 0, 2)
        return key.to(torch.int32), cont
    seeded = st.hit & ~st.unresolved
    key = torch.where(seeded, 1, torch.where(st.hit | st.unresolved | band, 0, 2))
    return key.to(torch.int32), torch.where(seeded, st.depth - proxy_backoff, cont)
