"""Multi-frame march: shared weights + a per-frame bias bank, the
persistent march kernel (K1) and the coarse-to-fine pipeline that drives
it (``render_batched_c2f``).

After latent folding the decoder's big weight matrices are latent-
independent: frames differ only in the per-layer bias vectors
(b + z @ W_z). So one launch marches rays of many frames against shared
weights, each ray reading its frame's column of the bias bank.

K1, ``sphere_trace_persistent``, replaces the JAX package's
``ops/pallas/batched_march.py::pallas_sphere_trace_persistent``
(``_make_persistent_kernel``). On a CUDA tensor it launches
``csrc/batched_march.cu``; on a CPU tensor, or with ``use_kernel=False``,
it runs the plain version (``march_rows_plain``, built on
``march_body.march_loop``).
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
from dist_renderer_tpu_torch.ops.kernels.march_body import (
    POS_BIG, make_carry, march_loop, mlp_apply, rows_from_carry,
)
from dist_renderer_tpu_torch.ops.tracer import TraceResult, live_counts_from_steps

FRAME_TILE = 128  # bias-bank frame padding (the JAX package's layout)
TILE = 32         # rays per CUDA thread block; frames pad to a multiple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SharedDecoder(NamedTuple):
    """Latent-independent weights + static bias layout.

    whT/wxT/offsets/total/final_tanh match the JAX package's SharedDecoder
    ([out_p, in_p] / [out_p, 8] bf16). ``flat`` and ``table`` are the CUDA
    kernels' layout: every weight in one bf16 buffer, input-major
    ([in_p][out_p], x rows [3][out_p]) so a thread reads 8 consecutive
    outputs with one 16-byte load; ``table`` holds per layer
    (out_p, in_p, wh offset, wx offset, bias row offset), -1 = absent."""

    whT: Tuple[Optional[torch.Tensor], ...]
    wxT: Tuple[Optional[torch.Tensor], ...]
    offsets: Tuple[Tuple[int, int], ...]
    total: int
    final_tanh: bool
    flat: torch.Tensor
    table: Tuple[int, ...]


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
                    rs: RaySetup, march: MarchConfig,
                    salvage: bool) -> torch.Tensor:
    """K1 on the card: one launch marches every ray -> [8, N] rows."""
    n = origins.shape[0]
    rays = pack_rays(origins, dirs, rs)
    check_cuda_inputs(shared, bank, rays)
    out = torch.empty((8, n), dtype=torch.float32, device=rays.device)
    lib = build.load()
    lib.call("drt_sphere_trace_persistent", build.ptr(rays), n, rays_per_frame,
             *march_args(shared, bank), march.convergence_eps,
             march.depth_eps, march.alpha, march.far_margin, march.max_steps,
             int(salvage), build.ptr(out), build.stream_of(rays))
    sphere_trace_persistent.launches += 1
    return out


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
    rpf = origins.shape[0] if rays_per_frame is None else rays_per_frame
    rs = ray_setup(origins, dirs, march, init_depth, init_active)
    if use_kernel and origins.is_cuda:
        out = march_rows_cuda(shared, bias_bank, rpf, origins, dirs, rs,
                              march, salvage)
    else:
        out = march_rows_plain(shared, bias_bank, frame_of_ray, origins, dirs,
                               rs, march, salvage, rpf >= origins.shape[0])
    return trace_from_rows(out, rs, origins, dirs, march)


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


sphere_trace_persistent.launches = 0


def pad_frames(o, v, seed, active):
    """[F, R, *] -> flat frame-major [F * r_pad, *] with each frame padded
    to a multiple of the CUDA tile (pad rays point along +1 and never
    march). Returns (o, v, seed, active, frame_of_ray, r_pad)."""
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
) -> TraceResult:
    """Frame-major multi-frame trace (K1); per-ray fields come back
    [F, R]. steps_per_ray stays in the padded flat layout. use_kernel=False
    runs the plain version on any device."""
    f, r = o.shape[0], o.shape[1]
    o_p, v_p, s_p, a_p, frame_of_ray, r_pad = pad_frames(o, v, seed, active)
    res = sphere_trace_persistent(shared, bank, frame_of_ray, o_p, v_p, march,
                                  s_p, init_active=a_p, block=block,
                                  salvage=salvage, rays_per_frame=r_pad,
                                  use_kernel=use_kernel)
    unflat = lambda x: x.reshape(f, r_pad)[:, :r]
    return TraceResult(
        depth=unflat(res.depth), hit=unflat(res.hit),
        min_sdf=unflat(res.min_sdf), depth_at_min=unflat(res.depth_at_min),
        last_sdf=unflat(res.last_sdf), steps_used=res.steps_used,
        live_counts=res.live_counts, unresolved=unflat(res.unresolved),
        steps_per_ray=res.steps_per_ray, bracketed=unflat(res.bracketed),
    )


class StageResult(NamedTuple):
    """One scheduler pass, every field [F, N] in pixel order."""

    depth: torch.Tensor
    hit: torch.Tensor
    min_sdf: torch.Tensor
    depth_at_min: torch.Tensor
    last_sdf: torch.Tensor
    steps: torch.Tensor
    unresolved: torch.Tensor


def not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


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
    scheduler: str = "auto",
    queue_caps: Tuple[int, ...] = (6, 16),
    queue_dense_frac: float = 0.5,
    warm=None,
    proxy: Optional[Tuple[Params, DecoderConfig]] = None,
    proxy_backoff: float = 0.015,
    proxy_band: float = 0.02,
    proxy_block: Optional[int] = None,
    verify_mode: str = "march",
    verify_band: str = "march",
    verify_hits: str = "march",
    verify_gen_caps: Optional[Tuple[int, ...]] = None,
    use_kernel: bool = True,
    packed=None,
) -> StageResult:
    """Coarse-to-fine classified render of F frames: coarse levels (K1),
    classification (ops/c2f.py), the fine march (K2 work queue) and, with
    a proxy, the full-decoder verify march (K2 again).

    With ``proxy`` the pyramid and the fine march run on the distilled
    proxy decoder and a verify stage re-marches the full decoder:
    proxy-hit rays seeded at (proxy depth - proxy_backoff), near-miss band
    rays (margin < proxy_band) and unresolved rays from the sphere entry
    (unresolved rays continue from their proxy depth); clear misses keep
    the proxy's values. Depth and the hit mask are then full-decoder
    march results.

    use_kernel=False runs every kernel's plain version (on any device).
    ``packed`` optionally carries pre-packed weights,
    ((shared, shared_proxy_or_None)), so a caller rendering many frames
    packs once. block / proxy_block / queue_dense_frac only steered the
    TPU's scheduling and have no effect.

    warm: optional (depth, hitish, anchor, margin), each [F, H*W], from
    the previous optimizer iteration's trace: the classification comes
    from them (ops/c2f.py::warm_maps) and the coarse pyramid is skipped.

    The port runs the queue scheduler with verify_mode="march",
    verify_band="march" and verify_hits="march"; the other modes and the
    rounds scheduler raise NotImplementedError."""
    from dist_renderer_tpu_torch.ops.c2f import (
        classify_pyramid, plan_from_maps, warm_maps,
    )
    from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march

    if verify_mode != "march" or verify_band != "march":
        not_ported(f"verify_mode={verify_mode!r}/verify_band={verify_band!r}",
                    "A8 (ops/cert.py)")
    if verify_hits != "march":
        not_ported(f"verify_hits={verify_hits!r}", "A9")
    f = origins.shape[0]
    h, w = img_hw
    n = h * w
    if scheduler == "auto":
        scheduler = "queue" if f == 1 else "rounds"
    if scheduler != "queue":
        not_ported(f"the {scheduler!r} fine-march scheduler",
                    "B (rounds scheduler, F=64 batched)")

    if packed is None:
        packed = (pack_shared(params, dcfg),
                  None if proxy is None else pack_shared(*proxy))
    shared, shared_p = packed
    bank = fold_bias_bank(params, latents, dcfg, shared)
    if proxy is not None:
        shared_m = shared_p
        bank_m = fold_bias_bank(proxy[0], latents, proxy[1], shared_m)
    else:
        shared_m, bank_m = shared, bank
    coarse_march = dataclasses.replace(
        march, max_steps=min(march.max_steps, coarse_steps))
    o_full = origins.expand(f, n, 3)

    def trace_level(o_l, v_l, seed, active, stride):
        return batched_trace_padded(shared_m, bank_m, o_l, v_l, coarse_march,
                                    seed, active, block, True, use_kernel)

    if warm is not None:
        maps = warm_maps(*warm, img_hw, backoff)
    else:
        maps = classify_pyramid(
            trace_level, o_full.reshape(f, h, w, 3), dirs.reshape(f, h, w, 3),
            tuple(s for s in strides if h % s == 0 and w % s == 0), backoff)

    if maps is None:  # no valid strides: plain batched march
        res = batched_trace_padded(
            shared, bank, o_full, dirs, march, None,
            torch.ones((f, n), dtype=torch.bool, device=dirs.device),
            block, True, use_kernel)
        r_pad = res.steps_per_ray.shape[0] // f
        return StageResult(res.depth, res.hit, res.min_sdf, res.depth_at_min,
                           res.last_sdf,
                           res.steps_per_ray.reshape(f, r_pad)[:, :n],
                           res.unresolved)

    key, init_depth, skip = plan_from_maps(maps)

    st = merge_skip(
        queue_march(shared_m, bank_m, o_full, dirs, key, init_depth, march,
                    gen_caps=queue_caps, use_kernel=use_kernel),
        skip, maps.anchor.reshape(f, n), maps.margin.reshape(f, n))
    if proxy is None:
        return st
    key2, seed2 = verify_plan(st, proxy_band, proxy_backoff)
    v2 = queue_march(shared, bank, o_full, dirs, key2, seed2, march,
                     gen_caps=verify_gen_caps or queue_caps,
                     use_kernel=use_kernel)
    act2 = key2 != 2
    # non-verified rays (clear misses, skips) keep their proxy values
    pick = lambda a, b: torch.where(act2, a, b)
    return StageResult(
        depth=pick(v2.depth, st.depth), hit=pick(v2.hit, st.hit),
        min_sdf=pick(v2.min_sdf, st.min_sdf),
        depth_at_min=pick(v2.depth_at_min, st.depth_at_min),
        last_sdf=pick(v2.last_sdf, st.last_sdf),
        steps=st.steps + pick(v2.steps, torch.zeros_like(st.steps)),
        unresolved=pick(v2.unresolved, torch.zeros_like(st.unresolved)),
    )


def merge_skip(st: StageResult, skip, anchor, margin) -> StageResult:
    """Skip-class rays never marched: their margin, anchor and last sample
    come from the coarse level, and they are not unresolved."""
    return st._replace(
        min_sdf=torch.where(skip, margin, st.min_sdf),
        depth_at_min=torch.where(skip, anchor, st.depth_at_min),
        last_sdf=torch.where(skip, margin, st.last_sdf),
        unresolved=st.unresolved & ~skip,
    )


def verify_plan(st: StageResult, proxy_band: float, proxy_backoff: float):
    """The verify stage's (key, seed) from a proxy stage result: proxy hits
    re-march seeded at (depth - backoff), a ~2-evaluation confirmation
    (key 1); unresolved rays continue from their depth and near-miss band
    rays restart at the sphere entry (key 0); clear misses are skipped."""
    hitish = st.hit | st.unresolved
    seeded = st.hit & ~st.unresolved
    band = (~hitish) & (st.min_sdf < proxy_band)
    key = torch.where(seeded, 1, torch.where(hitish | band, 0, 2)).to(torch.int32)
    nan = torch.full_like(st.depth, float("nan"))
    seed = torch.where(seeded, st.depth - proxy_backoff,
                       torch.where(st.unresolved, st.depth, nan))
    return key, seed

