"""Does a launch's cost grow with a kernel's loop trips, do two launches
cost twice one, do the work-queue's building blocks run, and where does
a single-frame render's time go: the counterpart of
scripts/diag_launch2.py.

  1. P6, the bare scalar while at 0, 1, 64, 1024 and 16384 trips: host
     us eager and device us in a CUDA graph per launch;
  2. P6 twice in one graph against once;
  3. P7, a while over an [8, 512] carry, at 0 and 8 trips;
  4. P8, an fp32 product [24, 512] x [1024, 512]^T on CUDA cores with a
     one-hot "even lanes to the front" matrix (exact);
  5. P9, a lane roll of [24, 1024] by -512 (512 on 1024 lanes);
  6. P10, the log-shift prefix sum of [1, 512];
  7. the sorts of a frame (a stable torch.sort of [1, N] int32 keys and
     the gather of 10 payloads; the same at N / 3);
  8. a frame of render_batched_c2f split: the two coarse levels alone
     (batched_trace_padded at strides 16 and 4, 16 steps), then the full
     forward at F = 1, without and with the anchor, steps and last
     payloads.

    python -m dist_renderer_tpu_torch.diag.diag_launch2 [--quick]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from dist_renderer_tpu_torch.diag import (
    N, check_close, check_equal, device, emit, kernel_row, launch_row,
)
from dist_renderer_tpu_torch.ops.kernels import probes as pk
from dist_renderer_tpu_torch.utils.profiling import PEAK_FP32, cuda_ms, graph_us, per_call_ms

SRC_L = "dist_renderer_tpu_torch/csrc/probe_launch.cu"
SRC_B = "dist_renderer_tpu_torch/csrc/probe_blocks.cu"
TPU = "scripts/diag_launch2.py"
TRIPS = (0, 1, 64, 1024, 16384)
# f32dot against its plain version (the card's fp32 GEMM) on seeded x, m
# in [-1, 1]: fp32 sums of 512 terms in another order. Measured on an
# NVIDIA H100 80GB HBM3 at 700 W: max |diff| 2.9e-5 with the first
# kernel's mul and add, 2.7e-5 with its fmaf chains. Bar: 1e-4. (scan's
# adds are the TPU kernel's own: bit for bit.)
DOT_BAR = 1e-4


def script_inputs(dev):
    """The TPU script's x [24, 512] iota, one-hot m [1024, 512] (even
    lanes to the front), xr [24, 1024] iota and xs [1, 512] (1 at every
    third lane)."""
    x = torch.arange(24 * 512, dtype=torch.float32).reshape(24, 512)
    ar = torch.arange(512)
    pos = torch.where(ar % 2 == 0, ar // 2, 10 ** 6)
    m = (torch.arange(1024)[:, None] == pos[None, :]).to(torch.float32)
    xr = torch.arange(24 * 1024, dtype=torch.float32).reshape(24, 1024)
    xs = (ar % 3 == 0).to(torch.float32)[None]
    return x.to(dev), m.to(dev), xr.to(dev), xs.to(dev)


def seeded(dev, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((24, 512), generator=g) * 2 - 1
    m = torch.rand((1024, 512), generator=g) * 2 - 1
    s = torch.rand((1, 512), generator=g) * 2 - 1
    return x.to(dev), m.to(dev), s.to(dev)


def check(dev) -> list:
    """P6-P10 against their plain versions, with their kernel rows (P6 at
    every count of the trip sweep)."""
    x, m, xr, xs = script_inputs(dev)
    gx, gm, gs = seeded(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = []
    t64 = torch.tensor([64], **i32)
    for trips in TRIPS:
        t = torch.tensor([trips], **i32)
        err = check_equal(f"P6 x{trips}", pk.scalar_while(t, zeros=True),
                          pk.scalar_while_plain(t, zeros=True))
    # one torch.zeros computes P6's function: its output is zeros at any
    # count, and its loop leaves nothing the caller can see
    zeros = lambda: torch.zeros(pk.ZEROS_SHAPE, device=dev)
    check_equal("P6 (one torch.zeros)", zeros(), pk.scalar_while(t64, zeros=True))
    rows.append(kernel_row("P6", pk.scalar_while, SRC_L, f"{TPU}:65", err,
                           lambda: pk.scalar_while(t64, zeros=True),
                           lambda: pk.scalar_while_plain(t64, zeros=True), zeros,
                           nbytes=4 + 4 * 8 * 128, graphs=True))
    t8 = torch.tensor([8], **i32)
    for trips in (0, 1, 8, 1 << 20):
        t = torch.tensor([trips], **i32)
        err = check_equal(f"P7 x{trips}", pk.vec_while(t), pk.vec_while_plain(t))
    # one torch add computes P7's function: the zero carry plus the trips
    z8 = torch.zeros((8, 512), dtype=torch.float32, device=dev)
    check_equal("P7 (one torch add)", torch.add(z8, t8), pk.vec_while(t8))
    rows.append(kernel_row("P7", pk.vec_while, SRC_L, f"{TPU}:119", err,
                           lambda: pk.vec_while(t8), lambda: pk.vec_while_plain(t8),
                           lambda: torch.add(z8, t8), nbytes=4 + 4 * 8 * 512, graphs=True))
    got = pk.f32dot(x, m)
    check_equal("P8 (one-hot)", got, pk.f32dot_plain(x, m))
    check_equal("P8 (the script's check)", got[:, :256], x[:, ::2])
    err = check_close("P8", pk.f32dot(gx, gm), pk.f32dot_plain(gx, gm), DOT_BAR)
    rows.append(kernel_row("P8", pk.f32dot, SRC_B, f"{TPU}:142", err,
                           lambda: pk.f32dot(x, m), lambda: pk.f32dot_plain(x, m),
                           lambda: torch.matmul(x, m.T),
                           nbytes=x.nbytes + m.nbytes + 24 * 1024 * 4,
                           ops=2 * 24 * 1024 * 512, peak=PEAK_FP32,
                           graphs=True))
    got = pk.roll_lanes(xr, -512)
    err = check_equal("P9", got, pk.roll_lanes_plain(xr, -512))
    check_equal("P9 (the script's check)", got[:, :512], xr[:, 512:])
    check_equal("P9 (shift 3)", pk.roll_lanes(xr, 3), pk.roll_lanes_plain(xr, 3))
    rows.append(kernel_row("P9", pk.roll_lanes, SRC_B, f"{TPU}:171", err,
                           lambda: pk.roll_lanes(xr, -512),
                           lambda: pk.roll_lanes_plain(xr, -512),
                           lambda: torch.roll(xr, -512, 1), nbytes=2 * xr.nbytes,
                           graphs=True))
    got = pk.scan(xs)
    err = check_equal("P10", got, pk.scan_plain(xs))
    check_equal("P10 (the script's check)", got, torch.cumsum(xs, 1))
    check_equal("P10 (seeded)", pk.scan(gs), pk.scan_plain(gs))
    rows.append(kernel_row("P10", pk.scan, SRC_B, f"{TPU}:189", err,
                           lambda: pk.scan(xs), lambda: pk.scan_plain(xs),
                           lambda: torch.cumsum(xs, 1), nbytes=2 * xs.nbytes,
                           graphs=True))
    return rows


def render_split(dev, reps: int = 3) -> dict:
    """A frame of render_batched_c2f at F = 1 on the bench decoder (no
    proxy, bench.py's march): the coarse levels alone, then the forward
    without and with the extra payloads; CUDA events, median of reps."""
    from dist_renderer_tpu_torch.config import MarchConfig
    from dist_renderer_tpu_torch.diag.diag_launch_cost import bench_decoder
    from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm

    params, dcfg, latent = bench_decoder(dev)
    img = 512
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img),
                            device=dev)
    o, v = pixel_rays(cam, img, img)
    march = MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                        coarse_to_fine=True, c2f_strides=(16, 4), c2f_coarse_steps=16)
    shared = bm.pack_shared(params, dcfg)
    bank = bm.fold_bias_bank(params, latent[None], dcfg, shared)
    coarse16 = dataclasses.replace(march, max_steps=16)
    og, vg = o.reshape(1, img, img, 3), v.reshape(1, img, img, 3)

    def coarse_only():
        out = []
        for s in (16, 4):
            o_l = og[:, ::s, ::s].reshape(1, -1, 3)
            v_l = vg[:, ::s, ::s].reshape(1, -1, 3)
            act = torch.ones((1, o_l.shape[1]), dtype=torch.bool, device=dev)
            out.append(bm.batched_trace_padded(shared, bank, o_l, v_l, coarse16, None,
                                               act, 512, True).depth)
        return out

    lat, ob, vb = latent[None], o[None, :1], v[None]
    full = lambda **kw: bm.render_batched_c2f(params, dcfg, lat, ob, vb, (img, img), march,
                                              shared_origin=True, **kw)
    with torch.no_grad():
        return dict(
            coarse_levels_ms=cuda_ms(coarse_only, reps),
            fwd_ms=cuda_ms(full, reps),
            fwd_payloads_ms=cuda_ms(lambda: full(return_anchor=True, return_steps=True,
                                                 return_last=True), reps))


def measure(dev, n: int = 200, quick: bool = False) -> dict:
    x, m, xr, xs = script_inputs(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = {"launches": n}
    sweep = {}
    for trips in TRIPS:
        t = torch.tensor([trips], **i32)
        sweep[trips] = launch_row(lambda t=t: pk.scalar_while(t, zeros=True), n)
    out["scalar_while_trips"] = sweep
    t0 = torch.tensor([0], **i32)
    one = lambda: pk.scalar_while(t0, zeros=True)
    out["two_in_one_graph_us"] = graph_us(lambda: (one(), one()), n)
    out["one_in_graph_us"] = graph_us(one, n)
    out["vec_while"] = {trips: launch_row(
        lambda t=torch.tensor([trips], **i32): pk.vec_while(t), n) for trips in (0, 8)}
    out["f32dot"] = launch_row(lambda: pk.f32dot(x, m), n)
    out["roll"] = launch_row(lambda: pk.roll_lanes(xr, -512), n)
    out["cumsum"] = launch_row(lambda: pk.scan(xs), n)
    if quick:
        return out
    sorts = {}
    for size in (N, N // 3):
        k = torch.zeros((1, size), **i32)
        pays = [torch.zeros((1, size), dtype=torch.float32, device=dev) for _ in range(10)]

        def sort_and_gather(k=k, pays=pays):
            _, perm = torch.sort(k, dim=1, stable=True)
            return [torch.gather(p, 1, perm) for p in pays]

        sorts[f"sort [1,{size}] + 10 payloads"] = per_call_ms(sort_and_gather, 5)
    out["sort_ms"] = sorts
    out["render_split"] = render_split(dev)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    dev = device()
    rows = check(dev)
    emit("diag_launch2", dict(
        kernels=[{k: v for k, v in r.items() if k != "kernel"} for r in rows],
        **measure(dev, quick=args.quick)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
