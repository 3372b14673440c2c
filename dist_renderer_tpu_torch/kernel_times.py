"""Times of the port's hand-written kernels on one CUDA card, at fixed
inputs, for comparing two trees of the repo in one call:

    python dist_renderer_tpu_torch/kernel_times.py [--root TREE] [--out FILE]

``--root`` (run it as a file, as above, for this) imports
``dist_renderer_tpu_torch`` and builds its kernels from another checkout
of the repo, e.g. an unpacked parent commit, so parent and change run the
same inputs: run parent, change, change, parent and compare within the
call.

Inputs (the committed bench fixture; seeded):
  - K5: 262,144 points uniform in [-1, 1]^3, the bench 8x512 decoder at
    its latent, one output row (chip_smoke.py phase 9's);
  - K6: the certification probes of the batched cert step at F=4 frames
    of 512x512 (chip_smoke.py phase 3's K6 row), the first K6 call;
  - K1 and K1-multi: 4 frames of 256x256 rays from the bench camera
    against the 4x256 proxy, 16 steps from the bounding sphere (a
    coarse level's work); and "K1 verify", "K1-multi verify": the first
    verify round of the batched headline at F=64 (chip_smoke.py phase
    8's: the 8x512 decoder, the rays the rounds scheduler gives it, cap 2);
  - K2: one 512x512 frame against the proxy, 50 steps, every ray live;
    "K2 (verify)": the 8x512 bench decoder at the same frame's latent on
    the rays that march leaves to verify (``verify_plan`` of its result:
    its hits backed off the proxy's margin, its band and unresolved rays),
    the verify stage's work on the bench cell;
  - K1-grid: one 256x256 frame against the folded proxy, 50 steps;
  - K3 and K4 (a): chip_smoke.py phase 3's shapes, the bench 8x512
    decoder at its latent on 65,536 points, the compose bucket's count.
    The points are seeded, the first 65,536 of K5's, not the bucket's
    anchors rebuilt from a march: a launch's time follows the count and
    not where the points lie, up to its near ties. Seeded unit directions
    (K3) and cotangents (K4); K3 (b) and K4 (b) on K5's 262,144 points
    (the lazy margin's width: its backward runs K3, then K4, on every
    anchor), K4 (c) with 3 seed rows and the xyz gradient; "K3 value"
    (K3's value mode, a tree that has it) on the first 184,320 of K5's
    points (the misses of a served request whose hits overflow the
    compose bucket);
  - the loop probes at their scripts' operands (diag_launch_cost's,
    diag_launch2's and diag_launch3's zero operands, the bench decoder's
    march plan as P3's and P4's scratch): P3, P5, P11, P12, P13 at
    n_live 0, P4 and P14 at n_live 0 and 512 ("P4 x512", "P14 x512"),
    P6 at 64 trips and 16,384 ("P6 x16384"), and "P6 library" (P5's
    and P6's function, their [8, 128] zeros, by one ``torch.zeros``);
  - the probes P7 (vec_while at 8 trips, diag_launch2's), P8 (f32dot,
    diag_launch2's [24, 512] x [1024, 512]^T), P9 (roll_lanes of its
    [24, 1024] by -512), P10 (scan of its [1, 512] fp32 row), P16 (scan
    of diag_launch3's [1, 512] bf16 row), P17 and P22 (compact of
    diag_launch4's d24, pos, surv: fp32 and int positions), P15 (dma_loop at one trip,
    diag_launch3's seeded [16, 262144] rays), P18 and P19 (copy, add_one
    of diag_launch4's seeded [8, 512] x), P20 and P21 (small_mm plain and
    looped one trip, that x times a seeded [512, 512] w), and "P7
    library", "P8 library", "P9 library", "P10 library", "P16 library",
    "P15 library", "P18 library", "P19 library", "P20 library" (the
    PyTorch call computing each function: ``torch.add(z8, t8)`` of an [8,
    512] zero carry and the count, ``torch.matmul``, ``torch.roll``,
    ``torch.cumsum`` (P16's into fp32), a torch add into the output's first 512 columns,
    ``clone()``, ``x + 1.0``, ``torch.mm(..., out_dtype=float32)``), and
    "P17 zeros" (``torch.zeros`` of compact's [24, 1024] output, a memset:
    no PyTorch call computes a compaction with its zero fill): a launch's
    device time inside a CUDA graph of 200 (``graph_us``), in ms;
  - the MLP chains P23 (bf16) and P24 (int8) at ``diag_int8``'s defaults
    (its seeded inputs: 8 layers of 512 x 512, 32 steps, 32,768 columns),
    and "P23 library", "P24 library" (a bf16 ``torch.matmul``, a
    ``torch._int_mm`` a layer).
Each other: CUDA events around the wrapper, median of 3 after a warm-up
(``utils/profiling.py``'s ``cuda_ms``, imported from the tree timed: a
``--root`` tree needs that module).
``--only K3,K4`` times just the entries whose names start so (K3's
three and K4's three: "K4" also takes "K4 (a)" .. "K4 (c)"). Prints one JSON
object, {name: ms}, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package is timed")
    ap.add_argument("--out", help="JSON file for the numbers")
    ap.add_argument("--only", help="comma-separated name prefixes to time")
    args = ap.parse_args(argv)
    only = tuple(args.only.split(",")) if args.only else ("",)
    want = lambda *names: any(n.startswith(o) for n in names for o in only)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from dist_renderer_tpu_torch.config import DecoderConfig
    from dist_renderer_tpu_torch.models.folded import fold_latent
    from dist_renderer_tpu_torch.models.pretrain import load_params_npz
    from dist_renderer_tpu_torch.models.proxy import load_proxy_npz
    from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels import fused_march as fm
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval
    from dist_renderer_tpu_torch.ops.kernels import recompute as rc
    from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march
    from dist_renderer_tpu_torch.profile_render import batched_setup, bench_setup
    from dist_renderer_tpu_torch.utils.profiling import cuda_ms, graph_us

    import dist_renderer_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(root):
        print(f"kernel_times: imported {pkg.__file__}, not from {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    times = {}
    with torch.no_grad():
        if any(o == "" or o.startswith("P") for o in only):
            from dist_renderer_tpu_torch.diag import diag_launch2, diag_launch4
            from dist_renderer_tpu_torch.ops.kernels import probes

            from dist_renderer_tpu_torch.diag.diag_launch3 import tri_inputs

            x, m, xr, xs = diag_launch2.script_inputs(dev)
            xb = tri_inputs(dev)[0]
            d24, pos, surv = diag_launch4.compaction_inputs(dev)
            xm, w = diag_launch4.mm_inputs(dev)
            g = torch.Generator().manual_seed(0)
            rays = (torch.rand((16, 512 * 512), generator=g) * 2 - 1).to(dev)
            d1 = torch.zeros((8, 512 * 512), dtype=torch.float32, device=dev)
            t1 = torch.ones(1, dtype=torch.int32, device=dev)
            t8 = torch.full((1,), 8, dtype=torch.int32, device=dev)
            z8 = torch.zeros((8, 512), dtype=torch.float32, device=dev)
            graphed = {
                "P7": lambda: probes.vec_while(t8),
                "P7 library": lambda: torch.add(z8, t8),
                "P8": lambda: probes.f32dot(x, m),
                "P8 library": lambda: torch.matmul(x, m.T),
                "P9": lambda: probes.roll_lanes(xr, -512),
                "P9 library": lambda: torch.roll(xr, -512, 1),
                "P10": lambda: probes.scan(xs),
                "P10 library": lambda: torch.cumsum(xs, 1),
                "P16": lambda: probes.scan(xb),
                "P16 library": lambda: torch.cumsum(xb, 1, dtype=torch.float32),
                "P17": lambda: probes.compact(d24, pos, surv),
                "P17 zeros": lambda: torch.zeros((24, 1024), device=dev),
                "P22": lambda: probes.compact(d24, pos, surv, int_pos=True),
                "P15": lambda: probes.dma_loop(t1, rays, d1),
                "P15 library": lambda: torch.add(rays[:8, :512], 1.0, out=d1[:, :512]),
                "P18": lambda: probes.copy(xm),
                "P18 library": lambda: xm.clone(),
                "P19": lambda: probes.add_one(xm),
                "P19 library": lambda: xm + 1.0,
                "P20": lambda: probes.small_mm(xm, w),
                "P21": lambda: probes.small_mm(xm, w, True),
                "P20 library": lambda: torch.mm(xm.to(torch.bfloat16), w,
                                                out_dtype=torch.float32),
            }
            if want("P3", "P4", "P5", "P6", "P11", "P12", "P13", "P14"):
                from dist_renderer_tpu_torch.diag import Operands, diag_launch3
                from dist_renderer_tpu_torch.diag.diag_launch_cost import (
                    bench_decoder, probe_calls,
                )
                from dist_renderer_tpu_torch.ops.kernels.mlp_eval import mma_smem_bytes

                params, dcfg, _ = bench_decoder(dev)
                shared = bm.pack_shared(params, dcfg)
                calls = {**probe_calls(mma_smem_bytes(shared, march=True)),
                         **diag_launch3.ladder()}
                o0 = Operands(dev, shared.total)
                o512 = Operands(dev, shared.total, n_live=512)
                t64 = torch.full((1,), 64, dtype=torch.int32, device=dev)
                t16k = torch.full((1,), 16384, dtype=torch.int32, device=dev)
                for pid in ("P3", "P4", "P5", "P11", "P12", "P13", "P14"):
                    graphed[pid] = lambda run=calls[pid][0]: run(o0)
                for pid in ("P4", "P14"):
                    graphed[f"{pid} x512"] = lambda run=calls[pid][0]: run(o512)
                graphed["P6"] = lambda: probes.scalar_while(t64, zeros=True)
                graphed["P6 x16384"] = lambda: probes.scalar_while(t16k, zeros=True)
                graphed["P6 library"] = lambda: torch.zeros(probes.ZEROS_SHAPE, device=dev)
            for name, fn in graphed.items():
                if want(name):
                    times[name] = graph_us(fn) / 1e3
        if want("P23", "P24"):
            from dist_renderer_tpu_torch.diag import diag_int8
            from dist_renderer_tpu_torch.ops.kernels import mlp_chain as mc

            xc, wb, wi = diag_int8.inputs(dev, 8, 512, 32_768)
            chains = {
                "P23": lambda: mc.chain_bf16(xc, wb, 32),
                "P23 library": lambda: mc.chain_bf16_library(xc, wb, 32),
                "P24": lambda: mc.chain_int8(xc, wi, 32),
                "P24 library": lambda: mc.chain_int8_library(xc, wi, 32),
            }
            for name, fn in chains.items():
                if want(name):
                    times[name] = cuda_ms(fn)
        if all(o.startswith("P") for o in only):
            return _report(times, root, smi, args.out)
        params, latent = load_params_npz(os.path.join(root, ".bench_decoder.npz"), dev)
        dcfg = DecoderConfig()
        packed = fm.pack_folded(fold_latent(params, latent, dcfg), dcfg)
        pts = torch.as_tensor(np.random.default_rng(0).uniform(-1.0, 1.0, (262_144, 3)),
                              dtype=torch.float32, device=dev)
        if want("K5"):
            times["K5"] = cuda_ms(lambda: mlp_eval.point_eval(packed, pts))

        pk = rc.pack_precise(params, dcfg)
        bs = rc.fold_bias_precise(params, latent, dcfg, pk)
        rng = np.random.default_rng(2)
        seeded = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                                dtype=torch.float32, device=dev)
        p3 = pts[:65_536].contiguous()
        v3 = torch.nn.functional.normalize(seeded(65_536, 3), dim=-1)
        ct1, ct_b, ct3 = seeded(65_536), seeded(pts.shape[0]), seeded(65_536, 3)
        v_b = torch.nn.functional.normalize(seeded(pts.shape[0], 3), dim=-1)
        precise = {
            "K3": lambda: rc.precise_sdg_call(pk, bs, p3, v3),
            "K3 (b)": lambda: rc.precise_sdg_call(pk, bs, pts, v_b),
        }
        if hasattr(rc, "precise_value_call"):
            p_v = pts[:184_320].contiguous()
            precise["K3 value"] = lambda: rc.precise_value_call(pk, bs, p_v)
        precise |= {
            "K4 (a)": lambda: rc.precise_bias_grads_call(pk, bs, p3, ct1),
            "K4 (b)": lambda: rc.precise_bias_grads_call(pk, bs, pts, ct_b),
            "K4 (c)": lambda: rc.precise_bias_grads_call(
                pk, bs, p3, ct3, scalar_chain=False, want_gx=True),
        }
        for name, fn in precise.items():
            if want(name):
                times[name] = cuda_ms(fn)
        if not want("K6", "K1", "K2"):
            return _report(times, root, smi, args.out)

        batch, _, _ = batched_setup(dev, 4, 512, 9)
        seen, real = [], mlp_eval.point_eval_banked

        def spy(*a, **kw):
            if not seen:
                seen.append((a, kw))
            return real(*a, **kw)

        spy.launches = 0
        mlp_eval.point_eval_banked = spy
        try:
            batch("cert")
        finally:
            mlp_eval.point_eval_banked = real
        a6, kw6 = seen[0]
        times["K6"] = cuda_ms(lambda: real(*a6, **kw6))
        del batch

        batch64, _, packed64 = batched_setup(dev, 64, 512, 9)
        rounds, real_tp = [], bm.batched_trace_padded

        def spy_tp(sh, *a, **kw):
            if sh is packed64[0] and not rounds:
                rounds.append(a)
            return real_tp(sh, *a, **kw)

        bm.batched_trace_padded = spy_tp
        try:
            batch64("march")
        finally:
            bm.batched_trace_padded = real_tp
        verify = rounds[0][:8]  # bank, o, v, march, seed, active, block, salvage
        for name, persistent in (("K1 verify", True), ("K1-multi verify", False)):
            times[name] = cuda_ms(lambda: real_tp(packed64[0], *verify, True, persistent))
        del batch64, rounds, verify

        _, _, _, _, cfg, _ = bench_setup(dev, 512)
        pparams, pcfg = load_proxy_npz(os.path.join(root, ".bench_proxy.npz"), dev)
        shared_p = bm.pack_shared(pparams, pcfg)
        lats = latent[None] + 0.001 * torch.as_tensor(
            np.random.default_rng(1).standard_normal((4, latent.shape[0])),
            dtype=torch.float32, device=dev)
        bank_p = bm.fold_bias_bank(pparams, lats, pcfg, shared_p)
        img = 256
        cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img),
                                device=dev)
        o, v = pixel_rays(cam, img, img)
        n = img * img
        coarse = dataclasses.replace(cfg.march, max_steps=16)
        o4, v4 = o.repeat(4, 1).contiguous(), v.repeat(4, 1).contiguous()
        frame = torch.arange(4, device=dev).repeat_interleave(n)
        times["K1"] = cuda_ms(lambda: bm.sphere_trace_persistent(
            shared_p, bank_p, frame, o4, v4, coarse, rays_per_frame=n))
        times["K1-multi"] = cuda_ms(lambda: bm.sphere_trace_batched(
            shared_p, bank_p, frame, o4, v4, coarse, rays_per_frame=n))
        folded_p = fm.pack_folded(fold_latent(pparams, latent, pcfg), pcfg)
        times["K1-grid"] = cuda_ms(lambda: fm.sphere_trace_grid(folded_p, o, v, cfg.march))
        cam2 = Camera.looking_at((0.0, 0.0, -2.5), focal=512 * 1.2, img_hw=(512, 512),
                                 device=dev)
        o2, v2 = pixel_rays(cam2, 512, 512)
        key = torch.zeros((1, 512 * 512), dtype=torch.int32, device=dev)
        seed = torch.full((1, 512 * 512), float("nan"), device=dev)
        bank_p1 = bank_p[:, :1].contiguous()
        times["K2"] = cuda_ms(lambda: queue_march(
            shared_p, bank_p1, o2[None, :1], v2[None], key, seed, cfg.march,
            gen_caps=cfg.march.queue_caps))
        if want("K2 (verify)"):
            fine = queue_march(shared_p, bank_p1, o2[None, :1], v2[None], key, seed,
                               cfg.march, gen_caps=cfg.march.queue_caps)
            key2, seed2 = bm.verify_plan(fine, cfg.march.proxy_band,
                                         cfg.march.proxy_backoff)
            shared_b = bm.pack_shared(params, dcfg)
            bank_b = bm.fold_bias_bank(params, lats[:1], dcfg, shared_b)
            times["K2 (verify)"] = cuda_ms(lambda: queue_march(
                shared_b, bank_b, o2[None, :1], v2[None], key2, seed2, cfg.march,
                gen_caps=cfg.march.queue_caps))
    times = {k: v for k, v in times.items() if want(k)}
    return _report(times, root, smi, args.out)


def _report(times, root, smi, out) -> int:
    res = dict(root=root, card=smi, ms=times)
    print(json.dumps(res))
    if out:
        with open(out, "w") as f:
            json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
