"""Where the time of one render, and of one render with its backward,
goes on one CUDA card.

Renders the bench cell that ``chip_smoke.py`` serves (the committed bench
fixture: the 8x512 DeepSDF decoder marched through its distilled 4x256
proxy, 512x512, 50 steps, bench.py's config, the smoke run's first
request latent) and reports:

  - ``render()`` ms/frame: CUDA events, median of ``--requests`` renders
    after a warm-up;
  - the same renders split by stage: CUDA events around each kernel
    wrapper that ``render()`` calls (K1 per coarse level, K2 for the
    proxy fine march and for the verify march, K3 on the compose bucket);
    "glue" is the rest (bias folds, classification, planning, merges,
    the bucket sort and scatters);
  - per march stage: active rays, mean march steps per active ray and
    the multiply-adds those steps cost, as a rate over the stage's time;
  - torch.profiler's device time per kernel over the same number of
    renders, and the device's idle share, 1 - device time / wall time;
  - all of the above again for bench.py's fwd+bwd (a depth L1 loss and
    its gradient to the latent, which adds K4 on the compose bucket),
    and the backward's cost beyond the forward split into K4 and the
    autograd glue.

    python -m dist_renderer_tpu_torch.profile_render [--requests 5]
                                                     [--out FILE.json]

With ``--batched [MODE ...]`` it instead splits one batch of bench.py's
batched step (F=64 frames of the same cell on render_batched_c2f's
rounds scheduler, in verify mode MODE: verify_hits "march", "polish" or
"polish-all", the finalize in polish modes; "cert", verify_mode="cert";
"hybrid", verify_band="probe") by stage: the coarse levels, the proxy
and verify stages with each round's K1 launch and each sort, the
certification (its K6 launches), the finalize, and the glue.

Needs one CUDA card. Prints a table, and with ``--out`` writes the
numbers as JSON to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_setup(dev, img=512, seed=0):
    """The bench cell: (sdf_fn, factory, latent, camera, cfg, decoders)."""
    import torch

    from dist_renderer_tpu_torch.config import (
        DecoderConfig, GradConfig, MarchConfig, RenderConfig,
    )
    from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
    from dist_renderer_tpu_torch.models.pretrain import load_params_npz
    from dist_renderer_tpu_torch.models.proxy import (
        load_proxy_meta, load_proxy_npz, proxy_march_margins,
    )
    from dist_renderer_tpu_torch.ops.camera import Camera
    from dist_renderer_tpu_torch.ops.renderer import make_march_factory

    dcfg = DecoderConfig()
    params, latent = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    pcache = os.path.join(ROOT, ".bench_proxy.npz")
    pparams, pcfg = load_proxy_npz(pcache, dev)
    backoff, band = proxy_march_margins(load_proxy_meta(pcache), 2e-3)
    cfg = RenderConfig(
        img_h=img, img_w=img,
        march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                          coarse_to_fine=True, c2f_strides=(16, 4),
                          c2f_coarse_steps=16, proxy_backoff=backoff,
                          proxy_band=band),
        grad=GradConfig(mode="ift", compact_frac=4, recompute="pallas"),
        compute_dtype="bfloat16", use_pallas=True,
    )
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2,
                            img_hw=(img, img), device=dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    z = latent + 0.001 * torch.randn(latent.shape, generator=gen).to(dev)
    factory = make_march_factory(params, dcfg, cfg, march_params=pparams,
                                 march_dcfg=pcfg)
    return (make_precise_sdf(params, dcfg), factory, z, cam, cfg,
            {"decoder": (params, dcfg), "proxy": (pparams, pcfg)})


def bench_frames(dev):
    """The bench cell's frame, (fwd, fwdbwd, decoders): fwd() serves one
    render(); fwdbwd() is bench.py's fwd+bwd, a depth L1 loss's gradient
    to the latent."""
    import torch

    from dist_renderer_tpu_torch.ops.renderer import render
    from dist_renderer_tpu_torch.utils.losses import masked_l1

    sdf_fn, factory, z, cam, cfg, decs = bench_setup(dev)
    img = cfg.img_h
    target = torch.full((img, img), 1.5, device=dev)
    everywhere = torch.ones((img, img), dtype=torch.bool, device=dev)

    def fwd():
        return render(sdf_fn, z, cam, cfg, factory)

    def fwdbwd():
        zz = z.detach().clone().requires_grad_(True)
        out = render(sdf_fn, zz, cam, cfg, factory)
        torch.autograd.grad(masked_l1(out.depth, target, everywhere), zz)
        return out

    return fwd, fwdbwd, decs


# The batched step's verify modes: render_batched_c2f's options for each
BATCHED_MODES = {
    "march": {}, "polish": dict(verify_hits="polish"),
    "polish-all": dict(verify_hits="polish-all"),
    "cert": dict(verify_mode="cert"), "hybrid": dict(verify_band="probe"),
}


def batched_setup(dev, frames=64, img=512, seed=9):
    """bench.py's batched step on the bench cell: ``frames`` latents (the
    bench latent + 0.001 jitter each, from ``seed``), one pinhole camera,
    the proxy with its margins, verify caps (2, 4, 12), 50 steps. Returns
    (batch, latents, packed) where batch(mode, f=frames, persistent=True,
    use_kernel=True, finalize=True, **kw) renders the first f frames
    through render_batched_c2f on the rounds scheduler in
    BATCHED_MODES[mode] and, in the polish modes, finalizes them
    (``batch.finalize(mode, trace, f)``: finalize_hits_batched, the weak
    mask in polish-all), as bench.py's timed step does; finalize=False
    returns the trace unfinalized."""
    import torch

    from dist_renderer_tpu_torch.ops import renderer
    from dist_renderer_tpu_torch.ops.camera import pixel_rays
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm

    _, _, _, cam, cfg, decs = bench_setup(dev, img)
    (params, dcfg), proxy = decs["decoder"], decs["proxy"]
    latent = bench_latent(dev)
    march = cfg.march
    origins, dirs = pixel_rays(cam, img, img)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lats = latent[None] + 0.001 * torch.randn((frames, latent.shape[0]),
                                              generator=gen).to(dev)
    ob = origins[None, :1].expand(frames, 1, 3)
    vb = dirs[None].expand(frames, img * img, 3)
    packed = (bm.pack_shared(params, dcfg), bm.pack_shared(*proxy))

    @torch.no_grad()
    def batch(vh, f=frames, persistent=True, use_kernel=True, finalize=True, **kw):
        st = bm.render_batched_c2f(
            params, dcfg, lats[:f], ob[:f], vb[:f], (img, img), march,
            proxy=proxy, proxy_backoff=march.proxy_backoff,
            proxy_band=march.proxy_band, **BATCHED_MODES[vh],
            verify_round_caps=march.proxy_verify_caps,
            proxy_block=march.proxy_block_width, shared_origin=True,
            packed=packed, persistent=persistent, use_kernel=use_kernel, **kw)
        if vh not in ("polish", "polish-all") or not finalize:
            return st
        return batch.finalize(vh, st, f)

    @torch.no_grad()
    def finish(vh, st, f=frames):
        d, h, m = renderer.finalize_hits_batched(
            params, dcfg, lats[:f], ob[:f], vb[:f], st.depth, st.hit, st.min_sdf,
            convergence_eps=march.convergence_eps,
            background_depth=cfg.background_depth,
            ift_min_denom=cfg.grad.ift_min_denom, polish_iters=2,
            compact_frac=3 if vh == "polish-all" else 4, weak=st.weak)
        return st._replace(depth=d, hit=h, min_sdf=m)

    batch.finalize = finish
    return batch, lats, packed


def bench_latent(dev):
    from dist_renderer_tpu_torch.models.pretrain import load_params_npz

    return load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)[1]


def batched_split(dev, verify_hits: str, frames: int, reps: int):
    """One batch of bench.py's batched step split by stage, CUDA events
    around every call: the coarse levels' K1 launches, each fine stage
    (the proxy's and the verify stage's fine_march_rounds) with its K1
    launches per round and its sorts (the class sort and the re-packs),
    the certification (cert and hybrid: certify_hits_batched and its K6
    launches), the finalize; glue is the rest. Medians over ``reps``
    batches after a warm-up."""
    import torch

    from dist_renderer_tpu_torch.ops import cert, renderer
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    batch, _, packed = batched_setup(dev, frames)
    batch(verify_hits)
    torch.cuda.synchronize()
    stack, calls, restore = [], [], []

    def wrap(module, attr, label):
        fn = getattr(module, attr)

        def timed(*args, **kwargs):
            name = label(args)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            stack.append(name)
            a.record()
            try:
                return fn(*args, **kwargs)
            finally:
                b.record()
                stack.pop()
                calls.append((name, a, b))

        timed.launches = getattr(fn, "launches", 0)
        setattr(module, attr, timed)
        restore.append((module, attr, fn))

    inside = lambda: stack[-1] if stack else "coarse levels"
    wrap(bm, "fine_march_rounds", lambda a: (
        "proxy stage" if a[0] is packed[1] else "verify stage"))
    wrap(bm, "batched_trace_padded", lambda a: f"{inside()}: K1 rounds")
    wrap(bm, "_sort_fields", lambda a: f"{inside()}: sorts")
    wrap(renderer, "finalize_hits_batched", lambda a: "finalize")
    wrap(cert, "certify_hits_batched", lambda a: "cert stage")
    wrap(mlp_eval, "point_eval_banked", lambda a: f"{inside()}: K6")
    totals, stages, counts = [], {}, {}
    try:
        for _ in range(reps):
            calls.clear()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            batch(verify_hits)
            b.record()
            torch.cuda.synchronize()
            totals.append(a.elapsed_time(b))
            per = {}
            for name, ea, eb in calls:
                if name.endswith("K1 rounds") and name.startswith("coarse"):
                    name = "coarse levels (K1)"
                per.setdefault(name, []).append(ea.elapsed_time(eb))
            for name, ms in per.items():
                stages.setdefault(name, []).append(sum(ms))
                counts[name] = [round(m, 3) for m in ms]
    finally:
        for module, attr, fn in restore:
            setattr(module, attr, fn)
    med = lambda xs: sorted(xs)[len(xs) // 2]
    stage_ms = {k: med(v) for k, v in stages.items()}
    top = [k for k in stage_ms if ":" not in k]
    stage_ms["glue"] = med(totals) - sum(stage_ms[k] for k in top)
    return dict(verify_hits=verify_hits, frames=frames, batch_ms=med(totals),
                all_ms=totals, stage_ms=stage_ms, calls_ms=counts)


def macs_per_eval(shared) -> int:
    """Multiply-adds of one march MLP evaluation (of a SharedDecoder) as
    the march kernels do it: padded widths, the last layer's single
    output row."""
    t = shared.table
    rows = [t[i:i + 5] for i in range(0, len(t), 5)]
    total = 0
    for li, (out_p, in_p, wh, wx, _) in enumerate(rows):
        out = 1 if li == len(rows) - 1 else out_p
        total += (in_p * out if wh >= 0 else 0) + (3 * out if wx >= 0 else 0)
    return total


class StageTimer:
    """Wraps the kernel wrappers render() calls; records CUDA events
    around each call, in call order."""

    def __init__(self):
        self.calls = []   # (name, start event, end event, output)
        self.restore = []

    def wrap(self, module, attr, name_of):
        import torch

        fn = getattr(module, attr)

        def timed(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            self.calls.append((name_of(self.calls, args, kwargs), a, b,
                               (args, kwargs, out)))
            return out

        # the wrappers count their launches on the module-level name,
        # which is this function while the timer is on
        timed.launches = getattr(fn, "launches", 0)
        setattr(module, attr, timed)
        self.restore.append((module, attr, fn))

    def close(self):
        for module, attr, fn in self.restore:
            setattr(module, attr, fn)


def _timed(run, requests):
    """CUDA-event ms of each of ``requests`` calls of run(), and the last
    call's result."""
    import torch

    ms, out = [], None
    for _ in range(requests):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = run()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return ms, out


def _device_ms(run, requests):
    """torch.profiler's device time per kernel, ms per call of run()."""
    from dist_renderer_tpu_torch.utils.profiling import device_kernels

    return device_kernels(run, requests)[0]


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--out", help="JSON file for the numbers")
    ap.add_argument("--batched", nargs="*", default=None,
                    choices=list(BATCHED_MODES),
                    help="instead: split one batch of bench.py's batched step "
                    "(F=--frames) by stage, for each verify mode given")
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if args.batched is not None:
        return batched_main(args)
    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels import queue_march as qm
    from dist_renderer_tpu_torch.ops.kernels import recompute as rc

    dev = torch.device("cuda", 0)
    set_fp32_matmul()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    fwd, fwdbwd, decs = bench_frames(dev)

    med = lambda xs: sorted(xs)[len(xs) // 2]
    queue_names = ("proxy fine march (K2)", "verify march (K2)")
    result = dict(card=smi)
    for mode, run in (("fwd", fwd), ("fwdbwd", fwdbwd)):
        # wall time per frame, nothing wrapped
        run()
        torch.cuda.synchronize()
        wall, out = _timed(run, args.requests)

        # stage split: events around each kernel wrapper's call
        timer = StageTimer()
        timer.wrap(bm, "batched_trace_padded",
                   lambda calls, a, k: f"c2f level {a[2].shape[1]} rays (K1)")
        timer.wrap(qm, "queue_march", lambda calls, a, k: queue_names[
            sum(c[0] in queue_names for c in calls) % 2])
        timer.wrap(rc, "precise_sdg_call", lambda calls, a, k: "compose bucket (K3)")
        timer.wrap(rc, "precise_bias_grads_call",
                   lambda calls, a, k: "sdg backward (K4)")
        stages, frames = {}, []
        try:
            for _ in range(args.requests):
                timer.calls = []
                ms, _ = _timed(run, 1)
                frames.append(ms[0])
                for name, ea, eb, _ in timer.calls:
                    stages.setdefault(name, []).append(ea.elapsed_time(eb))
            last_calls = timer.calls
        finally:
            timer.close()
        stage_ms = {k: med(v) for k, v in stages.items()}
        stage_ms["glue"] = med(frames) - sum(stage_ms.values())

        # march work per stage (from the last split render's outputs)
        work = {}
        for name, _, _, (a, k, o) in last_calls:
            if name not in queue_names:
                continue
            act = a[4] != 2
            steps = o.steps[act].to(torch.float64)
            dec = decs["proxy" if name.startswith("proxy") else "decoder"]
            ray_steps = float(steps.sum())
            work[name] = dict(
                active_rays=int(act.sum()),
                mean_steps=ray_steps / max(int(act.sum()), 1),
                max_steps=int(steps.max()) if steps.numel() else 0,
                tmac_per_s=ray_steps * macs_per_eval(bm.pack_shared(*dec))
                / (stage_ms[name] * 1e-3) / 1e12)

        # device time per kernel and the device's idle share
        kernels = _device_ms(run, args.requests)
        device_ms = sum(kernels.values())
        frame_ms = med(wall)
        result[mode] = dict(
            ms=frame_ms, wall_ms=wall, hit_frac=out.mask.float().mean().item(),
            split_ms=med(frames), stage_ms=stage_ms, work=work,
            device_ms=device_ms, idle_share=1 - device_ms / frame_ms,
            kernels_ms=kernels)

    fw, fb = result["fwd"], result["fwdbwd"]
    # the backward's cost beyond the forward, and the part of it that is
    # not K4: autograd's own work (the scatters' and the IFT's backward,
    # the bias fold's products, pixel_rays' backward)
    fb["backward_ms"] = fb["split_ms"] - fw["split_ms"]
    fb["autograd_glue_ms"] = fb["backward_ms"] - fb["stage_ms"].get("sdg backward (K4)", 0.0)
    print(f"card: {smi}")
    for mode in ("fwd", "fwdbwd"):
        r = result[mode]
        print(f"\n{'render()' if mode == 'fwd' else 'render() + backward'} "
              f"{r['ms']:.3f} ms/frame (median of {args.requests}, CUDA events; "
              f"all {[round(w, 3) for w in r['wall_ms']]}), hit_frac {r['hit_frac']:.4f}")
        print(f"split renders {r['split_ms']:.3f} ms/frame; stages (median ms):")
        for name, ms in sorted(r["stage_ms"].items(), key=lambda kv: -kv[1]):
            extra = ""
            if name in r["work"]:
                w = r["work"][name]
                extra = (f"  {w['active_rays']} active rays, mean {w['mean_steps']:.2f} "
                         f"steps (max {w['max_steps']}), {w['tmac_per_s']:.2f} TMAC/s")
            print(f"  {name:28s} {ms:9.3f}{extra}")
        print(f"device kernel time {r['device_ms']:.3f} ms/frame (torch.profiler); "
              f"idle share {r['idle_share']:.4f} of {r['ms']:.3f} ms")
        for name, ms in sorted(r["kernels_ms"].items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {ms:9.3f}  {name[:90]}")
    print(f"\nbackward beyond the forward {fb['backward_ms']:.3f} ms/frame: K4 "
          f"{fb['stage_ms'].get('sdg backward (K4)', 0.0):.3f}, autograd glue "
          f"{fb['autograd_glue_ms']:.3f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")
    return 0


def batched_main(args) -> int:
    import torch

    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul

    set_fp32_matmul()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    result = dict(card=smi, batched={})
    print(f"card: {smi}")
    for vh in args.batched or ["march", "polish", "polish-all"]:
        r = batched_split(torch.device("cuda", 0), vh, args.frames, args.requests)
        result["batched"][vh] = r
        print(f"\nverify mode {vh!r}: one batch of {r['frames']} frames "
              f"{r['batch_ms']:.1f} ms (median of {args.requests}, "
              f"{[round(m, 1) for m in r['all_ms']]}), "
              f"{r['batch_ms'] / r['frames']:.3f} ms/frame; stages (median ms, per frame):")
        for name, ms in r["stage_ms"].items():
            calls = r["calls_ms"].get(name)
            print(f"  {name:28s} {ms:10.1f} {ms / r['frames']:8.3f}"
                  + (f"  calls {calls}" if calls and len(calls) > 1 else ""))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
