"""Where the time of one forward render goes, on one CUDA card.

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
    renders, and the device's idle share, 1 - device time / wall time.

    python -m dist_renderer_tpu_torch.profile_render [--requests 5]
                                                     [--out FILE.json]

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


def macs_per_eval(params, dcfg) -> int:
    """Multiply-adds of one march MLP evaluation as the march kernels do
    it: padded widths, the last layer's single output row."""
    from dist_renderer_tpu_torch.ops.kernels.batched_march import pack_shared

    t = pack_shared(params, dcfg).table
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


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--out", help="JSON file for the numbers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels import queue_march as qm
    from dist_renderer_tpu_torch.ops.kernels import recompute as rc
    from dist_renderer_tpu_torch.ops.renderer import render

    dev = torch.device("cuda", 0)
    set_fp32_matmul()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    sdf_fn, factory, z, cam, cfg, decs = bench_setup(dev)
    run = lambda: render(sdf_fn, z, cam, cfg, factory)

    # wall time per frame, nothing wrapped
    run()
    torch.cuda.synchronize()
    wall = []
    for _ in range(args.requests):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = run()
        b.record()
        torch.cuda.synchronize()
        wall.append(a.elapsed_time(b))
    hit_frac = out.mask.float().mean().item()

    # stage split: events around each kernel wrapper's call
    queue_names = ("proxy fine march (K2)", "verify march (K2)")
    timer = StageTimer()
    timer.wrap(bm, "batched_trace_padded",
               lambda calls, a, k: f"c2f level {a[2].shape[1]} rays (K1)")
    timer.wrap(qm, "queue_march", lambda calls, a, k: queue_names[
        sum(c[0] in queue_names for c in calls) % 2])
    timer.wrap(rc, "precise_sdg_call", lambda calls, a, k: "compose bucket (K3)")
    stages, frames = {}, []
    try:
        for _ in range(args.requests):
            timer.calls = []
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            torch.cuda.synchronize()
            frames.append(a.elapsed_time(b))
            for name, ea, eb, _ in timer.calls:
                stages.setdefault(name, []).append(ea.elapsed_time(eb))
        last_calls = timer.calls
    finally:
        timer.close()
    med = lambda xs: sorted(xs)[len(xs) // 2]
    stage_ms = {k: med(v) for k, v in stages.items()}
    stage_ms["glue"] = med(frames) - sum(stage_ms.values())

    # march work per stage (from the last split render's outputs)
    work = {}
    for name, _, _, (a, k, out) in last_calls:
        if name not in queue_names:
            continue
        key = a[4]
        act = key != 2
        steps = out.steps[act].to(torch.float64)
        dec = decs["proxy" if name.startswith("proxy") else "decoder"]
        ray_steps = float(steps.sum())
        macs = ray_steps * macs_per_eval(*dec)
        work[name] = dict(active_rays=int(act.sum()),
                          mean_steps=ray_steps / max(int(act.sum()), 1),
                          max_steps=int(steps.max()) if steps.numel() else 0,
                          tmac_per_s=macs / (stage_ms[name] * 1e-3) / 1e12)

    # device time per kernel and the device's idle share
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.requests):
            run()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            kernels[ev.key] = t / 1e3 / args.requests  # ms per frame
    device_ms = sum(kernels.values())
    fwd_ms = med(wall)

    print(f"card: {smi}")
    print(f"render() {fwd_ms:.3f} ms/frame (median of {args.requests}, CUDA "
          f"events; all {[round(w, 3) for w in wall]}), hit_frac {hit_frac:.4f}")
    print(f"split renders {med(frames):.3f} ms/frame; stages (median ms):")
    for name, ms in sorted(stage_ms.items(), key=lambda kv: -kv[1]):
        extra = ""
        if name in work:
            w = work[name]
            extra = (f"  {w['active_rays']} active rays, mean {w['mean_steps']:.2f} "
                     f"steps (max {w['max_steps']}), {w['tmac_per_s']:.2f} TMAC/s")
        print(f"  {name:28s} {ms:9.3f}{extra}")
    print(f"device kernel time {device_ms:.3f} ms/frame (torch.profiler); "
          f"idle share {1 - device_ms / fwd_ms:.4f} of {fwd_ms:.3f} ms")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.3f}  {name[:90]}")
    result = dict(card=smi, fwd_ms=fwd_ms, wall_ms=wall, hit_frac=hit_frac,
                  split_ms=med(frames), stage_ms=stage_ms, work=work,
                  device_ms=device_ms, idle_share=1 - device_ms / fwd_ms,
                  kernels_ms=kernels)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
