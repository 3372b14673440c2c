"""Where the time of a training step goes on one CUDA card.

Three loops at the widths chip_smoke.py's phase 11 runs them:

  - ``fit``: ``fit_decoder_to_sdf`` on bench.py's shape (the 8x512/256
    DeepSDF decoder, batch 8,192);
  - ``distill``: ``distill_proxy`` of a 4x256 proxy from that decoder
    (latent jitter 0.002, batch 8,192);
  - ``train``: ``train_deepsdf_analytic`` at tasks/train.py's defaults
    (three shapes, 4 x 4,096 points).

For each: ms/step of the library call over ``--steps`` steps (host clock
around a synchronized run, after a warm-up call); the same step composed
from the module's own pieces with CUDA events around each stage
(sampling with its surface projection, targets (the auto-decoder's
sampling includes them), the loss's forward, the backward, the Adam
step); and torch.profiler's device time over the
steps: per kernel, by kind (GEMMs, the rest), the kernel launches per
step, and the device's idle share, 1 - device time / wall time.

    python -m dist_renderer_tpu_torch.profile_train [--steps 20] [--out FILE.json]

Needs one CUDA card. The decoders start from their seeded init: a step
costs the same at any weights.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BATCH = 8192


def _events(torch):
    a = torch.cuda.Event(enable_timing=True)
    a.record()
    return a


def _stage_split(torch, step, steps):
    """CUDA-event ms per stage of ``step(mark)``, where step calls
    mark(name) after each stage; medians over ``steps`` steps."""
    rows = {}
    for _ in range(steps):
        marks = [("start", _events(torch))]
        step(lambda name: marks.append((name, _events(torch))))
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            rows.setdefault(name, []).append(a.elapsed_time(b))
    return {k: sorted(v)[len(v) // 2] for k, v in rows.items()}


def _profile(torch, run, steps):
    """(device ms per step by kernel, launches per step, wall ms per step)
    of ``steps`` calls of run() under torch.profiler."""
    from dist_renderer_tpu_torch.utils.profiling import device_kernels

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernels, launches = device_kernels(run, steps)
    wall = 1e3 * (time.perf_counter() - t0) / steps
    return kernels, launches, wall


def _summary(kernels, wall):
    gemm = sum(v for k, v in kernels.items()
               if any(w in k.lower() for w in ("gemm", "cutlass", "xmma", "matmul")))
    total = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return dict(device_ms=total, gemm_ms=gemm, other_ms=total - gemm,
                idle_share=max(0.0, 1.0 - total / wall),
                top=[dict(kernel=k[:90], ms=v) for k, v in top])


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train needs a CUDA card", file=sys.stderr)
        return 1

    from dist_renderer_tpu_torch.config import DecoderConfig
    from dist_renderer_tpu_torch.diag import card_line
    from dist_renderer_tpu_torch.models.analytic import round_union, sphere_sdf, torus_sdf
    from dist_renderer_tpu_torch.models.decoder import (
        decoder_apply, init_decoder_params, set_fp32_matmul,
    )
    from dist_renderer_tpu_torch.models.pretrain import (
        clamped_l1, fit_decoder_to_sdf, normal, sample_training_points,
    )
    from dist_renderer_tpu_torch.models.proxy import (
        _full_fn, _sample_batch, default_proxy_cfg, distill_proxy,
    )
    from dist_renderer_tpu_torch.models.train_deepsdf import (
        analytic_batch, auto_decoder_loss, make_optimizer, train_deepsdf_analytic,
    )
    from dist_renderer_tpu_torch.tasks.common import analytic_shape

    dev = torch.device("cuda", 0)
    set_fp32_matmul()
    n = args.steps
    dcfg = DecoderConfig()
    shape = round_union(torus_sdf(0.55, 0.18), sphere_sdf(0.35, (0.0, 0.25, 0.0)), 0.08)
    target = lambda p: shape(None, p)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_decoder_params(gen, dcfg, dev)
    z0 = 0.1 * normal(gen, (dcfg.latent_size,), dev)
    pcfg = default_proxy_cfg(dcfg, width=256, depth=4)
    fns = [(lambda p, s=analytic_shape(k): s(None, p)) for k in ("sphere", "torus", "union")]
    report = {"card": card_line(), "steps": n}

    def lib_ms(run):
        run(1)  # warm-up: the allocator, cuBLAS's handles
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    # the three loops as a user calls them
    report["fit"] = dict(ms_per_step=lib_ms(lambda k: fit_decoder_to_sdf(
        target, dcfg, steps=k, batch=BATCH, device=dev)))
    report["distill"] = dict(ms_per_step=lib_ms(lambda k: distill_proxy(
        params, dcfg, z0[None], proxy_cfg=pcfg, steps=k, batch=BATCH,
        latent_jitter=0.002)))
    report["train"] = dict(ms_per_step=lib_ms(lambda k: train_deepsdf_analytic(
        fns, dcfg, steps=k, device=dev)))

    # one step of each, composed from the module's pieces
    leaves = [t.requires_grad_(True) for l in params["layers"] for t in (l["w"], l["b"])]
    fit_opt = torch.optim.Adam(leaves, lr=5e-4)

    def fit_step(mark):
        pts = sample_training_points(gen, target, BATCH, device=dev)
        mark("sample")
        with torch.no_grad():
            tgt = target(pts)
        mark("target")
        loss = clamped_l1(decoder_apply(params, z0, pts, dcfg, torch.bfloat16), tgt, 0.1)
        mark("forward")
        fit_opt.zero_grad(set_to_none=True)
        loss.backward()
        mark("backward")
        fit_opt.step()
        mark("adam")

    frozen = init_decoder_params(torch.Generator(device=dev).manual_seed(1), dcfg, dev)
    full = _full_fn(frozen, dcfg)
    proxy = init_decoder_params(gen, pcfg, dev)
    p_leaves = [t.requires_grad_(True) for l in proxy["layers"] for t in (l["w"], l["b"])]
    p_opt = torch.optim.Adam(p_leaves, lr=1e-3)

    def distill_step(mark):
        z = z0 + 0.002 * normal(gen, z0.shape, dev)
        pts = _sample_batch(gen, full, z, BATCH, 0.75, (0.05, 0.01, 2e-3), dev)
        mark("sample")
        with torch.no_grad():
            tgt = full(z, pts)
        mark("target")
        pred = decoder_apply(proxy, z, pts, pcfg, torch.bfloat16)
        w = 1.0 + 3.0 * (tgt.abs() < 0.02).float()
        loss = torch.sum(w * torch.abs(pred - tgt)) / torch.sum(w)
        mark("forward")
        p_opt.zero_grad(set_to_none=True)
        loss.backward()
        mark("backward")
        p_opt.step()
        mark("adam")

    lat = (0.01 * normal(gen, (3, dcfg.latent_size), dev)).requires_grad_(True)
    t_opt = make_optimizer(params, lat, 5e-4, 1e-3)

    def train_step(mark):
        idx, pts, tgt = analytic_batch(gen, fns, 3, 4096, dev)
        mark("sample")
        loss = auto_decoder_loss(params, lat, idx, pts, tgt, dcfg, 1e-4, 0.1, False)
        mark("forward")
        t_opt.zero_grad(set_to_none=True)
        loss.backward()
        mark("backward")
        t_opt.step()
        mark("adam")

    for name, step in (("fit", fit_step), ("distill", distill_step), ("train", train_step)):
        step(lambda _: None)
        report[name]["stages_ms"] = _stage_split(torch, step, n)
        kernels, per_step, wall = _profile(torch, lambda: step(lambda _: None), n)
        report[name].update(_summary(kernels, wall), launches_per_step=per_step,
                            profiled_wall_ms=wall)
        r = report[name]
        print(f"{name}: {r['ms_per_step']:.3f} ms/step (library call); stages "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["stages_ms"].items())
              + f"; device {r['device_ms']:.3f} ms (GEMMs {r['gemm_ms']:.3f}), "
              f"{per_step:.0f} launches a step, idle {r['idle_share']:.1%} of "
              f"{wall:.3f} ms under the profiler  [{report['card']}]")
        for row in r["top"][:5]:
            print(f"    {row['ms']:8.3f} ms  {row['kernel']}")
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
