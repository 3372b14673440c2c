"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each one against its plain PyTorch version at the shapes the main path
gives it, then serves five 512x512 forward renders of the committed bench
fixture (the 8x512 DeepSDF decoder marched through its distilled 4x256
proxy, 50 steps) through ``render()``, checks that the render went
through every kernel, and compares it with the same render on the plain
versions. Prints the timings, one JSON line of per-kernel results, the
card's name and power limit, and last a JSON status line.

    python3 chip_smoke.py            # needs one CUDA card; exits 1 without

Imports nothing of JAX. Any failed phase exits nonzero.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
IMG = 512
REQUESTS = 5
SEED = 0


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=3):
    """Median device time of fn() in ms (CUDA events, after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


# Kernel vs plain version at the main path's shapes. Both sum every
# product of bf16-valued operands in fp32; the plain version through the
# card's GEMM, whose order may differ from the kernels' in-order sum on
# some shapes (tests/test_torch_cuda.py holds the kernels to an in-order
# plain version bit for bit). Measured on an H100 at these shapes: hit
# agreement 1.0, depth equal but for one coarse ray (2.4e-7). Bars: hit
# agreement >= 0.999; on rays whose hit agrees, |depth| (hits),
# |min_sdf| and |depth_at_min| differences <= 1e-5. A march kernel that
# samples elsewhere (an unrounded position, a wrong bias, another step
# rule) moves depths inside the convergence ball (eps 2e-3) by far more.
MARCH_AGREE, MARCH_TOL = 0.999, 1e-5


def march_diff(a, b):
    """How two march results differ: hit agreement fraction, rays that hit
    in both, and the largest |depth| difference on those, |min_sdf| and
    |depth_at_min| differences on rays whose hit agrees."""
    same = a.hit == b.hit
    both = a.hit & b.hit
    mx = lambda x, m: x.abs()[m].max().item() if bool(m.any()) else 0.0
    return dict(agree=same.float().mean().item(), n_both=int(both.sum()),
                depth=mx(a.depth - b.depth, both),
                min_sdf=mx(a.min_sdf - b.min_sdf, same),
                depth_at_min=mx(a.depth_at_min - b.depth_at_min, same))


def march_line(d):
    return (f"hit agreement {d['agree']:.5f}, max |diff| depth on "
            f"{d['n_both']} common hits {d['depth']:.3e}, min_sdf "
            f"{d['min_sdf']:.3e}, depth_at_min {d['depth_at_min']:.3e}")


def max_err(d):
    return max(d["depth"], d["min_sdf"], d["depth_at_min"])


def march_ok(d):
    return d["agree"] >= MARCH_AGREE and max_err(d) <= MARCH_TOL


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, HERE)
    from dist_renderer_tpu_torch.config import (
        DecoderConfig, GradConfig, MarchConfig, RenderConfig,
    )
    from dist_renderer_tpu_torch.models.decoder import make_precise_sdf, set_fp32_matmul
    from dist_renderer_tpu_torch.models.pretrain import load_params_npz
    from dist_renderer_tpu_torch.models.proxy import (
        load_proxy_meta, load_proxy_npz, proxy_march_margins,
    )
    from dist_renderer_tpu_torch.ops.c2f import classify_pyramid, plan_from_maps
    from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
    from dist_renderer_tpu_torch.ops.kernels import build
    from dist_renderer_tpu_torch.ops.kernels.batched_march import (
        batched_trace_padded, fold_bias_bank, merge_skip, pack_shared,
        sphere_trace_persistent, verify_plan,
    )
    from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march
    from dist_renderer_tpu_torch.ops.kernels.recompute import (
        fold_bias_precise, pack_precise, precise_sdg_call,
    )
    from dist_renderer_tpu_torch.ops.renderer import make_march_factory, render

    dev = torch.device("cuda", 0)
    set_fp32_matmul()
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}  (nvidia-smi: {smi})")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    lib = build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s total, nvcc "
          f"{lib.build_seconds:.1f} s -> {os.path.relpath(lib.path, HERE)}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    sys.stdout.flush()

    # ---- the bench fixture and config (bench.py's) ----
    dcfg = DecoderConfig()
    params, latent = load_params_npz(os.path.join(HERE, ".bench_decoder.npz"), dev)
    pcache = os.path.join(HERE, ".bench_proxy.npz")
    pparams, pcfg = load_proxy_npz(pcache, dev)
    backoff, band = proxy_march_margins(load_proxy_meta(pcache), 2e-3)
    cfg = RenderConfig(
        img_h=IMG, img_w=IMG,
        march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                          coarse_to_fine=True, c2f_strides=(16, 4),
                          c2f_coarse_steps=16, proxy_backoff=backoff,
                          proxy_band=band),
        grad=GradConfig(mode="ift", compact_frac=4, recompute="pallas"),
        compute_dtype="bfloat16", use_pallas=True,
    )
    march = cfg.march
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=IMG * 1.2,
                            img_hw=(IMG, IMG), device=dev)
    origins, dirs = pixel_rays(cam, IMG, IMG)
    n = IMG * IMG

    # ---- phase 3: each kernel against its plain version, main-path shapes ----
    print("\n== kernels vs plain versions (bench fixture, main-path inputs) ==")
    shared_p = pack_shared(pparams, pcfg)
    shared = pack_shared(params, dcfg)
    z = latent[None]
    bank_p = fold_bias_bank(pparams, z, pcfg, shared_p)
    bank = fold_bias_bank(params, z, dcfg, shared)
    coarse = dataclasses.replace(march, max_steps=march.c2f_coarse_steps)
    k1_levels = []

    def trace_level(o_l, v_l, seed, active, stride):
        run = lambda k: batched_trace_padded(shared_p, bank_p, o_l, v_l, coarse,
                                             seed, active, use_kernel=k)
        rk, rp = run(True), run(False)
        torch.cuda.synchronize()
        d = march_diff(rk, rp)
        print(f"K1 coarse stride {stride}: {o_l.shape[1]} rays, {march_line(d)}")
        k1_levels.append((d, lambda: run(True), lambda: run(False)))
        return rp

    with torch.no_grad():
        maps = classify_pyramid(trace_level, origins[None].reshape(1, IMG, IMG, 3),
                                dirs[None].reshape(1, IMG, IMG, 3), (16, 4),
                                march.c2f_backoff)
        key, init_depth, skip = plan_from_maps(maps)
        ob, vb = origins[None, :1], dirs[None]

        def queue_pair(sh, bk, key_, seed_, stage):
            qk = queue_march(sh, bk, ob, vb, key_, seed_, march,
                             gen_caps=march.queue_caps)
            qp = queue_march(sh, bk, ob, vb, key_, seed_, march,
                             gen_caps=march.queue_caps, use_kernel=False)
            k1 = batched_trace_padded(sh, bk, ob.expand(1, n, 3), vb, march,
                                      seed_, key_ != 2, use_kernel=True)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in (
                (qk.depth, k1.depth), (qk.hit, k1.hit), (qk.min_sdf, k1.min_sdf),
                (qk.depth_at_min, k1.depth_at_min), (qk.last_sdf, k1.last_sdf),
                (qk.unresolved, k1.unresolved)))
            d = march_diff(qk, qp)
            print(f"K2 {stage}: {int((key_ != 2).sum())} active rays, K2 == K1 "
                  f"bit for bit: {exact}; vs plain: {march_line(d)}")
            check(exact, f"K2 ({stage}) differs from K1 on the same inputs")
            return qp, d

        fine_p, d_fine = queue_pair(shared_p, bank_p, key, init_depth, "proxy fine")
        fine = merge_skip(fine_p, skip, maps.anchor.reshape(1, n),
                          maps.margin.reshape(1, n))
        key2, seed2 = verify_plan(fine, march.proxy_band, march.proxy_backoff)
        ver_p, d_ver = queue_pair(shared, bank, key2, seed2, "verify")

        # K3 on the compose bucket: hit-first n/4 rays at their anchors
        sel = lambda a, b: torch.where(key2 != 2, a, b)[0]
        hit_v = sel(ver_p.hit, fine.hit)
        anchor = torch.where(hit_v, sel(ver_p.depth, fine.depth),
                             sel(ver_p.depth_at_min, fine.depth_at_min))
        order = torch.sort((~hit_v).to(torch.int32), stable=True).indices[: n // 4]
        pts = (origins[order] + anchor[order, None] * dirs[order]).contiguous()
        vs = dirs[order].contiguous()
        packed = pack_precise(params, dcfg)
        biases = fold_bias_precise(params, latent, dcfg, packed)
        sk, ddk, gk = precise_sdg_call(packed, biases, pts, vs)
        sp, ddp, gp = precise_sdg_call(packed, biases, pts, vs, use_kernel=False)
        torch.cuda.synchronize()
        q = lambda x: [x.quantile(0.5).item(), x.quantile(0.99).item(), x.max().item()]
        e_s, e_dd = q((sk - sp).abs()), q((ddk - ddp).abs())
        e_g = q((gk - gp).abs().amax(dim=1))
        print(f"K3 precise sdg: {pts.shape[0]} points ({int(hit_v.sum())} hits); "
              "|kernel - plain| median / p99 / max: "
              f"s {e_s[0]:.2e} / {e_s[1]:.2e} / {e_s[2]:.2e}, "
              f"dd {e_dd[0]:.2e} / {e_dd[1]:.2e} / {e_dd[2]:.2e}, "
              f"g {e_g[0]:.2e} / {e_g[1]:.2e} / {e_g[2]:.2e}")

        # K3 against its plain version: measured equal on every bucket point
        # (an H100); bars max |diff| 1e-5 on s, 1e-4 on dd and g
        for name, d in ([(f"K1 coarse level {i}", lv[0]) for i, lv in enumerate(k1_levels)]
                        + [("K2 fine", d_fine), ("K2 verify", d_ver)]):
            check(march_ok(d), f"{name} disagrees with its plain version: "
                  f"{march_line(d)} (bars: agreement >= {MARCH_AGREE}, "
                  f"|diff| <= {MARCH_TOL})")
        check(e_s[2] <= 1e-5 and e_dd[2] <= 1e-4 and e_g[2] <= 1e-4,
              "K3 disagrees with its plain version (bars: max |diff| s 1e-5, "
              "dd and g 1e-4)")

        # kernel times beside the plain versions at these shapes
        t_k1 = sum(cuda_ms(lv[1]) for lv in k1_levels)
        t_k1p = sum(cuda_ms(lv[2]) for lv in k1_levels)
        t_k2 = (cuda_ms(lambda: queue_march(shared_p, bank_p, ob, vb, key, init_depth,
                                            march, gen_caps=march.queue_caps))
                + cuda_ms(lambda: queue_march(shared, bank, ob, vb, key2, seed2,
                                              march, gen_caps=march.queue_caps)))
        t_k2p = (cuda_ms(lambda: queue_march(shared_p, bank_p, ob, vb, key,
                                             init_depth, march, gen_caps=march.queue_caps,
                                             use_kernel=False), 1)
                 + cuda_ms(lambda: queue_march(shared, bank, ob, vb, key2, seed2, march,
                                               gen_caps=march.queue_caps,
                                               use_kernel=False), 1))
        t_k3 = cuda_ms(lambda: precise_sdg_call(packed, biases, pts, vs))
        t_k3p = cuda_ms(lambda: precise_sdg_call(packed, biases, pts, vs,
                                                 use_kernel=False))
    print(f"times (ms, median of 3 after warm-up; plain K2 one run): "
          f"K1 {t_k1:.3f} vs plain {t_k1p:.3f}; K2 {t_k2:.3f} vs plain {t_k2p:.3f}; "
          f"K3 {t_k3:.3f} vs plain {t_k3p:.3f}", flush=True)

    # ---- phase 4: the slice: render() serving 5 requests ----
    print(f"\n== render(): {REQUESTS} requests at {IMG}x{IMG}, 50 steps ==")
    sdf_fn = make_precise_sdf(params, dcfg)
    factory = make_march_factory(params, dcfg, cfg, march_params=pparams,
                                 march_dcfg=pcfg)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    lats = [latent + 0.001 * torch.randn(latent.shape, generator=gen).to(dev)
            for _ in range(REQUESTS)]
    render(sdf_fn, lats[0], cam, cfg, factory)  # warm-up
    torch.cuda.synchronize()
    counters = (sphere_trace_persistent, queue_march, precise_sdg_call)
    for fn in counters:
        fn.launches = 0
    outs, ms = [], []
    for z_i in lats:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        outs.append(render(sdf_fn, z_i, cam, cfg, factory))
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"launches in the {REQUESTS} requests: {launches}")
    for name, count in launches.items():
        check(count > 0, f"the main path never launched {name}")
    for out in outs:
        check(torch.isfinite(out.depth).all().item(), "non-finite depth")
        check(torch.isfinite(out.normal).all().item(), "non-finite normal")
        check(torch.isfinite(out.min_sdf).all().item(), "non-finite margin")
        check(out.depth.shape == (IMG, IMG) and out.normal.shape == (IMG, IMG, 3),
              "wrong output shape")
    hit_frac = outs[0].mask.float().mean().item()
    print(f"hit_frac {hit_frac:.4f}")
    check(hit_frac > 0.05, "the render shows almost nothing of the shape")
    fwd_ms = sorted(ms)[len(ms) // 2]
    print(f"fwd ms/frame (median of {REQUESTS}, CUDA events): {fwd_ms:.3f}  "
          f"all: {[round(m, 3) for m in ms]}  [{smi}]")

    # the same request on the plain versions, same card
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    plain_fac = make_march_factory(params, dcfg, plain_cfg, march_params=pparams,
                                   march_dcfg=pcfg)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref = render(sdf_fn, lats[0], cam, plain_cfg, plain_fac)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    agree = (ref.mask == outs[0].mask).float().mean().item()
    both = ref.mask & outs[0].mask
    derr = (ref.depth - outs[0].depth).abs()[both]
    within = (derr <= 1e-3).float().mean().item()
    print(f"vs plain render ({plain_ms:.1f} ms): hit agreement {agree:.5f}; depth "
          f"on {int(both.sum())} common hits: median {derr.median().item():.3e}, "
          f"p99 {derr.quantile(0.99).item():.3e}, max {derr.max().item():.3e}, "
          f"within 1e-3: {within:.5f}")
    # a fraction, not every ray: the card's GEMM in the plain version may
    # sum a coarse level in another order than the kernel (cuBLAS picks its
    # algorithm by shape), which can move a fine seed; that ray's march then
    # stops elsewhere inside the convergence ball (eps 2e-3), and one IFT
    # step need not close the gap to 1e-3 (measured on an H100: one ray of
    # 54,245 common hits at 1.5e-3, every other within 4e-7 at p99)
    check(agree >= 0.99, f"hit agreement with the plain render {agree:.4f} < 0.99")
    check(within >= 0.999, "depth differs from the plain render by > 1e-3 on "
          f"{1 - within:.4%} of common hits (bar: 0.1%)")

    src = "dist_renderer_tpu_torch/csrc/"
    kernels = [
        dict(name="sphere_trace_persistent (K1)", route="cuda",
             source=src + "batched_march.cu",
             replaces="dist_renderer_tpu/ops/pallas/batched_march.py:254",
             launches=launches["sphere_trace_persistent"],
             max_abs_err=max(max_err(lv[0]) for lv in k1_levels), ms=t_k1,
             plain_ms=t_k1p),
        dict(name="queue_march (K2)", route="cuda", source=src + "queue_march.cu",
             replaces="dist_renderer_tpu/ops/pallas/queue_march.py:463",
             launches=launches["queue_march"],
             max_abs_err=max(max_err(d_fine), max_err(d_ver)),
             ms=t_k2, plain_ms=t_k2p),
        dict(name="precise_sdg_call (K3)", route="cuda", source=src + "recompute.cu",
             replaces="dist_renderer_tpu/ops/pallas/recompute.py:386",
             launches=launches["precise_sdg_call"],
             max_abs_err=max(e_s[2], e_dd[2], e_g[2]),
             ms=t_k3, plain_ms=t_k3p),
    ]
    print(json.dumps({"fwd_ms_per_frame": fwd_ms, "plain_fwd_ms": plain_ms,
                      "hit_frac": hit_frac, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
