"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each one against its plain PyTorch version at the shapes the main path
gives it, then serves five 512x512 forward renders of the committed bench
fixture (the 8x512 DeepSDF decoder marched through its distilled 4x256
proxy, 50 steps) through ``render()``, checks that the render went
through every kernel, and compares it with the same render on the plain
versions, and one request with polish-verify (compose()'s demote). Then
it differentiates the same render: bench.py's fwd+bwd (a depth loss's
gradient to the latent) for the five requests, that gradient and a
camera-pose gradient against the plain versions, and five Adam steps of
the depth-completion fit, checking that the backward went through the
recompute backward kernel. Then the single-frame grid march path
(K1-grid): SDFRenderer on the 8x512 bench decoder without the
coarse-to-fine pipeline, three forward and three fwd+bwd requests, held
against the plain versions, and one request through c2f_plan's coarse
levels; the command-line tasks (render_demo, depth_completion,
pose_refine with warm starts, multiview, batched_render) and the render
server, in process, on the committed torus 8x512 decoder; then
bench.py's batched headline: 64 frames of the bench cell through
render_batched_c2f on the rounds scheduler in the three verify modes,
with the multi-frame grid march (K1-multi) held to K1 and to its plain
version and K1 and K1-grid to the in-order witness (the CUDA-core march,
every sum in k order) on every ray of the first verify round, and with
the certification path (verify_mode="cert" and the
hybrid, on the banked point eval K6, which phase 3 holds against its
plain version, as phases 4 and 8 do at their own shapes, and phase 4
serves once each); and last the bulk point
eval (K5) against its plain version,
mesh extraction of the bench shape through it at 128^3 and 256^3, and
the color render (SDFRendererColor with the differentiable color head)
at 512x512, forward and backward, against the plain versions. The CLIs
also extract meshes (--mesh) and run evaluate. Phase 10 drives the
counterparts of the TPU probe scripts (dist_renderer_tpu_torch.diag):
each probe kernel (P1-P24) against its plain version, then the launch
costs (an empty kernel to the main path's kernels at zero work, eager
and in CUDA graphs), the host's waits in a bench frame, chain20, the
work-queue building blocks and the bf16 and int8 MLP chains, printed as
one "probes" JSON line. Phase 11 trains at full width, in a temporary
directory: bench.py's decoder fit of the bench shape (its K1-grid render
against the committed fixture's), its distilled 4x256 proxy (error
report, the proxy file read back, three trace_frame requests held to the
plain versions and to the K1-grid render), tasks/train.py at its
defaults exported as a DeepSDF experiment directory and loaded back bit
for bit (render_demo --experiment-dir), make_synthetic_data's layouts
and the three --data fits, and a resumed depth_completion against an
uninterrupted one; it checks that K1-grid, K1, K2, K3 and K4 launched.
Phase 12 spawns 4 ranks sharing the card over gloo: the sharded batched
render (rounds on K1 and on K1-multi, the queue on K2) against the
single-device one, the sharded K1-grid trace, 5 sharded fit steps through
K3 and K4 against one process running the same steps, the sharded frame
and view renders against render_rays; then the batched polish on K3
against its plain version, fused_dd against the K3 route, the counting
sort against torch.sort, and phase 9's mesh raycast against the K1-grid
render and preprocessed into both dataset layouts; every kernel of the
ranks' legs must launch in every rank. Phase 13 runs the scheduling
diagnostics (dist_renderer_tpu_torch.diag's diag_perf to diag_caps_ab)
at the bench cell, F=8: render_batched_c2f's straggler telemetry
(with_diag, which must change no bit of the render) and unverified proxy
trace (proxy_verify=False), the cost of a march tile-step, the cap
sweeps, each render held to its plain versions. Prints the timings, one
JSON line of per-kernel results, the card's name and power limit, and
last a JSON status line.

    python3 chip_smoke.py            # needs one CUDA card; exits 1 without

Imports nothing of JAX. Any failed phase exits nonzero.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from dist_renderer_tpu_torch.utils.profiling import bound_ms, cuda_ms  # noqa: E402
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


# Kernel path against plain path, whole gradients of a render (phase 5).
# Measured on an H100: latent gradient cos 1.0, relative L2 1.0e-5; pose
# gradient 9.4e-5 (the plain render's march stops elsewhere on one ray,
# phase 4). Bars with room: cos >= 0.9999, relative L2 <= 1e-3.
GRAD_COS, GRAD_REL = 0.9999, 1e-3


def grad_diff(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return dict(cos=(a @ b / (a.norm() * b.norm())).item(),
                rel=((a - b).norm() / b.norm()).item())


def macs_per_eval(shared):
    from dist_renderer_tpu_torch.profile_render import macs_per_eval as macs

    return macs(shared)


def march_bytes(n, shared, bank):
    """A march's traffic: [16, N] ray rows in, [8, N] rows out, the
    weights and the bias bank once."""
    return 4 * 24 * n + 2 * shared.flat.numel() + 4 * bank.numel()


def precise_macs(packed):
    """Multiply-adds of the precise recompute of one point: the forward
    (three products on the split input layers, one on the others) and the
    reverse sweep to the inputs."""
    total = 0
    for m in packed.meta:
        k = 3 if m.split else 1
        if m.has_wh:
            total += (k + 1) * m.in_p * m.out_p
        if m.has_wx:
            total += 4 * 3 * m.out_p
    return total


def ties_line(torch, fn, packed, n):
    """The near ties of fn's last launch (K3 or K4): values queued for the
    in-order sum, of the values on the tensor cores, and those past the
    queue (the overflow bits)."""
    from dist_renderer_tpu_torch.ops.kernels.recompute import (
        mma_values, precise_bias_grads_call,
    )

    queued, past = fn.ties.tolist()
    values = mma_values(packed, n, k4=fn is precise_bias_grads_call)
    return dict(queued=queued, values=values, share=queued / values, past_queue=past)


def precise_bytes(n, packed, rows_in, rows_out):
    return 4 * (rows_in + rows_out) * n + 2 * packed.flat.numel()


def fwd_bwd_phase(torch, dev, sdf_fn, factory, plain_fac, plain_sdf, cfg, cam,
                  lats, latent, counters, smi):
    """Phase 5: gradients through render() on the card. (i) bench.py's
    fwd+bwd (a depth L1 loss, its gradient to the latent) for every
    request; (ii) request 0 again on the plain versions; (iii) a pose
    gradient on the pose-refinement objective, kernels and plain; (iv) 5
    Adam steps of the depth-completion fit."""
    import math

    from dist_renderer_tpu_torch.config import OptimConfig
    from dist_renderer_tpu_torch.ops.camera import (
        Camera, camera_from_pose, pose_from_camera, so3_exp,
    )
    from dist_renderer_tpu_torch.ops.renderer import render
    from dist_renderer_tpu_torch.utils import losses as L
    from dist_renderer_tpu_torch.utils.optim import fit

    print(f"\n== fwd+bwd: gradients through render() ==")
    target = torch.full((IMG, IMG), 1.5, device=dev)
    everywhere = torch.ones((IMG, IMG), dtype=torch.bool, device=dev)

    def depth_grad(z, fac=factory, sdf=sdf_fn):
        zz = z.detach().clone().requires_grad_(True)
        out = render(sdf, zz, cam, cfg, fac)
        return torch.autograd.grad(L.masked_l1(out.depth, target, everywhere), zz)[0]

    def reset():
        for fn in counters:
            fn.launches = 0

    def counts(what):
        got = {fn.__name__: fn.launches for fn in counters}
        print(f"launches in {what}: {got}")
        for name, count in got.items():
            check(count > 0, f"{what} never launched {name}")
        return got

    depth_grad(lats[0])  # warm-up
    torch.cuda.synchronize()
    reset()
    grads, ms = [], []
    for z_i in lats:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        grads.append(depth_grad(z_i))
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    launches = counts(f"the {REQUESTS} fwd+bwd requests")
    for g in grads:
        check(torch.isfinite(g).all().item() and g.norm().item() > 0,
              "the latent gradient is not finite or is zero")
    fb_ms = sorted(ms)[len(ms) // 2]
    print(f"(i) fwd+bwd ms/frame (median of {REQUESTS}, CUDA events): {fb_ms:.3f}  "
          f"all: {[round(m, 3) for m in ms]}  [{smi}]")

    # (iv) tasks/depth_completion.py's fit: the bench latent's own render,
    # its left half of the columns observed, from a jittered start
    with torch.no_grad():
        truth = render(sdf_fn, latent, cam, cfg, factory)
    cols = (torch.arange(IMG, device=dev) < IMG // 2)[None, :]
    obs_valid = truth.mask & cols
    obs_depth = torch.where(obs_valid, truth.depth, torch.zeros_like(truth.depth))

    def loss_fn(z):
        out = render(sdf_fn, z, cam, cfg, factory)
        ld = L.depth_loss(out.depth, obs_depth, obs_valid, out.mask)
        ls = L.silhouette_loss(torch.where(cols, out.min_sdf, 0.0 * out.min_sdf),
                               obs_valid)
        return 10.0 * ld + ls + 1e-4 * L.latent_reg(z), {"depth": ld, "sil": ls}

    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    z_start = latent + 0.01 * torch.randn(latent.shape, generator=gen).to(dev)
    stamps = []
    tick = lambda *_: (torch.cuda.synchronize(), stamps.append(time.perf_counter()))
    mem = lambda: (torch.cuda.memory_stats(dev), torch.cuda.memory_reserved(dev))
    (st0, res0) = mem()
    reset()
    tick()
    res = fit(loss_fn, z_start, OptimConfig(steps=5), callback=tick)
    counts("the 5 fit steps")
    (st1, res1) = mem()
    hist = res.loss_history.tolist()
    steps_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    fit_ms = sorted(steps_ms)[len(steps_ms) // 2]
    print(f"(iv) fit losses {[round(x, 6) for x in hist]}; ms/step median "
          f"{fit_ms:.3f}, all {[round(m, 3) for m in steps_ms]}  [{smi}]; "
          f"allocator: reserved {res0 / 2**30:.1f} -> {res1 / 2**30:.1f} GiB, "
          + ", ".join(f"{k} +{st1.get(k, 0) - st0.get(k, 0)}" for k in (
              "num_alloc_retries", "num_device_alloc", "num_device_free")))
    check(all(math.isfinite(x) for x in hist), "a fit loss is not finite")

    # (ii) and (iii) run the plain versions, after the timed fit: timed
    # right after them, the fit's first step took 6.4 s on an H100, and
    # 0.57 s in a process that had not run them
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g_plain = depth_grad(lats[0], plain_fac, plain_sdf)
    b.record()
    torch.cuda.synchronize()
    plain_fb_ms = a.elapsed_time(b)
    d_lat = grad_diff(grads[0], g_plain)
    print(f"(ii) latent gradient, kernels vs plain versions ({plain_fb_ms:.1f} ms): "
          f"cos {d_lat['cos']:.7f}, relative L2 {d_lat['rel']:.3e}")

    # (iii) tasks/pose_refine.py's objective from a perturbed pose (its
    # defaults: 10 degrees about a seeded axis, 0.1 translation noise)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    axis = torch.randn(3, generator=gen)
    axis = (axis / axis.norm()).to(dev)
    R0 = so3_exp(axis * math.radians(10.0)) @ cam.R
    T0 = cam.T + 0.1 * torch.randn(3, generator=gen).to(dev)
    pose0 = pose_from_camera(Camera(K=cam.K, R=R0, T=T0))
    with torch.no_grad():
        gt = render(sdf_fn, lats[0], cam, cfg, factory)

    def pose_grad(fac, sdf):
        p = pose0.clone().requires_grad_(True)
        out = render(sdf, lats[0], camera_from_pose(p, cam.K), cfg, fac)
        loss = (10.0 * L.depth_loss(out.depth, gt.depth, gt.mask, out.mask)
                + L.silhouette_loss(out.min_sdf, gt.mask))
        return torch.autograd.grad(loss, p)[0]

    gp_k, gp_p = pose_grad(factory, sdf_fn), pose_grad(plain_fac, plain_sdf)
    d_pose = grad_diff(gp_k, gp_p)
    print(f"(iii) so3 pose gradient {[round(x, 6) for x in gp_k.tolist()]}; "
          f"kernels vs plain: cos {d_pose['cos']:.7f}, relative L2 {d_pose['rel']:.3e}")
    check(torch.isfinite(gp_k).all().item(), "the pose gradient is not finite")
    for what, d in (("latent", d_lat), ("pose", d_pose)):
        check(d["cos"] >= GRAD_COS and d["rel"] <= GRAD_REL,
              f"the {what} gradient on the kernels differs from the plain "
              f"versions' (bars: cos >= {GRAD_COS}, relative L2 <= {GRAD_REL})")

    return dict(fwdbwd_ms=fb_ms, plain_fwdbwd_ms=plain_fb_ms, fit_ms=fit_ms,
                launches=launches)


TRACE_FIELDS = ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf",
                "unresolved", "steps_per_ray", "bracketed")


def k2_generations(torch, run):
    """K2's generations in run() (one queue_march call on the card), read
    through queue_march.generation_watch: each one's queued rays, device
    time (CUDA events between its launches, in a run that reads nothing
    else), and active ray-steps against its 64-row tiles' lane-steps (a
    second run, the queues and step counts copied between launches)."""
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels import queue_march as qm

    events, snaps = [], []

    def timed(state, queue, count):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    def read(state, queue, count):
        snaps.append((state[10].clone(), queue[:int(count.item())].clone()))

    try:
        qm.generation_watch = timed
        run()
        torch.cuda.synchronize()
        qm.generation_watch = read
        run()
        torch.cuda.synchronize()
    finally:
        qm.generation_watch = None
    rows = []
    for g in range(len(snaps) - 1):
        steps0, q = snaps[g]
        delta = (snaps[g + 1][0] - steps0)[q.long()].to(torch.int32)
        tiles = bm.march_tile_steps(delta)
        lanes = bm.MARCH_TILE * int(tiles.sum())
        rows.append(dict(rays=q.numel(), ms=events[g].elapsed_time(events[g + 1]),
                         ray_steps=int(delta.sum()), lane_steps=lanes,
                         lane_share=int(delta.sum()) / max(lanes, 1)))
    return rows


def k1_grid_phase(torch, dev, params, dcfg, latent, cfg, origins, dirs):
    """Phase 3, K1-grid on the bench decoder folded at the bench latent,
    every ray of the 512^2 bench camera: (a) one full-budget march from
    the sphere entry, salvage on; (b) the rounds driver; (c) one march
    seeded and masked by c2f_plan's classification of the same frame (its
    levels also on K1-grid). Each against its plain version with K1's
    bars; (a) also against K1 at F=1, bit for bit."""
    from dist_renderer_tpu_torch.models.folded import fold_latent
    from dist_renderer_tpu_torch.ops.kernels.batched_march import (
        fold_bias_bank, pack_shared, sphere_trace_persistent,
    )
    from dist_renderer_tpu_torch.ops.kernels.fused_march import (
        pack_folded, sphere_trace_grid, sphere_trace_rounds,
    )
    from dist_renderer_tpu_torch.ops.renderer import c2f_plan, make_march_factory

    march = cfg.march
    shared = pack_shared(params, dcfg)
    packed = pack_folded(fold_latent(params, latent, dcfg), dcfg, shared)
    bank = fold_bias_bank(params, latent[None], dcfg, shared)
    cfg_c = dataclasses.replace(cfg, march=dataclasses.replace(
        march, coarse_to_fine=True, c2f_classify=True))
    plan = c2f_plan(make_march_factory(params, dcfg, cfg_c)(latent), origins,
                    dirs, cfg_c)
    perm = plan.order
    o_c, v_c = origins[perm], dirs[perm]
    seed_c, act_c = plan.init_depth[perm], plan.init_active[perm]
    cases = {
        "a": lambda k: sphere_trace_grid(packed, origins, dirs, march,
                                         use_kernel=k),
        "b": lambda k: sphere_trace_rounds(packed, origins, dirs, march,
                                           use_kernel=k),
        "c": lambda k: sphere_trace_grid(packed, o_c, v_c, march, seed_c,
                                         init_active=act_c, use_kernel=k),
    }
    n = origins.shape[0]
    rows = []
    macs = macs_per_eval(shared)
    for name, run in cases.items():
        rk, rp = run(True), run(False)
        torch.cuda.synchronize()
        d = march_diff(rk, rp)
        steps = int(rk.steps_per_ray.sum())
        r = dict(case=name, d=d, steps=steps, ms=cuda_ms(lambda: run(True)),
                 plain_ms=cuda_ms(lambda: run(False), 1))
        r["bound_ms"], r["bound_by"] = bound_ms(march_bytes(n, shared, packed.bias),
                                                2 * steps * macs)
        if name == "a":
            # the same tile march on K1's persistent grid: bits, and the
            # time the one-block-per-tile grid is kept for
            frame0 = torch.zeros(n, dtype=torch.int64, device=dev)
            k1_run = lambda: sphere_trace_persistent(shared, bank, frame0,
                                                     origins, dirs, march)
            k1 = k1_run()
            torch.cuda.synchronize()
            r["k1_exact"] = all(torch.equal(getattr(rk, f), getattr(k1, f))
                                for f in TRACE_FIELDS)
            r["k1_ms"] = cuda_ms(k1_run)
        rows.append(r)
        print(f"K1-grid ({name}) {int((rk.steps_per_ray > 0).sum())} marched rays, "
              f"{steps} active ray-steps: {march_line(d)}; {r['ms']:.3f} ms vs "
              f"plain {r['plain_ms']:.3f} ms (bound {r['bound_ms']:.3f} ms, "
              f"{r['bound_by']})" + (f"; == K1 at F=1 bit for bit: {r['k1_exact']}, "
                                     f"K1 at F=1 {r['k1_ms']:.3f} ms"
                                     if name == "a" else ""), flush=True)
    for r in rows:
        check(march_ok(r["d"]), f"K1-grid ({r['case']}) disagrees with its plain "
              f"version: {march_line(r['d'])} (bars: agreement >= {MARCH_AGREE}, "
              f"|diff| <= {MARCH_TOL})")
    check(rows[0]["k1_exact"], "K1-grid differs from K1 at F=1 on the same rays")
    return rows


# The K1-grid path against its plain versions, whole renders (phase 6).
# Gradient bars: phase 5's, set after the first reading on an H100 (see
# PERF.md); no looser than cos >= 0.999, relative L2 <= 1e-2.
GRID_GRAD_COS, GRID_GRAD_REL = GRAD_COS, GRAD_REL


def grid_path_phase(torch, dev, params, dcfg, lats, cam, smi, tf_out):
    """Phase 6: SDFRenderer on the bench decoder at 512^2 with use_pallas
    and no coarse-to-fine pipeline: the trace runs the rounds driver on
    K1-grid, the composition K3, the backward K4."""
    from dist_renderer_tpu_torch.config import GradConfig, MarchConfig, RenderConfig
    from dist_renderer_tpu_torch.ops.kernels.fused_march import sphere_trace_grid
    from dist_renderer_tpu_torch.ops.kernels.recompute import (
        precise_bias_grads_call, precise_sdg_call,
    )
    from dist_renderer_tpu_torch.ops.renderer import SDFRenderer
    from dist_renderer_tpu_torch.utils import losses as L

    print(f"\n== the K1-grid path: SDFRenderer, {IMG}x{IMG}, no coarse-to-fine ==")
    cfg = RenderConfig(
        march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4),
        grad=GradConfig(mode="ift", compact_frac=4, recompute="pallas"),
        compute_dtype="bfloat16", use_pallas=True)
    rk = SDFRenderer(params, cam.K, (IMG, IMG), decoder_cfg=dcfg, cfg=cfg)
    rp = SDFRenderer(params, cam.K, (IMG, IMG), decoder_cfg=dcfg, cfg=cfg,
                     use_kernel=False)
    counters = (sphere_trace_grid, precise_sdg_call, precise_bias_grads_call)
    target = torch.full((IMG, IMG), 1.5, device=dev)
    everywhere = torch.ones((IMG, IMG), dtype=torch.bool, device=dev)
    lat3 = lats[:3]

    def reset():
        for fn in counters:
            fn.launches = 0

    def grads(r, z):
        leaves = [x.detach().clone().requires_grad_(True) for x in (z, cam.R, cam.T)]
        out = r.render(*leaves)
        return torch.autograd.grad(L.masked_l1(out.depth, target, everywhere), leaves)

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    with torch.no_grad():
        rk.render(lat3[0], cam.R, cam.T)  # warm-up
    torch.cuda.synchronize()
    reset()
    outs, ms = [], []
    with torch.no_grad():
        for z in lat3:
            out, t = timed(lambda: rk.render(z, cam.R, cam.T))
            outs.append(out)
            ms.append(t)
    fwd_launches = {fn.__name__: fn.launches for fn in counters}
    print(f"launches in the {len(lat3)} forward requests: {fwd_launches}")
    for name in ("sphere_trace_grid", "precise_sdg_call"):
        check(fwd_launches[name] > 0, f"the K1-grid path never launched {name}")
    for out in outs:
        check(all(torch.isfinite(getattr(out, k)).all().item()
                  for k in ("depth", "normal", "min_sdf")), "non-finite render")
        check(out.depth.shape == (IMG, IMG), "wrong output shape")
    hit_frac = outs[0].mask.float().mean().item()
    fwd_ms = sorted(ms)[len(ms) // 2]
    steps = int(outs[0].trace.steps_per_ray.sum())
    print(f"hit_frac {hit_frac:.4f}; active ray-steps (request 0) {steps}")
    print(f"fwd ms/frame (median of {len(lat3)}, CUDA events): {fwd_ms:.3f}  "
          f"all: {[round(m, 3) for m in ms]}  [{smi}]")
    check(hit_frac > 0.05, "the render shows almost nothing of the shape")

    reset()
    gks, ms = [], []
    for z in lat3:
        g, t = timed(lambda: grads(rk, z))
        gks.append(g)
        ms.append(t)
    bwd_launches = {fn.__name__: fn.launches for fn in counters}
    print(f"launches in the {len(lat3)} fwd+bwd requests: {bwd_launches}")
    check(bwd_launches["precise_bias_grads_call"] > 0,
          "the K1-grid path's backward never launched precise_bias_grads_call")
    check(all(torch.isfinite(x).all().item() for g in gks for x in g),
          "a gradient is not finite")
    fb_ms = sorted(ms)[len(ms) // 2]
    print(f"fwd+bwd ms/frame (median of {len(lat3)}, CUDA events): {fb_ms:.3f}  "
          f"all: {[round(m, 3) for m in ms]}  [{smi}]")

    # the same request on the plain versions, same card
    with torch.no_grad():
        ref, plain_ms = timed(lambda: rp.render(lat3[0], cam.R, cam.T))
    agree = (ref.mask == outs[0].mask).float().mean().item()
    both = ref.mask & outs[0].mask
    derr = (ref.depth - outs[0].depth).abs()[both]
    within = (derr <= 1e-3).float().mean().item()
    print(f"vs plain render ({plain_ms:.1f} ms): hit agreement {agree:.5f}; depth on "
          f"{int(both.sum())} common hits: median {derr.median().item():.3e}, "
          f"max {derr.max().item():.3e}, within 1e-3: {within:.5f}")
    gps, plain_fb_ms = timed(lambda: grads(rp, lat3[0]))
    diffs = {name: grad_diff(a, b) for name, a, b in zip(("latent", "R", "T"),
                                                          gks[0], gps)}
    print("gradients, kernels vs plain ({:.1f} ms): ".format(plain_fb_ms) + "; ".join(
        f"{k} cos {d['cos']:.7f} relative L2 {d['rel']:.3e}" for k, d in diffs.items()))
    check(agree >= 0.99, f"hit agreement with the plain render {agree:.4f} < 0.99")
    check(within >= 0.999, "depth differs from the plain render by > 1e-3 on "
          f"{1 - within:.4%} of common hits (bar: 0.1%)")
    for k, d in diffs.items():
        check(d["cos"] >= GRID_GRAD_COS and d["rel"] <= GRID_GRAD_REL,
              f"the {k} gradient on the kernels differs from the plain versions' "
              f"(bars: cos >= {GRID_GRAD_COS}, relative L2 <= {GRID_GRAD_REL})")

    # one request through c2f_plan's levels (K1-grid), no classification
    cfg_c = dataclasses.replace(cfg, march=dataclasses.replace(
        cfg.march, coarse_to_fine=True, c2f_classify=False, c2f_strides=(16, 4),
        c2f_coarse_steps=16))
    rc = SDFRenderer(params, cam.K, (IMG, IMG), decoder_cfg=dcfg, cfg=cfg_c)
    with torch.no_grad():
        rc.render(lat3[0], cam.R, cam.T)  # warm-up
        reset()
        out_c, c2f_ms = timed(lambda: rc.render(lat3[0], cam.R, cam.T))
    check(sphere_trace_grid.launches > 0, "c2f_plan's levels never launched K1-grid")
    same = (out_c.mask == outs[0].mask).float().mean().item()
    print(f"c2f_plan request (strides (16, 4), unclassified): {c2f_ms:.3f} ms, "
          f"{sphere_trace_grid.launches} K1-grid launches; hit agreement with the "
          f"no-c2f render {same:.5f}")
    check(torch.isfinite(out_c.depth).all().item(), "non-finite c2f render")
    # for information: against phase 4's trace_frame render of the same latent
    both = tf_out.mask & outs[0].mask
    derr = (tf_out.depth - outs[0].depth).abs()[both]
    print(f"vs the trace_frame render (proxy + verify): hit agreement "
          f"{(tf_out.mask == outs[0].mask).float().mean().item():.5f}; depth on "
          f"{int(both.sum())} common hits: median {derr.median().item():.3e}, "
          f"p99 {derr.quantile(0.99).item():.3e}", flush=True)
    return dict(fwd_ms=fwd_ms, fwdbwd_ms=fb_ms, plain_ms=plain_ms,
                plain_fwdbwd_ms=plain_fb_ms, c2f_ms=c2f_ms, hit_frac=hit_frac,
                launches=fwd_launches["sphere_trace_grid"])


F8 = 64        # frames per batch in phase 8 (bench.py's batched headline)
F8_PLAIN = 4   # frames of phase 8's kernel-vs-plain comparison
# Phase 8's whole path at F=4 against the plain versions with their GEMM:
# the least share of hits agreeing, and of rays within MARCH_TOL per field,
# and the largest |diff|. Set from readings on an H100, (a): agreement
# 1.00000; within: depth 0.999949, min_sdf 0.999989, depth_at_min
# 0.999738; max 6.1e-3, 3.5e-3, 6.8e-3. (d) cert, three sets of frames
# (seeds 9, 11, 12): agreement 1.00000; within: depth 0.991793 / 0.992994
# / 0.989310, min_sdf 0.999352 / 0.999233 / 0.999214, depth_at_min
# 0.998046 / 0.998536 / 0.997766; max 9.8e-3. A certified depth is the
# secant through probes at the proxy depth +- backoff, which the bf16x2
# split places to ~1e-5, so a proxy depth that the GEMM's summation order
# moves by a last bit moves it too, where (a)'s verify march absorbs it:
# every ray outside MARCH_TOL had a proxy depth that moved (1785, 1518,
# 2326 of 1785, 1518, 2326), which the check holds. With the in-order
# product every ray is equal in both.
PATH_AGREE = 0.9999
PATH_WITHIN = dict(a=dict(depth=0.9999, min_sdf=0.9999, depth_at_min=0.9995),
                   d=dict(depth=0.98, min_sdf=0.998, depth_at_min=0.995))
PATH_MAX = 2e-2


def quantiles(x, ps=(0.5, 0.95, 1.0)):
    """Quantiles of a 1-D tensor by sorting (torch.quantile refuses more
    than 2^24 elements)."""
    s = x.flatten().sort().values
    return [s[int(round(p * (s.numel() - 1)))].item() for p in ps] if s.numel() else [0.0] * len(ps)


def batched_phase(torch, dev, params, dcfg, cfg, origins, dirs, smi):
    """Phase 8, bench.py's batched headline: render_batched_c2f over 64
    frames of 512^2 (the bench latent + 0.001 jitter each, one pinhole
    camera, the proxy with its margins, verify caps (2, 4, 12), 50 steps)
    on the rounds scheduler, verify_hits (a) "march", (b) "polish" and (c)
    "polish-all", the two polish modes with finalize_hits_batched (and
    (c) its weak mask) in the timed region; (a) again with every level and
    round on K1-multi; (d) verify_mode="cert" and (e) the hybrid
    (verify_band="probe"), the certification on K6, whose calls in the
    warm-up batch of (d) and (e) are held against its plain version;
    render_depth_batched at F=64. Then, outside the counted run: K1-multi
    against K1, K1 and K1-grid (frame by frame) against the in-order
    witness (the tensor-core march against the CUDA-core one summing in k
    order, every ray's bits), both against their plain version, and the
    round's active ray-steps against its lane-steps, on
    the verify stage's first round at F=64, render_depth_batched against
    K1, and the kernel path of
    (a) and of (d) against the plain versions at F=4 ((d) on three sets of
    frames)."""
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval
    from dist_renderer_tpu_torch.profile_render import batched_setup

    print(f"\n== phase 8: the batched headline, F={F8} x {IMG}x{IMG}, rounds ==")
    march = cfg.march
    n = IMG * IMG
    batch, lats, packed = batched_setup(dev, F8, IMG, SEED + 9)
    ob = origins[None, :1].expand(F8, 1, 3)
    vb = dirs[None].expand(F8, n, 3)

    def timed(fn, reps=3, warm_up=lambda fn: fn()):
        """(last output, median ms of reps after a warm-up), CUDA events;
        warm_up(fn) runs the warm-up. Peak memory counts from the reps."""
        out = warm_up(fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return out, sorted(ms)[len(ms) // 2], ms

    counters = (bm.sphere_trace_persistent, bm.sphere_trace_batched,
                mlp_eval.point_eval_banked)
    for c in counters:
        c.launches = 0
    rows = {}
    outs = {}
    k6_rows = {}

    def k6_held_at(name):
        """The warm-up of (d) or (e), its K6 calls held against the plain
        version (k6_capture, k6_held): K6 at the shapes of F=64."""
        def run(fn):
            out, calls = k6_capture(torch, fn)
            k6_rows[name] = k6_held(torch, calls, f"({name}) at F={F8}")
            return out
        return run

    with torch.no_grad():
        for name, vh, pers in (("a", "march", True), ("b", "polish", True),
                               ("c", "polish-all", True), ("a_multi", "march", False),
                               ("d", "cert", True), ("e", "hybrid", True)):
            out, ms, all_ms = timed(lambda: batch(vh, persistent=pers),
                                    **(dict(warm_up=k6_held_at(name))
                                       if name in ("d", "e") else {}))
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            outs[name] = out
            check(torch.isfinite(out.depth).all().item()
                  and torch.isfinite(out.min_sdf).all().item(),
                  f"phase 8 ({name}): non-finite depth or margin")
            check(out.depth.shape == (F8, n), f"phase 8 ({name}): wrong shape")
            hf = out.hit.float().mean().item()
            rows[name] = dict(verify_hits=vh, persistent=pers, ms=ms, all_ms=all_ms,
                              ms_per_frame=ms / F8, mrays_s=F8 * n / ms / 1e3,
                              hit_frac=hf, peak_gib=peak)
            print(f"({name}) verify mode {vh!r}{'' if pers else ', every level and round on K1-multi'}"
                  f"{', finalize in the timed region' if vh.startswith('polish') else ''}: "
                  f"{rows[name]['mrays_s']:.3f} Mrays/s, {ms / F8:.3f} ms/frame "
                  f"(median of 3 batches, {[round(m, 1) for m in all_ms]} ms), "
                  f"hit_frac {hf:.4f}, peak memory {peak:.2f} GiB  [{smi}]", flush=True)
            check(hf > 0.05, f"phase 8 ({name}) shows almost nothing of the shape")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dd_out = bm.render_depth_batched(params, dcfg, lats, ob, vb, march)
        b.record()
        torch.cuda.synchronize()
        dd_ms = a.elapsed_time(b)
    launches = {c.__name__: c.launches for c in counters}
    print(f"launches in phase 8's batches: {launches}")
    for k, v in launches.items():
        check(v > 0, f"phase 8 never launched {k}")
    check(torch.equal(outs["a"].depth, outs["a_multi"].depth)
          and torch.equal(outs["a"].hit, outs["a_multi"].hit),
          "(a) on K1-multi differs from (a) on K1")

    # flips of the other modes against march-verify, depth on common hits
    ha = outs["a"].hit
    for name in ("b", "c", "d", "e"):
        o = outs[name]
        flips = (o.hit != ha)
        both = o.hit & ha
        q = quantiles((o.depth - outs["a"].depth).abs()[both])
        rows[name].update(flips=int(flips.sum()), flip_of_hits=flips.sum().item() / max(int(ha.sum()), 1),
                          flip_of_rays=flips.float().mean().item(),
                          lost=int((ha & ~o.hit).sum()), gained=int((o.hit & ~ha).sum()),
                          depth_p50=q[0], depth_p95=q[1], depth_max=q[2])
        r = rows[name]
        print(f"({name}) vs (a): {r['flips']} hit flips = {r['flip_of_hits']:.4%} of (a)'s "
              f"hits ({r['lost']} lost, {r['gained']} gained), {r['flip_of_rays']:.4%} of "
              f"rays; |depth diff| on {int(both.sum())} common hits p50 {q[0]:.3e} "
              f"p95 {q[1]:.3e} max {q[2]:.3e}")

    # K1-multi against K1 on the rounds' own inputs: the verify stage's
    # first round (the first full-decoder launch of a batch)
    seen = []
    real = bm.batched_trace_padded

    def spy(sh, *a, **kw):
        if sh is packed[0] and not seen:
            seen.append([x.clone() if torch.is_tensor(x) else x for x in a])
        return real(sh, *a, **kw)

    bm.batched_trace_padded = spy
    try:
        with torch.no_grad():
            batch("march")
    finally:
        bm.batched_trace_padded = real
    bank, o_r, v_r, m_r, seed_r, act_r, block, salvage = seen[0][:8]
    grid = lambda p: real(packed[0], bank, o_r, v_r, m_r, seed_r, act_r, block,
                          salvage, True, p)
    differ = lambda x, y: ~((x == y) | (x.isnan() & y.isnan())) if x.is_floating_point() else x != y
    with torch.no_grad():
        km, k1 = grid(False), grid(True)
        torch.cuda.synchronize()
        exact = all(torch.equal(getattr(km, f), getattr(k1, f)) for f in TRACE_FIELDS)
        km_ms, k1_ms = cuda_ms(lambda: grid(False)), cuda_ms(lambda: grid(True))
        # its plain version on the same rays, 8 frames at a time (memory)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        parts = [real(packed[0], bank[:, i:i + 8], o_r[i:i + 8], v_r[i:i + 8], m_r,
                      seed_r[i:i + 8], act_r[i:i + 8], block, salvage, False, False)
                 for i in range(0, F8, 8)]
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        # K1 and K1-grid against the in-order witness (csrc/march_in_order.cu:
        # the decoder on CUDA cores, every sum in k order) on the same rays:
        # K1 in one launch over every frame, K1-grid frame by frame with that
        # frame's bank column as its folded biases; every ray's bits
        from dist_renderer_tpu_torch.ops.kernels import fused_march as fm
        from dist_renderer_tpu_torch.ops.kernels.march_in_order import trace_in_order

        f_r, r_r = v_r.shape[0], v_r.shape[1]
        r_pad = k1.steps_per_ray.shape[0] // f_r
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        w = trace_in_order(packed[0], bank, o_r, v_r, m_r, seed_r, act_r, salvage)
        b.record()
        torch.cuda.synchronize()
        witness_ms = a.elapsed_time(b)
        w_steps = w.steps_per_ray.reshape(f_r, r_pad)[:, :r_r]
        fields = ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf", "unresolved",
                  "bracketed")
        bad = k1.steps_per_ray.reshape(f_r, r_pad)[:, :r_r] != w_steps
        for f in fields:
            bad |= differ(getattr(k1, f), getattr(w, f))
        cross = int(bad.sum())
        cross_grid = 0
        for i in range(f_r):
            g = fm.sphere_trace_grid(fm.PackedFolded(packed[0], bank[:, i:i + 1].contiguous()),
                                     o_r[i], v_r[i], m_r, seed_r[i], act_r[i], salvage)
            bad = g.steps_per_ray != w_steps[i]
            for f in fields:
                bad |= differ(getattr(g, f), getattr(w, f)[i])
            cross_grid += int(bad.sum())
        torch.cuda.synchronize()
    # the round's lanes: a 64-ray tile steps while any of its rays is active
    tile_steps = bm.march_tile_steps(k1.steps_per_ray)
    lanes = dict(ray_steps=int(k1.steps_per_ray.sum()), tile_steps=int(tile_steps.sum()),
                 lane_steps=bm.MARCH_TILE * int(tile_steps.sum()),
                 live_tiles=int((tile_steps > 0).sum()), tiles=tile_steps.numel(),
                 lane_steps_32=bm.TILE * int(k1.steps_per_ray.reshape(-1, bm.TILE).amax(1).sum()))
    print(f"the in-order witness (CUDA cores, {witness_ms:.1f} ms) on the verify stage's "
          f"first round: K1 differs on {cross} rays of {f_r * r_r}, K1-grid (frame by "
          f"frame) on {cross_grid}; lanes of K1 and K1-multi "
          f"(64-ray tiles): {lanes['ray_steps']} active ray-steps of {lanes['lane_steps']} "
          f"lane-steps ({lanes['ray_steps'] / max(lanes['lane_steps'], 1):.4f}; 32-ray "
          f"tiles would spend {lanes['lane_steps_32']}), {lanes['tile_steps']} tile "
          f"evaluations, {lanes['live_tiles']} of {lanes['tiles']} tiles marched",
          flush=True)
    check(cross == 0 and cross_grid == 0, f"K1 differs from the in-order witness on "
          f"{cross} rays of the verify stage's first round, K1-grid on {cross_grid}")
    plain = types.SimpleNamespace(**{f: torch.cat([getattr(p, f) for p in parts])
                                     for f in ("depth", "hit", "min_sdf", "depth_at_min")})
    d_multi = march_diff(km, plain)
    d_k1 = march_diff(k1, plain)
    steps = int(km.steps_per_ray.sum())
    n_rays = km.steps_per_ray.numel()
    b_multi = bound_ms(march_bytes(n_rays, packed[0], bank), 2 * steps * macs_per_eval(packed[0]))
    print(f"K1-multi on the verify stage's first round ({o_r.shape[0]} frames x "
          f"{o_r.shape[1]} rays, cap {m_r.max_steps}, {steps} active ray-steps): == K1 bit "
          f"for bit: {exact}; {km_ms:.3f} ms vs K1 {k1_ms:.3f} ms; vs plain "
          f"({plain_ms:.1f} ms): {march_line(d_multi)} (bound {b_multi[0]:.3f} ms, "
          f"{b_multi[1]})", flush=True)
    check(exact, "K1-multi differs from K1 on the verify stage's first round")
    check(march_ok(d_multi), f"K1-multi disagrees with its plain version: "
          f"{march_line(d_multi)} (bars: agreement >= {MARCH_AGREE}, |diff| <= {MARCH_TOL})")
    check(march_ok(d_k1), f"K1 disagrees with its plain version: "
          f"{march_line(d_k1)} (bars: agreement >= {MARCH_AGREE}, |diff| <= {MARCH_TOL})")

    # render_depth_batched (K1-multi) against K1 on the same rays
    with torch.no_grad():
        shared_f = bm.pack_shared(params, dcfg)
        ref = real(shared_f, bm.fold_bias_bank(params, lats, dcfg, shared_f),
                   ob.expand(F8, n, 3), vb, march, None,
                   torch.ones((F8, n), dtype=torch.bool, device=dev), 512, True,
                   True, True)
        torch.cuda.synchronize()
    dd_exact = torch.equal(dd_out[0], ref.depth) and torch.equal(dd_out[1], ref.hit)
    del ref
    print(f"render_depth_batched at F={F8} (K1-multi, every ray from its sphere entry): "
          f"{dd_ms:.1f} ms, hit_frac {dd_out[1].float().mean().item():.4f}; == K1 bit "
          f"for bit: {dd_exact}", flush=True)
    check(dd_exact, "render_depth_batched differs from K1 on the same rays")

    # the kernel path against the plain versions at F=4, (a) march-verify
    # and (d) cert: with the GEMM, and with the in-order product in its place
    from dist_renderer_tpu_torch.models.decoder import dot_f32_in_order

    fields = ("depth", "hit", "min_sdf", "depth_at_min")
    with torch.no_grad():
        # the in-order product against a loop over k, bit for bit
        gen = torch.Generator(device="cpu").manual_seed(SEED + 10)
        bf = lambda *sh: torch.randn(sh, generator=gen).to(torch.bfloat16).float().to(dev)
        ok_dot = True
        for x, w in ((bf(1000, 515), bf(515, 70)), (bf(4096, 3), bf(3, 512))):
            loop = torch.zeros((x.shape[0], w.shape[1]), device=dev)
            for k in range(x.shape[1]):
                loop = loop + x[:, k:k + 1] * w[k]
            ok_dot &= torch.equal(dot_f32_in_order(x, w), loop)
        check(ok_dot, "the in-order product differs from its loop over k")
    # The plain versions' GEMM picks its summation order by the launch's
    # shape (the rays a scheduler left live); a last-bit difference in a
    # coarse level moves a seed, and that ray's march then stops elsewhere
    # inside the convergence ball (eps 2e-3). With the k sum in the
    # kernels' order the plain path must give every ray's bits.
    from dist_renderer_tpu_torch.ops import cert as cert_mod

    def proxy_depth_of(fn):
        """(fn(), the proxy depth certify_hits_batched was given, or None)."""
        seen, real_cert = [], cert_mod.certify_hits_batched

        def spy(*a, **kw):
            seen.append(a[4].clone())
            return real_cert(*a, **kw)

        cert_mod.certify_hits_batched = spy
        try:
            return fn(), (seen[0] if seen else None)
        finally:
            cert_mod.certify_hits_batched = real_cert

    def gemm_vs_plain(name, run, label):
        """The kernel path against the plain versions with the GEMM, on
        run(use_kernel); under cert, the rays outside MARCH_TOL in depth
        counted with those whose proxy depth (the probes' anchor) moved."""
        with torch.no_grad():
            rk, pk = run(True)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rp, pp = run(False)
            b.record()
            torch.cuda.synchronize()
            gemm_ms = a.elapsed_time(b)
        d_path = march_diff(rk, rp)
        same = rk.hit == rp.hit
        both = rk.hit & rp.hit
        within = dict(
            depth=((rk.depth - rp.depth).abs()[both] <= MARCH_TOL).float().mean().item(),
            min_sdf=((rk.min_sdf - rp.min_sdf).abs()[same] <= MARCH_TOL).float().mean().item(),
            depth_at_min=((rk.depth_at_min - rp.depth_at_min).abs()[same]
                          <= MARCH_TOL).float().mean().item())
        d_path.update(within=within, gemm_ms=gemm_ms)
        note = ""
        if pk is not None:
            out = both & ((rk.depth - rp.depth).abs() > MARCH_TOL)
            moved = differ(pk, pp)
            d_path.update(outside=int(out.sum()), outside_proxy_moved=int((out & moved).sum()),
                          proxy_moved=int(moved.sum()))
            note = (f"; of the {d_path['outside']} common hits outside {MARCH_TOL} in depth, "
                    f"{d_path['outside_proxy_moved']} have a proxy depth that differs "
                    f"({d_path['proxy_moved']} rays' proxy depths differ)")
        print(f"({name}) at F={F8_PLAIN}, {label}, kernels vs plain versions with the GEMM "
              f"({gemm_ms:.0f} ms): {march_line(d_path)}; within {MARCH_TOL}: " + ", ".join(
                  f"{k} {v:.6f}" for k, v in within.items()) + note, flush=True)
        check(d_path["agree"] >= PATH_AGREE and max_err(d_path) <= PATH_MAX
              and all(within[k] >= v for k, v in PATH_WITHIN[name].items())
              and d_path.get("outside") == d_path.get("outside_proxy_moved"),
              f"phase 8's kernel path ({name}, {label}) disagrees with the plain versions "
              f"at F={F8_PLAIN}: {march_line(d_path)}, within {MARCH_TOL}: {within} (bars: "
              f"agreement >= {PATH_AGREE}, max |diff| <= {PATH_MAX}, within {MARCH_TOL} "
              f"on at least {PATH_WITHIN[name]} of the rays, and under cert only rays "
              f"whose proxy depth moved outside it)")
        return d_path

    # (d)'s K6 sums on the tensor cores and again in k order the values whose
    # bf16 rounding that may move; (d) is also held to a second run of itself
    paths = {}
    for name, mode in (("a", "march"), ("d", "cert")):
        with torch.no_grad():
            rk = batch(mode, f=F8_PLAIN, return_anchor=True)
            t0 = time.perf_counter()
            ro = in_order(lambda: batch(mode, f=F8_PLAIN, use_kernel=False,
                                        return_anchor=True))
            order_ms = 1e3 * (time.perf_counter() - t0)
            n_diff = {f: int(differ(getattr(rk, f), getattr(ro, f)).sum()) for f in fields}
            del ro
            n_again = None
            if name == "d":
                ra = batch(mode, f=F8_PLAIN, return_anchor=True)
                n_again = {f: int(differ(getattr(rk, f), getattr(ra, f)).sum())
                           for f in fields}
                del ra
        del rk
        print(f"({name}) at F={F8_PLAIN}, kernels vs plain versions with the in-order "
              f"product ({order_ms:.0f} ms; product == its loop over k: {ok_dot}): rays "
              f"that differ: {n_diff}" + ("" if n_again is None else
                                          f"; vs a second run of the kernels: {n_again}"),
              flush=True)
        check(not any(n_diff.values()),
              f"phase 8's kernel path ({name}) differs from the plain versions with the "
              f"kernels' summation order at F={F8_PLAIN}: {n_diff} rays")
        check(n_again is None or not any(n_again.values()),
              f"phase 8's kernel path ({name}) differs from a second run of its kernels "
              f"at F={F8_PLAIN}: {n_again} rays")
        paths[name] = gemm_vs_plain(name, lambda k: proxy_depth_of(lambda: batch(
            mode, f=F8_PLAIN, use_kernel=k, return_anchor=True)), f"seed {SEED + 9}")
        paths[name].update(in_order_rays_differing=n_diff, in_order_ms=order_ms,
                           second_run_rays_differing=n_again)
    # (d)'s share within MARCH_TOL on two more sets of frames (other jitter)
    paths["d_more"] = []
    for seed in (SEED + 11, SEED + 12):
        batch_s, _, _ = batched_setup(dev, F8_PLAIN, IMG, seed)
        paths["d_more"].append(gemm_vs_plain("d", lambda k: proxy_depth_of(lambda: batch_s(
            "cert", use_kernel=k, return_anchor=True)), f"seed {seed}"))
    return dict(rows=rows, launches=launches, k1_multi=dict(
        ms=km_ms, k1_ms=k1_ms, plain_ms=plain_ms, d=d_multi, d_k1=d_k1, bound_ms=b_multi[0],
        bound_by=b_multi[1], ray_steps=steps, exact=exact, k1_in_order_differ=cross,
        k1_grid_in_order_differ=cross_grid, witness_ms=witness_ms, lanes=lanes),
        render_depth_ms=dd_ms, path_vs_plain=paths, k6=k6_rows)


K5_POINTS = 262_144   # phase 9 (a): seeded points in [-1, 1]^3
K5_IN_ORDER = 65_536  # of those, held to the in-order plain version
K5_RAGGED = (1, 31, 33, 100_000)  # prefixes of them K5 must give the same bits
# Phase 9 (a), K5 against its plain version with the card's GEMM: the
# least share of points within 1e-5 and the largest |diff|. Read on an
# H100: every point equal. The bars allow what two summation orders gave
# on the CPU (tests/test_torch_mlp_eval.py): >= 99.7% within 1e-5, max
# 3.0e-3 (a flipped bf16 activation rounding).
K5_WITHIN, K5_MAX = 0.99, 5e-3
# The color render's RGB against the plain versions': sigmoid(logits),
# whose slope is at most 1/4, so K5's bar on the logits bounds RGB by
# K5_MAX / 4
RGB_MAX = K5_MAX / 4
MESH_RES = (128, 256)


def k5_bytes(n, packed, out_rows):
    """K5's traffic: [N, 3] points in, [N, out_rows] out, the weights and
    the folded biases once."""
    return 4 * (3 + out_rows) * n + 2 * packed.shared.flat.numel() + 4 * packed.bias.numel()


def k5_macs(shared, out_rows):
    """Multiply-adds of one K5 evaluation: the march's, with out_rows
    outputs of the last layer."""
    in_last = shared.table[-4]
    return macs_per_eval(shared) + (out_rows - 1) * in_last


def in_order(fn):
    """fn() with the plain versions' products summed in k order
    (decoder.dot_f32_in_order, the kernels' order), synchronized."""
    import torch

    from dist_renderer_tpu_torch.models.decoder import dot_f32_in_order
    from dist_renderer_tpu_torch.ops.kernels import march_body, recompute

    real = march_body.dot_f32, recompute.dot_f32
    march_body.dot_f32 = recompute.dot_f32 = dot_f32_in_order
    try:
        out = fn()
        torch.cuda.synchronize()
        return out
    finally:
        march_body.dot_f32, recompute.dot_f32 = real


def bf16_chain(torch, params, cfg, latent):
    """The library yardstick for K5: the folded decoder as a chain of bf16
    torch.nn.functional.linear calls (cuBLAS, tensor cores), the xyz
    columns concatenated to a layer's input where it takes them. It
    computes K5's function up to bf16 rounding of sums and biases; the
    port never calls it."""
    from dist_renderer_tpu_torch.models.folded import fold_latent

    F = torch.nn.functional
    layers = []
    for l in fold_latent(params, latent, cfg):
        w = l.wx if l.wh is None else (l.wh if l.wx is None else torch.cat([l.wh, l.wx]))
        layers.append((w.T.contiguous().to(torch.bfloat16), l.b.to(torch.bfloat16),
                       l.wh is not None and l.wx is not None))

    def run(pts, out_rows):
        x = pts.to(torch.bfloat16)
        h = None
        for i, (w, b, cat) in enumerate(layers):
            inp = x if h is None else (torch.cat([h, x], dim=-1) if cat else h)
            h = F.linear(inp, w, b)
            if i < len(layers) - 1:
                h = torch.relu(h)
        out = h[:, :out_rows].float()
        return torch.tanh(out) if cfg.final_tanh else out

    return run


def precise_chain(torch, params, cfg, latent, dtype=None):
    """The library yardstick for K3 and K4: the folded decoder's forward as
    a chain of bf16 torch.nn.functional.linear calls (cuBLAS, tensor
    cores), keeping the ReLU gates, then the reverse sweep from the value
    through the transposed weights, bf16 F.linear again. sdg(points, dirs)
    -> (s, dd, g) computes K3's function, bias_grads(points, ct) -> [u_l]
    K4's (a) (ct through the tanh chain, u_l summed over the points for
    each layer the latent enters), both up to bf16 rounding of inputs,
    sums and cotangents; the port never calls it. dtype=torch.float32
    runs the same chain on fp32 weights and activations (TF32 is off), to
    tell the bf16 chain's rounding from a fault in the chain."""
    from dist_renderer_tpu_torch.models.folded import fold_latent

    F = torch.nn.functional
    dt = torch.bfloat16 if dtype is None else dtype
    layers = []
    for i, l in enumerate(fold_latent(params, latent, cfg)):
        w = l.wx if l.wh is None else (l.wh if l.wx is None else torch.cat([l.wh, l.wx]))
        w = w.T.contiguous().to(dt)
        layers.append(dict(w=w, wt=w.T.contiguous(), b=l.b.to(dt),
                           cat=l.wh is not None and l.wx is not None,
                           n_h=0 if l.wh is None else l.wh.shape[0], has_x=l.wx is not None,
                           takes_z=i == 0 or i in cfg.latent_in))

    def sweep(pts, seed):
        x = pts.to(dt)
        h, gates = None, []
        for i, l in enumerate(layers):
            inp = x if h is None else (torch.cat([h, x], dim=-1) if l["cat"] else h)
            h = F.linear(inp, l["w"], l["b"])
            if i < len(layers) - 1:
                gates.append(h > 0)
                h = torch.relu(h)
        pre0 = h[:, 0].float()
        s, d = pre0, seed
        if cfg.use_tanh:
            s = torch.tanh(s)
            d = d * (1.0 - s * s)
        if cfg.final_tanh:
            s = torch.tanh(s)
            d = d * (1.0 - s * s)
        delta = torch.zeros_like(h)
        delta[:, 0] = d.to(dt)
        gx, us = None, []
        for i in range(len(layers) - 1, -1, -1):
            l = layers[i]
            if l["takes_z"]:
                us.append(delta.float().sum(0))
            back = F.linear(delta, l["wt"])
            if l["has_x"]:
                gx = back[:, l["n_h"]:].float() if gx is None else gx + back[:, l["n_h"]:].float()
            if l["n_h"] == 0:
                break
            delta = back[:, :l["n_h"]] * gates[i - 1]
        us.reverse()
        return s, gx, us

    def sdg(pts, dirs):
        s, gx, _ = sweep(pts, torch.ones(pts.shape[0], device=pts.device))
        return s, (gx * dirs).sum(-1), gx

    def bias_grads(pts, ct):
        return sweep(pts, ct)[2]

    return types.SimpleNamespace(sdg=sdg, bias_grads=bias_grads)


def folded_reference(torch, params, cfg, latent, pts, ct):
    """K3's and K4's (a) function in fp64, by autograd through the folded
    decoder: (s [N], g [N, 3], u [sum of the latent layers' widths],
    kink [N]), u the gradient of sum(ct * s) to the folded biases of each
    layer the latent enters, kink each point's least |preactivation| of a
    hidden unit (near 0 an fp32 sum may take the other ReLU gate, which
    moves that point's g and u by a whole unit's term). The truth that the
    kernels and both chains are each measured against; the port never
    calls it."""
    from dist_renderer_tpu_torch.models.folded import fold_latent

    folded = fold_latent(params, latent, cfg)
    bs = [l.b.double().clone().requires_grad_(True) for l in folded]
    x = pts.double().clone().requires_grad_(True)
    h = None
    kink = torch.full((pts.shape[0],), float("inf"), dtype=torch.float64, device=pts.device)
    with torch.enable_grad():
        for i, l in enumerate(folded):
            acc = bs[i]
            if l.wh is not None:
                acc = acc + h @ l.wh.double()
            if l.wx is not None:
                acc = acc + x @ l.wx.double()
            if i < len(folded) - 1:
                kink = torch.minimum(kink, acc.detach().abs().amin(1))
            h = torch.relu(acc) if i < len(folded) - 1 else acc
        s = h[:, 0]
        if cfg.use_tanh:
            s = torch.tanh(s)
        if cfg.final_tanh:
            s = torch.tanh(s)
        g, = torch.autograd.grad(s.sum(), x, retain_graph=True)
        us = torch.autograd.grad((s * ct.double()).sum(),
                                 [b for i, b in enumerate(bs) if i == 0 or i in cfg.latent_in])
    return s.detach(), g, torch.cat(us), kink


def k6_macs(shared):
    """Multiply-adds of one K6 evaluation: the march's, plus the x-products
    of the positions' low halves."""
    t = shared.table
    rows = [t[i:i + 5] for i in range(0, len(t), 5)]
    lo = sum(3 * (1 if li == len(rows) - 1 else r[0])
             for li, r in enumerate(rows) if r[3] >= 0)
    return macs_per_eval(shared) + lo


def k6_bytes(n, n_blocks, shared, bank):
    """K6's traffic: [n, 3] points, n active flags and the block frames in,
    [n] values out, the weights and the bias bank once."""
    return 4 * 4 * n + n + 4 * n_blocks + 2 * shared.flat.numel() + 4 * bank.numel()


def k6_chain(torch, shared, bank):
    """The library yardstick for K6: the shared decoder as a chain of bf16
    torch.nn.functional.linear calls (cuBLAS, tensor cores) on the points of
    the live tiles, the positions' high and low halves each through the x
    weights, each point's bias gathered from its frame's bank column. It
    computes K6's function up to bf16 rounding of sums and biases; the
    port never calls it."""
    F = torch.nn.functional

    def run(pts, frame):
        hi = pts.to(torch.bfloat16)
        lo = (pts - hi.float()).to(torch.bfloat16)
        h = None
        last = len(shared.offsets) - 1
        for li, (wh, wx, (off, out_p)) in enumerate(zip(shared.whT, shared.wxT,
                                                        shared.offsets)):
            acc = bank[off:off + out_p].T[frame].to(torch.bfloat16)
            if wh is not None:
                acc = acc + F.linear(h, wh)
            if wx is not None:
                acc = acc + F.linear(hi, wx[:, :3]) + F.linear(lo, wx[:, :3])
            h = torch.relu(acc) if li < last else acc
        out = h[:, 0].float()
        return torch.tanh(out) if shared.final_tanh else out

    return run


def k6_row(torch, dev, smi):
    """Phase 3's K6 row: the certification probes (a and b, hit-first
    buckets, dead suffixes) of phase 8's verify_mode="cert" batch cut to
    F8_PLAIN frames, on the bench decoder: K6 against its plain version
    with the GEMM (active lanes within K5's bars, dead tiles equal), with
    the in-order product (bit for bit) and against itself with its blocks
    shuffled and split (bit for bit), timed beside its plain version and a
    bf16 F.linear chain on the live tiles' points."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval
    from dist_renderer_tpu_torch.profile_render import batched_setup

    batch, _, _ = batched_setup(dev, F8_PLAIN, IMG, SEED + 9)
    seen, real = [], mlp_eval.point_eval_banked

    def spy(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return real(*a, **kw)

    # the wrapper counts on its module-level name; these launches do not
    # count for the main path (the real counter is left as it was)
    spy.launches = 0
    mlp_eval.point_eval_banked = spy
    try:
        batch("cert")
    finally:
        mlp_eval.point_eval_banked = real
    (shared, bank, fob, pts, act), kw = seen[0]
    block = kw["block"]
    run = lambda k: real(shared, bank, fob, pts, act, block=block, use_kernel=k)
    out_k, out_p = run(True), run(False)
    exact = torch.equal(out_k, in_order(lambda: run(False)))
    grouped = k6_grouping_exact(torch, real, shared, bank, fob, pts, act, block, out_k)
    live = mlp_eval._live_tiles(act)
    err = (out_k - out_p).abs()[act]
    n_eval = int(live.sum())
    chain = k6_chain(torch, shared, bank)
    frame = fob.to(torch.int64).repeat_interleave(block)
    pts_l, frame_l = pts[live], frame[live]
    lib_err = (chain(pts_l, frame_l) - out_k[live]).abs().max().item()
    row = dict(n=pts.shape[0], evaluated=n_eval, active=int(act.sum()), exact=exact,
               grouping_exact=grouped,
               dead_equal=bool((out_k[~live] == out_p[~live]).all()),
               max=err.max().item(), within=(err <= 1e-5).float().mean().item(),
               ms=cuda_ms(lambda: run(True)), plain_ms=cuda_ms(lambda: run(False)),
               library_ms=cuda_ms(lambda: chain(pts_l, frame_l)), library_max=lib_err)
    row["bound_ms"], row["bound_by"] = bound_ms(k6_bytes(row["n"], fob.numel(), shared, bank),
                                                2 * n_eval * k6_macs(shared))
    print(f"K6 banked point eval, phase 8's cert probes at F={F8_PLAIN} ({row['n']} "
          f"lanes, {row['active']} active, {n_eval} evaluated in live tiles): vs plain "
          f"(GEMM) on active lanes max |diff| {row['max']:.3e}, within 1e-5 "
          f"{row['within']:.6f}, dead tiles equal {row['dead_equal']}; == in-order plain "
          f"bit for bit: {exact}; blocks shuffled and split over two launches bit for "
          f"bit: {grouped}; {row['ms']:.3f} ms vs plain {row['plain_ms']:.3f} ms, "
          f"bf16 F.linear chain {row['library_ms']:.3f} ms (max |diff| {lib_err:.2e}); "
          f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}, "
          f"{row['bound_ms'] / row['ms']:.1%})  [{smi}]", flush=True)
    check(exact, "K6 differs from its in-order plain version")
    check(grouped, "K6 gives a point other bits when its blocks are shuffled or split "
          "over two launches")
    check(row["dead_equal"] and row["within"] >= K5_WITHIN and row["max"] <= K5_MAX,
          f"K6 disagrees with its plain version (bars: within 1e-5 on >= {K5_WITHIN} "
          f"of active lanes, max |diff| <= {K5_MAX}, dead tiles equal)")
    return row


def k6_grouping_exact(torch, k6, shared, bank, fob, pts, act, block, out):
    """K6 against itself: the blocks shuffled (each keeping its frame and
    points) and split over two launches give out's bits on every lane
    live in both groupings (a 32-point tile's liveness follows its
    neighbours), and 3e38 on every lane of a dead tile."""
    from dist_renderer_tpu_torch.ops.kernels.mlp_eval import _live_tiles

    nb = fob.shape[0]
    gen = torch.Generator().manual_seed(SEED + 13)
    perm = torch.randperm(nb, generator=gen).to(pts.device)
    lanes = (perm[:, None] * block + torch.arange(block, device=pts.device)).reshape(-1)
    run = lambda f, p, a: k6(shared, bank, f.contiguous(), p.contiguous(), a.contiguous(),
                             block=block)
    live = _live_tiles(act)

    def same(ln, got, now):
        both = now & live[ln]
        return (torch.equal(got[both], out[ln][both]) and bool((got[~now] == 3.0e38).all()))

    cut = (nb // 3) * block  # each launch's tiles start at its first lane
    return (same(lanes, run(fob[perm], pts[lanes], act[lanes]), _live_tiles(act[lanes]))
            and same(torch.arange(pts.shape[0], device=pts.device),
                     torch.cat([run(fob[:nb // 3], pts[:cut], act[:cut]),
                                run(fob[nb // 3:], pts[cut:], act[cut:])]),
                     torch.cat([_live_tiles(act[:cut]), _live_tiles(act[cut:])])))


def k5_grouping_exact(torch, run, pts, out):
    """K5 against itself: the points shuffled, split over two launches and
    as ragged prefixes (K5_RAGGED) give every point out's bits."""
    gen = torch.Generator().manual_seed(SEED + 14)
    perm = torch.randperm(pts.shape[0], generator=gen).to(pts.device)
    cut = pts.shape[0] // 3 + 7
    return (torch.equal(run(pts[perm].contiguous()), out[perm])
            and torch.equal(torch.cat([run(pts[:cut].contiguous()),
                                       run(pts[cut:].contiguous())]), out)
            and all(torch.equal(run(pts[:m].contiguous()), out[:m]) for m in K5_RAGGED))


def k6_capture(torch, fn):
    """fn() with every call of the K6 wrapper kept: (args, kwargs, output),
    cloned. The wrapper counts its launches on its module-level name, here
    the spy, which hands them on to the real counter: the calls count as
    the path's own."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    calls, real = [], mlp_eval.point_eval_banked

    def spy(*a, **kw):
        out = real(*a, **kw)
        real.launches += spy.launches
        spy.launches = 0
        calls.append(([x.clone() if torch.is_tensor(x) else x for x in a], dict(kw),
                      out.clone()))
        return out

    spy.launches = 0
    mlp_eval.point_eval_banked = spy
    try:
        out = fn()
    finally:
        mlp_eval.point_eval_banked = real
    return out, calls


def k6_held(torch, calls, where):
    """K6's outputs of a path's calls (k6_capture) against its plain
    version with the GEMM on the same inputs: active lanes within K5's
    bars, every point of a dead tile equal (3e38). Returns the worst."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    check(len(calls) > 0, f"{where}: no K6 call to hold against its plain version")
    res = dict(calls=len(calls), lanes=0, max=0.0, within=1.0, dead_equal=True)
    for (shared, bank, fob, pts, act), kw, out in calls:
        plain = mlp_eval.point_eval_banked_plain(
            shared, bank, fob, pts, act, kw.get("block", 512), kw.get("precise_x", True))
        live = mlp_eval._live_tiles(act)
        err = (out - plain).abs()[act]
        res["lanes"] += pts.shape[0]
        res["max"] = max(res["max"], err.max().item() if err.numel() else 0.0)
        res["within"] = min(res["within"], (err <= 1e-5).float().mean().item()
                            if err.numel() else 1.0)
        res["dead_equal"] &= bool((out[~live] == plain[~live]).all())
    print(f"K6 on {where}: {res['calls']} calls, {res['lanes']} lanes, vs plain (GEMM) "
          f"on active lanes max |diff| {res['max']:.3e}, within 1e-5 {res['within']:.6f} "
          f"(least of the calls), dead tiles equal {res['dead_equal']}", flush=True)
    check(res["dead_equal"] and res["within"] >= K5_WITHIN and res["max"] <= K5_MAX,
          f"K6 disagrees with its plain version on {where} (bars: within 1e-5 on >= "
          f"{K5_WITHIN} of active lanes, max |diff| <= {K5_MAX}, dead tiles equal)")
    return res


def k5_phase(torch, dev, params, dcfg, latent, cam, smi):
    """Phase 9: K5 and the paths through it. (a) K5 against its plain
    version on 262,144 seeded points, the bench decoder (1 row) and the
    default 8x512 color decoder (3 rows): the GEMM's differences, bit for
    bit with the in-order product on 65,536 of them, and bit for bit
    against itself shuffled, split and at ragged prefixes; times beside a
    chain of bf16 F.linear calls. (b) Mesh extraction of the bench shape
    through make_pallas_point_fn + extract_mesh at 128^3 and 256^3, the K5
    grid against the plain grid, the K5 mesh against the precise sdf's at
    128^3. (c) SDFRendererColor on the K1-grid path at 512^2 with the
    differentiable color head: fwd and fwd+bwd of a photometric L1, RGB
    against the plain versions (within RGB_MAX with the GEMM, bit for bit
    with the in-order product), gradients to both latents against the
    plain versions."""
    import numpy as np

    from dist_renderer_tpu_torch.config import GradConfig, MarchConfig, RenderConfig
    from dist_renderer_tpu_torch.eval.chamfer import chamfer_distance
    from dist_renderer_tpu_torch.eval.mesh import assemble_mesh, extract_mesh, sdf_grid
    from dist_renderer_tpu_torch.eval.native import load_library
    from dist_renderer_tpu_torch.models.color_decoder import (
        init_color_params, make_color_config,
    )
    from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
    from dist_renderer_tpu_torch.models.folded import fold_latent
    from dist_renderer_tpu_torch.ops.kernels.fused_march import pack_folded, sphere_trace_grid
    from dist_renderer_tpu_torch.ops.kernels.mlp_eval import make_pallas_point_fn, point_eval
    from dist_renderer_tpu_torch.ops.kernels.recompute import (
        make_color_vjp, precise_bias_grads_call, precise_sdg_call,
    )
    from dist_renderer_tpu_torch.ops.renderer import SDFRenderer, SDFRendererColor

    def host_ms(fn, reps=1):
        """(last output, median ms) of fn() ending in a synchronize."""
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return out, sorted(ms)[len(ms) // 2]

    print(f"\n== phase 9: K5 (bulk point eval), mesh extraction, the color render ==")
    ccfg = make_color_config()
    gen = torch.Generator().manual_seed(SEED + 11)
    cparams = init_color_params(gen, ccfg, dev)
    z_tex = (0.3 * torch.randn(ccfg.latent_size, generator=gen)).to(dev)
    z_tgt = (0.3 * torch.randn(ccfg.latent_size, generator=gen)).to(dev)

    # (a) K5 against its plain version
    gen = torch.Generator().manual_seed(SEED + 12)
    pts = (torch.rand((K5_POINTS, 3), generator=gen) * 2.0 - 1.0).to(dev)
    rows_a = []
    for name, p_, c_, z_, r in (("sdf", params, dcfg, latent, 1),
                                ("color", cparams, ccfg, z_tex, 3)):
        packed = pack_folded(fold_latent(p_, z_, c_), c_)
        run = lambda k, x=pts: point_eval(packed, x, out_rows=r, use_kernel=k)
        out_k, out_p = run(True), run(False)
        head = pts[:K5_IN_ORDER].contiguous()
        exact = torch.equal(out_k[:K5_IN_ORDER], in_order(lambda: run(False, head)))
        grouped = k5_grouping_exact(torch, lambda x: run(True, x), pts, out_k)
        err = (out_k - out_p).abs().reshape(K5_POINTS, -1).amax(dim=1)
        chain = bf16_chain(torch, p_, c_, z_)
        lib_err = (chain(pts, r).reshape(out_k.shape) - out_k).abs().max().item()
        row = dict(case=name, out_rows=r, n=K5_POINTS, exact=exact, grouping_exact=grouped,
                   max=err.max().item(), within=(err <= 1e-5).float().mean().item(),
                   ms=cuda_ms(lambda: run(True)), plain_ms=cuda_ms(lambda: run(False)),
                   library_ms=cuda_ms(lambda: chain(pts, r)), library_max=lib_err)
        row["bound_ms"], row["bound_by"] = bound_ms(k5_bytes(K5_POINTS, packed, r),
                                                    2 * K5_POINTS * k5_macs(packed.shared, r))
        rows_a.append(row)
        print(f"K5 ({name}, {r} row{'s' if r > 1 else ''}) {K5_POINTS} points: vs plain "
              f"(GEMM) max |diff| {row['max']:.3e}, within 1e-5 {row['within']:.6f}; == "
              f"in-order plain on {K5_IN_ORDER} bit for bit: {exact}; shuffled, split and "
              f"ragged ({K5_RAGGED}) bit for bit: {grouped}; {row['ms']:.3f} ms vs "
              f"plain {row['plain_ms']:.3f} ms, bf16 F.linear chain {row['library_ms']:.3f} "
              f"ms (max |diff| {lib_err:.2e}); bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']})  [{smi}]", flush=True)
    for row in rows_a:
        check(row["exact"], f"K5 ({row['case']}) differs from its in-order plain version")
        check(row["grouping_exact"], f"K5 ({row['case']}) gives a point other bits when "
              "the points are shuffled, split over two launches or cut to a ragged prefix")
        check(row["within"] >= K5_WITHIN and row["max"] <= K5_MAX,
              f"K5 ({row['case']}) disagrees with its plain version (bars: within 1e-5 "
              f"on >= {K5_WITHIN} of points, max |diff| <= {K5_MAX})")

    # (b) mesh extraction of the bench shape through K5
    fn = make_pallas_point_fn(params, latent, dcfg)
    plain_fn = make_pallas_point_fn(params, latent, dcfg, use_kernel=False)
    precise = make_precise_sdf(params, dcfg)
    route = "native" if load_library() is not None else "numpy"
    rows_b, mesh_launches = [], 0
    for res in MESH_RES:
        point_eval.launches = 0
        (verts, faces), total_ms = host_ms(lambda: extract_mesh(fn, res, device=dev))
        launches = point_eval.launches
        mesh_launches += launches
        grid_k, grid_ms = host_ms(lambda: sdf_grid(fn, res, device=dev),
                                  3 if res <= 128 else 1)
        (_, _, rt), asm_ms = host_ms(lambda: assemble_mesh(grid_k))
        grid_p, plain_ms = host_ms(lambda: sdf_grid(plain_fn, res, device=dev))
        d = np.abs(grid_k - grid_p)
        row = dict(res=res, verts=len(verts), faces=len(faces), launches=launches,
                   total_ms=total_ms, grid_ms=grid_ms, assembly_ms=asm_ms, route=rt,
                   plain_grid_ms=plain_ms, max=float(d.max()),
                   sign_agree=float((np.sign(grid_k) == np.sign(grid_p)).mean()))
        if res == MESH_RES[0]:
            # against the mesh of the precise sdf (fp32 decoder) on the same grid
            pv, pf, _ = assemble_mesh(sdf_grid(lambda p: precise(latent, p), res,
                                               device=dev))
            a, b = (torch.as_tensor(v, device=dev) for v in (verts, pv))
            row.update(precise_verts=len(pv),
                       chamfer_euclid=float(chamfer_distance(a, b, squared=False)[2]),
                       chamfer_sq=float(chamfer_distance(a, b)[2]),
                       spacing=2.0 / (res - 1))
        rows_b.append(row)
        print(f"mesh {res}^3 through K5: {row['verts']} verts, {row['faces']} faces; "
              f"extract_mesh {total_ms:.1f} ms ({launches} K5 launches); sdf_grid "
              f"{grid_ms:.1f} ms, triangle assembly ({rt}) {asm_ms:.1f} ms; plain grid "
              f"{plain_ms:.1f} ms, max |diff| {row['max']:.3e}, sign agreement "
              f"{row['sign_agree']:.7f}" + (
                  f"; vs the precise sdf's mesh ({row['precise_verts']} verts): "
                  f"chamfer mean euclidean (sum of both ways) {row['chamfer_euclid']:.3e}, "
                  f"squared {row['chamfer_sq']:.3e}, grid spacing {row['spacing']:.4f}"
                  if "chamfer_euclid" in row else "") + f"  [{smi}]", flush=True)
    check(route == rows_b[0]["route"], "the triangle route changed between calls")
    for row in rows_b:
        check(row["launches"] == row["res"], f"extract_mesh at {row['res']}^3 made "
              f"{row['launches']} K5 launches, not one per x-slab")
        check(row["verts"] > 1000 and row["faces"] > 1000,
              f"the {row['res']}^3 mesh is (almost) empty")
        check(row["sign_agree"] >= 0.9999 and row["max"] <= K5_MAX,
              f"the K5 grid at {row['res']}^3 disagrees with the plain grid")
    # bf16 noise (~2e-3 in the value) moves a vertex along its grid edge by
    # ~2e-3 / |grad f|, far inside the 2 / (R - 1) spacing. Measured on an
    # H100 at 128^3: 2.0e-3 as the two-way mean euclidean distance, 0.13 of
    # the spacing; bar, a quarter of the spacing
    check(rows_b[0]["chamfer_euclid"] <= 0.25 * rows_b[0]["spacing"],
          f"the K5 mesh is farther from the precise sdf's than a quarter of the "
          f"grid spacing: {rows_b[0]['chamfer_euclid']:.3e}")

    # (c) the color render on the K1-grid path
    cfg = RenderConfig(
        march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4),
        grad=GradConfig(mode="ift", compact_frac=4, recompute="pallas"),
        compute_dtype="bfloat16", use_pallas=True)
    rk = SDFRendererColor(SDFRenderer(params, cam.K, (IMG, IMG), decoder_cfg=dcfg,
                                      cfg=cfg), make_color_vjp(cparams, ccfg))
    rp = SDFRendererColor(SDFRenderer(params, cam.K, (IMG, IMG), decoder_cfg=dcfg,
                                      cfg=cfg, use_kernel=False),
                          make_color_vjp(cparams, ccfg, use_kernel=False))
    counters = (sphere_trace_grid, precise_sdg_call, precise_bias_grads_call, point_eval)
    with torch.no_grad():
        _, target = rk.render_color(latent, z_tgt, cam.R, cam.T)

    def grads(r):
        leaves = [latent.clone().requires_grad_(True), z_tex.clone().requires_grad_(True)]
        out, rgb = r.render_color(leaves[0], leaves[1], cam.R, cam.T)
        return (out, rgb) + torch.autograd.grad((rgb - target).abs().mean(), leaves)

    def timed3(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        outs, ms = [], []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            outs.append(fn())
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return outs[0], sorted(ms)[1], ms, {c.__name__: c.launches for c in counters}

    with torch.no_grad():
        (out_f, rgb_f), fwd_ms, fwd_all, fwd_l = timed3(
            lambda: rk.render_color(latent, z_tex, cam.R, cam.T))
    gk, fb_ms, fb_all, fb_l = timed3(lambda: grads(rk))
    hit_frac = out_f.mask.float().mean().item()
    print(f"color render fwd ms/frame (median of 3, CUDA events) {fwd_ms:.3f}, all "
          f"{[round(m, 3) for m in fwd_all]}, launches {fwd_l}; fwd+bwd (photometric L1 "
          f"to shape and texture latents) {fb_ms:.3f}, all {[round(m, 3) for m in fb_all]}, "
          f"launches {fb_l}; hit_frac {hit_frac:.4f}  [{smi}]", flush=True)
    for name in ("sphere_trace_grid", "precise_sdg_call", "point_eval"):
        check(fwd_l[name] > 0, f"the color render never launched {name}")
    for name in ("precise_bias_grads_call", "point_eval"):
        check(fb_l[name] > 0, f"the color render's fwd+bwd never launched {name}")
    check(hit_frac > 0.05 and bool(torch.isfinite(rgb_f).all())
          and rgb_f.shape == (IMG, IMG, 3), "the color render is empty, not finite "
          "or of the wrong shape")
    check(bool((rgb_f.reshape(-1, 3)[~out_f.mask] == 0).all()), "a miss has a color")
    with torch.no_grad():
        _, rgb_o = in_order(lambda: rp.render_color(latent, z_tex, cam.R, cam.T))
    rgb_exact = torch.equal(rgb_f, rgb_o)
    t0 = time.perf_counter()
    gp = grads(rp)
    torch.cuda.synchronize()
    plain_fb_ms = 1e3 * (time.perf_counter() - t0)
    diffs = {name: grad_diff(a, b) for name, a, b in zip(("shape latent", "texture latent"),
                                                         gk[2:], gp[2:])}
    rgb_gemm = (gk[1] - gp[1]).abs().max().item()
    print(f"color render vs plain versions: RGB == in-order plain bit for bit: {rgb_exact}; "
          f"max |RGB diff| with the GEMM {rgb_gemm:.3e} (bar {RGB_MAX:.2e}); gradients "
          f"({plain_fb_ms:.0f} ms "
          "plain): " + "; ".join(f"{k} cos {d['cos']:.7f} relative L2 {d['rel']:.3e}"
                                 for k, d in diffs.items()), flush=True)
    check(rgb_exact, "the color render's RGB differs from the in-order plain versions'")
    check(rgb_gemm <= RGB_MAX, f"the color render's RGB differs from the plain versions' "
          f"by {rgb_gemm:.3e} (bar {RGB_MAX:.2e})")
    check(all(torch.isfinite(g).all().item() for g in gk[2:]),
          "a color-render gradient is not finite")
    for k, d in diffs.items():
        check(d["cos"] >= GRAD_COS and d["rel"] <= GRAD_REL,
              f"the {k} gradient of the color render differs from the plain versions' "
              f"(bars: cos >= {GRAD_COS}, relative L2 <= {GRAD_REL})")
    launches = mesh_launches + fwd_l["point_eval"] + fb_l["point_eval"]
    return dict(a=rows_a, mesh=rows_b, mesh_arrays=(verts, faces), route=route,
                launches=launches,
                color=dict(fwd_ms=fwd_ms, fwdbwd_ms=fb_ms, plain_fwdbwd_ms=plain_fb_ms,
                           hit_frac=hit_frac, rgb_exact=rgb_exact, rgb_gemm_max=rgb_gemm,
                           grads={k: d for k, d in diffs.items()}))


# Phase 7's --mesh fits: steps at lr 5e-2 from the zero latent, and the bar
# on depth_completion's chamfer-sq against the hidden shape: about twice
# the first reading on an H100, 0.258 after 8 steps (0.345, 0.262 and
# 0.301 after 4, 6 and 12; PERF.md). Multiview weights its photometric
# term 0.1: at 1.0 it holds the fit at the empty zero-latent shape (an
# empty mesh after 4-12 steps on an H100; 27,874 and 108,275 verts after
# 6 and 10 at 0.1)
DC_STEPS, MV_STEPS = 8, 10
DC_CHAMFER_MAX = 0.5


# The first versions of the redesigned probe kernels: device us per launch
# in a CUDA graph of 200 (PERF.md's P rows: P8, P18, P19 and P21 beside
# the library call, P20 the launch table's; P7 at 8 trips and P15 at one,
# the mean of two kernel_times.py runs of the first version; P4 at n_live
# 0 and P6 at 64 trips likewise, the bracketed first-version readings of
# the P4 and P6 rows), NVIDIA H100 80GB HBM3, 700.00 W
PARENT_GRAPH_US = {"P4": 91.47, "P6": 11.36, "P7": 2.75, "P8": 38.99, "P15": 2.81,
                   "P18": 3.42, "P19": 3.61, "P20": 13.94, "P21": 19.76}
# the MLP chains' first version (mma.sync, the weights' fragments from L2,
# the carry in shared memory): ms at diag_int8.py's defaults, CUDA events,
# median of 3 (PERF.md's P23 and P24 rows), NVIDIA H100 80GB HBM3, 700.00 W
PARENT_CHAIN_MS = {"P23": 25.976, "P24": 17.459}


def probes_phase(torch, dev):
    """Phase 10: the TPU probe scripts' kernels (P1-P24), each held to its
    plain version at the scripts' shapes by the diag modules' checks
    (equal where the math is exact, within each module's stated bar
    where sums run in another order), then the probe path itself with
    the launch counts set to 0: the launch-cost tables (host us eager,
    device us in a CUDA graph), the zero-work launches of K1-K4, chain20,
    the building blocks, the frame split, and the MLP chains at
    diag_int8.py's defaults, each held to its plain version on every
    column it is timed on. Returns (kernel rows, launches, the probes
    line)."""
    from dist_renderer_tpu_torch.diag import (
        diag_int8, diag_launch2, diag_launch3, diag_launch4, diag_launch_cost,
    )
    from dist_renderer_tpu_torch.ops.kernels import mlp_chain, probes

    print("\n== phase 10: the probes (P1-P24) ==", flush=True)
    t0 = time.perf_counter()
    modules = (diag_launch_cost, diag_launch2, diag_launch3, diag_launch4)
    wrappers = probes.KERNELS + (mlp_chain.chain_bf16, mlp_chain.chain_int8)
    try:
        rows = [r for m in modules for r in m.check(dev)]
        for w in wrappers:
            w.launches = 0
        res = {m.__name__.rsplit(".", 1)[1]: m.measure(dev) for m in modules}
        # the chains are held to their plain versions at the size they are timed
        res["diag_int8"] = chain = diag_int8.measure(dev)
    except AssertionError as e:
        fail(f"phase 10: {e}")
    launches = {w.__name__: w.launches for w in wrappers}
    for name, v in launches.items():
        check(v > 0, f"phase 10 never launched {name}")
    rows += [chain["bf16"], chain["int8"]]
    for kind in ("bf16", "int8"):
        chain[kind] = {k: v for k, v in chain[kind].items() if k != "kernel"}
    rows.sort(key=lambda r: int(r["id"][1:]))
    for r in rows:
        print(f"{r['id']:>4} {r['kernel'].__name__:<13} ms {r['ms']:.6f}  plain "
              f"{r['plain_ms']:.6f}  library {r['library_ms']}  bound "
              f"{r['bound_ms']:.3e} ({r['bound_by']})  max|diff| {r['max_abs_err']:.3e}"
              + (f"  graph of 200: kernel {r['launch']['graph_us']:.3f} us, library "
                 f"{r['library_launch']['graph_us']:.3f} us" if "launch" in r else "")
              + (f" (first version {PARENT_GRAPH_US[r['id']]:.2f} us)"
                 if r["id"] in PARENT_GRAPH_US else "")
              + (f" (first version {PARENT_CHAIN_MS[r['id']]:.3f} ms)"
                 if r["id"] in PARENT_CHAIN_MS else ""))
    sweep = res["diag_launch2"]["scalar_while_trips"]
    print("  scalar_while (P6) in a graph of 200, us by trips: "
          + ", ".join(f"{t}: {row['graph_us']:.3f}" for t, row in sweep.items()))
    lc = res["diag_launch_cost"]
    for name, row in lc["table"].items():
        print(f"  launch {name:<14} host {row['host_us']:8.2f} us  graph "
              f"{row.get('graph_us', float('nan')):8.3f} us")
    print(f"  the main path's launches a frame: fwd {lc['frame_syncs']['fwd']['launches']}, "
          f"{lc['host_us_per_frame_fwd']:.1f} us of host time; fwd+bwd "
          f"{lc['frame_syncs']['fwdbwd']['launches']}, {lc['host_us_per_frame_fwdbwd']:.1f} us")
    print(f"  chains: bf16 {chain['bf16']['ms']:.3f} ms, int8 {chain['int8']['ms']:.3f} ms, "
          f"int8 speedup {chain['int8_speedup']:.2f}x; launches {launches}")
    res["kernels"] = [{k: v for k, v in r.items() if k not in ("kernel", "source",
                                                              "replaces")} for r in rows]
    for r in res["kernels"]:
        if r["id"] in PARENT_GRAPH_US:
            r["first_version_graph_us"] = PARENT_GRAPH_US[r["id"]]
        if r["id"] in PARENT_CHAIN_MS:
            r["first_version_ms"] = PARENT_CHAIN_MS[r["id"]]
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps({"probes": res}), flush=True)
    return rows, launches, res


def cli_phase(torch, smi):
    """Phase 7: the command-line tasks and the server, in process, on the
    committed torus 8x512 decoder, each into a temporary --out."""
    import argparse
    import math
    import tempfile

    from dist_renderer_tpu_torch.ops.kernels.batched_march import sphere_trace_persistent
    from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march
    from dist_renderer_tpu_torch.ops.kernels.recompute import (
        precise_bias_grads_call, precise_sdg_call,
    )
    from dist_renderer_tpu_torch.tasks import (
        batched_render, depth_completion, evaluate, multiview, pose_refine,
        render_demo, serve,
    )
    from dist_renderer_tpu_torch.tasks.common import add_common_args

    print("\n== the tasks on the card ==")
    counters = (sphere_trace_persistent, queue_march, precise_sdg_call,
                precise_bias_grads_call)
    times = {}

    def run(name, fn, argv, need=()):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        res = fn(argv)
        torch.cuda.synchronize()
        got = {c.__name__: c.launches for c in counters}
        print(f"{name}: {time.perf_counter() - t0:.1f} s in all; launches {got}",
              flush=True)
        for k in need:
            check(got[k] > 0, f"{name} never launched {k}")
        return res

    def fit_ok(name, res, out):
        hist = res.loss_history.tolist()
        check(len(hist) > 0 and all(math.isfinite(x) for x in hist),
              f"{name}: a loss is not finite: {hist}")
        check(os.path.exists(os.path.join(out, "final.png"))
              or os.path.exists(os.path.join(out, "final_views.png")),
              f"{name} wrote no final image")
        times[name] = res.metrics["ms_per_step"]
        print(f"{name}: losses {[round(x, 6) for x in hist]}; ms/step median "
              f"{times[name]:.1f}  [{smi}]")

    def obj_counts(path):
        """(vertices, faces) of an OBJ the --mesh flag wrote."""
        check(os.path.exists(path), f"no mesh at {path}")
        with open(path) as f:
            lines = f.read().splitlines()
        return (sum(l.startswith("v ") for l in lines),
                sum(l.startswith("f ") for l in lines))

    fits = ("precise_sdg_call", "precise_bias_grads_call")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "demo")
        ms = run("render_demo", render_demo.main,
                 ["--fast", "--img", "256", "--views", "2", "--mesh", "--out", out])
        check(all(os.path.exists(os.path.join(out, f"view{i:02d}.png"))
                  for i in range(2)), "render_demo wrote no views")
        times["render_demo"] = ms[-1]
        nv, nf = obj_counts(os.path.join(out, "shape.obj"))
        check(nv > 1000 and nf > 1000, "render_demo --mesh wrote an (almost) empty mesh")
        print(f"render_demo: ms per view {[round(m, 1) for m in ms]}; --mesh "
              f"{render_demo.MESH_RES}^3: {nv} verts, {nf} faces  [{smi}]")

        # the --mesh fits start from the zero latent, whose shape is empty:
        # at lr 5e-2 a few steps grow the surface
        out = os.path.join(tmp, "depth")
        res = run("depth_completion", depth_completion.main,
                  ["--fast", "--img", "256", "--steps", str(DC_STEPS), "--lr", "5e-2",
                   "--mesh", "--mesh-res", "128", "--out", out], fits)
        fit_ok("depth_completion", res, out)
        nv, nf = obj_counts(os.path.join(out, "fitted.obj"))
        times["depth_completion_chamfer"] = res.metrics["chamfer"]
        times["depth_completion_mesh"] = (nv, nf)
        print(f"depth_completion --mesh --mesh-res 128: {nv} verts, {nf} faces; "
              f"chamfer-sq vs the hidden shape {res.metrics['chamfer']:.3e} (bar "
              f"{DC_CHAMFER_MAX:.1e})")
        check(nv > 1000 and nf > 1000, "depth_completion --mesh wrote an (almost) empty mesh")
        check(res.metrics["chamfer"] <= DC_CHAMFER_MAX,
              f"depth_completion's chamfer {res.metrics['chamfer']:.3e} > {DC_CHAMFER_MAX}")

        out = os.path.join(tmp, "pose")
        # the pose gradient reaches the points through K3's spatial
        # gradient; with the latent frozen no K4 sum is needed
        res, rot, t_err = run("pose_refine", pose_refine.main,
                              ["--fast", "--img", "256", "--steps", "5", "--warm",
                               "4", "--out", out],
                              ("queue_march", "precise_sdg_call"))
        fit_ok("pose_refine", res, out)
        check(math.isfinite(rot) and math.isfinite(t_err), "pose errors not finite")

        out = os.path.join(tmp, "mv")
        res = run("multiview", multiview.main,
                  ["--fast", "--img", "128", "--views", "3", "--steps", str(MV_STEPS),
                   "--lr", "5e-2", "--w-photo", "0.1", "--mesh", "--out", out], fits)
        fit_ok("multiview", res, out)
        nv, nf = obj_counts(os.path.join(out, "reconstructed.obj"))
        times["multiview_mesh"] = (nv, nf)
        print(f"multiview --mesh: {nv} verts, {nf} faces")
        check(nv > 1000 and nf > 1000, "multiview --mesh wrote an (almost) empty mesh")

        # the chamfer of the torus decoder against the analytic torus, mesh-
        # based (96^3 through the precise sdf, native surface sampling), and
        # the render-space metrics over 4 ring views
        t0 = time.perf_counter()
        agg = run("evaluate", evaluate.main,
                  ["--mesh-based", "--image-metrics", "--instances", "1", "--img", "128",
                   "--out", os.path.join(tmp, "eval")])
        times["evaluate_s"] = time.perf_counter() - t0
        times["evaluate"] = agg
        check(all(math.isfinite(v) for k, v in agg.items() if k.endswith(("mean", "median")))
              and agg["chamfer_sym_mean"] < 0.05 and agg["silhouette_iou_mean"] > 0.8,
              f"evaluate's metrics are off: {agg}")
        print(f"evaluate: {agg}  [{smi}]", flush=True)

        # config #5 cut to size: 16 latents x 4 views at 256^2 through
        # render_batched_c2f with the bench proxy, in chunks of 64 frames
        res = run("batched_render", batched_render.main,
                  ["--fast", "--pallas", "--proxy", os.path.join(HERE, ".bench_proxy.npz"),
                   "--stream", "--latents", "16", "--views", "4", "--img", "256",
                   "--chunk", "64"], ("sphere_trace_persistent",))
        check(res["hit_frac"] > 0.01 and math.isfinite(res["mean_hit_depth"]),
              "batched_render rendered almost nothing")
        times["batched_render_mrays_s"] = res["Mrays_per_s"]
        times["batched_render_hit_frac"] = res["hit_frac"]
        print(f"batched_render: {res['Mrays_per_s']} Mrays/s, hit_frac "
              f"{res['hit_frac']}, {res['seconds']} s for {res['total_rays']} rays, "
              f"peak {res.get('peak_hbm_gb')} GB  [{smi}]", flush=True)

        ap = argparse.ArgumentParser()
        add_common_args(ap)
        args = ap.parse_args(["--fast", "--img", "256"])
        do_render, latent0, _ = run("serve.build_engine", serve.build_engine, args)
        for c in counters:
            c.launches = 0
        req_ms = []
        for az in (30.0, 75.0, 120.0):
            t0 = time.perf_counter()
            out = do_render(latent0, az, 20.0, 2.2)  # synchronizes
            req_ms.append(1e3 * (time.perf_counter() - t0))
            check(torch.isfinite(out.depth).all().item() and out.mask.any().item(),
                  "a served render is empty or not finite")
        got = {c.__name__: c.launches for c in counters}
        for k in ("sphere_trace_persistent", "queue_march", "precise_sdg_call"):
            check(got[k] > 0, f"the server never launched {k}")
        times["serve"] = sorted(req_ms)[1]
        print(f"serve: 3 requests, ms {[round(m, 1) for m in req_ms]}; launches "
              f"{got}  [{smi}]", flush=True)
    return times


# Phase 11: training and data at full width. (a) bench.py's decoder fit
# (the 8x512/256 DeepSDF decoder, batch 8192, bench.py's 1,500 steps), its
# K1-grid render's hits against the committed fixture's (IoU over hits);
# (b) its 4x256 proxy (latent jitter 0.002, bench.py's 6,000 steps), served
# through trace_frame and held to the K1-grid render under phase 4's bars;
# (c) tasks/train.py at its defaults for 200 steps, exported and loaded
# back; (d) make_synthetic_data and the three --data fits; (e) a resumed
# depth_completion against an uninterrupted one.
FIT_STEPS, FIT_BATCH = 1500, 8192
DISTILL_STEPS = 6000
TRAIN_STEPS = 200
DATA_STEPS = 5
# the fresh fit against the committed fixture (fitted by the JAX package
# from other random draws): the same shape, not the same bits
FIT_IOU_MIN = 0.9


def train_phase(torch, dev, smi, bench_params, bench_latent, cam):
    """Phase 11: fit, distill, train, export and load, data on disk and
    resume, in a temporary directory, every render on the kernels; the
    launch counters are set to 0 at its start and read at its end.
    Returns its timings and checks for the JSON line."""
    import math
    import tempfile

    import numpy as np

    from dist_renderer_tpu_torch.config import (
        DecoderConfig, GradConfig, MarchConfig, RenderConfig,
    )
    from dist_renderer_tpu_torch.models.analytic import round_union, sphere_sdf, torus_sdf
    from dist_renderer_tpu_torch.models.checkpoint import load_decoder, load_latent_codes
    from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
    from dist_renderer_tpu_torch.models.pretrain import fit_decoder_to_sdf
    from dist_renderer_tpu_torch.models.proxy import (
        default_proxy_cfg, distill_proxy, load_proxy_meta, load_proxy_npz,
        proxy_error_report, proxy_march_margins, save_proxy_npz,
    )
    from dist_renderer_tpu_torch.ops.kernels.batched_march import sphere_trace_persistent
    from dist_renderer_tpu_torch.ops.kernels.fused_march import sphere_trace_grid
    from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march
    from dist_renderer_tpu_torch.ops.kernels.recompute import (
        precise_bias_grads_call, precise_sdg_call,
    )
    from dist_renderer_tpu_torch.ops.renderer import SDFRenderer, make_march_factory, render
    from dist_renderer_tpu_torch.tasks import (
        depth_completion, make_synthetic_data, multiview, pose_refine, render_demo, train,
    )

    print("\n== phase 11: training and data at full width ==", flush=True)
    counters = (sphere_trace_grid, sphere_trace_persistent, queue_march,
                precise_sdg_call, precise_bias_grads_call)
    for c in counters:
        c.launches = 0
    t_phase = time.perf_counter()
    res = {}
    dcfg = DecoderConfig()
    grid_cfg = RenderConfig(
        march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4),
        grad=GradConfig(mode="ift", compact_frac=4, recompute="pallas"),
        compute_dtype="bfloat16", use_pallas=True)

    def grid_render(params, z, pcfg=dcfg):
        with torch.no_grad():
            return SDFRenderer(params, cam.K, (IMG, IMG), decoder_cfg=pcfg,
                               cfg=grid_cfg).render(z, cam.R, cam.T)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def loss_line(losses):
        h = torch.stack(losses).cpu()
        check(bool(torch.isfinite(h).all()), "a training loss is not finite")
        k = min(50, len(h))
        return h, dict(first=float(h[0]), last=float(h[-1]),
                       first50=float(h[:k].mean()), last50=float(h[-k:].mean()))

    with tempfile.TemporaryDirectory() as tmp:
        # (a) bench.py's fit of the bench shape
        shape = round_union(torus_sdf(0.55, 0.18), sphere_sdf(0.35, (0.0, 0.25, 0.0)), 0.08)
        losses = []
        (params, z0), s = timed(lambda: fit_decoder_to_sdf(
            lambda p: shape(None, p), dcfg, steps=FIT_STEPS, batch=FIT_BATCH, device=dev,
            losses=losses))
        _, fl = loss_line(losses)
        res["fit"] = dict(steps=FIT_STEPS, batch=FIT_BATCH, seconds=s,
                          ms_per_step=1e3 * s / FIT_STEPS, **fl)
        print(f"(a) fit_decoder_to_sdf, 8x512/256, batch {FIT_BATCH}: {FIT_STEPS} steps in "
              f"{s:.2f} s, {res['fit']['ms_per_step']:.3f} ms/step; loss {fl['first']:.5f} "
              f"-> {fl['last']:.5f} (mean of the first / last 50: {fl['first50']:.5f} -> "
              f"{fl['last50']:.5f})  [{smi}]", flush=True)
        check(fl["last50"] < 0.5 * fl["first50"], "the decoder fit's loss did not fall")
        fresh = grid_render(params, z0)
        ref = grid_render(bench_params, bench_latent)
        inter = int((fresh.mask & ref.mask).sum())
        union = int((fresh.mask | ref.mask).sum())
        iou = inter / max(union, 1)
        res["fit"].update(iou=iou, hits=int(fresh.mask.sum()), fixture_hits=int(ref.mask.sum()))
        print(f"    K1-grid render at {IMG}x{IMG}: {res['fit']['hits']} hits; the committed "
              f".bench_decoder.npz's {res['fit']['fixture_hits']}; IoU over hits {iou:.5f} "
              f"(bar {FIT_IOU_MIN})", flush=True)
        check(all(torch.isfinite(getattr(fresh, k)).all().item()
                  for k in ("depth", "normal", "min_sdf")), "non-finite fresh render")
        check(iou >= FIT_IOU_MIN, f"the fresh decoder's hits differ from the fixture's: "
              f"IoU {iou:.4f} < {FIT_IOU_MIN}")

        # (b) its proxy, bench.py's distillation
        losses = []
        (proxy, pcfg), s = timed(lambda: distill_proxy(
            params, dcfg, z0[None], proxy_cfg=default_proxy_cfg(dcfg, width=256, depth=4),
            steps=DISTILL_STEPS, latent_jitter=0.002, losses=losses))
        _, dl = loss_line(losses)
        rep, s_rep = timed(lambda: proxy_error_report(params, dcfg, proxy, pcfg, z0[None]))
        ppath = os.path.join(tmp, "proxy.npz")
        save_proxy_npz(ppath, proxy, pcfg, err_report=rep)
        proxy2, pcfg2 = load_proxy_npz(ppath, dev)
        check(pcfg2 == pcfg and all(torch.equal(a[k], b[k]) for a, b in
                                    zip(proxy["layers"], proxy2["layers"]) for k in "wb"),
              "the proxy file did not read back bit for bit")
        meta = load_proxy_meta(ppath)
        check(meta == {k: rep[k] for k in ("p50", "p95", "p99", "max")},
              "the proxy file's error quantiles did not read back")
        res["distill"] = dict(steps=DISTILL_STEPS, seconds=s,
                              ms_per_step=1e3 * s / DISTILL_STEPS, report=rep,
                              report_seconds=s_rep, **dl)
        print(f"(b) distill_proxy 4x256, latent jitter 0.002: {DISTILL_STEPS} steps in "
              f"{s:.2f} s, {res['distill']['ms_per_step']:.3f} ms/step; loss "
              f"{dl['first50']:.5f} -> {dl['last50']:.5f}; error report ({s_rep:.2f} s): "
              f"{rep}  [{smi}]", flush=True)
        check(dl["last50"] < dl["first50"], "the distillation's loss did not fall")
        backoff, band = proxy_march_margins(meta, 2e-3)
        cfg = RenderConfig(
            img_h=IMG, img_w=IMG,
            march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                              coarse_to_fine=True, c2f_strides=(16, 4),
                              c2f_coarse_steps=16, proxy_backoff=backoff,
                              proxy_band=band),
            grad=GradConfig(mode="ift", compact_frac=4, recompute="pallas"),
            compute_dtype="bfloat16", use_pallas=True)
        sdf_fn = make_precise_sdf(params, dcfg)
        factory = make_march_factory(params, dcfg, cfg, march_params=proxy2,
                                     march_dcfg=pcfg2)
        gen = torch.Generator().manual_seed(SEED)
        lats = [z0] + [z0 + 0.001 * torch.randn(z0.shape, generator=gen).to(dev)
                       for _ in range(2)]
        before = {c.__name__: c.launches for c in counters}
        outs, ms = [], []
        for z in lats:
            with torch.no_grad():
                out, s = timed(lambda: render(sdf_fn, z, cam, cfg, factory))
            outs.append(out)
            ms.append(1e3 * s)
        served = {c.__name__: c.launches - before[c.__name__] for c in counters}
        for k in ("sphere_trace_persistent", "queue_march", "precise_sdg_call"):
            check(served[k] > 0, f"phase 11's trace_frame requests never launched {k}")
        check(all(torch.isfinite(o.depth).all().item() for o in outs),
              "a trace_frame request's depth is not finite")
        # phase 4's bars: the same request on the plain versions
        plain_fac = make_march_factory(params, dcfg, cfg, march_params=proxy2,
                                       march_dcfg=pcfg2, use_kernel=False)
        with torch.no_grad():
            plain = render(make_precise_sdf(params, dcfg, use_kernel=False), z0, cam, cfg,
                           plain_fac)
        p_agree = (plain.mask == outs[0].mask).float().mean().item()
        both = plain.mask & outs[0].mask
        p_within = ((plain.depth - outs[0].depth).abs()[both] <= 1e-3).float().mean().item()
        # against the K1-grid render: the same hits, as near the full
        # decoder's surface. The two marches stop at different points of
        # the convergence band, so depths differ beyond 1e-3 on a few % of
        # hits for the bench fixture too (phase 6's line): they are
        # printed, and each render's share of hits with precise |f| <=
        # convergence eps is compared (measured on an H100: 99.24% for
        # both; the rest are grazing hits whose IFT step was clamped)
        agree = (outs[0].mask == fresh.mask).float().mean().item()
        both = outs[0].mask & fresh.mask
        dq = quantiles((outs[0].depth - fresh.depth).abs()[both], (0.5, 0.99, 0.999, 1.0))
        bench_sdf = make_precise_sdf(bench_params, dcfg)
        with torch.no_grad():
            resid = {name: f(z, o.points[o.mask]).abs() for name, f, z, o in (
                ("trace_frame", sdf_fn, z0, outs[0]), ("K1-grid", sdf_fn, z0, fresh),
                ("fixture K1-grid", bench_sdf, bench_latent, ref))}
        eps = cfg.march.convergence_eps
        on_surface = {k: (v <= eps).float().mean().item() for k, v in resid.items()}
        rq = {k: quantiles(v, (0.5, 0.999, 1.0)) for k, v in resid.items()}
        res["serve"] = dict(ms=ms, launches=served, plain_hit_agreement=p_agree,
                            plain_depth_within_1e3=p_within, grid_hit_agreement=agree,
                            grid_depth_quantiles=dq, on_surface=on_surface,
                            residual_quantiles=rq, margins=(backoff, band))
        print(f"    3 trace_frame requests with the fresh proxy (margins {backoff:.3e} / "
              f"{band:.3e}): ms {[round(m, 2) for m in ms]}, launches {served}; vs the "
              f"plain versions: hit agreement {p_agree:.5f}, depth within 1e-3 "
              f"{p_within:.5f}; vs the K1-grid render: hit agreement {agree:.5f}, |depth "
              f"diff| on {int(both.sum())} common hits p50/p99/p99.9/max "
              f"{[f'{x:.2e}' for x in dq]}; precise |f| at the hits p50/p99.9/max "
              f"{ {k: [f'{x:.2e}' for x in v] for k, v in rq.items()} }, within eps "
              f"{on_surface}  [{smi}]", flush=True)
        check(p_agree >= 0.99 and p_within >= 0.999, "the fresh proxy's trace_frame "
              "render differs from its plain versions' beyond phase 4's bars")
        check(agree >= 0.99, f"the fresh proxy's render disagrees with K1-grid's: hit "
              f"agreement {agree:.4f} < 0.99")
        check(on_surface["trace_frame"] >= on_surface["K1-grid"] - 1e-3,
              "the fresh proxy's hits are off the full decoder's surface more often "
              f"than K1-grid's: {on_surface}")

        # (c) tasks/train.py at its defaults, exported, loaded, rendered
        exp = os.path.join(tmp, "exp")
        (tparams, tlat, h, ms_step), s = timed(lambda: train.main(
            ["--shapes", "sphere", "torus", "union", "--steps", str(TRAIN_STEPS),
             "--out", exp]))
        res["train"] = dict(steps=TRAIN_STEPS, seconds=s, ms_per_step=ms_step,
                            first50=float(h[:50].mean()), last50=float(h[-50:].mean()))
        print(f"(c) tasks.train, 3 shapes, 8x512/256, 4 x 4096 points: {TRAIN_STEPS} steps, "
              f"{ms_step:.3f} ms/step; loss {res['train']['first50']:.5f} -> "
              f"{res['train']['last50']:.5f}  [{smi}]", flush=True)
        check(bool(np.isfinite(h).all()) and res["train"]["last50"] < res["train"]["first50"],
              "tasks.train's loss did not fall")
        lparams, lcfg = load_decoder(exp, device=dev)
        llat = load_latent_codes(exp, device=dev)
        check(lcfg == dcfg, f"the exported specs read back as {lcfg}")
        check(all(torch.equal(a[k], b[k]) for a, b in zip(tparams["layers"],
                                                          lparams["layers"]) for k in "wb")
              and torch.equal(llat, tlat), "the exported experiment dir did not load "
              "back bit for bit")
        a, b = grid_render(tparams, tlat[1], lcfg), grid_render(lparams, llat[1], lcfg)
        same = all(torch.equal(getattr(a, k), getattr(b, k))
                   for k in ("depth", "mask", "normal", "min_sdf"))
        res["train"].update(loaded_equal=True, render_equal=same, hits=int(a.mask.sum()))
        print(f"    loaded == trained bit for bit; K1-grid render of latent 1 (torus) from "
              f"the directory == from memory: {same} ({int(a.mask.sum())} hits)", flush=True)
        check(same, "the render from the loaded experiment dir differs from memory's")
        out = os.path.join(tmp, "demo")
        render_demo.main(["--fast", "--experiment-dir", exp, "--img", "256", "--out", out])
        check(os.path.exists(os.path.join(out, "view00.png")),
              "render_demo --experiment-dir wrote no view")

        # (d) data on disk from the committed torus 8x512 decoder, and the fits
        data = os.path.join(tmp, "synth")
        _, s = timed(lambda: make_synthetic_data.main(
            ["--fast", "--img", "256", "--instances", "2", "--views", "3", "--out", data]))
        res["data"] = dict(make_seconds=s)
        print(f"(d) make_synthetic_data: 2 instances x 3 views at 256^2 in {s:.2f} s",
              flush=True)
        fit = ["--fast", "--steps", str(DATA_STEPS), "--lr", "5e-2"]
        dc = depth_completion.main(fit + ["--data", os.path.join(data, "depth"),
                                          "--instance", "1", "--out",
                                          os.path.join(tmp, "dc")])
        pr, rot, t_err = pose_refine.main(["--fast", "--steps", str(DATA_STEPS), "--data",
                                           os.path.join(data, "depth"), "--out",
                                           os.path.join(tmp, "pr")])
        mv = multiview.main(fit + ["--data", os.path.join(data, "multiview"), "--out",
                                   os.path.join(tmp, "mv")])
        hs = {k: r.loss_history.tolist() for k, r in
              (("depth_completion", dc), ("pose_refine", pr), ("multiview", mv))}
        res["data"].update(losses=hs, ms_per_step={k: r.metrics["ms_per_step"] for k, r in
                                                   (("depth_completion", dc),
                                                    ("pose_refine", pr),
                                                    ("multiview", mv))})
        for k, v in hs.items():
            print(f"    {k} --data: losses {[round(x, 6) for x in v]}; ms/step median "
                  f"{res['data']['ms_per_step'][k]:.1f}  [{smi}]", flush=True)
            check(all(math.isfinite(x) for x in v), f"{k} --data: a loss is not finite")
        # the zero latent renders little of the shape: depth completion's
        # objective rises as the shape appears, then falls
        dh = hs["depth_completion"]
        check(dh[-1] < 0.7 * max(dh[1:]), "depth_completion --data's objective did not fall")
        check(hs["pose_refine"][-1] < hs["pose_refine"][0],
              "pose_refine --data's objective did not fall")
        check(min(hs["multiview"][1:]) < hs["multiview"][0],
              "multiview --data's objective did not fall")

        # (e) resume: 3 steps, a checkpoint, 3 more, against 6 uninterrupted
        base = ["--fast", "--img", "256", "--lr", "5e-2", "--checkpoint-every", "3"]
        ck = os.path.join(tmp, "ckpt")
        whole = depth_completion.main(base + ["--steps", "6", "--out",
                                              os.path.join(tmp, "w")])
        first = depth_completion.main(base + ["--steps", "3", "--checkpoint-dir", ck,
                                              "--out", os.path.join(tmp, "r1")])
        rest = depth_completion.main(base + ["--steps", "6", "--checkpoint-dir", ck,
                                             "--out", os.path.join(tmp, "r2")])
        resumed = torch.cat([first.loss_history, rest.loss_history])
        equal = (torch.equal(rest.variables, whole.variables)
                 and torch.equal(resumed, whole.loss_history))
        res["resume"] = dict(equal=equal, max_latent_diff=float(
            (rest.variables - whole.variables).abs().max()))
        print(f"(e) depth_completion resumed at step 3 == uninterrupted 6 steps, bit for "
              f"bit: {equal} (max |latent diff| {res['resume']['max_latent_diff']:.3e}; "
              f"losses {resumed.tolist()} vs {whole.loss_history.tolist()})", flush=True)
        check(equal, "the resumed depth_completion differs from the uninterrupted one")

    launches = {c.__name__: c.launches for c in counters}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11: {res['seconds']:.1f} s; launches {launches}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"phase 11 never launched {k}")
    return res


# Phase 12: parallel/ at the bench fixture's width (the sharded renders and
# the sharded fit step on 4 ranks), the batched polish, fused_dd, the
# counting sort, mesh raycasting and preprocessing. The 4 ranks are
# processes sharing card 0 over gloo (their collectives go through the
# host), so the script needs one card; it does not measure NCCL across
# cards. The kernels are built in this process before the ranks start, and
# each rank counts its own launches.
F12 = 4          # frames of the sharded batched render (a)
FIT_IMG = 128    # (c): 4 shapes at 128^2 each
FIT_STEPS12 = 5
FIT_JITTER = 0.05  # (c)'s latents: the bench latent + 0.05 N(0, 1) (the
                   # batched_render CLI's --latent-noise); the 0.001 of the
                   # renders is less than one Adam step at lr 1e-2
FIT_REL = 1e-5   # (c): the latents against the one-process run, relative L2
RANKS12 = 4


def sharded_phase(torch, dev, smi, params, dcfg, latent, pparams, pcfg, cfg, key,
                  mesh_arrays, img=IMG, fit_img=FIT_IMG, frames=F12):
    """Phase 12, in legs (a)-(h) (the module comment above); any failed
    check exits nonzero. Returns its numbers for the JSON line."""
    import tempfile

    import numpy as np

    from dist_renderer_tpu_torch.config import GradConfig, LossConfig, RenderConfig
    from dist_renderer_tpu_torch.data.datasets import PMOMultiViewDataset, ShapeNetDepthDataset
    from dist_renderer_tpu_torch.eval.mesh import save_obj
    from dist_renderer_tpu_torch.eval.native import load_library
    from dist_renderer_tpu_torch.eval.raycast import render_mesh_depth
    from dist_renderer_tpu_torch.models.decoder import decoder_apply, make_precise_sdf
    from dist_renderer_tpu_torch.models.folded import fold_latent
    from dist_renderer_tpu_torch.ops.binning import counting_sort_perm
    from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels import build
    from dist_renderer_tpu_torch.ops.kernels.fused_march import pack_folded, sphere_trace_grid
    from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march
    from dist_renderer_tpu_torch.ops.kernels.recompute import (
        precise_bias_grads_call, precise_sdg_call,
    )
    from dist_renderer_tpu_torch.ops.polish import polish_depth_batched
    from dist_renderer_tpu_torch.ops.renderer import (
        class_order, make_march_factory, render, render_rays,
    )
    from dist_renderer_tpu_torch.parallel import sharding
    from dist_renderer_tpu_torch.parallel.dryrun import fit_steps, run_calls
    from dist_renderer_tpu_torch.parallel.mesh import run_ranks
    from dist_renderer_tpu_torch.tasks.preprocess_shapenet import preprocess_mesh

    print(f"\n== phase 12: {RANKS12} ranks (parallel/), the batched polish, fused_dd, "
          "the counting sort, mesh raycasting ==", flush=True)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    print(f"CUDA cards visible: {cards}; the {RANKS12} ranks are processes sharing "
          "card 0 over gloo (collectives through the host); NCCL across cards is not "
          "measured by this run", flush=True)
    t_phase = time.perf_counter()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)

    def host_ms(fn, reps=1):
        """fn()'s last result and the median wall ms of ``reps`` calls
        after a warm-up, the card drained around each."""
        fn()
        ms = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        return out, sorted(ms)[len(ms) // 2]

    if dev.type == "cuda":
        build.load()  # once, here: the ranks find the built library
    march = cfg.march
    n = img * img
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img), device=dev)
    o, v = pixel_rays(cam, img, img)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 12)
    lats = latent[None] + 0.001 * torch.randn((frames, latent.shape[0]), generator=gen).to(dev)
    ob, vb = o[None].expand(frames, n, 3), v[None].expand(frames, n, 3)
    sdf = make_precise_sdf(params, dcfg)
    mesh22, mesh14 = (("latents", "rays"), (2, 2)), (("latents", "rays"), (1, 4))
    counters = [bm.sphere_trace_persistent, bm.sphere_trace_batched, queue_march,
                sphere_trace_grid, precise_sdg_call, precise_bias_grads_call]
    names = [c.__name__ for c in counters]

    # (a) the flagship: rounds on K1, rounds on K1-multi, the queue (K2)
    bkw = dict(params=params, dcfg=dcfg, latents=lats, origins=ob, dirs=vb,
               img_hw=(img, img), march=march, strides=(16, 4), coarse_steps=16)
    legs_a = [("rounds", dict(scheduler="rounds")),
              ("rounds on K1-multi", dict(scheduler="rounds", persistent=False)),
              ("queue", dict(scheduler="queue"))]
    calls = []
    for _, kw in legs_a:   # each twice: a warm-up, then the timed call
        calls += [(sharding.render_batched_c2f_sharded, *mesh22, dict(bkw, **kw))] * 2
    # (b) K1-grid on 4 ray shards
    packed = pack_folded(fold_latent(params, latent, dcfg), dcfg)
    calls += [(sharding.trace_sharded_pallas, *mesh14,
               dict(packed=packed, origins=o, dirs=v, march=march))] * 2
    # (c) the fit step: 4 shapes at fit_img^2, the unjittered latent's render
    fit_cfg = RenderConfig(img_h=fit_img, img_w=fit_img, march=march,
                           grad=GradConfig(mode="ift", recompute="pallas"))
    cam_f = Camera.looking_at((0.0, 0.0, -2.5), focal=fit_img * 1.2,
                              img_hw=(fit_img, fit_img), device=dev)
    with torch.no_grad():
        gt = render(sdf, latent, cam_f, fit_cfg)
    of, vf = pixel_rays(cam_f, fit_img, fit_img)
    nf = fit_img * fit_img
    obs = dict(origins=of[None].expand(4, nf, 3), dirs=vf[None].expand(4, nf, 3),
               obs_depth=gt.depth.reshape(1, nf).expand(4, nf),
               obs_mask=gt.mask.reshape(1, nf).expand(4, nf))
    fit_lats = latent[None] + FIT_JITTER * torch.randn((4, latent.shape[0]),
                                                       generator=gen).to(dev)
    fit_kw = dict(sdf_fn=sdf, cfg=fit_cfg, loss_cfg=LossConfig(), latents=fit_lats,
                  steps=FIT_STEPS12, **obs)
    calls.append((fit_steps, *mesh22, fit_kw))
    # (d) render_frame_sharded (4 ray shards), render_views_sharded (4 views)
    rcfg = RenderConfig(img_h=img, img_w=img, march=march,
                        grad=GradConfig(mode="ift", recompute="pallas"))
    vcams = [Camera.looking_at((2.5 * np.sin(a), 0.3, -2.5 * np.cos(a)), focal=img * 1.2,
                               img_hw=(img, img), device=dev)
             for a in np.linspace(0.0, 2 * np.pi, RANKS12, endpoint=False)]
    vrays = [pixel_rays(c, img, img) for c in vcams]
    vo = torch.stack([r[0] for r in vrays])
    vv = torch.stack([r[1] for r in vrays])
    calls.append((sharding.render_frame_sharded, ("rays",), (RANKS12,),
                  dict(sdf_fn=sdf, latent=latent, camera=cam, cfg=rcfg)))
    calls.append((sharding.render_views_sharded, ("latents",), (RANKS12,),
                  dict(sdf_fn=sdf, latent=latent, origins=vo, dirs=vv, cfg=rcfg)))

    t0 = time.perf_counter()
    res = run_ranks(run_calls, RANKS12, calls, dev.type, counters, backend="gloo",
                    device=dev.type)
    ranks_s = time.perf_counter() - t0
    print(f"{RANKS12} ranks: {ranks_s:.1f} s for legs (a)-(d), spawn and start included",
          flush=True)
    launches = {nm: 0 for nm in names}
    for r in res:
        for per_rank in r["launches"]:
            for nm, c in zip(names, per_rank):
                launches[nm] += c
    out = dict(ranks=RANKS12, backend="gloo", cards=cards, ranks_seconds=ranks_s)

    def ran(r, nm):
        """Every rank launched counter nm in call r."""
        return all(per[names.index(nm)] > 0 for per in r["launches"])

    # (a) against the single-device render, JAX's cross-layout contract
    rows_a = []
    with torch.no_grad():
        for i, (label, kw) in enumerate(legs_a):
            r = res[2 * i + 1]
            ref, ms1 = host_ms(lambda: bm.render_batched_c2f(
                params, dcfg, lats, ob, vb, (img, img), march, strides=(16, 4),
                coarse_steps=16, **kw))
            d, hit, msdf = (t.to(dev) for t in r["out"])
            hit_ref = ref.hit
            dd = (d - ref.depth).abs()[hit_ref]
            md = (msdf - ref.min_sdf).abs()
            differ = int(((d != ref.depth) | (hit != hit_ref) | (msdf != ref.min_sdf)).sum())
            row = dict(leg=label, sharded_ms_per_frame=1e3 * r["seconds"] / frames,
                       single_ms_per_frame=ms1 / frames, hits=int(hit_ref.sum()),
                       hits_equal=bool(torch.equal(hit, hit_ref)), rays_differing=differ,
                       depth_share_1e6=float((dd > 1e-6).float().mean()),
                       depth_max=float(dd.max()),
                       msdf_share_1e6=float((md > 1e-6).float().mean()),
                       msdf_max=float(md.max()),
                       launches=[dict(zip(names, p)) for p in r["launches"]])
            rows_a.append(row)
            print(f"(a) render_batched_c2f_sharded {label}, F={frames} x {img}^2, mesh 2x2: "
                  f"{row['sharded_ms_per_frame']:.2f} ms/frame on {RANKS12} ranks sharing "
                  f"the card, single-device {row['single_ms_per_frame']:.2f}; hits equal "
                  f"{row['hits_equal']} ({row['hits']}); rays differing at all {differ}; "
                  f"|ddepth| > 1e-6 on {row['depth_share_1e6']:.5f} of hits, max "
                  f"{row['depth_max']:.3e}; min_sdf > 1e-6 {row['msdf_share_1e6']:.5f}, "
                  f"max {row['msdf_max']:.3e}; launches per rank "
                  f"{[{k: c for k, c in x.items() if c} for x in row['launches']]}  [{smi}]",
                  flush=True)
            check(row["hits_equal"] and row["hits"] > 0,
                  f"(a) {label}: the sharded hit mask differs from the single-device plan")
            check(row["depth_share_1e6"] <= 0.005 and row["depth_max"] <= 4 * march.depth_eps,
                  f"(a) {label}: sharded depth off the single-device plan")
            check(row["msdf_share_1e6"] <= 0.005 and row["msdf_max"] <= 1e-3,
                  f"(a) {label}: sharded margins off the single-device plan")
        check(ran(res[1], "sphere_trace_persistent") and ran(res[5], "sphere_trace_persistent"),
              "(a): a rank never launched K1")
        check(ran(res[3], "sphere_trace_batched"), "(a): a rank never launched K1-multi")
        check(ran(res[5], "queue_march"), "(a): a rank never launched K2")
    out["a"] = rows_a

    # (b) K1-grid on 4 ray shards against one launch over every ray
    r = res[7]
    (grid, ms1) = host_ms(lambda: sphere_trace_grid(packed, o, v, march))
    same = all(torch.equal(a.to(dev), b) for a, b in zip(r["out"], (grid.depth, grid.hit,
                                                                      grid.min_sdf)))
    diff_b = int(((r["out"][0].to(dev) != grid.depth) | (r["out"][1].to(dev) != grid.hit)
                  | (r["out"][2].to(dev) != grid.min_sdf)).sum())
    out["b"] = dict(sharded_ms=1e3 * r["seconds"], single_ms=ms1, bit_equal=same,
                    rays_differing=diff_b, launches=[dict(zip(names, p)) for p in r["launches"]])
    print(f"(b) trace_sharded_pallas on 4 ray shards of {n} rays: {out['b']['sharded_ms']:.2f} ms "
          f"(ranks sharing the card), single-device sphere_trace_grid {ms1:.2f} ms; bit for "
          f"bit: {same} ({diff_b} rays differ)  [{smi}]", flush=True)
    check(same, f"(b): the sharded K1-grid trace differs from one launch on {diff_b} rays")
    check(ran(r, "sphere_trace_grid"), "(b): a rank never launched K1-grid")

    # (c) the fit step against one process computing the same steps: each
    # latent block's tiles, the ray bands' gradients summed, Adam on each
    # block (the ranks' arithmetic); and, for information, one [B, L] leaf
    # with every tile's loss in one graph, where autograd sums a row's
    # terms in another order, a last-bit change that the marches' hit
    # decisions amplify over the steps
    r = res[8]
    losses, hist = r["out"]["losses"], r["out"]["latents"].to(dev)
    n_fb, n_rb = mesh22[1]
    b_loc = fit_lats.shape[0] // n_fb
    keys = ("origins", "dirs", "obs_depth", "obs_mask")
    block = lambda f: [obs[k][f * b_loc:(f + 1) * b_loc] for k in keys]
    zs = [fit_lats[f * b_loc:(f + 1) * b_loc].clone().requires_grad_(True)
          for f in range(n_fb)]
    opts = [torch.optim.Adam([z], lr=1e-2) for z in zs]
    t0 = time.perf_counter()
    for _ in range(FIT_STEPS12):
        for f, (z, opt) in enumerate(zip(zs, opts)):
            g = 0.0
            for tile in zip(*(a.chunk(n_rb, dim=1) for a in block(f))):
                g = g + torch.autograd.grad(
                    sharding.local_loss(sdf, fit_cfg, LossConfig(), z, *tile), z)[0]
            opt.zero_grad()
            z.grad = g
            opt.step()
    sync()
    ref_s = time.perf_counter() - t0
    z1 = torch.cat([z.detach() for z in zs])
    zg = fit_lats.clone().requires_grad_(True)
    opt = torch.optim.Adam([zg], lr=1e-2)
    for _ in range(FIT_STEPS12):
        opt.zero_grad()
        sum(sharding.local_loss(sdf, fit_cfg, LossConfig(), zg, *tile) for tile in
            zip(*(obs[k].chunk(n_rb, dim=1) for k in keys))).backward()
        opt.step()
    rel_to = lambda z: float((hist[-1] - z).norm() / z.norm())
    rel, rel_graph = rel_to(z1), rel_to(zg.detach())
    out["c"] = dict(losses=[float(x) for x in losses], rel_l2=rel,
                    differing=int((hist[-1] != z1).sum()), one_graph_rel_l2=rel_graph,
                    ms_per_step=1e3 * r["seconds"] / FIT_STEPS12,
                    one_process_ms_per_step=1e3 * ref_s / FIT_STEPS12,
                    launches=[dict(zip(names, p)) for p in r["launches"]])
    print(f"(c) make_sharded_fit_step, 4 shapes x {fit_img}^2 on a 2x2 mesh, ift + K3/K4: "
          f"loss {out['c']['losses'][0]:.5f} -> {out['c']['losses'][-1]:.5f} in "
          f"{FIT_STEPS12} steps ({out['c']['ms_per_step']:.1f} ms/step on the ranks, "
          f"{out['c']['one_process_ms_per_step']:.1f} in one process); latents against "
          f"the one-process run: relative L2 {rel:.3e} ({out['c']['differing']} entries "
          f"differ); against one graph of every tile {rel_graph:.3e}  [{smi}]", flush=True)
    check(out["c"]["losses"][-1] < out["c"]["losses"][0], "(c): the sharded fit's loss did not fall")
    check(rel <= FIT_REL, f"(c): the sharded fit left the one-process run ({rel:.3e})")
    check(ran(r, "precise_sdg_call") and ran(r, "precise_bias_grads_call"),
          "(c): a rank never launched K3 or K4")

    # (d) the frame and the views against single-device render_rays
    rows_d = []
    with torch.no_grad():
        ref_f, ms_f = host_ms(lambda: render_rays(sdf, latent, o, v, rcfg))
        refs_v, ms_v = host_ms(lambda: [render_rays(sdf, latent, a, b, rcfg)
                                        for a, b in zip(vo, vv)])
    for label, r, want in (("frame", res[9], [ref_f]), ("views", res[10], refs_v)):
        got = r["out"]
        flat = lambda k: getattr(got, k).reshape(len(want), -1).to(dev)
        stack = lambda k: torch.stack([getattr(w, k).reshape(-1) for w in want])
        mask_eq = bool(torch.equal(flat("mask"), stack("mask")))
        dmax = float((flat("depth") - stack("depth")).abs().max())
        mmax = float((flat("min_sdf") - stack("min_sdf")).abs().max())
        row = dict(leg=label, sharded_ms=1e3 * r["seconds"],
                   single_ms=ms_f if label == "frame" else ms_v, masks_equal=mask_eq,
                   depth_max=dmax, msdf_max=mmax, hits=int(stack("mask").sum()))
        rows_d.append(row)
        print(f"(d) render_{label}_sharded at {img}^2 ({len(want)} x {n} rays): "
              f"{row['sharded_ms']:.1f} ms on the ranks, single-device {row['single_ms']:.1f}; "
              f"masks equal {mask_eq} ({row['hits']} hits); max |ddepth| {dmax:.3e}, "
              f"|dmin_sdf| {mmax:.3e}  [{smi}]", flush=True)
        check(mask_eq and row["hits"] > 0 and dmax <= 1e-5 and mmax <= 1e-5,
              f"(d) render_{label}_sharded differs from the single-device render_rays")
    out["d"] = rows_d

    # (e) the batched polish on a proxy march (K3 against its plain version)
    with torch.no_grad():
        st = bm.render_batched_c2f(pparams, pcfg, lats, ob[:, :1], vb, (img, img), march,
                                   strides=(16, 4), shared_origin=True)
        precise_sdg_call.launches = 0
        (dk, rk), pol_ms = host_ms(lambda: polish_depth_batched(
            params, dcfg, lats, ob, vb, st.depth, st.hit, return_residual=True), reps=3)
        k3_launches = precise_sdg_call.launches
        (dp, rp), pol_plain_ms = host_ms(lambda: polish_depth_batched(
            params, dcfg, lats, ob, vb, st.depth, st.hit, use_kernel=False,
            return_residual=True))
        f0 = torch.stack([decoder_apply(params, lats[i], ob[i] + st.depth[i, :, None] * vb[i],
                                        dcfg).abs() for i in range(frames)])
    hit = st.hit
    dd = (dk - dp).abs()[hit]
    within = float((dd <= 1e-5).float().mean())
    med_res, med_f0 = float(rk[hit].median()), float(f0[hit].median())
    out["e"] = dict(ms=pol_ms, plain_ms=pol_plain_ms, k3_launches=k3_launches,
                    hits=int(hit.sum()), within_1e5=within, max=float(dd.max()),
                    median_residual=med_res, median_proxy_f=med_f0,
                    moved=float(((dk - st.depth).abs()[hit] > 1e-6).float().mean()))
    print(f"(e) polish_depth_batched, F={frames} x {img}^2 proxy march ({out['e']['hits']} hits): "
          f"{pol_ms:.2f} ms on K3 ({k3_launches} launches in 4 calls), plain {pol_plain_ms:.2f}; "
          f"K3 vs plain: depth within 1e-5 on {within:.6f} of hits, max {out['e']['max']:.3e}; "
          f"median |f| {med_f0:.3e} at the proxy depth -> residual {med_res:.3e}; moved "
          f"{out['e']['moved']:.4f} of hits  [{smi}]", flush=True)
    check(within >= 0.999, f"(e): the polish on K3 differs from its plain version ({within:.5f})")
    check(med_res < med_f0, "(e): the polish did not shrink the median residual")
    check(k3_launches > 0, "(e): the polish never launched K3")

    # (f) fused_dd against the K3 route, one render() request fwd+bwd
    rows_f = {}
    for fused in (False, True):
        c = dataclasses.replace(cfg, grad=dataclasses.replace(cfg.grad, fused_dd=fused))
        fac = make_march_factory(params, dcfg, c, march_params=pparams, march_dcfg=pcfg)

        def fwd_bwd():
            z = latent.clone().requires_grad_(True)
            r_ = render(sdf, z, cam, c, fac)
            (g,) = torch.autograd.grad(torch.where(r_.mask, r_.depth, 0.0).sum(), z)
            return r_, g

        precise_sdg_call.launches = 0
        (r_f, g_f), ms = host_ms(fwd_bwd, reps=3)
        rows_f[fused] = (r_f, g_f, ms, precise_sdg_call.launches)
    (ra, ga, msa, la), (rb, gb, msb, lb) = rows_f[False], rows_f[True]
    both = ra.mask & rb.mask
    dd = (ra.depth - rb.depth).detach().abs()
    frontal = both & ((ra.normal * v.reshape(img, img, 3)).sum(-1).abs() > 0.2)
    cos = float(ga @ gb / (ga.norm() * gb.norm()))
    rel = float((gb - ga).norm() / ga.norm())
    out["f"] = dict(k3_ms=msa, fused_ms=msb, k3_launches=la, fused_k3_launches=lb,
                    hit_agree=float((ra.mask == rb.mask).float().mean()),
                    within_1e5=float((dd[both] <= 1e-5).float().mean()),
                    within_1e3=float((dd[both] <= 1e-3).float().mean()),
                    max=float(dd[both].max()), frontal_p95=float(dd[frontal].quantile(0.95)),
                    frontal_share=float(frontal.sum() / both.sum()),
                    grad_cos=cos, grad_rel=rel)
    print(f"(f) render() fwd+bwd at {img}^2, fused_dd=True {msb:.2f} ms ({lb} K3 launches) "
          f"vs the K3 route {msa:.2f} ms ({la}); hit agreement {out['f']['hit_agree']:.5f}; "
          f"depth within 1e-5 on {out['f']['within_1e5']:.5f} of common hits, within 1e-3 "
          f"{out['f']['within_1e3']:.5f}, max {out['f']['max']:.3e}; p95 on the frontal "
          f"{out['f']['frontal_share']:.4f} of them (|<n, v>| > 0.2) "
          f"{out['f']['frontal_p95']:.3e}; latent gradient cos {cos:.6f}, relative L2 "
          f"{rel:.3e}  [{smi}]", flush=True)
    # fused_dd's denominator is a bf16 tangent (the JAX package's design:
    # ~1e-2 relative, clamped), so a hit's depth moves by its |f| times
    # that over |dd|: far on grazing rays, whose |dd| nears the clamp
    # (read on an H100: max 0.107, 98.3% of hits within 1e-3), and the
    # gradient by ~1e-2 relative. Bars: tests/test_parity.py's, p95 <= 1e-3
    # on frontal common hits, and tests/test_torch_grad.py's whole-render
    # gradient bars
    check(lb == 0, "(f): fused_dd still launched K3")
    check(out["f"]["hit_agree"] >= 0.999 and out["f"]["frontal_p95"] <= 1e-3,
          "(f): the fused_dd render differs from the K3 route beyond the parity bar")
    check(cos >= 0.999 and rel <= 3e-2, f"(f): the fused_dd gradient left the K3 "
          f"route's (cos {cos:.6f}, relative L2 {rel:.3e})")

    # (g) the counting sort against torch.sort(stable=True) on the plan's keys
    k = key.reshape(-1).contiguous()
    (oc, ic), ms_c = host_ms(lambda: counting_sort_perm(k, 3), reps=20)
    (os_, is_), ms_s = host_ms(lambda: class_order(k), reps=20)
    same_g = bool(torch.equal(oc, os_) and torch.equal(ic, is_))
    out["g"] = dict(n=int(k.numel()), counting_ms=ms_c, sort_ms=ms_s, same=same_g,
                    classes=[int((k == c).sum()) for c in range(3)])
    print(f"(g) counting_sort_perm vs class_order (torch.sort stable) on {k.numel()} keys "
          f"(classes {out['g']['classes']}): {ms_c:.4f} vs {ms_s:.4f} ms a call (order and "
          f"inverse, wall time of a call, median of 20); the same permutation: {same_g}  "
          f"[{smi}]", flush=True)
    check(same_g, "(g): the counting sort's permutation differs from torch.sort's")

    # (h) the extracted mesh raycast (native BVH) against the K1-grid render
    lib = load_library()
    check(lib is not None, "(h): the native mesh library did not load")
    verts, faces = mesh_arrays
    (md_, mm_), ms_h = host_ms(lambda: render_mesh_depth(verts, faces, cam, (img, img)))
    gh = grid.hit.reshape(img, img).cpu().numpy()
    gd = grid.depth.reshape(img, img).cpu().numpy()
    iou = float((gh & mm_).sum() / max((gh | mm_).sum(), 1))
    q = np.quantile(np.abs(md_ - gd)[gh & mm_], [0.5, 0.95, 1.0])
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "bench.obj")
        save_obj(obj, verts, faces)
        t0 = time.perf_counter()
        s = preprocess_mesh(obj, os.path.join(tmp, "data"), views=2, img=128, device=dev)
        pre_s = time.perf_counter() - t0
        dobs = ShapeNetDepthDataset(os.path.join(tmp, "data", "depth"))[0]
        mobs = PMOMultiViewDataset(os.path.join(tmp, "data", "multiview"))[0]
    out["h"] = dict(ms=ms_h, verts=len(verts), faces=len(faces), iou=iou,
                    depth_p50=float(q[0]), depth_p95=float(q[1]), depth_max=float(q[2]),
                    preprocess_s=pre_s, instances=len(s["instances"]),
                    depth_obs_hits=int(dobs.mask.sum()), views=int(mobs.images.shape[0]))
    print(f"(h) render_mesh_depth of phase 9's 256^3 bench mesh ({len(verts)} verts, native "
          f"BVH) at {img}^2: {ms_h:.1f} ms; hits against the K1-grid render IoU {iou:.5f}, "
          f"|ddepth| on common hits p50 {q[0]:.3e} p95 {q[1]:.3e} max {q[2]:.3e}; "
          f"preprocess_mesh (2 views, 128^2) {pre_s:.2f} s, read back: "
          f"{out['h']['instances']} depth instances ({out['h']['depth_obs_hits']} mask "
          f"pixels in the first), {out['h']['views']} views  [{smi}]", flush=True)
    spacing = 2.0 / (MESH_RES[-1] - 1)
    check(iou >= 0.95 and q[0] <= spacing,
          "(h): the mesh raycast does not match the K1-grid render of its decoder")
    check(out["h"]["instances"] == 2 and out["h"]["depth_obs_hits"] > 0
          and out["h"]["views"] == 2, "(h): preprocess_mesh's layouts did not read back")

    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 12: {out['seconds']:.1f} s; launches in the ranks (all legs, all ranks) "
          f"{launches}", flush=True)
    return out


# Phase 13: the scheduling diagnostics (dist_renderer_tpu_torch/diag/: the
# counterparts of the JAX package's diag_perf, diag_proxy, diag_proxy_ab,
# diag_kernel, diag_proxy_cost, diag_binning, diag_round_caps,
# diag_verify_caps, diag_queue and diag_caps_ab) at the bench cell: the
# 8x512 fixture, its 4x256 proxy, 512^2, 50 steps, F=8 as the scripts
# default, one timed repetition a configuration; diag_repack_scale and
# sweep_batched (--rim-only) too. Each module holds every render it times
# to its plain versions with the in-order product, bit for bit, on its
# first frame, and each forced march launch on its first 4,096 rays (the
# plain versions with the card's GEMM order moved 6.3% of a full-decoder
# frame's hit depths by > 1e-5 at strides (16, 4): a stride-16 level of
# 1,024 rays takes another cuBLAS order). The phase checks on top: with_diag
# changes no bit of the F=8 rounds render or of the cert render; cert
# demotes and probes band rays on tests/test_proxy.py's two option sets;
# K2's cap schedules (diag_queue, diag_caps_ab) give the first schedule's
# bits; the rounds scheduler's schedules move stops inside the
# convergence ball (a function of the caps, as in the JAX package) and
# keep hits on >= 0.999 of the rays; every kernel of the phase launched.
F13 = 8


def schedule_phase(torch, dev, smi, fixture, frames=F13, img=IMG):
    """Phase 13 (the comment above); any failed check exits nonzero.
    Returns its numbers for the JSON line."""
    from dist_renderer_tpu_torch.diag import (
        BenchCell, diag_binning, diag_caps_ab, diag_kernel, diag_perf, diag_proxy,
        diag_proxy_ab, diag_proxy_cost, diag_queue, diag_repack_scale, diag_round_caps,
        diag_verify_caps, differ, sweep_batched,
    )
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval
    from dist_renderer_tpu_torch.ops.kernels.fused_march import sphere_trace_grid
    from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march
    from dist_renderer_tpu_torch.ops.kernels.recompute import (
        precise_bias_grads_call, precise_sdg_call,
    )

    print(f"\n== phase 13: the scheduling diagnostics at the bench cell, F={frames} x "
          f"{img}x{img} ==", flush=True)
    t_phase = time.perf_counter()
    counters = (bm.sphere_trace_persistent, bm.sphere_trace_batched, queue_march,
                sphere_trace_grid, precise_sdg_call, precise_bias_grads_call,
                mlp_eval.point_eval_banked)
    for c in counters:
        c.launches = 0
    cell = BenchCell(dev, frames, img, fixture=fixture)
    res = {}
    fields = ("depth", "hit", "min_sdf")
    try:
        # telemetry changes no bit; cert's counts on tests/test_proxy.py's options
        same = {}
        for name, kw in (("rounds", {}), ("cert", dict(verify_mode="cert"))):
            plain_run = cell.render(**kw)
            out, diag = cell.render(with_diag=True, **kw)
            same[name] = {k: int(differ(getattr(plain_run, k), getattr(out, k)).sum())
                          for k in fields}
            check(not any(same[name].values()), f"phase 13: with_diag changed the {name} "
                  f"render: {same[name]} rays differ")
        counts = {}
        for name, kw in (("demote", dict(verify_mode="cert", proxy_backoff=2e-4)),
                         ("band_probe", dict(verify_mode="cert", verify_band="probe",
                                             proxy_band=0.05))):
            _, diag = cell.render(with_diag=True, **kw)
            counts[name] = {k: (float(v) if k == "cert_frac" else int(v))
                            for k, v in diag.items() if k.startswith("cert_")}
        print(f"with_diag vs without, rays differing: {same}; cert counts: {counts}",
              flush=True)
        check(counts["demote"]["cert_demoted"] > 0, "phase 13: cert demoted no hit at "
              "proxy_backoff 2e-4")
        check(counts["band_probe"]["cert_band_probed"] > 0, "phase 13: cert probed no band "
              "ray at proxy_band 0.05")
        res["with_diag_rays_differing"], res["cert_counts"] = same, counts

        t0 = time.perf_counter()
        res["module_seconds"] = secs = {}
        us = []
        modules = (
            ("diag_kernel", lambda: diag_kernel.measure(dev, reps=1, img=img,
                                                        fixture=fixture)),
            ("diag_proxy_cost", lambda: diag_proxy_cost.measure(dev, reps=1, img=img,
                                                                fixture=fixture)),
            ("diag_binning", lambda: diag_binning.measure(dev, cell, us[0])),
            ("diag_perf", lambda: diag_perf.measure(dev, cell, reps=1)),
            ("diag_proxy", lambda: diag_proxy.measure(dev, cell, "auto", reps=1)),
            ("diag_proxy_ab", lambda: diag_proxy_ab.measure(
                dev, cell, diag_proxy_ab.ALL_MODES + ",march-b1024", reps=1)),
            ("diag_round_caps", lambda: diag_round_caps.measure(dev, cell)),
            ("diag_verify_caps", lambda: diag_verify_caps.measure(dev, cell)),
            ("diag_queue", lambda: diag_queue.measure(dev, cell, frames=(1, frames))),
            ("diag_caps_ab", lambda: diag_caps_ab.measure(
                dev, BenchCell(dev, 1, img, fixture=fixture), calls=2, reps=1)),
            ("diag_repack_scale", lambda: diag_repack_scale.measure(
                dev, BenchCell(dev, 8 * frames, img, fixture=fixture),
                (frames, 4 * frames, 8 * frames), reps=1)),
            ("sweep_batched", lambda: sweep_batched.measure(dev, cell, rim_only=True,
                                                            reps=1)),
        )
        for name, run in modules:
            t1 = time.perf_counter()
            res[name] = run()
            secs[name] = time.perf_counter() - t1
            print(f"{name}: {secs[name]:.1f} s", flush=True)
            if name == "diag_kernel":
                us.append(diag_kernel.us_per_tile_step(res[name]))
        res["modules_seconds"] = time.perf_counter() - t0
    except AssertionError as e:
        fail(f"phase 13: {e}")
    launches = {c.__name__: c.launches for c in counters}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    for name in sorted(k for k in res if k.startswith(("diag_", "sweep_"))):
        print(json.dumps({name: res[name]}), flush=True)
    kr = {(r["decoder"], r["kernel"], r["frames"]): r for r in res["diag_proxy_cost"]["rows"]
          + res["diag_kernel"]["rows"]}
    for (dec, k, f), r in sorted(kr.items()):
        print(f"{k:<9} {dec:<5} F={f}: {r['us_per_tile_step']:.3f} us per tile-step "
              f"({r['tile_steps']} tile-steps in {r['ms']:.3f} ms), dead tile "
              f"{r['us_per_dead_tile']:.4f} us  [{smi}]")
    ab = res["diag_proxy_ab"]
    print("proxy ablations, ms/frame: " + ", ".join(
        f"{m} {r['ms_per_frame']:.3f}" for m, r in ab["rows"].items())
        + f"; verify stage {ab['verify_stage_ms_per_frame']:.3f}, proxy saving "
        f"{ab['proxy_saving_ms_per_frame']:.3f}  [{smi}]")
    stages = res["diag_proxy"].get("stages", {})
    print("lane-steps / ray-steps per stage: " + ", ".join(
        f"{k} {v['ratio']:.3f}" for k, v in stages.items() if v["ratio"]))
    for name in ("diag_round_caps", "diag_verify_caps"):
        rows = res[name]["rows"]
        rows = next(iter(rows.values())) if isinstance(rows, dict) else rows
        print(f"{name}: " + "; ".join(
            f"{tuple(r['caps'])} {r['ms_per_frame']:.3f} ms/frame"
            + (f" ({sum(r['rays_differing'].values())} ray-fields differ from the first, "
               f"hits {r['hit_agree']:.5f})" if "rays_differing" in r else "")
            for r in rows))
    for f, q in res["diag_queue"].items():
        print(f"diag_queue F={f}: rounds {q['rounds']['ms']:.3f} ms; queue " + "; ".join(
            f"{tuple(r['caps'])} {r['ms']:.3f} ms" for r in q["queue"])
            + " (every schedule the first's bits)")
    print("diag_caps_ab: " + "; ".join(f"{tuple(r['caps'])} {r['fwd_ms']:.3f} ms"
                                       for r in res["diag_caps_ab"]["rows"])
          + " (every schedule the first's bits)")
    print("diag_repack_scale, the re-pack's speedup (the same bits): " + ", ".join(
        f"F={f} {r['speedup']:.3f}x" for f, r in res["diag_repack_scale"]["frames"].items()))
    print("sweep_batched: " + "; ".join(
        f"{r['config']} {r['ms_per_frame']:.3f} ms/frame, hits {r['hit_agree']:.5f}"
        for r in res["sweep_batched"]["rows"]))
    print(f"phase 13: {res['seconds']:.1f} s (modules {res['modules_seconds']:.1f} s); "
          f"launches {launches}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"phase 13 never launched {k}")
    return res


def schedule_summary(res):
    """Phase 13's numbers for the timings line (every module's whole
    result is printed as its own JSON line)."""
    caps = lambda rows: [dict(caps=r["caps"], ms_per_frame=r["ms_per_frame"],
                              rays_differing=r.get("rays_differing"),
                              hit_agree=r.get("hit_agree")) for r in rows]
    vc = res["diag_verify_caps"]["rows"]
    return dict(
        seconds=res["seconds"], launches=res["launches"],
        with_diag_rays_differing=res["with_diag_rays_differing"],
        cert_counts=res["cert_counts"],
        us_per_tile_step={f"{r['kernel']} {r['decoder']} F={r['frames']}": r["us_per_tile_step"]
                          for r in res["diag_kernel"]["rows"] + res["diag_proxy_cost"]["rows"]},
        proxy_ab={m: r["ms_per_frame"] for m, r in res["diag_proxy_ab"]["rows"].items()},
        verify_stage_ms_per_frame=res["diag_proxy_ab"]["verify_stage_ms_per_frame"],
        proxy_saving_ms_per_frame=res["diag_proxy_ab"]["proxy_saving_ms_per_frame"],
        stages=res["diag_proxy"].get("stages"),
        round_caps=caps(res["diag_round_caps"]["rows"]),
        verify_caps={bo: caps(rows) for bo, rows in vc.items()},
        queue={f: dict(rounds_ms=q["rounds"]["ms"],
                       queue_ms={str(r["caps"]): r["ms"] for r in q["queue"]})
               for f, q in res["diag_queue"].items()},
        caps_ab_ms={str(r["caps"]): r["fwd_ms"] for r in res["diag_caps_ab"]["rows"]},
        repack_speedup={f: r["speedup"] for f, r in res["diag_repack_scale"]["frames"].items()},
        sweep_ms_per_frame=[(r["config"], r["ms_per_frame"])
                            for r in res["sweep_batched"]["rows"]])


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
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
    from dist_renderer_tpu_torch.ops.kernels.march_in_order import trace_in_order
    from dist_renderer_tpu_torch.ops.kernels.mlp_eval import point_eval_banked
    from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march
    from dist_renderer_tpu_torch.ops.kernels.recompute import (
        fold_bias_precise, latent_grad, pack_precise, precise_bias_grads_call,
        precise_sdg_call,
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
        if ("Used" in line and "registers" in line) or "spill" in line or (
                "Compiling entry" in line):
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
    from dist_renderer_tpu_torch.ops.kernels.mlp_eval import mma_smem_bytes
    print(f"K5/K6 (csrc/point_mlp.cuh): dynamic shared memory per block "
          f"{mma_smem_bytes(shared)} bytes (bench 8x512 decoder), "
          f"{mma_smem_bytes(shared_p)} (4x256 proxy); registers: the ptxas lines of "
          "point_mlp_kernel above", flush=True)
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
        k1_levels.append((d, lambda: run(True), lambda: run(False),
                          int(rk.steps_per_ray.sum()), o_l.shape[1]))
        return rp

    with torch.no_grad():
        maps = classify_pyramid(trace_level, origins[None].reshape(1, IMG, IMG, 3),
                                dirs[None].reshape(1, IMG, IMG, 3), (16, 4),
                                march.c2f_backoff)
        key, init_depth, skip = plan_from_maps(maps)
        ob, vb = origins[None, :1], dirs[None]

        def queue_pair(sh, bk, key_, seed_, stage):
            run = lambda: queue_march(sh, bk, ob, vb, key_, seed_, march,
                                      gen_caps=march.queue_caps)
            qk = run()
            qp = queue_march(sh, bk, ob, vb, key_, seed_, march,
                             gen_caps=march.queue_caps, use_kernel=False)
            k1 = batched_trace_padded(sh, bk, ob.expand(1, n, 3), vb, march,
                                      seed_, key_ != 2, use_kernel=True)
            # the in-order witness (csrc/march_in_order.cu) on the same rays
            w = trace_in_order(sh, bk, ob, vb, march, seed_, key_ != 2)
            torch.cuda.synchronize()
            same = lambda r: [torch.equal(a, b) for a, b in (
                (qk.depth, r.depth), (qk.hit, r.hit), (qk.min_sdf, r.min_sdf),
                (qk.depth_at_min, r.depth_at_min), (qk.last_sdf, r.last_sdf),
                (qk.unresolved, r.unresolved),
                (qk.steps[0], r.steps_per_ray[:n].to(qk.steps.dtype)))]
            exact, in_order = all(same(k1)), all(same(w))
            w_differ = int((~(qk.depth == w.depth) | (qk.hit != w.hit)
                            | ~(qk.min_sdf == w.min_sdf) | (qk.steps[0] != w.steps_per_ray[:n])
                            ).sum())
            d = march_diff(qk, qp)
            gens = k2_generations(torch, run)
            print(f"K2 {stage}: {int((key_ != 2).sum())} active rays, K2 == K1 "
                  f"bit for bit: {exact}, == the in-order witness: {in_order} ({w_differ} "
                  f"rays differ in depth, hit, margin or steps); vs plain: "
                  f"{march_line(d)}", flush=True)
            for g, r in enumerate(gens):
                print(f"  generation {g} (cap {([*march.queue_caps, march.max_steps])[g]}): "
                      f"{r['rays']} rays, {r['ms']:.3f} ms, {r['ray_steps']} active "
                      f"ray-steps of {r['lane_steps']} lane-steps ({r['lane_share']:.4f})",
                      flush=True)
            check(exact, f"K2 ({stage}) differs from K1 on the same inputs")
            check(in_order, f"K2 ({stage}) differs from the in-order witness on "
                  f"{w_differ} rays")
            k2_steps.append((int(qk.steps.sum()), macs_per_eval(sh), march_bytes(n, sh, bk)))
            k2_gens[stage] = dict(generations=gens, in_order_rays_differing=w_differ)
            return qp, d

        k2_steps, k2_gens = [], {}

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
        ties = {"K3": ties_line(torch, precise_sdg_call, packed, pts.shape[0])}
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
        # K3 on the tensor cores against the in-order plain version, bit for
        # bit: every value near a decision is summed again in k order, so a
        # point that differs is a tie the margin (NEAR_TIE) missed
        so, ddo, go = in_order(lambda: precise_sdg_call(packed, biases, pts, vs,
                                                        use_kernel=False))
        k3_differ = int(((sk != so) | (ddk != ddo) | (gk != go).any(dim=1)).sum())
        print(f"K3 near ties: {ties['K3']['queued']} of {ties['K3']['values']} "
              f"tensor-core values queued ({ties['K3']['share']:.4%}), "
              f"{ties['K3']['past_queue']} past the queue; points differing from the "
              f"in-order plain version: {k3_differ} of {pts.shape[0]}", flush=True)
        check(k3_differ == 0, f"K3 differs from its in-order plain version on {k3_differ} "
              "points (a near tie the margin missed)")

        # K4 on the main path's inputs: (a) the compose bucket with a
        # seeded cotangent, (b) every ray's anchor (the lazy margin's
        # width), (c) 3 seed rows taken as preactivation cotangents, with
        # the xyz gradient. Each against its plain version, with the xyz
        # gradient asked for in every case; timed in the mode the render's
        # backward uses
        gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
        seeded = lambda *shape: torch.randn(shape, generator=gen).to(dev)
        pts_all = (origins + anchor[:, None] * dirs).contiguous()
        k4 = []
        for case, p_c, ct_c, kw in (
                ("a", pts, seeded(pts.shape[0]), dict(scalar_chain=True)),
                ("b", pts_all, seeded(n), dict(scalar_chain=True)),
                ("c", pts, seeded(pts.shape[0], 3),
                 dict(scalar_chain=False, want_gx=True))):
            call = lambda k, gx: precise_bias_grads_call(
                packed, biases, p_c, ct_c, use_kernel=k,
                **dict(kw, want_gx=gx))
            (uk, gxk), (up, gxp) = call(True, True), call(False, True)
            ties["K4 " + case] = ties_line(torch, precise_bias_grads_call, packed,
                                           p_c.shape[0])
            u_main = call(True, kw.get("want_gx", False))
            u_main = u_main[0] if kw.get("want_gx") else u_main
            torch.cuda.synchronize()
            cat = lambda us: torch.cat(us).double()
            rel = lambda a, b: ((a - b).norm() / b.norm()).item()
            r = dict(case=case, n=p_c.shape[0],
                     u=rel(cat(uk), cat(up)),
                     gz=rel(latent_grad(packed, uk).double(),
                            latent_grad(packed, up).double()),
                     u_abs=(cat(uk) - cat(up)).abs().max().item(),
                     gx=(gxk - gxp).abs().max().item(),
                     same=all(torch.equal(a, b) for a, b in zip(uk, u_main)),
                     ms=cuda_ms(lambda: call(True, kw.get("want_gx", False))),
                     plain_ms=cuda_ms(lambda: call(False, kw.get("want_gx", False))))
            if case != "b":  # against the in-order plain version
                uo, gxo = in_order(lambda: call(False, True))
                r.update(u_in_order=rel(cat(uk), cat(uo)), gx_in_order=torch.equal(gxk, gxo))
            k4.append(r)
            if case == "a":
                ct_a = ct_c
            t4 = ties["K4 " + case]
            print(f"K4 bias grads ({case}) {r['n']} points, {kw}: relative L2 u "
                  f"{r['u']:.3e}, gz {r['gz']:.3e}; max |diff| gx {r['gx']:.3e}; "
                  f"u equal across launches and gx modes: {r['same']}; "
                  f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms; near ties "
                  f"{t4['queued']} of {t4['values']} ({t4['share']:.4%}), "
                  f"{t4['past_queue']} past the queue"
                  + ("" if case == "b" else
                     f"; vs the in-order plain version: gx equal {r['gx_in_order']}, "
                     f"relative L2 u {r['u_in_order']:.3e}"), flush=True)
        # bars: u and gz within relative L2 1e-5, gx within 1e-5, and a
        # second launch gives the same bits
        for r in k4:
            check(r["u"] <= 1e-5 and r["gz"] <= 1e-5 and r["gx"] <= 1e-5
                  and r["same"], f"K4 ({r['case']}) disagrees with its plain "
                  "version or with itself (bars: relative L2 u, gz <= 1e-5; "
                  "max |diff| gx <= 1e-5; equal bits across launches)")
            check(r["case"] == "b" or (r["gx_in_order"] and r["u_in_order"] <= 1e-6),
                  f"K4 ({r['case']}) differs from its in-order plain version (bars: gx "
                  "bit for bit, relative L2 u <= 1e-6)")

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
        # K3's and K4's library yardstick on the same inputs, beside how
        # far its bf16 roundings put it from the kernels' answers
        chain = precise_chain(torch, params, dcfg, latent)
        t_k3c = cuda_ms(lambda: chain.sdg(pts, vs))
        t_k4c = cuda_ms(lambda: chain.bias_grads(pts, ct_a))
        sc, _, gc = chain.sdg(pts, vs)
        uc = torch.cat(chain.bias_grads(pts, ct_a)).double()
        uk_a = torch.cat(precise_bias_grads_call(packed, biases, pts, ct_a)).double()
        chain_gap = dict(s_median=(sc - sk).abs().median().item(),
                         g_rel=((gc - gk).norm() / gk.norm()).item(),
                         u_rel=((uc - uk_a).norm() / uk_a.norm()).item())
        # whether the chain computes K3's and K4's function at all: the same
        # chain on fp32 weights and activations against the fp64 autograd
        # truth, and each of kernels, bf16 chain and fp32 chain against it;
        # then the fp32 chain again on the points whose every hidden
        # preactivation lies 1e-5 or more from the ReLU kink, where fp32
        # takes fp64's gates and differs by its roundings alone
        chain32 = precise_chain(torch, params, dcfg, latent, dtype=torch.float32)
        s32, _, g32 = chain32.sdg(pts, vs)
        u32 = torch.cat(chain32.bias_grads(pts, ct_a)).double()
        s64, g64, u64, kink = folded_reference(torch, params, dcfg, latent, pts, ct_a)
        rel = lambda a, b: ((a.double() - b).norm() / b.norm()).item()
        to_truth = {name: dict(s_median=(s_.double() - s64).abs().median().item(),
                               g_rel=rel(g_, g64), u_rel=rel(u_, u64))
                    for name, s_, g_, u_ in (("kernels", sk, gk, uk_a),
                                             ("bf16_chain", sc, gc, uc),
                                             ("fp32_chain", s32, g32, u32))}
        smooth = kink >= 1e-5
        s64s, g64s, u64s, _ = folded_reference(torch, params, dcfg, latent, pts[smooth],
                                               ct_a[smooth])
        s32s, _, g32s = chain32.sdg(pts[smooth], vs[smooth])
        u32s = torch.cat(chain32.bias_grads(pts[smooth], ct_a[smooth]))
        to_truth["fp32_chain_off_kinks"] = t32 = dict(
            share=smooth.double().mean().item(), s_rel=rel(s32s, s64s),
            g_rel=rel(g32s, g64s), u_rel=rel(u32s, u64s))
        chain_gap["fp32_chain_to_kernels"] = dict(
            s_median=(s32 - sk).abs().median().item(), g_rel=rel(g32, gk.double()),
            u_rel=rel(u32, uk_a))
        chain_gap["to_fp64_truth"] = to_truth
        check(t32["share"] >= 0.5 and max(t32["s_rel"], t32["g_rel"], t32["u_rel"]) <= 1e-5,
              "the fp32 chain does not compute K3's and K4's function off the ReLU kinks "
              f"(on {t32['share']:.4f} of the points, relative L2 to the fp64 autograd "
              f"truth: s {t32['s_rel']:.2e}, g {t32['g_rel']:.2e}, u {t32['u_rel']:.2e}; "
              "bars: share >= 0.5, each <= 1e-5), so the bf16 chain's time is no "
              "yardstick")
    print(f"times (ms, median of 3 after warm-up; plain K2 one run): "
          f"K1 {t_k1:.3f} vs plain {t_k1p:.3f}; K2 {t_k2:.3f} vs plain {t_k2p:.3f}; "
          f"K3 {t_k3:.3f} vs plain {t_k3p:.3f} and its bf16 F.linear chain {t_k3c:.3f}; "
          f"K4 (a) {k4[0]['ms']:.3f} vs its chain {t_k4c:.3f} (the chains' gap to the "
          f"kernels: |s| median {chain_gap['s_median']:.2e}, g relative L2 "
          f"{chain_gap['g_rel']:.2e}, u relative L2 {chain_gap['u_rel']:.2e}; the fp32 "
          f"chain's: g {chain_gap['fp32_chain_to_kernels']['g_rel']:.2e}, u "
          f"{chain_gap['fp32_chain_to_kernels']['u_rel']:.2e}); to the fp64 autograd "
          "truth, g / u relative L2: " + ", ".join(
              f"{k} {v['g_rel']:.2e} / {v['u_rel']:.2e}"
              for k, v in chain_gap["to_fp64_truth"].items())
          + f" (the last on {chain_gap['to_fp64_truth']['fp32_chain_off_kinks']['share']:.4f}"
          " of the points)", flush=True)
    with torch.no_grad():
        kg = k1_grid_phase(torch, dev, params, dcfg, latent, cfg, origins, dirs)
        k6 = k6_row(torch, dev, smi)
    # bounds at these shapes and this run's active ray-steps
    b_k1 = bound_ms(sum(march_bytes(lv[4], shared_p, bank_p) for lv in k1_levels),
                    2 * sum(lv[3] for lv in k1_levels) * macs_per_eval(shared_p))
    b_k2 = bound_ms(sum(by for _, _, by in k2_steps), 2 * sum(st * mc for st, mc, _ in k2_steps))
    b_k3 = bound_ms(precise_bytes(pts.shape[0], packed, 6, 5),
                    2 * pts.shape[0] * precise_macs(packed))
    b_k4 = bound_ms(precise_bytes(pts.shape[0], packed, 4, 0),
                    2 * pts.shape[0] * precise_macs(packed))

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

    # the same request on the plain versions (use_kernel=False), same card
    plain_sdf = make_precise_sdf(params, dcfg, use_kernel=False)
    plain_fac = make_march_factory(params, dcfg, cfg, march_params=pparams,
                                   march_dcfg=pcfg, use_kernel=False)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref = render(plain_sdf, lats[0], cam, cfg, plain_fac)
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

    # the same request with polish-verify: the verify stage re-marches band
    # and unresolved rays only, compose()'s Newton polish finalizes hits
    cfg_pol = dataclasses.replace(
        cfg, march=dataclasses.replace(march, proxy_verify_hits="polish"),
        grad=dataclasses.replace(cfg.grad, polish_iters=2))
    fac_pol = make_march_factory(params, dcfg, cfg_pol, march_params=pparams,
                                 march_dcfg=pcfg)
    render(sdf_fn, lats[0], cam, cfg_pol, fac_pol)  # warm-up
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    pol = render(sdf_fn, lats[0], cam, cfg_pol, fac_pol)
    b.record()
    torch.cuda.synchronize()
    polish_ms = a.elapsed_time(b)
    polish_agree = (pol.mask == outs[0].mask).float().mean().item()
    both = pol.mask & outs[0].mask
    q = quantiles((pol.depth - outs[0].depth).abs()[both])
    print(f"polish-verify request (proxy_verify_hits='polish', polish_iters=2): "
          f"{polish_ms:.3f} ms; hit agreement with the march-verify render "
          f"{polish_agree:.5f}, |depth diff| on {int(both.sum())} common hits p50 "
          f"{q[0]:.3e} p95 {q[1]:.3e} max {q[2]:.3e}  [{smi}]", flush=True)
    check(torch.isfinite(pol.depth).all().item() and polish_agree >= 0.99,
          f"the polish-verify render disagrees with march-verify ({polish_agree:.4f} < 0.99)")

    # the same request with the certification path (ops/cert.py on K6):
    # verify_mode="cert", and the hybrid (verify_band="probe")
    verify4 = {}
    for name, mk in (("cert", dict(proxy_verify_mode="cert")),
                     ("hybrid", dict(proxy_verify_band="probe"))):
        cfg_v = dataclasses.replace(cfg, march=dataclasses.replace(march, **mk))
        fac_v = make_march_factory(params, dcfg, cfg_v, march_params=pparams,
                                   march_dcfg=pcfg)
        # the warm-up's K6 calls, held against the plain version at F=1
        _, k6_calls = k6_capture(torch, lambda: render(sdf_fn, lats[0], cam, cfg_v, fac_v))
        torch.cuda.synchronize()
        k6_f1 = k6_held(torch, k6_calls, f"phase 4's {name} request (F=1)")
        del k6_calls
        point_eval_banked.launches = 0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out_v = render(sdf_fn, lats[0], cam, cfg_v, fac_v)
        b.record()
        torch.cuda.synchronize()
        n_k6 = point_eval_banked.launches
        agree_v = (out_v.mask == outs[0].mask).float().mean().item()
        both = out_v.mask & outs[0].mask
        q = quantiles((out_v.depth - outs[0].depth).abs()[both])
        verify4[name] = dict(ms=a.elapsed_time(b), agree=agree_v, k6_launches=n_k6,
                             depth_p50=q[0], depth_p95=q[1], depth_max=q[2],
                             k6_vs_plain=k6_f1)
        print(f"{name} request ({mk}): {verify4[name]['ms']:.3f} ms, {n_k6} K6 launches; "
              f"hit agreement with the march-verify render {agree_v:.5f}, |depth diff| "
              f"on {int(both.sum())} common hits p50 {q[0]:.3e} p95 {q[1]:.3e} max "
              f"{q[2]:.3e}  [{smi}]", flush=True)
        check(n_k6 > 0, f"the {name} request never launched point_eval_banked")
        check(all(torch.isfinite(getattr(out_v, k)).all().item()
                  for k in ("depth", "normal", "min_sdf")), f"non-finite {name} render")
        check(agree_v >= 0.99, f"the {name} render disagrees with march-verify "
              f"({agree_v:.4f} < 0.99)")

    fb = fwd_bwd_phase(torch, dev, sdf_fn, factory, plain_fac, plain_sdf, cfg, cam,
                       lats, latent, counters + (precise_bias_grads_call,), smi)
    g6 = grid_path_phase(torch, dev, params, dcfg, lats, cam, smi, outs[0])
    tasks = cli_phase(torch, smi)
    b8 = batched_phase(torch, dev, params, dcfg, cfg, origins, dirs, smi)
    km = b8["k1_multi"]
    k9 = k5_phase(torch, dev, params, dcfg, latent, cam, smi)
    k5 = k9["a"][0]
    p_rows, p_launches, probes = probes_phase(torch, dev)
    t11 = train_phase(torch, dev, smi, params, latent, cam)
    t12 = sharded_phase(torch, dev, smi, params, dcfg, latent, pparams, pcfg, cfg, key,
                        k9["mesh_arrays"])
    t13 = schedule_phase(torch, dev, smi, (params, dcfg, latent, (pparams, pcfg),
                                           (backoff, band)))

    src = "dist_renderer_tpu_torch/csrc/"
    kernels = [
        dict(name="sphere_trace_persistent (K1)", route="cuda",
             source=src + "batched_march.cu",
             replaces="dist_renderer_tpu/ops/pallas/batched_march.py:254",
             launches=b8["launches"]["sphere_trace_persistent"],
             max_abs_err=max([max_err(km["d_k1"])] + [max_err(lv[0]) for lv in k1_levels]),
             ms=km["k1_ms"], plain_ms=km["plain_ms"], bound_ms=km["bound_ms"],
             bound_by=km["bound_by"], library_ms=None),
        dict(name="queue_march (K2, tensor cores)", route="cuda",
             source=src + "queue_march.cu",
             replaces="dist_renderer_tpu/ops/pallas/queue_march.py:463",
             launches=launches["queue_march"],
             max_abs_err=max(max_err(d_fine), max_err(d_ver)),
             ms=t_k2, plain_ms=t_k2p, bound_ms=b_k2[0], bound_by=b_k2[1],
             library_ms=None),
        dict(name="precise_sdg_call (K3, tensor cores)", route="cuda",
             source=src + "recompute.cu",
             replaces="dist_renderer_tpu/ops/pallas/recompute.py:386",
             launches=launches["precise_sdg_call"],
             max_abs_err=max(e_s[2], e_dd[2], e_g[2]),
             ms=t_k3, plain_ms=t_k3p, bound_ms=b_k3[0], bound_by=b_k3[1],
             library_ms=t_k3c),
        dict(name="precise_bias_grads_call (K4, tensor cores)", route="cuda",
             source=src + "recompute.cu",
             replaces="dist_renderer_tpu/ops/pallas/recompute.py:421",
             launches=fb["launches"]["precise_bias_grads_call"],
             max_abs_err=max(max(r["u_abs"], r["gx"]) for r in k4),
             ms=k4[0]["ms"], plain_ms=k4[0]["plain_ms"], bound_ms=b_k4[0],
             bound_by=b_k4[1], library_ms=t_k4c),
        dict(name="sphere_trace_grid (K1-grid, tensor cores)", route="cuda",
             source=src + "fused_march.cu",
             replaces="dist_renderer_tpu/ops/pallas/fused_march.py:148",
             launches=g6["launches"],
             max_abs_err=max(max_err(r["d"]) for r in kg),
             ms=kg[0]["ms"], plain_ms=kg[0]["plain_ms"],
             bound_ms=kg[0]["bound_ms"], bound_by=kg[0]["bound_by"],
             library_ms=None),
        dict(name="sphere_trace_batched (K1-multi)", route="cuda",
             source=src + "fused_march.cu",
             replaces="dist_renderer_tpu/ops/pallas/batched_march.py:371",
             launches=b8["launches"]["sphere_trace_batched"],
             max_abs_err=max_err(km["d"]), ms=km["ms"], plain_ms=km["plain_ms"],
             bound_ms=km["bound_ms"], bound_by=km["bound_by"], library_ms=None),
        dict(name="point_eval (K5)", route="cuda", source=src + "point_eval.cu",
             replaces="dist_renderer_tpu/ops/pallas/mlp_eval.py:61",
             launches=k9["launches"], max_abs_err=max(r["max"] for r in k9["a"]),
             ms=k5["ms"], plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"],
             bound_by=k5["bound_by"], library_ms=k5["library_ms"]),
        dict(name="point_eval_banked (K6)", route="cuda", source=src + "point_eval.cu",
             replaces="dist_renderer_tpu/ops/pallas/mlp_eval.py:154",
             launches=b8["launches"]["point_eval_banked"], max_abs_err=k6["max"],
             ms=k6["ms"], plain_ms=k6["plain_ms"], bound_ms=k6["bound_ms"],
             bound_by=k6["bound_by"], library_ms=k6["library_ms"]),
    ] + [dict(name=f"{r['kernel'].__name__} ({r['id']})", route="cuda", source=r["source"],
              replaces=r["replaces"], launches=p_launches[r["kernel"].__name__],
              max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
              bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"])
         for r in p_rows]
    print(json.dumps({"fwd_ms_per_frame": fwd_ms, "plain_fwd_ms": plain_ms,
                      "fwdbwd_ms_per_frame": fb["fwdbwd_ms"],
                      "plain_fwdbwd_ms": fb["plain_fwdbwd_ms"],
                      "fit_ms_per_step": fb["fit_ms"],
                      "hit_frac": hit_frac,
                      "grid_fwd_ms_per_frame": g6["fwd_ms"],
                      "grid_fwdbwd_ms_per_frame": g6["fwdbwd_ms"],
                      "grid_plain_fwd_ms": g6["plain_ms"],
                      "grid_plain_fwdbwd_ms": g6["plain_fwdbwd_ms"],
                      "grid_c2f_fwd_ms": g6["c2f_ms"],
                      "grid_hit_frac": g6["hit_frac"],
                      "k1_f1_ms": kg[0]["k1_ms"],
                      "k1_coarse": dict(ms=t_k1, plain_ms=t_k1p, bound_ms=b_k1[0],
                                        launches=launches["sphere_trace_persistent"]),
                      "k3_k4_chains": dict(k3_ms=t_k3c, k4_a_ms=t_k4c, gap=chain_gap),
                      "k3_k4": dict(near_ties=ties, k3_in_order_differing=k3_differ,
                                    k4=[{k: v for k, v in r.items() if k != "same"}
                                        for r in k4]),
                      "k2_stages": k2_gens,
                      "k1_grid_cases": [dict(case=r["case"], ms=r["ms"],
                                             plain_ms=r["plain_ms"],
                                             ray_steps=r["steps"],
                                             bound_ms=r["bound_ms"]) for r in kg],
                      "polish_fwd_ms": polish_ms, "polish_hit_agreement": polish_agree,
                      "cert_requests": verify4,
                      "k6": {k: v for k, v in k6.items() if k != "exact"},
                      "task_ms": tasks,
                      "batched": dict(
                          frames=F8, modes={k: {kk: vv for kk, vv in r.items()
                                                if kk != "verify_hits"}
                                            for k, r in b8["rows"].items()},
                          launches=b8["launches"],
                          k1_multi_ms=km["ms"], k1_same_inputs_ms=km["k1_ms"],
                          k1_multi_plain_ms=km["plain_ms"],
                          k1_multi_ray_steps=km["ray_steps"],
                          k1_in_order_rays_differing=km["k1_in_order_differ"],
                          k1_grid_in_order_rays_differing=km["k1_grid_in_order_differ"],
                          in_order_witness_ms=km["witness_ms"],
                          verify_round_lanes=km["lanes"],
                          render_depth_batched_ms=b8["render_depth_ms"],
                          k6_vs_plain=b8["k6"],
                          path_within={k: v["within"] for k, v in
                                       b8["path_vs_plain"].items() if k != "d_more"},
                          d_more_within=[p["within"] for p in
                                         b8["path_vs_plain"]["d_more"]]),
                      "k5": dict(cases=[{k: v for k, v in r.items() if k != "exact"}
                                        for r in k9["a"]],
                                 mesh=k9["mesh"], triangle_route=k9["route"],
                                 color=k9["color"]),
                      "probes_seconds": probes["seconds"],
                      "train": t11,
                      "sharded": t12,
                      "schedule": schedule_summary(t13),
                      "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
