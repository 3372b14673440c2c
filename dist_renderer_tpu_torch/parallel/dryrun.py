"""Runners of the sharded path across ranks, and the multi-rank gate.

``run_calls`` is the rank side of ``mesh.run_ranks`` for a list of
sharded calls (the tests and the smoke run use it); ``fit_steps`` runs
``make_sharded_fit_step`` for a number of steps; ``dryrun_multichip`` is
the counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
one sharded fit step through the fused recompute (K3 forward, K4
backward under the ranks) and the flagship ``render_batched_c2f_sharded``
held to the single-device plan, on n ranks.

    python -m dist_renderer_tpu_torch.parallel.dryrun --ranks 4 --cpu
    python -m dist_renderer_tpu_torch.parallel.dryrun --ranks 4 --backend gloo   # one card
"""

from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from dist_renderer_tpu_torch.parallel.mesh import (
    check_backend, make_mesh, run_ranks, to_device,
)
from dist_renderer_tpu_torch.parallel.sharding import (
    gather_latents, make_sharded_fit_step,
)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_calls(calls: Sequence, device: str, counters: Sequence = ()) -> list:
    """Run each call on every rank, in order; for ``run_ranks``.

    A call is (fn, axes, shape, kwargs): the tensors in kwargs (and
    objects with a ``to``) move to this rank's device, a mesh
    ``make_mesh(axes, shape)`` goes in as kwargs["mesh"] (none when axes
    is None), and fn(**kwargs) runs between two synchronisations.
    ``counters``: kernel wrappers whose ``launches`` are set to 0 before
    each call and read after it. Returns per call a dict: ``out`` (fn's
    result on this rank), ``seconds`` (the slowest rank's wall time) and
    ``launches`` (per rank, each counter's count)."""
    dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
           else torch.device("cpu"))
    results = []
    for fn, axes, shape, kwargs in calls:
        kw = to_device(dict(kwargs), dev)
        if axes is not None:
            kw["mesh"] = make_mesh(axes, shape, device_type=dev.type)
        for c in counters:
            c.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(**kw)
        _sync(dev)
        dt = time.perf_counter() - t0
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, (dt, [c.launches for c in counters]))
        results.append(dict(out=out, seconds=max(p[0] for p in per_rank),
                            launches=[p[1] for p in per_rank]))
    return results


def fit_steps(sdf_fn, cfg, loss_cfg, mesh, latents, origins, dirs, obs_depth,
              obs_mask, steps: int, latent_axis: str = "latents",
              ray_axis: str = "rays") -> dict:
    """``steps`` sharded fit steps from ``latents`` [B, L]: the global loss
    of each step [steps] and the whole latents after each [steps, B, L]."""
    step, _ = make_sharded_fit_step(sdf_fn, cfg, loss_cfg, mesh, latents,
                                    latent_axis, ray_axis)
    losses, lats = [], []
    for _ in range(steps):
        shard, loss = step(origins, dirs, obs_depth, obs_mask)
        losses.append(loss)
        lats.append(gather_latents(shard, mesh, latent_axis))
    return dict(losses=torch.stack(losses), latents=torch.stack(lats))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def dryrun_multichip(n: int, device: str = "cuda", backend: str = None) -> dict:
    """One sharded fit step and the flagship sharded render on ``n`` ranks
    (tiny shapes), held to the single-device plan; prints two lines and
    returns their numbers. device: "cuda" (default; without a card it
    raises) or "cpu". backend: "nccl" on the card, "gloo" on the CPU by
    default; "gloo" lets ranks share a card (NCCL with more ranks than
    cards raises). The kernels build in this process before the ranks
    start. Any failed check raises RuntimeError."""
    from dist_renderer_tpu_torch.config import (
        DecoderConfig, GradConfig, LossConfig, MarchConfig, RenderConfig,
    )
    from dist_renderer_tpu_torch.eval.mesh import default_device
    from dist_renderer_tpu_torch.models.analytic import torus_sdf
    from dist_renderer_tpu_torch.models.decoder import (
        init_decoder_params, make_precise_sdf,
    )
    from dist_renderer_tpu_torch.models.pretrain import fit_decoder_to_sdf
    from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
    from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f
    from dist_renderer_tpu_torch.parallel.sharding import render_batched_c2f_sharded

    backend = backend or ("gloo" if device == "cpu" else "nccl")
    dev = torch.device("cpu") if device == "cpu" else default_device()
    check_backend(n, backend, device,
                  torch.cuda.device_count() if device == "cuda" else 0)
    if dev.type == "cuda":
        from dist_renderer_tpu_torch.ops.kernels import build

        build.load()
    shape = (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)
    axes = ("latents", "rays")

    # the fit step: ift through the fused recompute (K3, K4 under the ranks)
    img, b = 8, 2 * shape[0]
    dcfg = DecoderConfig(hidden_dims=(64,) * 8, latent_size=32)
    params = init_decoder_params(torch.Generator().manual_seed(0), dcfg)
    cfg = RenderConfig(img_h=img, img_w=img, march=MarchConfig(max_steps=8),
                       grad=GradConfig(mode="ift", recompute="pallas"))
    o, v = pixel_rays(Camera.looking_at((0.0, 0.0, -2.0), focal=10.0,
                                        img_hw=(img, img)), img, img)
    nr = o.shape[0]
    fit = dict(sdf_fn=make_precise_sdf(params, dcfg), cfg=cfg,
               loss_cfg=LossConfig(), latents=torch.zeros(b, dcfg.latent_size),
               origins=o[None].expand(b, nr, 3), dirs=v[None].expand(b, nr, 3),
               obs_depth=torch.full((b, nr), 1.5),
               obs_mask=torch.ones((b, nr), dtype=torch.bool), steps=1)

    # the flagship: render_batched_c2f_sharded against the single-device plan
    n_fb, n_rb = shape
    img2, f2 = max(32, 8 * n_rb), 2 * n_fb   # stride 4 divides every band
    dcfg2 = DecoderConfig(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))
    params2, z2 = fit_decoder_to_sdf(lambda p: torus_sdf(0.55, 0.2)(None, p),
                                     dcfg2, steps=150, batch=512, device=dev)
    gen = torch.Generator().manual_seed(3)
    lat2 = z2[None].expand(f2, -1) + 0.02 * torch.randn(
        (f2, dcfg2.latent_size), generator=gen).to(dev)
    o2, v2 = pixel_rays(Camera.looking_at((0.0, 0.0, -2.0), focal=img2 * 1.2,
                                          img_hw=(img2, img2), device=dev), img2, img2)
    ob2, vb2 = o2[None].expand(f2, -1, 3), v2[None].expand(f2, -1, 3)
    march2 = MarchConfig(max_steps=24, convergence_eps=2e-3, depth_eps=5e-4)
    kw2 = dict(strides=(4,), coarse_steps=12)
    with torch.no_grad():
        ref = render_batched_c2f(params2, dcfg2, lat2, ob2, vb2, (img2, img2),
                                 march2, **kw2)
    flagship = dict(params=params2, dcfg=dcfg2, latents=lat2, origins=ob2,
                    dirs=vb2, img_hw=(img2, img2), march=march2, **kw2)

    res = run_ranks(run_calls, n, [(fit_steps, axes, shape, fit),
                                   (render_batched_c2f_sharded, axes, shape, flagship)],
                    device, backend=backend, device=device)
    loss = float(res[0]["out"]["losses"][0])
    _require(np.isfinite(loss), f"non-finite loss {loss}")
    print(f"dryrun_multichip({n}): mesh={dict(zip(axes, shape))} loss={loss:.4f} OK",
          flush=True)

    d_sh, hit_sh, msdf_sh = res[1]["out"]
    hit_ref = ref.hit.cpu()
    n_hit = int(hit_ref.sum())
    _require(n_hit > 0, "flagship dryrun rendered zero hits")
    _require(torch.equal(hit_sh, hit_ref), "sharded c2f hit mask != single-device plan")
    dd = (d_sh - ref.depth.cpu()).abs()[hit_ref]
    md = (msdf_sh - ref.min_sdf.cpu()).abs()
    # the JAX package's cross-layout contract (tests/test_parallel_batched.py):
    # a ray's setup math may move a last bit between a band's batch and the
    # whole frame's, and a 1-ulp seed can flip a secant branch on an
    # isolated ray, bounded by the march's own depth tolerance
    frac_d, frac_m = float((dd > 1e-6).float().mean()), float((md > 1e-6).float().mean())
    derr, merr = float(dd.max()), float(md.max())
    _require(frac_d <= 0.005 and derr < 4 * march2.depth_eps,
             f"sharded c2f depth off-plan: {frac_d:.4f} rays > 1e-6, max {derr:.2e}")
    _require(frac_m <= 0.005 and merr < 1e-3,
             f"sharded c2f margins off-plan: {frac_m:.4f} > 1e-6, max {merr:.2e}")
    print(f"dryrun_multichip({n}): flagship render_batched_c2f_sharded (multi-frame "
          f"march + halo c2f, {f2}x{img2}^2, mesh {n_fb}x{n_rb}) plan-exact vs "
          f"single-device: {n_hit} hits, depth err {derr:.1e}, msdf err {merr:.1e} OK",
          flush=True)
    return dict(loss=loss, hits=n_hit, depth_err=derr, msdf_err=merr)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU (default: the CUDA card)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="default: nccl on the card, gloo on the CPU")
    args = ap.parse_args(argv)
    return dryrun_multichip(args.ranks, "cpu" if args.cpu else "cuda", args.backend)


if __name__ == "__main__":
    main()
