"""The march kernels' cost per tile-step: the counterpart of
scripts/diag_kernel.py.

Every ray's march is forced to an exact step count: convergence is
impossible (eps 0, depth eps 0, far margin 100), so each ray that enters
the bounding sphere marches ``--steps`` steps; with every ray inactive,
a launch's tiles step no time (the dead-tile cost). K1 (a persistent
grid over the rays) and K1-multi (a block per 64-ray tile) march the
bench cell's 512x512 rays on the 8x512 bench decoder, the rays split
over F=1 and F=8 latents of the bias bank (the TPU script's single-frame
and batched kernels). A launch's tile-steps are ``march_tile_steps`` of
its steps per ray (a tile steps while any of its 64 rays is active), so
us per tile-step = device time / tile-steps. The TPU's block widths
(512 and 1024 lanes) have no counterpart: the card's tile is 64 rows.
Each launch is held to its plain version on its first ``--check-rays``
rays, the plain version's products summed in k order (the kernels'
order): every field bit for bit. (With the GEMM's order, a last-bit
difference may move an activation's bf16 rounding, and a march of 32
steps that never converges samples enough points to show it: min_sdf
moved 5.5e-5 on one of 4,096 rays on an H100.)

    python -m dist_renderer_tpu_torch.diag.diag_kernel [--steps 32] [--reps 3]
"""

from __future__ import annotations

import torch

from dist_renderer_tpu_torch.diag import (
    bench_camera, bench_latents, device, differ, emit, in_order, load_bench, parser,
    time_ms,
)

CHECK_RAYS = 4096
FIELDS = ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf", "unresolved",
          "steps_per_ray", "bracketed")


def hard_march(steps: int):
    """A march no ray can end early: exactly ``steps`` steps a ray."""
    from dist_renderer_tpu_torch.config import MarchConfig

    return MarchConfig(max_steps=steps, convergence_eps=0.0, depth_eps=0.0,
                       far_margin=100.0)


def plain_check(name, res, run_plain, rays: int) -> dict:
    """Hold a launch's first ``rays`` rays to the plain version's with the
    in-order product: the rays whose bits differ, per field (all 0)."""
    with in_order():
        ref = run_plain(rays)
    out = {k: int(differ(getattr(res, k)[:rays], getattr(ref, k)).sum()) for k in FIELDS}
    if any(out.values()):
        raise AssertionError(f"{name}: the kernel differs from its plain version with "
                             f"the in-order product on {rays} rays: {out}")
    return dict(rays=rays, rays_differing=out)


def tile_step_cost(name: str, shared, bank, origins, dirs, frames: int, steps: int,
                   persistent: bool, reps: int = 3, check_rays: int = CHECK_RAYS) -> dict:
    """One kernel's row: device ms of a launch of every ray forced to
    ``steps`` steps, its tile-steps (march_tile_steps), us per tile-step,
    and the dead-tile cost of the same launch with every ray inactive."""
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm

    n = origins.shape[0]
    rpf = n // frames
    frame_of_ray = torch.arange(frames, device=origins.device).repeat_interleave(rpf)
    trace = bm.sphere_trace_persistent if persistent else bm.sphere_trace_batched
    march = hard_march(steps)

    def run(active=None, use_kernel=True, m=n):
        return trace(shared, bank, frame_of_ray[:m], origins[:m], dirs[:m], march,
                     init_active=active, rays_per_frame=rpf, use_kernel=use_kernel)

    res, ms = time_ms(run, reps)
    spr = res.steps_per_ray
    tiles = bm.march_tile_steps(spr)
    tile_steps = int(tiles.sum())
    marched = spr > 0
    dead = torch.zeros((n,), dtype=torch.bool, device=origins.device)
    dres, dead_ms = time_ms(lambda: run(dead), reps)
    if int(dres.steps_per_ray.sum()) != 0:
        raise AssertionError(f"{name}: a dead launch stepped")
    n_tiles = tiles.numel()
    return dict(
        kernel=name, frames=frames, rays=n, steps=steps, ms=ms, tiles=n_tiles,
        tile_steps=tile_steps, lane_steps=tile_steps * bm.MARCH_TILE,
        ray_steps=int(spr.sum()), marched_rays=int(marched.sum()),
        exact_share=(spr[marched] == steps).float().mean().item() if bool(marched.any())
        else 0.0,
        us_per_tile_step=1e3 * ms / max(tile_steps, 1),
        dead_ms=dead_ms, us_per_dead_tile=1e3 * dead_ms / n_tiles,
        plain=plain_check(name, res, lambda m: run(use_kernel=False, m=m), check_rays))


def decoder_bank(dev, which: str, frames: int, fixture=None):
    """(shared, bank) of the bench decoder ("full", 8x512) or its proxy
    ("proxy", 4x256) at ``frames`` latents (the bench latent's draws)."""
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm

    params, dcfg, latent, proxy, _ = fixture or load_bench(dev)
    p, c = (params, dcfg) if which == "full" else proxy
    shared = bm.pack_shared(p, c)
    lats = latent[None] if frames == 1 else bench_latents(latent, frames)
    return shared, bm.fold_bias_bank(p, lats, c, shared)


def measure(dev, decoders=("full",), frames=(1, 8), steps: int = 32, reps: int = 3,
            img: int = 512, check_rays: int = CHECK_RAYS, fixture=None) -> dict:
    """Rows for K1 and K1-multi on each decoder at each frame count."""
    fixture = fixture or load_bench(dev)
    _, origins, dirs = bench_camera(dev, img)
    rows = []
    for which in decoders:
        for f in frames:
            shared, bank = decoder_bank(dev, which, f, fixture)
            for kname, persistent in (("K1", True), ("K1-multi", False)):
                row = tile_step_cost(kname, shared, bank, origins, dirs, f, steps,
                                     persistent, reps, check_rays)
                rows.append(dict(decoder=which, **row))
    return dict(steps=steps, tile=64, rows=rows)


def us_per_tile_step(result: dict, kernel: str = "K1", frames: int = 8,
                     decoder: str = "full") -> float:
    """A row's us per tile-step (diag_binning's cost of a tile-step)."""
    for r in result["rows"]:
        if (r["kernel"], r["frames"], r["decoder"]) == (kernel, frames, decoder):
            return r["us_per_tile_step"]
    raise KeyError((kernel, frames, decoder))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check-rays", type=int, default=CHECK_RAYS)
    args = ap.parse_args(argv)
    dev = device()
    emit("diag_kernel", measure(dev, steps=args.steps, reps=args.reps,
                                check_rays=args.check_rays))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
