"""Warm-started fit steps against cold ones: the counterpart of
scripts/diag_warm.py.

One depth-completion Adam step (render, loss, gradient, update; lr
1e-2) of the bench decoder from a zero latent against the bench
latent's own render (depth and mask, 50 steps, strides (16, 4), IFT on
an n/4 bucket with ``--recompute``), at each size of ``--imgs``: cold
(the full coarse pyramid every step) and warm (``render_with_warm``: the
previous trace seeds the next render, the full pyramid every
``--refresh`` steps, the carry starting from one cold render). ms per
step over ``--steps`` steps after one untimed step (CUDA events around
each step), and the loss of the last step, per mode. The zero latent's
render has no hit, so a warm carry renders nothing until its first
refresh: each mode also reports how many timed steps rendered a hit and
their mean ms, the speedup is taken over those steps, and a warm window
without one raises (``--steps`` must reach the refresh). The target
render is held to the same render through the plain versions with the
in-order product, bit for bit.

    python -m dist_renderer_tpu_torch.diag.diag_warm [--imgs 256 512]
        [--steps 30] [--refresh 8] [--recompute pallas]
"""

from __future__ import annotations

import torch

from dist_renderer_tpu_torch.diag import BenchCell, device, emit, parser


def fit_rows(cell: BenchCell, steps: int, refresh: int, recompute: str) -> dict:
    """Cold and warm ms per step and last loss at the cell's size."""
    from dist_renderer_tpu_torch.config import GradConfig
    from dist_renderer_tpu_torch.ops.renderer import render, render_with_warm, warm_from_trace
    from dist_renderer_tpu_torch.utils import losses as L

    cfg = cell.frame_cfg(GradConfig(mode="ift", compact_frac=4, recompute=recompute))
    factory, sdf = cell.factory(cfg), cell.sdf()
    gt = cell.frame_fns(cfg, factory, sdf)[0]()
    held = cell.hold_frame(f"the {cell.img}^2 target", cfg, gt)
    obs_depth, obs_mask = gt.depth, gt.mask

    def obj(z, out):
        ld = L.depth_loss(out.depth, obs_depth, obs_mask, out.mask)
        return 10.0 * ld + L.silhouette_loss(out.min_sdf, obs_mask) + 1e-4 * L.latent_reg(z)

    def fit(warm: bool):
        z = torch.zeros_like(cell.latent).requires_grad_(True)
        opt = torch.optim.Adam([z], lr=1e-2)
        state = {}
        if warm:
            with torch.no_grad():
                out0 = render(sdf, z, cell.cam, cfg, factory)
            state["carry"] = (1, warm_from_trace(out0.trace))

        def step():
            opt.zero_grad(set_to_none=True)
            if warm:
                out, state["carry"] = render_with_warm(sdf, z, cell.cam, cfg, factory,
                                                       state["carry"], refresh)
            else:
                out = render(sdf, z, cell.cam, cfg, factory)
            loss = obj(z, out)
            loss.backward()
            opt.step()
            return loss.detach(), out.mask.any()

        step()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        marks[0].record()
        hits = []
        for k in range(steps):
            loss, hit = step()
            hits.append(hit)
            marks[k + 1].record()
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        hit_ms = [t for t, h in zip(ms, torch.stack(hits).tolist()) if h]
        return dict(ms_per_step=sum(ms) / steps, loss=float(loss), hit_steps=len(hit_ms),
                    ms_per_hit_step=sum(hit_ms) / len(hit_ms) if hit_ms else None)

    cold, warm = fit(False), fit(True)
    if not warm["hit_steps"]:
        raise ValueError(f"{cell.img}^2: the warm fit rendered no hit in its {steps} timed "
                         f"steps (its first refresh is step {refresh}): nothing to compare")
    return dict(cold=cold, warm=warm,
                speedup=(cold["ms_per_hit_step"] / warm["ms_per_hit_step"]
                         if cold["hit_steps"] else None),
                target_plain=held, target_hit_frac=obs_mask.float().mean().item())


def measure(dev, imgs=(256, 512), steps: int = 30, refresh: int = 8,
            recompute: str = "pallas", fixture=None) -> dict:
    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul

    set_fp32_matmul()
    rows = {}
    for img in imgs:
        cell = BenchCell(dev, 1, img, fixture=fixture)
        fixture = cell.fixture
        rows[str(img)] = fit_rows(cell, steps, refresh, recompute)
    return dict(steps=steps, refresh=refresh, recompute=recompute, imgs=rows)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--imgs", type=int, nargs="*", default=[256, 512])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--refresh", type=int, default=8)
    ap.add_argument("--recompute", default="pallas", choices=["xla", "pallas"])
    args = ap.parse_args(argv)
    dev = device()
    emit("diag_warm", measure(dev, args.imgs, args.steps, args.refresh, args.recompute))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
