"""A sweep of the batched render's coarse-to-fine settings: the
counterpart of scripts/sweep_batched.py.

render_batched_c2f of the bench cell's 8x512 decoder without its proxy
(F frames of 512x512, ``--steps``) at render_batched_c2f's defaults (the
reference), then at strides (16, 4) with 16 coarse steps under each
round-cap schedule and live prefix (``live_frac`` 2 or 3) of the TPU
script's grid, and at march alpha 1.75 and 2.0 (a more aggressive rim
march). ``--rim-only`` keeps one grid point and the two alphas. Each
configuration: ms, ms/frame, Mrays/s, hit agreement with the reference
and the p95 depth difference on common hits; the fastest is named. The
live prefix only bounds the widths a round marches, so configurations
that differ in it alone give the same bits, which is checked. Every
render is held to the same render through the plain versions.

    python -m dist_renderer_tpu_torch.diag.sweep_batched [--frames 8] [--rim-only]
"""

from __future__ import annotations

import dataclasses
import itertools

from dist_renderer_tpu_torch.diag import BenchCell, device, differ, emit, parser

GRID_CAPS = [(4, 12), (4, 8), (3, 9), (4, 10), (2, 6, 14), (5, 14)]


def configs(rim_only: bool) -> list:
    out = [dict(strides=(16, 4), coarse_steps=16, round_caps=caps, live_frac=lf)
           for caps, lf in (itertools.product(GRID_CAPS, (2, 3)) if not rim_only
                            else [((4, 12), 3)])]
    out += [dict(strides=(16, 4), coarse_steps=16, round_caps=(4, 12), live_frac=3,
                 alpha=a) for a in (1.75, 2.0)]
    return out


def measure(dev, cell: BenchCell, rim_only: bool = False, reps: int = 3) -> dict:
    f, n = cell.frames, cell.img * cell.img
    ref, ref_ms, ref_held = cell.timed_render(reps, proxy=False, strides=(16, 4),
                                              coarse_steps=16)
    rows, by_caps = [], {}
    for c in configs(rim_only):
        kw = dict(c)
        alpha = kw.pop("alpha", None)
        if alpha is not None:
            kw["march"] = dataclasses.replace(cell.march, alpha=alpha)
        out, ms, held = cell.timed_render(reps, proxy=False, **kw)
        both = out.hit & ref.hit
        dd = (out.depth - ref.depth).abs()[both].sort().values
        row = dict(config={k: list(v) if isinstance(v, tuple) else v
                           for k, v in c.items()}, ms=ms, ms_per_frame=ms / f,
                   mrays_s=f * n / ms / 1e3,
                   hit_agree=(out.hit == ref.hit).float().mean().item(),
                   p95_depth=dd[int(0.95 * (dd.numel() - 1))].item() if dd.numel()
                   else 0.0, plain=held)
        if alpha is None:
            twin = by_caps.setdefault(c["round_caps"], out)
            row["rays_differing_other_live_frac"] = {
                k: int(differ(getattr(twin, k), getattr(out, k)).sum())
                for k in ("depth", "hit", "min_sdf")}
            if any(row["rays_differing_other_live_frac"].values()):
                raise AssertionError(f"{c}: live_frac changed the render")
        rows.append(row)
    best = max(rows, key=lambda r: r["mrays_s"])
    return dict(frames=f, reference=dict(ms=ref_ms, mrays_s=f * n / ref_ms / 1e3,
                                         plain=ref_held),
                rows=rows, best=best["config"])


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--rim-only", action="store_true",
                    help="one grid point and the two alphas")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, args.frames, args.img, args.steps)
    emit("sweep_batched", measure(dev, cell, args.rim_only, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
