"""Straggler binning: the counterpart of scripts/diag_binning.py.

One with_diag render of the bench cell (the 8x512 decoder without its
proxy, stride-4 classification, 50 steps, F=8 at 512x512) records each
ray's true fine-march steps (pixel order, ``return_steps``) and the plan
(``plan_key``, ``plan_width``); candidate sort keys are then simulated
offline: each frame's rays sorted by the key and packed into the card's
64-row march tiles, a tile paying the most of its rays' steps. The
residency (the tiles' summed steps) times the card's cost of a
tile-step, K1's us per tile-step on the 8x512 decoder at F=8 measured by
diag_kernel in the same run (or ``--us-per-tile-step``), gives the
simulated kernel ms; the TPU script used 11.5 us per 512-lane block.
Also simulated: two rounds, the first capped at 8, 12 or 16 steps under
the class sort, the rest packed by remaining work.

    python -m dist_renderer_tpu_torch.diag.diag_binning [--frames 8] [--dump FILE.npz]
"""

from __future__ import annotations

import numpy as np

from dist_renderer_tpu_torch.diag import (
    BenchCell, device, emit, parser, residency, summary,
)

TILE = 64   # rows of a march kernel's tile (batched_march.MARCH_TILE)
WIDTH_4Q = [0.01, 0.03, 0.1]
WIDTH_8Q = [0.005, 0.01, 0.02, 0.03, 0.05, 0.1, 0.3]


def residency_ms(steps: np.ndarray, key: np.ndarray, us_per_tile_step: float,
                 tile: int = TILE):
    """Sort each frame's rays by key (stable), pack them into tiles of
    ``tile`` rows and return (the sum of the tiles' most steps, implied
    kernel ms)."""
    tot = 0
    for i in range(steps.shape[0]):
        s = steps[i][np.argsort(key[i], kind="stable")]
        s = np.pad(s, (0, (-len(s)) % tile))
        tot += int(s.reshape(-1, tile).max(axis=1).sum())
    return tot, tot * us_per_tile_step / 1e3


def strategies(steps: np.ndarray, key: np.ndarray, width: np.ndarray) -> dict:
    """The script's candidate sort keys: the class, the oracle (true
    steps, most first), the class refined by the quantized coarse width,
    and the width alone (skip rays last)."""
    w = np.nan_to_num(width, posinf=9.0)
    return {
        "current (class)": key,
        "oracle (true steps)": -steps,
        "class+width(4q)": key * 100 + np.digitize(w, WIDTH_4Q),
        "class+width(8q)": key * 100 + np.digitize(w, WIDTH_8Q),
        "width only": np.digitize(w, WIDTH_8Q) + 100 * (key == 2),
    }


def simulate(steps: np.ndarray, key: np.ndarray, width: np.ndarray,
             us_per_tile_step: float) -> dict:
    """Simulated residency and kernel ms of each strategy, and of two
    rounds: the first capped at each cap under the class sort, the
    survivors' remaining steps packed most first."""
    out = {"strategies": {}, "two_round": {}}
    for name, k in strategies(steps, key, width).items():
        tot, ms = residency_ms(steps, k, us_per_tile_step)
        out["strategies"][name] = dict(residency=tot, ms=ms)
    for cap in (8, 12, 16):
        tot_a, ms_a = residency_ms(np.minimum(steps, cap), key, us_per_tile_step)
        rem = np.maximum(steps - cap, 0)
        tot_b, ms_b = residency_ms(rem, -rem, us_per_tile_step)
        out["two_round"][str(cap)] = dict(residency=tot_a + tot_b, ms=ms_a + ms_b)
    return out


def measure(dev, cell: BenchCell, us_per_tile_step: float, strides=(4,),
            reps: int = 1, dump: str = None) -> dict:
    (st, diag), ms, held = cell.timed_render(reps, proxy=False, strides=tuple(strides),
                                             with_diag=True, return_steps=True)
    steps = st.steps.cpu().numpy()
    key = diag["plan_key"].cpu().numpy()
    width = diag["plan_width"].cpu().numpy()
    if dump:
        np.savez(dump, steps=steps, key=key, width=width)
    classes = {}
    for c, name in enumerate(("rim", "interior", "skip")):
        m = key == c
        classes[name] = dict(ray_frac=float(m.mean()), steps=int(steps[m].sum()),
                             mean=float(steps[m].mean()) if m.any() else 0.0)
    w_int, s_int = width[key == 1], steps[key == 1]
    bins = {}
    for lo, hi in ((0, 0.01), (0.01, 0.03), (0.03, 0.1), (0.1, 1e9)):
        m = (w_int >= lo) & (w_int < hi)
        if m.any():
            bins[f"[{lo},{hi})"] = dict(frac=float(m.mean()), mean=float(s_int[m].mean()),
                                        p90=float(np.percentile(s_int[m], 90)),
                                        max=int(s_int[m].max()))
    return dict(
        frames=cell.frames, img=cell.img, strides=list(strides), ms=ms, plain=held,
        us_per_tile_step=us_per_tile_step, fine_ray_steps=int(steps.sum()),
        classes=classes, interior_width=bins, residency=residency(diag),
        coarse_ray_steps={k: summary(v) for k, v in diag.items()
                          if k.endswith("_ray_steps")},
        simulated=simulate(steps, key, width, us_per_tile_step))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--strides", type=int, nargs="*", default=[4])
    ap.add_argument("--us-per-tile-step", type=float, default=None,
                    help="the cost of a tile-step (default: diag_kernel's K1 reading, "
                         "8x512 decoder, F=8, measured now)")
    ap.add_argument("--dump", default=None, help="write steps, key and width to this .npz")
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, args.frames, args.img, args.steps)
    us = args.us_per_tile_step
    if us is None:
        from dist_renderer_tpu_torch.diag import diag_kernel

        us = diag_kernel.us_per_tile_step(diag_kernel.measure(dev, frames=(8,)))
    emit("diag_binning", measure(dev, cell, us, args.strides, dump=args.dump))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
