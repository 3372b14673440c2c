"""The rounds scheduler's difficulty re-pack at each batch size: the
counterpart of scripts/diag_repack_scale.py.

render_batched_c2f of the bench cell (the proxy unless ``--no-proxy``,
strides (16, 4), 50 steps, 512x512) at each F of ``--fs``, with
``difficulty_repack`` off and on (its default is on from F=32, a gate
the JAX package set on the TPU): ms/frame of each and the speedup of the
re-pack. The re-pack only orders the survivors of a round (by the
quantized |last SDF sample|); a ray's rounds and caps stay its own, so
on the card's march kernels the two renders give the same bits, which
is checked. Every render is held to the same render through the plain
versions.

    python -m dist_renderer_tpu_torch.diag.diag_repack_scale [--fs 8,32,64] [--no-proxy]
"""

from __future__ import annotations

from dist_renderer_tpu_torch.diag import BenchCell, device, differ, emit, parser


def measure(dev, cell: BenchCell, fs=(8, 32, 64), proxy: bool = True,
            reps: int = 3) -> dict:
    out = {}
    for f in fs:
        rows = {}
        for rp in (False, True):
            res, ms, held = cell.timed_render(reps, f=f, proxy=proxy, difficulty_repack=rp)
            rows[rp] = (res, dict(ms=ms, ms_per_frame=ms / f,
                                  hits=res.hit.sum().item() / f, plain=held))
        (a, ra), (b, rb) = rows[False], rows[True]
        differing = {k: int(differ(getattr(a, k), getattr(b, k)).sum())
                     for k in ("depth", "hit", "min_sdf")}
        if any(differing.values()):
            raise AssertionError(f"F={f}: difficulty_repack changed the render: "
                                 f"{differing} rays differ")
        out[str(f)] = dict(off=ra, on=rb, speedup=ra["ms"] / rb["ms"],
                           rays_differing=differing)
    return dict(proxy=proxy, frames=out)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--fs", default="8,32,64")
    ap.add_argument("--no-proxy", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    fs = [int(x) for x in args.fs.split(",")]
    cell = BenchCell(dev, max(fs), args.img)
    emit("diag_repack_scale", measure(dev, cell, fs, not args.no_proxy, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
