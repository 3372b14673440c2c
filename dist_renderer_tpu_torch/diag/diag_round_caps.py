"""The rounds scheduler's step caps on the batched render: the
counterpart of scripts/diag_round_caps.py.

render_batched_c2f of the bench cell (F frames of 512x512, the proxy
unless ``--no-proxy``, strides (16, 4), 50 steps) on the rounds
scheduler, once per schedule of ``round_caps`` (``--caps``, ";" between
schedules). A round caps every live ray at its cap and the survivors
re-pack, so a smaller first cap moves work into the re-packed rounds,
which bin stragglers densely, at the price of one more re-pack sort.

Each schedule's render is timed, held to the same render through the
plain versions, and compared with the first schedule's: rays whose bits
differ, hit agreement and the largest depth difference on common hits.
A round re-seeds its march at the ray's depth, so results are a
function of the caps, in this package as in the JAX package (the
schedule moves where a ray stops inside its convergence ball); hits
must agree on >= CAPS_AGREE of the rays.

    python -m dist_renderer_tpu_torch.diag.diag_round_caps [--frames 8]
        [--caps "4,12;2,12;2,6,18;3,12"] [--no-proxy]
"""

from __future__ import annotations

from dist_renderer_tpu_torch.diag import BenchCell, device, differ, emit, parser

CAPS_AGREE = 0.999


def against_first(first, out) -> dict:
    """How a cap schedule's render differs from the first schedule's: rays
    whose depth, hit or min_sdf bits differ, hit agreement, the largest
    |depth| difference on common hits."""
    both = first.hit & out.hit
    dd = (first.depth - out.depth).abs()[both]
    return dict(rays_differing={k: int(differ(getattr(first, k), getattr(out, k)).sum())
                                for k in ("depth", "hit", "min_sdf")},
                hit_agree=(first.hit == out.hit).float().mean().item(),
                depth_max=dd.max().item() if dd.numel() else 0.0)


def caps_list(spec: str, sep: str):
    return [tuple(int(c) for c in s.split(",")) for s in spec.split(sep) if s]


def sweep(cell: BenchCell, names, schedules, reps: int = 1, exact: bool = False,
          extra=None, **kw) -> list:
    """Render once per cap schedule (given as each of render_batched_c2f's
    arguments ``names``), each timed, held to its plain versions and
    compared with the first schedule's render. ``exact``: the bits must
    be the first's, which alone is held to its plain versions (the plain
    versions give one uninterrupted march's bits whatever the caps too).
    ``extra(out)``: more of a row, from its render."""
    rows, first = [], None
    name = names[0]
    f = kw.get("f", cell.frames)
    for caps in schedules:
        out, ms, held = cell.timed_render(reps, held=first is None or not exact,
                                          **{n: caps for n in names}, **kw)
        row = dict(caps=list(caps), ms=ms, ms_per_frame=ms / f,
                   hits=out.hit.sum().item() / f, plain=held, **(extra(out) if extra else {}))
        if first is None:
            first = out
        else:
            row.update(against_first(first, out))
            if exact and any(row["rays_differing"].values()):
                raise AssertionError(f"{name}={caps} changed the render: "
                                     f"{row['rays_differing']} rays differ from {rows[0]['caps']}")
            if row["hit_agree"] < CAPS_AGREE:
                raise AssertionError(f"{name}={caps}: hits agree with {rows[0]['caps']} on "
                                     f"{row['hit_agree']:.6f} < {CAPS_AGREE}")
        rows.append(row)
    return rows


def measure(dev, cell: BenchCell, caps: str = "4,12;2,12;2,6,18;3,12",
            proxy: bool = True, reps: int = 1) -> dict:
    return dict(frames=cell.frames, proxy=proxy, rows=sweep(
        cell, ("round_caps",), caps_list(caps, ";"), reps, scheduler="rounds", proxy=proxy))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--caps", default="4,12;2,12;2,6,18;3,12")
    ap.add_argument("--no-proxy", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, args.frames, args.img)
    emit("diag_round_caps", measure(dev, cell, args.caps, not args.no_proxy, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
