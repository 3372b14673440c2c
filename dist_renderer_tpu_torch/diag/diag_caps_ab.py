"""The work queue's generation caps through the whole single-frame
render: the counterpart of scripts/diag_caps_ab.py.

``render()`` of the bench latent (the 8x512 decoder without its proxy,
512x512, 50 steps, strides (16, 4), bench.py's IFT gradient config) on
the trace_frame path, whose fine march is the work queue (K2) at F=1
with ``MarchConfig.queue_caps``: the production boundary, where
diag_queue sweeps render_batched_c2f's own default. Each schedule's
forward (depth, min_sdf, mask) is timed (the least of 3 means of
``--calls`` renders). K2's generations carry each ray's march whole,
so the caps are pure scheduling: every schedule's depth, min_sdf,
normal and mask must equal the first's bit for bit, and the first's the
same render through the plain versions with the in-order product.

    python -m dist_renderer_tpu_torch.diag.diag_caps_ab [--img 512]
        [--caps "1,2,6,16;1,2,4,12;4,12;1,4,12"]
"""

from __future__ import annotations

from dist_renderer_tpu_torch.diag import (
    RENDER_FIELDS, BenchCell, device, differ, emit, parser,
)
from dist_renderer_tpu_torch.diag.diag_round_caps import caps_list
from dist_renderer_tpu_torch.utils.profiling import timed


def measure(dev, cell: BenchCell, caps: str = "1,2,6,16;1,2,4,12;4,12;1,4,12",
            calls: int = 8, reps: int = 3) -> dict:
    from dist_renderer_tpu_torch.config import GradConfig

    sdf_fn = cell.sdf()
    rows, first = [], None
    for qc in caps_list(caps, ";"):
        cfg = cell.frame_cfg(GradConfig(mode="ift", compact_frac=4, recompute="pallas"),
                             queue_caps=qc)
        fwd = cell.frame_fns(cfg, cell.factory(cfg), sdf_fn)[0]
        out = fwd()
        t = min(timed(lambda: [fwd() for _ in range(calls)])[1] for _ in range(reps)) / calls
        row = dict(caps=list(qc), fwd_ms=t, hits=int(out.mask.sum()))
        if first is None:
            # the later schedules are held to this one's bits
            row["plain"] = cell.hold_frame(f"render() queue_caps={qc}", cfg, out)
            first = out
        else:
            row["rays_differing"] = {k: int(differ(getattr(first, k), getattr(out, k)).sum())
                                     for k in RENDER_FIELDS}
            if any(row["rays_differing"].values()):
                raise AssertionError(f"queue_caps={qc} changed the render: "
                                     f"{row['rays_differing']} pixels differ from "
                                     f"{rows[0]['caps']}")
        rows.append(row)
    return dict(img=cell.img, calls=calls, rows=rows)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--caps", default="1,2,6,16;1,2,4,12;4,12;1,4,12")
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, 1, args.img)
    emit("diag_caps_ab", measure(dev, cell, args.caps, args.calls, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
