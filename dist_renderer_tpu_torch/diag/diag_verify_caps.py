"""The verify stage's cap schedule: the counterpart of
scripts/diag_verify_caps.py.

render_batched_c2f of the bench cell (F frames of 512x512, the proxy,
strides (16, 4), 50 steps, verify_mode "march") once per
``verify_round_caps`` schedule (``--caps``, "|" between schedules; the
same schedule is the queue's ``verify_gen_caps``), crossed with
``--backoffs`` (default: the proxy's measured backoff). Seeded proxy
hits converge in 2-3 full-decoder steps while band and unresolved rays
march long, so the verify stage's best schedule is not the main march's.

Each render is timed, held to the same render through the plain versions
and compared with the first schedule's at its backoff (rays whose bits
differ, hit agreement, largest depth difference). On the rounds
scheduler a schedule moves where a ray stops inside its convergence
ball (results are a function of the caps, as in the JAX package); hits
must agree on >= 0.999 of the rays. On the work queue (K2) results are
one uninterrupted march's whatever the caps: the bits must be equal.

    python -m dist_renderer_tpu_torch.diag.diag_verify_caps [--frames 8]
        [--caps "4,12|2,6,16|2,4,12|3,8,24"] [--backoffs 0.0,0.01]
        [--scheduler rounds] [--queue-caps 2,6,16]
"""

from __future__ import annotations

from dist_renderer_tpu_torch.diag import BenchCell, device, emit, parser
from dist_renderer_tpu_torch.diag.diag_round_caps import caps_list, sweep


def measure(dev, cell: BenchCell, caps: str = "4,12|2,6,16|2,4,12|3,8,24",
            backoffs=None, scheduler: str = "rounds", queue_caps=None,
            reps: int = 1) -> dict:
    schedules = caps_list(caps, "|")
    kw = dict(verify_mode="march", scheduler=scheduler)
    if queue_caps:
        kw["queue_caps"] = tuple(int(c) for c in queue_caps.split(","))
    # the queue's bits are one uninterrupted march's whatever the caps
    exact = scheduler == "queue" or (scheduler == "auto" and cell.frames == 1)
    rows = {}
    for bo in backoffs or [cell.backoff]:
        rows[f"{bo:.6g}"] = sweep(cell, ("verify_round_caps", "verify_gen_caps"),
                                  schedules, reps, exact, proxy_backoff=bo, **kw)
    return dict(frames=cell.frames, scheduler=scheduler, exact=exact,
                queue_caps=kw.get("queue_caps"), rows=rows)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--caps", default="4,12|2,6,16|2,4,12|3,8,24")
    ap.add_argument("--backoffs", default=None,
                    help="comma list of proxy_backoff values crossed with --caps")
    ap.add_argument("--scheduler", default="rounds", choices=["rounds", "queue", "auto"])
    ap.add_argument("--queue-caps", default=None,
                    help="the proxy stage's queue_caps, e.g. 2,6,16")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, args.frames, args.img)
    backoffs = [float(b) for b in args.backoffs.split(",")] if args.backoffs else None
    emit("diag_verify_caps", measure(dev, cell, args.caps, backoffs, args.scheduler,
                                     args.queue_caps, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
