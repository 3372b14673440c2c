"""The work-queue fine march against the rounds scheduler: the
counterpart of scripts/diag_queue.py.

render_batched_c2f of the bench cell's 8x512 decoder without its proxy
(strides (16, 4), 50 steps, 512x512) at F=1 and F=8: the rounds
scheduler, then the work queue (K2) at each generation-cap schedule of
``--caps``: ms, Mrays/s, hit agreement with the rounds render and the
p95 depth difference on common hits. K2's generations carry each ray's
march whole, so every cap schedule gives one uninterrupted march's bits
(tests/test_torch_queue.py's contract): each is checked equal to the
first schedule's. Every render is held to the same render through the
plain versions.

    python -m dist_renderer_tpu_torch.diag.diag_queue [--frames 1 8]
        [--caps "6,16;4,12;8;6,16,32"]
"""

from __future__ import annotations

from dist_renderer_tpu_torch.diag import BenchCell, device, emit, parser
from dist_renderer_tpu_torch.diag.diag_round_caps import caps_list, sweep


def measure(dev, cell: BenchCell, frames=(1, 8), caps: str = "6,16;4,12;8;6,16,32",
            reps: int = 1) -> dict:
    out = {}
    n = cell.img * cell.img
    for f in frames:
        rounds, ms, held = cell.timed_render(reps, f=f, proxy=False, scheduler="rounds")

        def against_rounds(q):
            d = (q.depth - rounds.depth).abs()[q.hit & rounds.hit].sort().values
            return dict(rounds_hit_agree=(q.hit == rounds.hit).float().mean().item(),
                        rounds_depth_p95=d[int(0.95 * (d.numel() - 1))].item()
                        if d.numel() else 0.0)

        rows = sweep(cell, ("queue_caps",), caps_list(caps, ";"), reps, exact=True,
                     extra=against_rounds, f=f, proxy=False, scheduler="queue")
        for r in rows:
            r["mrays_s"] = f * n / r["ms"] / 1e3
        out[str(f)] = dict(rounds=dict(ms=ms, mrays_s=f * n / ms / 1e3,
                                       hits=rounds.hit.sum().item(), plain=held),
                           queue=rows)
    return out


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--frames", type=int, nargs="*", default=[1, 8])
    ap.add_argument("--caps", default="6,16;4,12;8;6,16,32")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, max(args.frames), args.img)
    emit("diag_queue", measure(dev, cell, args.frames, args.caps, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
