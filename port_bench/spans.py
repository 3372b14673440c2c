"""The port's own spans and counters (``dist_renderer_tpu_torch.utils.
profiling``: ``annotate``, ``count``, ``count_device``, ``drain``), read
after a traced window: the program's spans clipped to the window, on the
device trace's clock (the recorder stamps ``time.time_ns()``, the clock
of the profiler's events); each idle gap of the device put down to the
innermost span open at its start, the program's or the benchmark's own
(its span around each call, ``d2h``; ``trace.HOST`` outside all); and
the counters, each keyed by the span it was counted in.

The recorder is drained once a run, by the first reader that asks. A
program that records nothing (one older than its recorder) gives None,
and so does every reader built on it.

    python3 -m port_bench.spans --workload proxy.frame --seed 7 --seconds 20

runs the cell traced and prints its device-idle ms per answer by
innermost span, the spans' host ms per answer, and the counters.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from port_bench import trace as tr

Pick = Callable[[str], bool]


def plan(name: str) -> bool:
    """Set-up and c2f planning: rays, latent folds, the pyramid, the maps."""
    return name.startswith(("drt.setup", "drt.plan."))


def march(name: str) -> bool:
    """The fine schedulers: the fine and verify stages."""
    return name.startswith(("drt.fine", "drt.verify"))


def compose(name: str) -> bool:
    return name.startswith(("drt.compose", "drt.finalize"))


def read(name: str) -> bool:
    """The host's reads of device values."""
    return name.startswith("drt.") and name.endswith(".read")


class Recorded(NamedTuple):
    spans: List[tr.Interval]             # the program's, clipped to the window
    counts: Dict[Tuple[str, str], int]   # (counter, span) -> total
    dropped: int


_last: Optional[tuple] = None   # (the TraceData drained for, its Recorded)


def recorded(ctx) -> Optional[Recorded]:
    """What the program recorded in the traced run ``ctx`` describes."""
    global _last
    if _last is not None and _last[0] is ctx.trace:
        return _last[1]
    rec = None
    try:
        from dist_renderer_tpu_torch.utils import profiling
    except ImportError:
        profiling = None
    drain = getattr(profiling, "drain", None)
    if drain is not None:
        d = drain()
        lo, hi = ctx.trace.window
        spans = []
        for s in d.spans:
            if s.end_ns is None:
                continue
            a, b = max(s.start_ns * 1e-9, lo), min(s.end_ns * 1e-9, hi)
            if b > a:
                spans.append((s.name, a, b))
        if d.spans or d.counts:
            rec = Recorded(spans, dict(d.counts), d.dropped)
    _last = (ctx.trace, rec)
    return rec


def counter(ctx, name: str) -> Optional[int]:
    """Counter ``name`` summed over every span; None where it was never
    counted."""
    rec = recorded(ctx)
    found = [] if rec is None else [n for (c, _), n in rec.counts.items() if c == name]
    return sum(found) if found else None


def _union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def host_ms(ctx, pick: Pick) -> Optional[float]:
    """Host ms per answer inside the program's spans that ``pick`` names
    (the union of their intervals)."""
    rec = recorded(ctx)
    if rec is None or not ctx.answered:
        return None
    return 1e3 * _union_s((a, b) for n, a, b in rec.spans if pick(n)) / ctx.answered


def innermost(spans: List[tr.Interval]) -> Tuple[List[float], List[str]]:
    """The innermost span at each moment: (times, names), names[i] open
    from times[i] to times[i + 1] (a span holds [start, end); the innermost
    is the latest to open, the shortest at a tie)."""
    events = sorted([(a, 1, i) for i, (_, a, _) in enumerate(spans)]
                    + [(b, 0, i) for i, (_, _, b) in enumerate(spans)])
    live: Dict[int, tuple] = {}
    times, names = [], []
    for t, opens, i in events:
        if opens:
            live[i] = (spans[i][1], spans[i][1] - spans[i][2])
        else:
            live.pop(i, None)
        inner = max(live, key=live.get) if live else None
        times.append(t)
        names.append(tr.HOST if inner is None else spans[inner][0])
    return times, names


def idle_by_span(ctx) -> Optional[Dict[str, float]]:
    """Device-idle seconds of the window by the innermost span open at
    each gap's start; None without device operations or program spans."""
    rec = recorded(ctx)
    if rec is None or not rec.spans or not ctx.trace.ops or ctx.window_s <= 0:
        return None
    times, names = innermost(rec.spans + list(ctx.trace.spans))
    lo, hi = ctx.trace.window
    out: Dict[str, float] = {}
    t = lo
    for a, b in tr.busy_intervals(ctx.trace) + [(hi, hi)]:
        if a > t:
            i = bisect.bisect_right(times, t) - 1
            name = names[i] if i >= 0 else tr.HOST
            out[name] = out.get(name, 0.0) + (a - t)
        t = max(t, b)
    return out


def idle_ms(ctx, pick: Pick) -> Optional[float]:
    """Device-idle ms per answer of the gaps that begin in a span that
    ``pick`` names."""
    by = idle_by_span(ctx)
    if by is None or not ctx.answered:
        return None
    return 1e3 * sum(s for n, s in by.items() if pick(n)) / ctx.answered


def report(workload: str, seed: int, seconds: float, device, tweak=None) -> dict:
    """Run a cell traced on ``device``: its result, and its idle and host
    time per answer by span and its counters."""
    import io

    from port_bench import harness, spans
    from port_bench.context import Context

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    result = harness.run_cell(bench, workload, seed, seconds, True, device,
                              time.perf_counter(), tweak=tweak, out=io.StringIO())
    # the readers drained the recorder through this module's importable
    # name, which "python -m" does not give this copy of it
    data, rec = spans._last or (None, None)
    if rec is None:
        raise RuntimeError("the program recorded no spans")
    n = result["attempted"]
    idle = spans.idle_by_span(Context(data, {}, 0, n, [])) or {}
    host: Dict[str, list] = {}
    for name, a, b in rec.spans:
        host.setdefault(name, []).append((a, b))
    per = lambda s: round(1e3 * s / max(n, 1), 4)
    return {
        "workload": workload, "seed": seed, "answers": n,
        "window_s": data.window[1] - data.window[0], "idle_s": sum(idle.values()),
        "idle_ms_per_answer": {k: per(v) for k, v in
                               sorted(idle.items(), key=lambda kv: -kv[1])},
        "host_ms_per_answer": {k: per(_union_s(v)) for k, v in sorted(host.items())},
        "counts": {f"{c}@{s}": v for (c, s), v in sorted(rec.counts.items())},
        "dropped": rec.dropped, "result": result}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="python3 -m port_bench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.spans measures the CUDA card, and there is none", file=sys.stderr)
        return 2
    print(json.dumps(report(args.workload, args.seed, args.seconds,
                            torch.device("cuda", 0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
