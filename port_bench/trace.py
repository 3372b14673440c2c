"""The device trace of a window, read from torch.profiler: device
operations and the benchmark's own spans on one clock, the busy time
(the union of the operations' intervals), the idle gaps named by the
span the host was in, and the kernels built from the port's CUDA
sources, by name."""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Iterable, List, NamedTuple, Tuple

Interval = Tuple[str, float, float]     # (name, start s, end s)
WINDOW = "window"                       # the span around the measured window
HOST = "harness"                        # a gap outside every call into the port


class TraceData(NamedTuple):
    window: Tuple[float, float]
    ops: List[Interval]                 # device operations (kernels, copies, sets)
    spans: List[Interval]               # the benchmark's spans


def _ns(ev, which: str) -> float:
    if which == "end" and not hasattr(ev, "end_ns"):
        return ev.start_ns() + ev.duration_ns()
    return getattr(ev, f"{which}_ns")()


def from_profiler(prof, span_names: Iterable[str]) -> TraceData:
    """The trace of a torch.profiler run whose window sits in a span
    named WINDOW."""
    names = set(span_names) | {WINDOW}
    ops, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        on_device = "CUDA" in str(ev.device_type())
        item = (name, _ns(ev, "start") * 1e-9, _ns(ev, "end") * 1e-9)
        if on_device:
            if name not in names and not ev.is_user_annotation():
                ops.append(item)
        elif name in names:
            spans.append(item)
    win = [s for s in spans if s[0] == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window span")
    return TraceData((win[0][1], win[0][2]), ops, [s for s in spans if s[0] != WINDOW])


def busy_intervals(trace: TraceData) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals inside the window."""
    lo, hi = trace.window
    out: List[List[float]] = []
    for _, a, b in sorted(trace.ops, key=lambda x: x[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: TraceData) -> float:
    return sum(b - a for a, b in busy_intervals(trace))


def idle_gaps(trace: TraceData) -> List[Interval]:
    """The window's idle gaps, each named by the innermost span the host
    was in at the gap's start (HOST outside every span)."""
    lo, hi = trace.window
    gaps, t = [], lo
    for a, b in busy_intervals(trace) + [(hi, hi)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    named = []
    for a, b in gaps:
        inside = [s for s in trace.spans if s[1] <= a < s[2]]
        name = min(inside, key=lambda s: s[2] - s[1])[0] if inside else HOST
        named.append((name, a, b))
    return named


def op_seconds(trace: TraceData) -> Dict[str, float]:
    """Device seconds by operation name, inside the window."""
    lo, hi = trace.window
    out: Dict[str, float] = {}
    for name, a, b in trace.ops:
        d = min(b, hi) - max(a, lo)
        if d > 0:
            out[name] = out.get(name, 0.0) + d
    return out


def breakdown(trace: TraceData, top: int = 10) -> dict:
    ops = sorted(op_seconds(trace).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: -(g[2] - g[1]))[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, b - a] for n, a, b in gaps]}


_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?(\w+)\s*\(")


def source_kernels(csrc: str) -> List[str]:
    """The names of the __global__ functions in a directory of CUDA sources."""
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")) + glob.glob(os.path.join(csrc, "*.cuh")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return sorted(names)


def is_source_kernel(op: str, kernels: Iterable[str]) -> bool:
    """Whether a device operation is one of these kernels (by its name, a
    plain or demangled C++ name with namespaces and template arguments)."""
    return any(re.search(rf"(?:^|[\s:]){re.escape(k)}\b", op) for k in kernels)
