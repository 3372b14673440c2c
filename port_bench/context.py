"""What a per-layer metric's reader (``metrics/<name>.py``, ``read(ctx)
-> float | None``) reads: the traced window's device trace, the work the
port's marches report for the window's units, and the window's counts.
A reader returns None where it finds nothing to read."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

from port_bench import trace as tr
from port_bench.work import PEAK_BF16, bound_s


class Context(NamedTuple):
    trace: tr.TraceData
    work: Dict[str, float]          # FLOPs by stage and by kernel (K1, K2), "all"
    units: int                      # units the window completed
    answered: int                   # answers: frames or requests
    source_kernels: List[str]       # __global__ names of the port's CUDA sources

    @property
    def window_s(self) -> float:
        return self.trace.window[1] - self.trace.window[0]

    def seconds(self, kernel_name_part: str) -> float:
        """Device seconds of the operations whose name holds this part."""
        return sum(s for n, s in tr.op_seconds(self.trace).items() if kernel_name_part in n)


def idle_pct(ctx: Context) -> Optional[float]:
    if ctx.window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s(ctx.trace) / ctx.window_s)


def mfu_pct(ctx: Context) -> Optional[float]:
    if not ctx.work.get("all") or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.work["all"] / (ctx.window_s * PEAK_BF16)


def roofline_pct(ctx: Context, work_key: str, kernel_name_part: str) -> Optional[float]:
    """The kernel's least time for its counted work (bf16 tensor-core
    peak; its bytes' bound, rays in and answers out, is ~0.1% of that) over
    its device time."""
    t = ctx.seconds(kernel_name_part)
    if t <= 0 or not ctx.work.get(work_key):
        return None
    return 100.0 * bound_s(ctx.work[work_key]) / t


def glue_ms_per_answer(ctx: Context) -> Optional[float]:
    """Device ms per answer of the operations not built from the port's
    CUDA sources (sorts, gathers, merges, copies, library kernels)."""
    if not ctx.answered or not ctx.trace.ops:
        return None
    s = sum(t for n, t in tr.op_seconds(ctx.trace).items()
            if not tr.is_source_kernel(n, ctx.source_kernels))
    return 1e3 * s / ctx.answered
