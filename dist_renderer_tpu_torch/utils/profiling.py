"""Tracing and timing on a CUDA card (the JAX package's
``utils/profiling.py``): the program's spans and counters, a device
trace, a wall-clock timer that waits for the card, the march's live-ray
telemetry as work-efficiency numbers, and the launch-cost timers the
probes (``dist_renderer_tpu_torch.diag``) measure with.

Spans and counters. ``annotate(name)`` is the program's one span: the
render paths open one at each layer boundary (``drt.render``,
``drt.batch``, ``drt.setup``, ``drt.plan.*``, ``drt.fine*``,
``drt.verify*``, ``drt.compose*``, ``drt.finalize*``; every host read of
a device value sits in a ``*.read`` span). ``count(name, n)`` adds a
host integer and ``count_device(name, values)`` the sum of a tensor,
accumulated on the tensor's device; each count is keyed by the innermost
open span, so one counter is split by stage. They record exactly while a
torch.profiler is running. With none, a span is one check and a shared
do-nothing context, and a counter returns at once: no allocation, no
device work, no host read. While one runs, a span is a
``record_function`` range, so ``device_profile``'s Chrome trace shows it
around the kernels it launched, and the recorder keeps (name, start,
end, parent, call) on ``time.time_ns()``, the clock of the profiler's
own events; ``call`` numbers the outermost span (one ``render()`` or
``render_batched_c2f()`` call), which every span inside it shares. A
span reads no device value and never synchronizes; device counters are
read on the host only by ``drain()``, which returns what was recorded
and empties the recorder (at most ``MAX_SPANS`` spans; past that they
are counted as dropped). Inside a CUDA-graph capture (``batched_render
--scan``) the spans and host counts record the capture, not the
replays, and device counters count nothing.

Device time comes from CUDA events (``cuda_ms``, ``graph_us``); the host
cost of a launch from ``time.perf_counter`` around each launch
(``host_us``). A timer that needs the card raises without one: a CPU
time is never reported as the card's.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# whether a torch.profiler (or the autograd profiler) is recording
enabled = torch._C._autograd._profiler_enabled

MAX_SPANS = 1 << 20


class Span(NamedTuple):
    """One recorded span: ``parent`` is the index of the span it opened
    in (-1 for an outermost span), ``call`` the number of its outermost
    span; ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    call: int


class Drained(NamedTuple):
    spans: List[Span]                   # in the order they opened
    counts: Dict[Tuple[str, str], int]  # (counter, innermost span) -> total
    dropped: int                        # spans past MAX_SPANS


class Recorder:
    """The spans and counts of the traced stretch of a process."""

    def __init__(self, cap: int = MAX_SPANS):
        self.cap = cap
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        self.spans: List[list] = []
        self.counts: Dict[Tuple[str, str], int] = {}
        self.device: Dict[Tuple[str, str, torch.device], torch.Tensor] = {}
        self.dropped = 0
        self.calls = 0

    def stack(self) -> list:
        """This thread's open spans, innermost last: (index, record)."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def innermost(self) -> str:
        st = self.stack()
        return st[-1][1][0] if st else ""

    def count(self, name: str, n: int) -> None:
        key = (name, self.innermost())
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + int(n)

    def count_device(self, name: str, values: torch.Tensor) -> None:
        if values.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        key = (name, self.innermost(), values.device)
        with self._lock:
            acc = self.device.get(key)
            if acc is None:
                acc = self.device[key] = torch.zeros(
                    (), dtype=torch.int64, device=values.device)
        acc.add_(values.sum(dtype=torch.int64))

    def drain(self) -> Drained:
        with self._lock:
            spans, counts, device, dropped = (self.spans, dict(self.counts),
                                              self.device, self.dropped)
            self.reset()
        for (name, span, _), acc in device.items():
            counts[(name, span)] = counts.get((name, span), 0) + int(acc)
        return Drained([Span(*r) for r in spans], counts, dropped)


RECORDER = Recorder()


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rf", "rec", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        r = RECORDER
        stack = self.stack = r.stack()
        if self.name.startswith("."):
            self.name = (stack[-1][1][0] if stack else "drt") + self.name
        if stack:
            parent, call = stack[-1][0], stack[-1][1][4]
        else:
            r.calls += 1
            parent, call = -1, r.calls
        self.rec = rec = [self.name, 0, None, parent, call]
        idx = len(r.spans)
        if idx < r.cap:
            r.spans.append(rec)
        else:
            idx = -1
            r.dropped += 1
        stack.append((idx, rec))
        self.rf = torch.profiler.record_function(self.name)
        rec[1] = time.time_ns()
        self.rf.__enter__()

    def __exit__(self, *exc) -> bool:
        self.rf.__exit__(*exc)
        self.rec[2] = time.time_ns()
        self.stack.pop()
        return False


def annotate(name: str):
    """A span (a context manager) named ``name``; a name that starts with
    "." is taken relative to the innermost open span ("drt" outside
    every span): ``annotate(".read")`` inside ``drt.fine`` is
    ``drt.fine.read``. Records only while a profiler runs (see the
    module's docstring)."""
    if not enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add the host integer n to counter ``name`` under the innermost open
    span, while a profiler runs."""
    if enabled():
        RECORDER.count(name, n)


def count_device(name: str, values: torch.Tensor) -> None:
    """Add values.sum() to counter ``name`` under the innermost open span,
    accumulated on values' device (two small launches on a card, no host
    read), while a profiler runs."""
    if enabled():
        RECORDER.count_device(name, values)


def drain() -> Drained:
    """The spans and counts recorded since the last drain (device counters
    read on the host here), and an empty recorder. Call it outside every
    span."""
    return RECORDER.drain()


@contextlib.contextmanager
def device_profile(out_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU activity, and the card's when CUDA is
    present) and write a Chrome trace, ``out_dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def device_kernels(fn: Callable[[], Any], calls: int = 1) -> Tuple[Dict[str, float], float]:
    """``calls`` calls of fn() under torch.profiler (the card's activity
    only): device ms per kernel name and launches, each per call. A
    profiler pass leaves later launches dearer on the host, so time
    nothing after it that the comparison needs."""
    _need_card()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels, launches = {}, 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + t / 1e3 / calls
            launches += ev.count
    return kernels, launches / calls


def _devices(result: Any, found: set) -> set:
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            found.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _devices(v, found)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _devices(v, found)
    return found


def block_until_ready(result: Any) -> Any:
    """Wait until the cards that hold result's tensors have finished
    their queued work (JAX's ``block_until_ready``)."""
    for dev in _devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


class Timer:
    """Wall-clock timing that waits for the card's queued work."""

    def __init__(self):
        self.records: Dict[str, list] = {}

    @contextlib.contextmanager
    def time(self, name: str, result: Any = None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if result is not None:
            block_until_ready(result)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def timeit(self, name: str, fn, *args, warmup: int = 1, iters: int = 5):
        out = None
        for _ in range(warmup):
            out = fn(*args)
        block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        block_until_ready(out)
        self.records.setdefault(name, []).append(
            (time.perf_counter() - t0) / iters
        )
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "mean_ms": float(np.mean(v) * 1e3),
                "min_ms": float(np.min(v) * 1e3),
                "count": len(v),
            }
            for k, v in self.records.items()
        }

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w") as f:
                f.write(s)
        return s


def march_efficiency(trace_result) -> Dict[str, float]:
    """Live-ray telemetry -> work-efficiency stats: the ray-steps the
    march took, the ray-steps of marching every ray that started for as
    many steps as the march ran, and their ratio."""
    live = np.asarray(torch.as_tensor(trace_result.live_counts).cpu())
    live = live[live > 0]
    if live.size == 0:
        return {"ray_steps": 0.0, "naive_ray_steps": 0.0, "savings": 1.0}
    n0 = float(live[0])
    total = float(live.sum())
    naive = n0 * len(live)
    return {
        "ray_steps": total,
        "naive_ray_steps": naive,
        "savings": naive / max(total, 1.0),
        "steps_used": int(len(live)),
    }


# An NVIDIA H100 SXM's published dense peaks (bf16 and int8 tensor
# cores, fp32 CUDA cores; operations a second) and memory rate (bytes a
# second)
PEAK_BF16, PEAK_INT8, PEAK_FP32, PEAK_BYTES = 989e12, 1979e12, 67e12, 3.35e12


def bound_ms(nbytes: float, ops: float = 0.0, peak: float = PEAK_BF16):
    """The least time the card could take for a function's work: (ms,
    "bytes" or "operations"), the larger of the bytes it must move at the
    memory rate and its operations (2 a multiply-add) at ``peak``."""
    t_b, t_o = nbytes / PEAK_BYTES, ops / peak
    return 1e3 * max(t_b, t_o), "operations" if t_o > t_b else "bytes"


def _need_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("this timer measures the CUDA card, and there is none")


def timed(fn: Callable[[], Any]) -> Tuple[Any, float]:
    """fn()'s result and its device time in ms: CUDA events around one
    call."""
    _need_card()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def cuda_ms(fn: Callable[[], Any], reps: int = 3, warmup: int = 1) -> float:
    """Median device time of one fn() in ms: CUDA events around each of
    ``reps`` calls, after ``warmup`` calls."""
    _need_card()
    for _ in range(warmup):
        fn()
    return statistics.median(timed(fn)[1] for _ in range(reps))


def host_us(fn: Callable[[], Any], n: int = 200, warmup: int = 5) -> float:
    """The host's cost of one fn() in us: the median over ``n``
    back-to-back calls of ``time.perf_counter`` around each (what a
    launch costs the caller, not the card). The card is drained before
    the first and after the last."""
    _need_card()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def warm_on_side_stream(fn: Callable[[], Any]) -> None:
    """Run fn() once on a side stream and wait for it: the warm-up a
    capture needs (lazy handles and workspaces made outside the graph)."""
    _need_card()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


def capture(fn: Callable[[], Any], n: int, warm: bool = True,
            keep_graph: bool = False) -> torch.cuda.CUDAGraph:
    """One CUDA graph of ``n`` back-to-back fn() calls, fn warmed up on a
    side stream first unless warm=False (the caller warmed it). With
    keep_graph the graph stays uninstantiated until ``instantiate()`` or
    its first replay, and ``graph_nodes`` can count it. A call that
    cannot be captured raises here."""
    if warm:
        warm_on_side_stream(fn)
    _need_card()
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return graph


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a graph captured with keep_graph=True
    (libcuda's cuGraphGetNodes on its cudaGraph_t)."""
    import ctypes

    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA error {err}")
    return count.value


def graph_us(fn: Callable[[], Any], n: int = 200, reps: int = 3) -> float:
    """Device time of one fn() in us inside a CUDA graph of ``n`` of
    them: the median over ``reps`` timed replays (CUDA events) / n."""
    graph = capture(fn, n)
    return 1e3 * cuda_ms(graph.replay, reps) / n


def per_call_ms(fn: Callable[[], Any], calls: int = 20, reps: int = 3) -> float:
    """Device time of one fn() in ms when issued eagerly: CUDA events
    around ``calls`` back-to-back calls, median of ``reps``, / calls."""
    return cuda_ms(lambda: [fn() for _ in range(calls)], reps) / calls
