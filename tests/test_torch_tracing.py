"""The port's spans and counters (utils/profiling.py: annotate, count,
count_device, drain) on its two render paths, and the benchmark's
readers of them (port_bench/spans.py, port_bench/metrics/*): they record
only while a profiler runs, nest as the layers do, share the profiler's
clock, change no bit of a render, and count the marches' ray-steps and
K3's points where the work happens."""

import gc
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import profile
from torch.utils._python_dispatch import TorchDispatchMode

from dist_renderer_tpu_torch.config import GradConfig, MarchConfig, RenderConfig
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
from dist_renderer_tpu_torch.models.pretrain import load_params_npz
from dist_renderer_tpu_torch.models.proxy import load_proxy_npz
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f
from dist_renderer_tpu_torch.ops.renderer import make_march_factory, render
from dist_renderer_tpu_torch.utils import profiling
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32
PATHS = ("proxy", "direct")


@pytest.fixture(scope="module")
def net():
    """The repository's 4x256 proxy as the decoder (and as its own proxy
    on the proxy path), and the fixture's latent."""
    proxy, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"))
    _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    return proxy, pcfg, z0


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.drain()
    yield
    profiling.drain()


def _cfg(**grad_kw):
    return RenderConfig(
        img_h=IMG, img_w=IMG,
        march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                          coarse_to_fine=True, c2f_strides=(16, 4), c2f_coarse_steps=16),
        grad=GradConfig(mode="ift", compact_frac=4, recompute="pallas", **grad_kw),
        compute_dtype="bfloat16", use_pallas=True)


def _cam(dist=-2.5):
    return Camera.looking_at((0.0, 0.0, dist), focal=IMG * 1.2, img_hw=(IMG, IMG))


def serve(net, path, dist=-2.5, **grad_kw):
    """One served frame: render() as the port's server calls it."""
    p, pcfg, z0 = net
    cfg = _cfg(**grad_kw)
    extra = dict(march_params=p, march_dcfg=pcfg) if path == "proxy" else {}
    return render(make_precise_sdf(p, pcfg), z0, _cam(dist), cfg,
                  make_march_factory(p, pcfg, cfg, **extra))


def batch(net, path, frames=2, **kw):
    """render_batched_c2f of ``frames`` views of the fixture."""
    p, pcfg, z0 = net
    cams = [Camera.looking_at((0.6 * i, 0.0, -2.5), focal=IMG * 1.2, img_hw=(IMG, IMG))
            for i in range(frames)]
    rays = [pixel_rays(c, IMG, IMG) for c in cams]
    o = torch.stack([r[0][:1] for r in rays])
    v = torch.stack([r[1] for r in rays])
    if path == "proxy":
        kw = dict(proxy=(p, pcfg), verify_round_caps=(2, 4, 12), **kw)
    return render_batched_c2f(p, pcfg, z0.expand(frames, -1), o, v, (IMG, IMG),
                              _cfg().march, strides=(16, 4), coarse_steps=16,
                              shared_origin=True, **kw)


def traced(fn):
    with profile() as prof:
        out = fn()
    return out, profiling.drain(), prof


def _bits(t):
    if t.is_floating_point():
        return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)
    return t


def _assert_same_bits(a, b):
    fields = a._fields
    for k in fields:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(x, torch.Tensor):
            assert torch.equal(_bits(x), _bits(y)), k
        elif hasattr(x, "_fields"):
            _assert_same_bits(x, y)


class Ops(TorchDispatchMode):
    """Every operator dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_nothing_is_recorded_without_a_profiler(net):
    """A render() and a render_batched_c2f() at 32^2, both paths, record
    no span and no count; the span is the shared do-nothing context."""
    assert not profiling.enabled()
    for path in PATHS:
        serve(net, path)
        batch(net, path)
    d = profiling.drain()
    assert d.spans == [] and d.counts == {} and d.dropped == 0
    assert profiling.annotate("drt.render") is profiling.annotate(".read")


@pytest.mark.parametrize("on", [False, True])
def test_spans_and_counters_launch_nothing_and_read_nothing(on):
    """Off, a span and both counters dispatch no operator. On, a span and a
    host count dispatch only the profiler's range (no device work, no host
    read), and a device count adds on the tensor's device without a host
    read."""
    x = torch.arange(6, dtype=torch.int32)
    with profile() if on else torch.no_grad():
        with Ops() as mode:
            with profiling.annotate("drt.render"):
                with profiling.annotate(".read"):
                    profiling.count("k3_points", 7)
        spans_ops = list(mode.ops)
        with Ops() as mode:
            profiling.count_device("ray_steps", x)
    # the record_function range's own operators are the profiler's, no tensor's
    assert all(op.startswith("profiler._record_function") for op in spans_ops)
    assert (len(spans_ops) > 0) == on
    assert "aten._local_scalar_dense.default" not in mode.ops
    assert (len(mode.ops) > 0) == on
    d = profiling.drain()
    if on:
        assert [s.name for s in d.spans] == ["drt.render", "drt.render.read"]
        assert d.counts == {("k3_points", "drt.render.read"): 7, ("ray_steps", ""): 15}
    else:
        assert d.spans == [] and d.counts == {}


def test_the_recorder_is_bounded():
    rec = profiling.Recorder(cap=3)
    old, profiling.RECORDER = profiling.RECORDER, rec
    try:
        with profile():
            for i in range(5):
                with profiling.annotate(f"drt.s{i}"):
                    profiling.count("n", 1)
        d = profiling.drain()
    finally:
        profiling.RECORDER = old
    assert [s.name for s in d.spans] == ["drt.s0", "drt.s1", "drt.s2"]
    assert d.dropped == 2 and d.counts == {("n", f"drt.s{i}"): 1 for i in range(5)}
    assert [s.call for s in d.spans] == [1, 2, 3]


def _parent_names(d):
    return [(s.name, d.spans[s.parent].name if s.parent >= 0 else None) for s in d.spans]


@pytest.mark.parametrize("path", PATHS)
def test_served_spans_nest_as_the_layers(net, path):
    """Two requests: one call each; every span lies inside its parent; the
    pyramid, fine, verify and compose stages under the batch and the
    render as the table of PERF.md section 3 has them."""
    _, d, _ = traced(lambda: [serve(net, path, dist=-2.5, compact_min=256),
                              serve(net, path, dist=-1.3, compact_min=256)])
    assert {s.call for s in d.spans} == {1, 2}
    for s in d.spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = d.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and p.call == s.call
    pairs = set(_parent_names(d))
    # the second request's hits overflow the compose bucket: its misses
    # take K3's value mode
    want = {("drt.render", None), ("drt.setup", "drt.render"), ("drt.batch", "drt.render"),
            ("drt.setup", "drt.batch"), ("drt.plan.level16", "drt.batch"),
            ("drt.plan.level4", "drt.batch"), ("drt.plan.maps", "drt.batch"),
            ("drt.fine", "drt.batch"), ("drt.compose", "drt.render"),
            ("drt.compose.read", "drt.compose"), ("drt.compose.k3", "drt.compose"),
            ("drt.compose.value", "drt.compose")}
    if path == "proxy":
        want |= {("drt.verify.plan", "drt.batch"), ("drt.verify", "drt.batch"),
                 ("drt.verify.merge", "drt.batch")}
    assert want == pairs


@pytest.mark.parametrize("path", PATHS)
def test_batched_spans_nest_as_the_layers(net, path):
    """render_batched_c2f on the rounds scheduler: one call; each round,
    re-pack and host read under its stage."""
    _, d, _ = traced(lambda: batch(net, path))
    assert {s.call for s in d.spans} == {1}
    pairs = set(_parent_names(d))
    assert ("drt.batch", None) in pairs and ("drt.setup", "drt.batch") in pairs
    stages = ("drt.fine", "drt.verify") if path == "proxy" else ("drt.fine",)
    for st in stages:
        assert {(st, "drt.batch"), (st + ".r0", st), (st + ".repack", st),
                (st + ".read", st)} <= pairs
    assert not any(n.startswith("drt.verify") for n, _ in pairs) or path == "proxy"
    reads = {n for n, _ in pairs if n.endswith(".read")}
    assert reads == {st + ".read" for st in stages}


def _kineto(prof):
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("drt."):
            end = ev.end_ns() if hasattr(ev, "end_ns") else ev.start_ns() + ev.duration_ns()
            out.setdefault(ev.name(), []).append((ev.start_ns(), end))
    return {k: sorted(v) for k, v in out.items()}


def _clock_gaps(fn):
    """(start, end) gaps in ns between each recorder span and the
    profiler's range of the same name, over one traced call of fn."""
    with profile() as prof:
        with torch.profiler.record_function("first"):   # the profile's first range
            pass
        fn()
    d = profiling.drain()
    kin = _kineto(prof)
    mine = {}
    for s in d.spans:
        mine.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    assert set(mine) == set(kin) and len(mine) > 8
    gaps = []
    for name, spans in mine.items():
        assert len(spans) == len(kin[name]), name
        gaps += [(a - ka, b - kb) for (a, b), (ka, kb) in zip(sorted(spans), kin[name])]
    return gaps


@pytest.mark.parametrize("entry", ["serve", "batch"])
def test_spans_share_the_profilers_clock(net, entry):
    """Every recorder span is the profiler's range of the same name within
    50 us at both ends. The stamps sit beside the profiler's own, so a
    pause between the two (the test process descheduled among the
    suite's workers, or its collector) shows as a gap: the collector
    waits, and of three traced calls one must match everywhere, while a
    clock offset would move every span of every call."""
    fn = (lambda: serve(net, "proxy", compact_min=256)) if entry == "serve" else (
        lambda: batch(net, "proxy"))
    fn()
    gc.collect()
    gc.disable()
    try:
        worst = []
        for _ in range(3):
            gaps = _clock_gaps(fn)
            starts = sorted(abs(a) for a, _ in gaps)
            ends = sorted(abs(b) for _, b in gaps)
            assert starts[len(starts) // 2] < 50_000 and ends[len(ends) // 2] < 50_000
            worst.append(max(starts[-1], ends[-1]))
            if worst[-1] < 50_000:
                break
    finally:
        gc.enable()
    assert min(worst) < 50_000, worst


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("entry", ["serve", "batch"])
def test_outputs_are_the_same_bits_traced_or_not(net, entry, path):
    fn = (lambda: serve(net, path, compact_min=256)) if entry == "serve" else (
        lambda: batch(net, path, return_steps=True, return_anchor=True, return_last=True))
    off = fn()
    on, d, _ = traced(fn)
    assert d.spans
    _assert_same_bits(off, on)


def _steps(counts, pick=lambda span: True):
    return sum(n for (c, s), n in counts.items() if c == "ray_steps" and pick(s))


@pytest.mark.parametrize("scheduler", ["rounds", "queue"])
@pytest.mark.parametrize("path", PATHS)
def test_ray_steps_are_the_marches_steps(net, path, scheduler):
    """ray_steps under drt.plan.* is with_diag's coarse ray-steps; all of
    it is that plus the returned per-ray steps (fine, and verify on the
    proxy path); the rays counter is frames x pixels."""
    (st, diag), d, _ = traced(lambda: batch(net, path, with_diag=True, return_steps=True,
                                            scheduler=scheduler))
    coarse = sum(int(t.sum()) for k, t in diag.items()
                 if k.startswith("coarse") and k.endswith("_ray_steps"))
    assert coarse > 0
    assert _steps(d.counts, lambda s: s.startswith("drt.plan.")) == coarse
    assert _steps(d.counts) == coarse + int(st.steps.sum())
    fine = _steps(d.counts, lambda s: s.startswith("drt.fine"))
    verify = _steps(d.counts, lambda s: s.startswith("drt.verify"))
    assert fine > 0 and (verify > 0) == (path == "proxy")
    assert d.counts[("rays", "drt.batch")] == 2 * IMG * IMG


@pytest.mark.parametrize("dist, fits", [(-2.5, True), (-1.3, False)])
def test_k3_points_are_the_compose_width(net, dist, fits):
    """k3_points is the n/4 bucket where the frame's hits fit it, else
    the hits, counted under drt.compose.k3; the misses of an overflowed
    bucket are k3_value_points, under drt.compose.value."""
    out, d, _ = traced(lambda: serve(net, "proxy", dist=dist, compact_min=256))
    n = IMG * IMG
    bucket = min(((n // 4 + 511) // 512) * 512, n)
    hits = int(out.trace.hit.sum())
    assert (hits <= bucket) == fits
    k3 = {("k3_points", "drt.compose.k3"): bucket} if fits else {
        ("k3_points", "drt.compose.k3"): hits,
        ("k3_value_points", "drt.compose.value"): n - hits}
    assert d.counts == {**{k: v for k, v in d.counts.items()
                           if not k[0].startswith("k3_")}, **k3}


def test_the_value_mode_is_recorded_only_under_a_profiler(net):
    """An overflowed request records k3_value_points and the
    drt.compose.value span under the profiler, and nothing without one;
    the render's bits are the same either way."""
    out, d, _ = traced(lambda: serve(net, "proxy", dist=-1.3, compact_min=256))
    n, hits = IMG * IMG, int(out.trace.hit.sum())
    assert d.counts[("k3_value_points", "drt.compose.value")] == n - hits > 0
    assert [s.name for s in d.spans].count("drt.compose.value") == 1
    off = serve(net, "proxy", dist=-1.3, compact_min=256)
    d_off = profiling.drain()
    assert d_off.spans == [] and d_off.counts == {}
    _assert_same_bits(out, off)


# -- the benchmark's readers ------------------------------------------------

def _ctx(spans_s, ops, answered=2, window=(0.0, 1.0)):
    from port_bench import trace as tr
    from port_bench.context import Context

    return Context(tr.TraceData(window, ops, spans_s), {}, answered, answered, [])


def _drained(spans, counts=None):
    """A Drained of (name, start s, end s, parent) spans."""
    return profiling.Drained(
        [profiling.Span(n, round(a * 1e9), round(b * 1e9), p, 1) for n, a, b, p in spans],
        counts or {}, 0)


def _reader(name):
    from port_bench import harness

    return harness.reader(name)


NEW = ("host_plan_ms.frame", "idle_plan_ms.frame", "idle_march_ms.frame",
       "idle_compose_ms.frame", "compose_points.frame", "idle_read_ms.batch",
       "steps_per_ray.batch")


def test_idle_gaps_go_to_the_innermost_span(monkeypatch):
    """Gaps are put down to the innermost span open at their start, the
    program's or the benchmark's; together they are the window's idle."""
    from port_bench import spans, trace as tr

    prog = [("drt.render", 0.10, 0.60, -1), ("drt.setup", 0.10, 0.15, 0),
            ("drt.plan.level16", 0.15, 0.25, 0), ("drt.fine", 0.25, 0.40, 0),
            ("drt.fine.read", 0.295, 0.32, 3), ("drt.compose", 0.40, 0.60, 0),
            ("drt.compose.read", 0.445, 0.47, 5)]
    monkeypatch.setattr(profiling, "drain", lambda: _drained(
        prog, {("k3_points", "drt.compose.k3"): 65536 * 2, ("ray_steps", "drt.fine"): 9,
               ("rays", "drt.batch"): 3}))
    bench = [("render", 0.05, 0.62), ("d2h", 0.62, 0.70)]
    # the gaps: render 0.05-0.08, setup 0.12-0.14, level 0.20-0.22, fine.read
    # 0.30-0.31, compose.read 0.45-0.46, d2h 0.65-0.70, harness 0.90-1.00
    busy = [(0.0, 0.05), (0.08, 0.12), (0.14, 0.20), (0.22, 0.30), (0.31, 0.45),
            (0.46, 0.65), (0.70, 0.90)]
    ctx = _ctx(bench, [("k", a, b) for a, b in busy])
    by = spans.idle_by_span(ctx)
    want = {tr.HOST: 0.10, "render": 0.03, "drt.setup": 0.02, "drt.plan.level16": 0.02,
            "drt.fine.read": 0.01, "drt.compose.read": 0.01, "d2h": 0.05}
    assert set(by) == set(want)
    for k, v in want.items():
        assert by[k] == pytest.approx(v, abs=1e-9), k
    assert sum(by.values()) == pytest.approx(ctx.window_s - tr.busy_s(ctx.trace))
    got = {n: _reader(n)(ctx) for n in NEW}
    assert got["idle_plan_ms.frame"] == pytest.approx(1e3 * 0.04 / 2)
    assert got["idle_march_ms.frame"] == pytest.approx(1e3 * 0.01 / 2)
    assert got["idle_compose_ms.frame"] == pytest.approx(1e3 * 0.01 / 2)
    assert got["idle_read_ms.batch"] == pytest.approx(1e3 * 0.02 / 2)
    assert got["host_plan_ms.frame"] == pytest.approx(1e3 * 0.15 / 2)
    assert got["compose_points.frame"] == pytest.approx(65.536)
    assert got["steps_per_ray.batch"] == pytest.approx(3.0)


def test_spans_outside_the_window_are_clipped(monkeypatch):
    from port_bench import spans

    monkeypatch.setattr(profiling, "drain", lambda: _drained(
        [("drt.setup", 0.5, 1.5, -1), ("drt.plan.maps", 1.6, 1.7, -1)]))
    ctx = _ctx([], [("k", 0.0, 0.2)])
    assert _reader("host_plan_ms.frame")(ctx) == pytest.approx(1e3 * 0.5 / 2)
    assert spans.recorded(ctx).spans == [("drt.setup", 0.5, 1.0)]


def test_the_recorder_is_drained_once_a_run(monkeypatch):
    from port_bench import spans

    calls = []

    def drain():
        calls.append(1)
        return _drained([("drt.setup", 0.1, 0.2, -1)])

    monkeypatch.setattr(profiling, "drain", drain)
    ctx = _ctx([], [("k", 0.0, 0.05)])
    for n in NEW:
        _reader(n)(ctx)
    assert len(calls) == 1
    _reader("host_plan_ms.frame")(_ctx([], []))
    assert len(calls) == 2


@pytest.mark.parametrize("case", ["no_recorder", "nothing_recorded", "no_device"])
def test_readers_find_nothing_to_read(monkeypatch, case):
    """A program without the recorder (the benchmark's parent commit), or
    one that recorded nothing, gives every new reader None; without device
    operations (a CPU run) the gap readers give None and the others read."""
    if case == "no_recorder":
        monkeypatch.delattr(profiling, "drain")
    elif case == "nothing_recorded":
        monkeypatch.setattr(profiling, "drain", lambda: _drained([]))
    else:
        monkeypatch.setattr(profiling, "drain", lambda: _drained(
            [("drt.setup", 0.1, 0.2, -1)], {("k3_points", "drt.compose.k3"): 2048,
                                            ("ray_steps", "drt.fine.r0"): 10,
                                            ("rays", "drt.batch"): 5}))
    got = {n: _reader(n)(_ctx([], [] if case == "no_device" else [("k", 0.0, 0.5)]))
           for n in NEW}
    if case != "no_device":
        assert got == {n: None for n in NEW}
    else:
        assert {n for n, v in got.items() if v is None} == {
            "idle_plan_ms.frame", "idle_march_ms.frame", "idle_compose_ms.frame",
            "idle_read_ms.batch"}
        assert got["steps_per_ray.batch"] == 2.0


@pytest.mark.parametrize("case", ["split", "no_split", "parent", "nothing_recorded"])
def test_compose_value_points_reads_the_value_modes_rows(monkeypatch, case):
    """compose_value_points.frame: k3_value_points per request / 1000;
    None where no request split (a fitting bucket, or the full width of a
    program without the value mode) or nothing was recorded."""
    counts = {"split": {("k3_points", "drt.compose.k3"): 80_000,
                        ("k3_value_points", "drt.compose.value"): 182_144},
              "no_split": {("k3_points", "drt.compose.k3"): 131_072},
              "parent": {("k3_points", "drt.compose.k3"): 524_288},
              "nothing_recorded": {}}[case]
    monkeypatch.setattr(profiling, "drain", lambda: _drained(
        [("drt.compose", 0.1, 0.2, -1)], counts))
    got = _reader("compose_value_points.frame")(_ctx([], [("k", 0.0, 0.5)]))
    assert got == (pytest.approx(182.144 / 2) if case == "split" else None)


CELL_RUN = """
import json, sys
sys.path[0:0] = [{root!r}, {tests!r}]
import torch
torch.set_num_threads(2)
from helpers import run_cpu
r = run_cpu({cell!r}, trace=True)
print(json.dumps({{"correct": r["correct"], "metrics": r["metrics"]}}))
"""


@pytest.mark.parametrize("cell", ["proxy.frame", "proxy.batch64", "direct.batch64"])
def test_a_traced_cpu_run_reads_the_counters(cell):
    """--trace 1 of each cell on the CPU at 32^2 (in a process without
    JAX, as the benchmark runs): the counter readers and the planning
    spans' host time read; the device-gap readers find no device."""
    code = CELL_RUN.format(root=ROOT, tests=os.path.join(ROOT, "port_bench", "tests"),
                           cell=cell)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"]
    if cell == "proxy.frame":
        assert m["compose_points.frame"] == pytest.approx(1.024)   # 32^2: no bucket
        assert "compose_value_points.frame" not in m            # no split
        assert m["host_plan_ms.frame"] > 0
        assert not {"idle_plan_ms.frame", "idle_march_ms.frame",
                    "idle_compose_ms.frame"} & set(m)
    else:
        assert 1.0 < m["steps_per_ray.batch"] < 50.0
        assert "idle_read_ms.batch" not in m


@pytest.mark.parametrize("cell", ["proxy.batch64", "direct.batch64"])
def test_steps_per_ray_is_the_replays_count(cell):
    """The counters of a traced batch equal the ray-steps the benchmark's
    untimed replays count for the same unit (Program.batch_work)."""
    sys.path.insert(0, os.path.join(ROOT, "port_bench", "tests"))
    from helpers import tiny

    from port_bench import harness
    from port_bench.drivers import load as load_driver
    from port_bench.program import Program

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    _, cfg, traffic, limits = harness.load_cell(bench, cell)
    tiny(cfg, traffic, limits)
    dev = torch.device("cpu")
    prog = Program(cfg, ROOT, int(traffic["img"]), dev)
    drv = load_driver(traffic["kind"])(prog, traffic, 2147483659, dev)
    inputs = drv.unit(0)
    _, d, _ = traced(lambda: drv.run(inputs))
    work = prog.batch_work(*inputs)
    assert _steps(d.counts) == work["coarse"] + work["fine"] + work["verify"]
    assert _steps(d.counts, lambda s: s.startswith("drt.plan.")) == work["coarse"]
    assert _steps(d.counts, lambda s: s.startswith("drt.verify")) == work["verify"]
