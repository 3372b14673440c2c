"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the result line.

A run loads and warms up (set-up, timed from the process's start), runs
whole units back to back until ``--seconds`` have passed (it starts no
unit after that), reads the card's memory peak, and then, outside the
window: with ``--trace 1`` reads the device trace and the work the
port's marches report in untimed passes over the same units, and in
every run compares a seeded sample of the window's answers with the
plain reference. The last line on standard output is one JSON object;
the comparison's numbers and limits are the last lines on standard
error and the last key of that object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "port_bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "dist_renderer_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(bench: dict, workload: str, here: str = HERE):
    """(cell, configuration, traffic, limits) of a workload, each found
    by its name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json names "
                         f"{sorted(cells)}")
    cell = cells[workload]
    return (cell, load_json(here, "configs", cell["config"] + ".json"),
            load_json(here, "traffic", cell["traffic"] + ".json"),
            load_json(here, "limits", workload + ".json"))


def cell_metrics(bench: dict, cell: dict, kind: str) -> list:
    """The cell's end-to-end or per-layer metrics: those that list it, or
    list no cells and move (per-layer) or are (end-to-end) a metric the
    cell reports."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str, here: str = HERE):
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        os.path.join(here, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _worse(a: Optional[float], b: float) -> float:
    """The worse of two readings; a reading that is not finite is worst."""
    if a is None or not math.isfinite(b):
        return b
    return a if not math.isfinite(a) or a >= b else b


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, here: str = HERE, root: str = ROOT,
             tweak=None, out=None, err=None) -> dict:
    """Run the cell once on ``device`` and return the result. ``tweak``
    (tests) may change the loaded configuration, traffic and limits."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench import judge
    from port_bench import trace as tr
    from port_bench.context import Context
    from port_bench.drivers import load as load_driver
    from port_bench.drivers import synchronize
    from port_bench.program import Program
    from port_bench.reference.plain import Decoder, no_tf32

    out, err = out or sys.stdout, err or sys.stderr
    cell, cfg, traffic, limits = load_cell(bench, workload, here)
    if tweak is not None:
        tweak(cfg, traffic, limits)
    prog = Program(cfg, root, int(traffic["img"]), device)
    drv = load_driver(traffic["kind"])(prog, traffic, seed, device)
    drv.warm()
    synchronize(device)
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    n, latencies = 0, []
    with record_function(tr.WINDOW):
        t0 = t_end = time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            inputs = drv.unit(n)
            with record_function(drv.span):
                answer = drv.run(inputs)
            t_end = time.perf_counter()
            latencies.append(t_end - ts)
            drv.keep(n, inputs, answer)
            n += 1
            del answer
    e2e = drv.end_to_end(n, t_end - t0, latencies)
    e2e["setup_s"] = setup_s
    mem = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result = {"correct": False, "attempted": drv.answered(n), "failed": 0}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(mem)}
    if trace:
        prof.stop()
        data = tr.from_profiler(prof, {drv.span, "d2h"})
        del prof
        ctx = Context(data, drv.work(n), n, drv.answered(n), tr.source_kernels(
            os.path.join(root, "dist_renderer_tpu_torch", "csrc")))
        metrics = {}
        for m in cell_metrics(bench, cell, "per_layer"):
            v = reader(m["name"], here)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s(data), window_s=ctx.window_s)
        result["breakdown"] = tr.breakdown(data)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, cell, "end_to_end")}

    # the comparison: outside the window, the program's state freed
    samples = list(drv.answers())
    del drv, prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    ref = Decoder(os.path.join(root, cfg["decoder"]["file"]), cfg["decoder"], device)
    worst, bad = {}, 0
    for latent, o, v, answer, label in samples:
        nums = judge.numbers(ref, latent, o, v, answer, limits["reference"])
        if judge.failed(nums, limits["limits"]):
            bad += 1
            print(f"failed: {label}: {json.dumps(nums)}", file=err)
        for k, x in nums.items():
            worst[k] = _worse(worst.get(k), x)
    # a reading that is not finite (or missing) prints as null: it fails
    checks = {k: {"value": worst[k] if math.isfinite(worst.get(k, math.nan)) else None,
                  "limit": lim} for k, lim in limits["limits"].items()}
    result.update(correct=bool(samples) and bad == 0, failed=bad, metrics=metrics,
                  device=dev)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs without JAX", file=err)
        raise SystemExit(3)
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = load_cell(bench, args.workload)[0]
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".port_bench_cache", "triton"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
             torch.device("cuda", 0), t_start)
    return 0
