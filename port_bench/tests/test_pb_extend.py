"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and new BENCHMARK.json entries, and edits
no file that is there: the harness lists, loads and runs them."""

import hashlib
import json
import os
import shutil

from helpers import ROOT, run_cpu, tiny
from port_bench import harness


def _digests(folder):
    out = {}
    for dirpath, dirs, files in os.walk(folder):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, folder)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_files_and_entries_are_enough(tmp_path):
    here = tmp_path / "port_bench"
    shutil.copytree(os.path.join(ROOT, "port_bench"), here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    before = _digests(here)

    # a configuration: the 8x512 decoder with another march budget
    cfg = harness.load_json(here, "configs", "deepsdf8x512.json")
    cfg.update(name="deepsdf8x512-steps64")
    cfg["march"]["max_steps"] = 64
    (here / "configs" / "deepsdf8x512-steps64.json").write_text(json.dumps(cfg))
    # a traffic mix: smaller batches from closer cameras
    mix = harness.load_json(here, "traffic", "batch64.json")
    mix.update(latents_per_unit=2, views_per_unit=4, distance=[2.2, 2.4])
    (here / "traffic" / "batch8close.json").write_text(json.dumps(mix))
    # the cell's limits and a per-layer metric with its reader
    (here / "limits" / "direct.batch8close.json").write_text(
        (here / "limits" / "direct.batch64.json").read_text())
    (here / "metrics" / "busy_ms.batch.py").write_text(
        "from port_bench import trace\n\n\n"
        "def read(ctx):\n"
        "    return 1e3 * trace.busy_s(ctx.trace) / ctx.answered if ctx.answered else None\n")
    bench["configs"].append({"name": cfg["name"], "source": bench["configs"][1]["source"],
                             "file": "port_bench/configs/deepsdf8x512-steps64.json",
                             "reduced": [], "why": "a longer march"})
    bench["workloads"].append({"name": "direct.batch8close", "config": cfg["name"],
                               "traffic": "batch8close", "chips": 1, "why": "closer views"})
    for m in bench["end_to_end"]:
        if m["name"] == "mrays_per_s":
            m["workloads"].append("direct.batch8close")
    bench["per_layer"].append({"name": "busy_ms.batch", "unit": "ms/frame", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "mrays_per_s", "workloads": ["direct.batch8close"]})

    cell, c, t, lim = harness.load_cell(bench, "direct.batch8close", str(here))
    assert c["march"]["max_steps"] == 64 and t["views_per_unit"] == 4
    assert [m["name"] for m in harness.cell_metrics(bench, cell, "per_layer")] == ["busy_ms.batch"]
    assert callable(harness.reader("busy_ms.batch", str(here)))

    def shrink(cfg_, traffic, limits):
        assert cfg_["march"]["max_steps"] == 64 and traffic["views_per_unit"] == 4
        tiny(cfg_, traffic, limits)

    for trace in (False, True):
        r = run_cpu("direct.batch8close", trace=trace, bench=bench, here=str(here),
                    tweak=shrink)
        assert r["correct"]
        assert set(r["metrics"]) == ({"busy_ms.batch"} if trace else {"mrays_per_s", "setup_s"})
    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before
