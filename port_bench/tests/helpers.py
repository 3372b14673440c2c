"""Shared pieces of the benchmark's CPU tests: the repository's root, a
tweak that shrinks a cell to a CPU-sized rehearsal, and a run of a cell
on the CPU."""

from __future__ import annotations

import io
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(cfg: dict, traffic: dict, limits: dict) -> None:
    """32^2 frames; a batch of 1 latent x 2 views; every answer sampled."""
    traffic["img"] = 32
    if traffic["kind"] == "batch":
        traffic.update(latents_per_unit=1, views_per_unit=2, sample_answers=2)
    else:
        traffic.update(sample_answers=2, warm_units=1)


def run_cpu(workload: str, seed: int = 2147483659, trace: bool = False,
            bench: dict = None, here: str = None, tweak=tiny) -> dict:
    import torch

    from port_bench import harness

    bench = bench or harness.load_json(ROOT, "BENCHMARK.json")
    out, err = io.StringIO(), io.StringIO()
    return harness.run_cell(bench, workload, seed, 0.05, trace, torch.device("cpu"),
                            time.perf_counter(), here=here or harness.HERE, root=ROOT,
                            tweak=tweak, out=out, err=err)
