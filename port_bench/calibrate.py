"""The readings a cell's limits are set from, in one process: the
program's numbers on a dozen seeds or more, and the control's (the plain
reference marched and composed in float8, put in the program's place)
on three or more, each on the cell's own traffic and sizes. Not run by
the benchmark's runs::

    python3 port_bench/calibrate.py --workload proxy.batch64 [--seeds 12]
        [--control-seeds 3] [--first-seed 1000003] [--out FILE.json]

Each seed renders the unit(s) its sample of answers is drawn from:
the first unit of a batch cell, the first ``sample_answers`` requests of
a served cell. Prints one JSON line per seed, then the summary: per
number, the program's largest reading and the control's smallest.
``--cpu --img N`` rehearses on the CPU at N^2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seed_readings(prog, Driver, traffic, limits, seed, ref, device, control: bool) -> dict:
    from port_bench import judge

    drv = Driver(prog, traffic, seed, device)
    units = 1 if traffic["kind"] == "batch" else int(traffic["sample_answers"])
    for i in range(units):
        inputs = drv.unit(i)
        drv.keep(i, inputs, drv.run(inputs))
    worst = {}
    for latent, o, v, answer, label in drv.answers():
        if control:
            answer = judge.control_answer(ref, latent, o, v, limits["reference"],
                                          normals=answer.get("normal") is not None,
                                          polish=2 if traffic["kind"] == "frame" else 0)
        for k, x in judge.numbers(ref, latent, o, v, answer, limits["reference"]).items():
            worst[k] = max(worst.get(k, x), x)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1000003)
    ap.add_argument("--out")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--img", type=int)
    args = ap.parse_args(argv)
    import torch

    from port_bench import harness
    from port_bench.drivers import load
    from port_bench.program import Program
    from port_bench.reference.plain import Decoder, no_tf32

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("calibrate.py needs a CUDA card (or --cpu)")
    device = torch.device("cpu" if args.cpu else "cuda")
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell, cfg, traffic, limits = harness.load_cell(bench, args.workload)
    if args.img:
        traffic["img"] = args.img
    prog = Program(cfg, harness.ROOT, int(traffic["img"]), device)
    Driver = load(traffic["kind"])
    Driver(prog, traffic, 0, device).warm()
    no_tf32()
    ref = Decoder(os.path.join(harness.ROOT, cfg["decoder"]["file"]), cfg["decoder"], device)
    rows = []
    for k in range(args.seeds + args.control_seeds):
        control = k >= args.seeds
        seed = args.first_seed + 7919 * k
        t = time.perf_counter()
        r = seed_readings(prog, Driver, traffic, limits, seed, ref, device, control)
        rows.append(dict(seed=seed, control=control, seconds=time.perf_counter() - t, **r))
        print(json.dumps(rows[-1]), flush=True)
    names = [k for k in rows[0] if k not in ("seed", "control", "seconds")]
    summary = {k: {"program_max": max(r[k] for r in rows if not r["control"]),
                   "control_min": min((r[k] for r in rows if r["control"]), default=None),
                   "limit": limits["limits"].get(k)} for k in names}
    line = {"workload": args.workload, "img": traffic["img"], "summary": summary,
            "device": torch.cuda.get_device_name() if device.type == "cuda" else "cpu"}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **line}, f, indent=1)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
