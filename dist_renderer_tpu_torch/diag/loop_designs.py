"""What sets scalar_while's and index_loop's (P3-P6's, P11-P14's) time on
the card: ``loop_designs.cu`` (beside this file) built with the port's
nvcc flags into the kernel build directory and run. It times the
kernels, their first versions (the loop bound read from device memory at
every trip), an empty launch and the designs between (the bound in a
shared word; one warp looping; P4's list staged by int4 loads; the bound
in a register, the loop machinery's floor; the list entry read beside
the bound; mode 0's two inner loops, or its loop unrolled by 4), each in
a CUDA graph at the
TPU scripts' shapes, P6's and P14's bodies at 0 to 16,384 trips, P4's at
n_live 0 and 512, and holds each to its plain version on the card (the
zeros written, every input as it was; AssertionError otherwise). It
measures the card's dependent shared-load latency by a pointer chase and
gives each design's us a trip and each kernel's floor at its trips (trips
x that latency + an empty launch). Then ptxas's registers of each design
and, from ``cuobjdump -sass`` of the program, each loop's shared and
global loads: the kernels' loops must read their bound by LDS, with no
LDG (AssertionError after the printout otherwise). Prints
the card's name and power limit, then one JSON line {"loop_designs":
{"scalar_while": {design: {"us": {trips: us}, "rounds", "equal",
"us_per_trip"}}, "index_loop mode 1": {...}, "index_loop mode 0": {...},
"chase": {...}, "load_us", "floor_us", "ptxas", "sass"}}.

    python -m dist_renderer_tpu_torch.diag.loop_designs
"""

from __future__ import annotations

import os
import re
import subprocess

from dist_renderer_tpu_torch.diag import device, emit, run_program
from dist_renderer_tpu_torch.diag.chain_designs import ptxas_report
from dist_renderer_tpu_torch.diag.dma_designs import loop_ops
from dist_renderer_tpu_torch.ops.kernels import build

LONG = 16384           # the longest trip count timed
OPS = ("scalar_while", "index_loop mode 1", "index_loop mode 0")


def _design(name: str, bound: int, one_warp: int, v4: int, body: int = 0) -> str:
    # a template's mangled arguments: <Bound, bool, bool(, Body)>
    tail = rf"E\w*4BodyE{body}EE" if name == "index_design" else "EE"
    return rf"{len(name)}{name}I\w*5BoundE{bound}ELb{one_warp}ELb{v4}{tail}"


# label -> a pattern of its mangled name
SASS_KERNELS = {
    "scalar_while kernel": r"19scalar_while_kernelE",
    "index_loop kernel": r"17index_loop_kernelE",
    "scalar_while (a) first version": r"18first_scalar_whileE",
    "index_loop (a) first version": r"16first_index_loopE",
    "scalar_while (b) shared bound": _design("while_design", 0, 0, 1),
    "scalar_while (c) one warp": _design("while_design", 0, 1, 1),
    "scalar_while (c) 4-byte zeros": _design("while_design", 0, 1, 0),
    "scalar_while (e) register bound": _design("while_design", 1, 1, 1),
    "index_loop (b) shared bound": _design("index_design", 0, 0, 0),
    "index_loop (c) one warp": _design("index_design", 0, 1, 0),
    "index_loop (d) int4 staging": _design("index_design", 0, 1, 1),
    "index_loop (e) register bound": _design("index_design", 1, 1, 1),
    "index_loop (h) entry read with the bound": _design("index_design", 0, 1, 1, 1),
    "index_loop (i) two inner loops": _design("index_design", 0, 1, 1, 2),
    "index_loop (j) (h) unrolled by 4": _design("index_design", 0, 1, 1, 3),
}
# opcodes counted inside loops: shared loads and stores, global loads
# (LDG, or LD through a generic pointer), barriers
COUNTED = ("LDS", "STS", "LDG", "LD", "BAR")


def sass_loops(sass: str) -> dict:
    """Each kernel of SASS_KERNELS: its global loads, loops and the
    COUNTED opcodes inside its loops, all together and loop by loop
    (dma_designs.loop_ops)."""
    return loop_ops(sass, SASS_KERNELS, COUNTED)


def registers(log: str) -> dict:
    """{label: registers} of each SASS_KERNELS kernel in nvcc's ``-Xptxas
    -v`` report."""
    rep = ptxas_report(log, "|".join(SASS_KERNELS.values()))
    return {label: row.get("registers") for label, p in SASS_KERNELS.items()
            for name, row in rep.items() if re.search(p, name)}


def derive(res: dict) -> dict:
    """Adds each design's us a trip (the time at LONG trips less that at
    0, over LONG), the dependent shared-load latency (the chase's, alike)
    and each kernel's floor at its timed counts (trips x that latency +
    the empty launch; P4's body runs its 512-entry list at every
    n_live)."""
    chase = res["chase"]["us"]
    load = (chase[str(LONG)] - chase["0"]) / LONG
    res["load_us"] = load
    floor = {}
    for op in OPS:
        empty = res[op]["empty launch"]["us"]["0"]
        for row in res[op].values():
            us = row["us"]
            if str(LONG) in us:
                row["us_per_trip"] = (us[str(LONG)] - us["0"]) / LONG
        trips = lambda t: 512 if op == "index_loop mode 0" else int(t)
        floor[op] = {t: trips(t) * load + empty for t in res[op]["kernel"]["us"]}
    res["floor_us"] = floor
    return res


def check(res: dict) -> None:
    """Raise unless every checked design held to its plain version."""
    for op in OPS:
        for name, row in res[op].items():
            if row["equal"] is False:
                raise AssertionError(f"{op} {name}: differs from its plain version (the "
                                     f"zeros not written, or an input changed)")


def check_sass(loops: dict) -> None:
    """Raise unless each kernel has a trip loop (one holding an LDS) and
    no loop that holds an LDS also reads device memory (LDG, or LD through
    a generic pointer); the staging loops read device memory and hold no
    LDS."""
    for label in ("scalar_while kernel", "index_loop kernel"):
        trips = [ops for ops in loops[label]["per_loop"] if ops.get("LDS")]
        if not trips or any(ops.get("LDG") or ops.get("LD") for ops in trips):
            raise AssertionError(f"{label}: its loops hold {loops[label]['per_loop']}, not "
                                 f"a trip loop with an LDS and no device-memory load")


def main(argv=None) -> int:
    dev = device()
    from dist_renderer_tpu_torch.diag.diag_launch_cost import bench_decoder
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels.mlp_eval import mma_smem_bytes

    params, dcfg, _ = bench_decoder(dev)
    plan = mma_smem_bytes(bm.pack_shared(params, dcfg), march=True)  # P3's, P4's scratch
    exe, res = run_program("loop_designs.cu", args=[str(plan)])
    check(res)
    derive(res)
    res["plan_bytes"] = plan
    with open(os.path.join(os.path.dirname(exe), "build.log")) as f:
        res["ptxas"] = registers(f.read())
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", exe], capture_output=True, text=True,
                          check=True).stdout
    res["sass"] = sass_loops(sass)
    emit("loop_designs", res)
    missing = sorted(set(SASS_KERNELS) - set(res["sass"]))
    if missing:
        raise AssertionError(f"no SASS found for {missing}")
    check_sass(res["sass"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
