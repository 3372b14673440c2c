"""What sets compact's and scan's (P17's, P22's, P10's, P16's) time on the
card: ``block_designs.cu`` (beside this file) built with the port's nvcc
flags into the kernel build directory and run. It times the kernels,
their first versions (compact: one block zeroing every output, then the
survivors' 4-byte stores; scan: a block per row, two barriers a
log-shift step), an empty launch, a memset of compact's [24, 1024]
output and the designs between (compact: 4-byte loads, a flat grid with
1-8 rows and 256-1,024 slots a block, an inverse map slot -> lane and a
gather, one round of 512 lanes with its loads before or after the
barrier; scan: lanes holding contiguous values with float4 or
scalar loads, lanes holding strided float4s), each in a CUDA graph of
200 at the TPU scripts' shapes, and checks each output bit for bit against its plain
version computed on the host (AssertionError otherwise). Then ptxas's
registers and spills of each, and from ``cuobjdump -sass`` each kernel's
global loads and stores, shared loads and stores, shuffles and barriers:
compact's kernel must store by STG.E.128 and scan's kernels must hold no
BAR (AssertionError after the printout otherwise). Prints the card's
name and power limit, then one JSON line {"block_designs": {"compact":
{design: {"us", "rounds", "equal"}}, "compact int": {...}, "scan":
{...}, "scan bf16": {...}, "ptxas": {label: {"registers", ...}},
"sass": {label: {opcode: count}}}}.

    python -m dist_renderer_tpu_torch.diag.block_designs
"""

from __future__ import annotations

import os
import re
import subprocess

from dist_renderer_tpu_torch.diag import device, emit, run_program
from dist_renderer_tpu_torch.diag.chain_designs import ptxas_report
from dist_renderer_tpu_torch.ops.kernels import build

# label -> a pattern of its mangled name (an identifier follows its
# length; I opens template arguments, Li<n>E an int's)
SASS_KERNELS = {
    "compact kernel": r"14compact_kernelILb1EE",
    "compact (a) first version": r"13first_compact[EP]",
    "compact (b) 4-byte loads": r"14compact_kernelILb0EE",
    "compact (c) flat grid": r"13tiled_compactILi1ELi256ELi2EE",
    "compact (d) 2 rows a block": r"13tiled_compactILi2ELi256ELi2EE",
    "compact (e) 4 rows a block": r"13tiled_compactILi4ELi256ELi2EE",
    "compact (f) 8 rows a block": r"13tiled_compactILi8ELi256ELi2EE",
    "compact (g) 512 slots a block": r"13tiled_compactILi1ELi128ELi4EE",
    "compact (h) 256 slots a block": r"13tiled_compactILi1ELi64ELi8EE",
    "compact (i) inverse map": r"14gather_compactILi256EE",
    "compact (j) one round, float2 loads": r"15compact_variantILb1ELb1EE",
    "compact (k) one round, loads after the barrier": r"15compact_variantILb0ELb0EE",
    "scan kernel": r"11scan_kernelILi16EfE",
    "scan kernel bf16": r"11scan_kernelILi16E13__nv_bfloat16E",
    "scan (a) first version": r"10first_scan[EP]",
    "scan (b) contiguous lanes": r"15contiguous_scanILi16EfE",
    "scan (b) contiguous lanes bf16": r"15contiguous_scanILi16E13__nv_bfloat16E",
    "scan (d) strided float4s": r"16vec_strided_scanILi16EfE",
    "scan (d) strided float4s bf16": r"16vec_strided_scanILi16E13__nv_bfloat16E",
}
# the kernels the library ships, which check_sass holds to their design
SHIPPED = ("compact kernel", "compact (b) 4-byte loads", "scan kernel", "scan kernel bf16")
COUNTED = ("LDG", "STG", "LDS", "STS", "SHFL", "BAR")


def sass_ops(sass: str, kernels: dict = SASS_KERNELS) -> dict:
    """{label: {opcode: count}} of each kernel in ``kernels`` (label -> a
    pattern of its mangled name), from ``cuobjdump -sass``'s text: every
    opcode of a COUNTED family, with its width and modifiers
    (``STG.E.128``, ``LDG.E.CONSTANT``, ``BAR.SYNC.DEFER_BLOCKING``)."""
    res = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        label = next((k for k, p in kernels.items() if re.search(p, name)), None)
        if label is None:
            continue
        ops = {}
        for text in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body):
            op = re.sub(r"^@!?\w+\s+", "", text.strip()).split(None, 1)[0]
            if op.split(".")[0] in COUNTED:
                ops[op] = ops.get(op, 0) + 1
        res[label] = ops
    return res


def check_sass(ops: dict) -> None:
    """Raise unless compact's kernels (both load forms) store by STG.E.128
    and scan's kernels hold no barrier."""
    missing = [k for k in SHIPPED if k not in ops]
    if missing:
        raise AssertionError(f"no SASS found for {missing}")
    for label in ("compact kernel", "compact (b) 4-byte loads"):
        if not ops[label].get("STG.E.128"):
            raise AssertionError(f"{label}: no STG.E.128 in {ops[label]}")
    for label in ("scan kernel", "scan kernel bf16"):
        bars = {op: n for op, n in ops[label].items() if op.startswith("BAR")}
        if bars:
            raise AssertionError(f"{label}: holds {bars}")


def check(res: dict) -> None:
    """Raise unless every checked design held to its plain version."""
    for op in ("compact", "compact int", "scan", "scan bf16"):
        for name, row in res[op].items():
            if row["equal"] is False:
                raise AssertionError(f"{op} {name}: differs from its plain version")


def registers(log: str) -> dict:
    """{label: {"registers", "spill_stores", "spill_loads"}} of each
    SASS_KERNELS kernel in nvcc's ``-Xptxas -v`` report."""
    rep = ptxas_report(log, "|".join(SASS_KERNELS.values()))
    return {label: row for label, p in SASS_KERNELS.items()
            for name, row in rep.items() if re.search(p, name)}


def main(argv=None) -> int:
    device()
    exe, res = run_program("block_designs.cu")
    with open(os.path.join(os.path.dirname(exe), "build.log")) as f:
        res["ptxas"] = registers(f.read())
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", exe], capture_output=True, text=True,
                          check=True).stdout
    res["sass"] = sass_ops(sass)
    emit("block_designs", res)
    check(res)
    check_sass(res["sass"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
