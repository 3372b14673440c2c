"""What sets the MLP chains' (P23's, P24's) time on the card:
``chain_designs.cu`` (beside this file) built with the port's nvcc flags
into the kernel build directory and run on diag_int8's inputs at its
defaults (8 layers of 512 x 512, 32 steps, 32,768 columns). It times the
kernels, their first version and the design steps between (the ring with
mma.sync; the ring with wgmma; clusters of 2 and 4 with multicast; 128
columns a block), the shipped design's ring and MMAs alone, and the L2
read rate of one 4 MB weight set read by every SM. Each design is held to
the plain version computed here on the card (int8 bit for bit, bf16
within ``diag_int8.CHAIN_BF16_BAR``; AssertionError otherwise). Then
ptxas's registers and spills of the chain kernels (the design program's
and the kernel library's) and, from ``cuobjdump -sass`` of the library,
the warpgroup MMAs (HGMMA, IGMMA) and warp MMAs (HMMA, IMMA) in the
shipped kernels. Prints the card's name and power limit, then one JSON
line {"chain_designs": {"bf16": {design: {"ms", "max_abs_err",
"equal"}}, "int8": {...}, "l2": {...}, "ptxas": {...}, "sass": {...}}}.

    python -m dist_renderer_tpu_torch.diag.chain_designs
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile

import torch

from dist_renderer_tpu_torch.diag import device, emit, run_program
from dist_renderer_tpu_torch.diag.diag_int8 import CHAIN_BF16_BAR, inputs
from dist_renderer_tpu_torch.ops.kernels import build
from dist_renderer_tpu_torch.ops.kernels import mlp_chain as mc

LAYERS, WIDTH, COLUMNS, STEPS = 8, 512, 32768, 32
MMA_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA")


def ptxas_report(log: str, pattern: str = r"chain") -> dict:
    """{mangled kernel: {"registers", "spill_stores", "spill_loads"}} for
    the entry functions matching ``pattern`` in nvcc's ``-Xptxas -v``
    report."""
    res, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            res.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res.setdefault(name, {})["registers"] = int(m.group(1))
    return res


def mma_counts(sass: str, pattern: str = r"chain_kernel") -> dict:
    """{kernel: {opcode: count}} of the MMA opcodes in each function of
    ``cuobjdump -sass``'s text whose name matches ``pattern``."""
    res = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        if re.search(pattern, name):
            res[name] = {op: len(re.findall(rf"\b{op}\.", body)) for op in MMA_OPS}
    return res


def check(res: dict) -> None:
    """Raise unless every checked design equals (int8) or stays within
    CHAIN_BF16_BAR of (bf16) its plain version."""
    for kind, rows in res.items():
        for name, row in rows.items():
            if "equal" not in row:
                continue
            if kind == "int8" and not row["equal"]:
                raise AssertionError(f"P24 {name}: differs from its plain version "
                                     f"(max |diff| {row['max_abs_err']:.3e})")
            if kind == "bf16" and not row["max_abs_err"] <= CHAIN_BF16_BAR:
                raise AssertionError(f"P23 {name}: max |kernel - plain| "
                                     f"{row['max_abs_err']:.3e} > {CHAIN_BF16_BAR:.1e}")


def main(argv=None) -> int:
    dev = device()
    x, wb, wi = inputs(dev, LAYERS, WIDTH, COLUMNS)
    refs = {"ref_bf16": mc.chain_bf16_plain(x, wb, STEPS),
            "ref_int8": mc.chain_int8_plain(x, wi, STEPS)}
    with tempfile.TemporaryDirectory() as d:
        for name, t in (("x", x), ("wb", wb.view(torch.int16)), ("wi", wi), *refs.items()):
            t.contiguous().cpu().numpy().tofile(os.path.join(d, name))
        exe, res = run_program("chain_designs.cu", timeout=600, args=[d])
    check({k: res[k] for k in ("bf16", "int8")})
    lib = build.load()
    with open(os.path.join(os.path.dirname(exe), "build.log")) as f:
        res["ptxas"] = {"designs": ptxas_report(f.read()),
                        "library": ptxas_report(lib.build_log)}
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib.path], capture_output=True, text=True,
                          check=True).stdout
    res["sass"] = mma_counts(sass)
    emit("chain_designs", res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
