"""What sets dma_loop's and vec_while's (P15's, P7's) time on the card:
``dma_designs.cu`` (beside this file) built with the port's nvcc flags
into the kernel build directory and run. It times the kernels, their
first versions, an empty launch and the designs they were chosen from,
each in a CUDA graph of 200 at the TPU scripts' shapes (P15 at 0, 1 and
64 trips, P7 at 0 and 8), and checks each output bit for bit (P15 at 0,
1, 2 and 64 trips, P7 at 0, 1, 8 and 2^20). Then ``cuobjdump -sass`` of
the same program counts what the first versions' and the kernels' loops
hold: global loads (the count read every trip or not), adds, compares,
barriers, bulk copies and mbarrier operations, all loops together and
loop by loop. Prints the card's name and power limit, then
one JSON line {"dma_designs": {"dma_loop": {design: {"us": {trips: us},
"rounds", "equal"}}, "vec_while": {...}, "sass": {kernel: {"loads",
"loops", "in_loops"}}}}.

    python -m dist_renderer_tpu_torch.diag.dma_designs
"""

from __future__ import annotations

import os
import re
import subprocess

from dist_renderer_tpu_torch.diag import device, emit, run_program
from dist_renderer_tpu_torch.ops.kernels import build

# mangled names (an identifier follows its length, then E at the end of
# a namespace's name, I at its template arguments)
SASS_KERNELS = {
    "dma_loop first version": r"9first_dmaILb0ELb0E",
    "dma_loop kernel": r"15dma_loop_kernelE",
    "vec_while first version": r"15first_vec_whileE",
    "vec_while kernel": r"16vec_while_kernelE",
}
# opcodes counted inside loops: global loads (LDG, or LD through a
# generic pointer), fp32 adds and compares, barriers, bulk copies,
# mbarrier ops
COUNTED = ("LDG", "LD", "FADD", "FSETP", "BAR", "UBLKCP", "SYNCS")


def loop_ops(sass: str, kernels: dict = SASS_KERNELS, counted=COUNTED) -> dict:
    """For each kernel in ``kernels`` (label -> a pattern of its mangled
    name), from ``cuobjdump -sass``'s text: its global loads in program
    order, its number of loops (backward branches; not the branch to
    itself that pads a kernel's end) and how many of each ``counted``
    opcode lie inside a loop (an address range from a backward branch's
    target to the branch), all loops together and loop by loop
    ("per_loop", in program order)."""
    res = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        label = next((k for k, p in kernels.items() if re.search(p, name)), None)
        if label is None:
            continue
        ins = [(int(addr, 16), re.sub(r"^@!?\w+\s+", "", text.strip()))
               for addr, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        loops = [(int(m.group(1), 16), addr) for addr, text in ins
                 for m in [re.match(r"BRA(?:\.\w+)*\s+0x([0-9a-f]+)", text)]
                 if m and int(m.group(1), 16) < addr]
        ops = [(addr, text.split(None, 1)[0].split(".")[0] if text else "")
               for addr, text in ins]
        count = lambda ranges: {op: n for op in counted if (n := sum(
            1 for addr, o in ops if o == op and any(lo <= addr <= hi for lo, hi in ranges)))}
        loads = [t.split(None, 1)[0] for _, t in ins if re.match(r"(?:LDG|LD)\.", t)]
        res[label] = dict(loads=" ".join(loads), loops=len(loops), in_loops=count(loops),
                          per_loop=[count([r]) for r in sorted(loops)])
    return res


def main(argv=None) -> int:
    device()
    exe, res = run_program("dma_designs.cu")
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", exe], capture_output=True, text=True,
                          check=True).stdout
    res["sass"] = loop_ops(sass)
    emit("dma_designs", res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
