"""What sets copy's and add_one's (P18's, P19's) time on the card:
``copy_designs.cu`` (beside this file) built with the port's nvcc flags
into the kernel build directory and run. It times the kernels, their
first version, an empty launch and the grids they were chosen from,
each in a CUDA graph of 200 at the TPU script's [8, 512] fp32, and
checks each output bit for bit. Then ``cuobjdump -sass`` of the same
program gives the order of the global loads and stores (LDG, STG) in the
copy's first version, with and without ``__restrict__``, and in the
shipped vector body. Prints the card's name and power limit, then one
JSON line {"copy_designs": {"copy": {design: {"us", "rounds", "equal"}},
"add_one": {...}, "sass": {kernel: "LDG.E STG.E ..."}}}.

    python -m dist_renderer_tpu_torch.diag.copy_designs
"""

from __future__ import annotations

import os
import re
import subprocess

from dist_renderer_tpu_torch.diag import device, emit, run_program
from dist_renderer_tpu_torch.ops.kernels import build

# mangled names (an identifier follows its length, then E at the end of
# a namespace's name or P at its first pointer argument)
SASS_KERNELS = {
    "first version": r"10first_copy[EP]",
    "first version, restrict": r"19first_copy_restrict[EP]",
    "kernel (vector body)": r"13stream_kernelILb0ELb1E",
}


def memory_ops(sass: str) -> dict:
    """The global loads and stores of each kernel in SASS_KERNELS, in
    program order, from ``cuobjdump -sass``'s text."""
    ops = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        for label, pattern in SASS_KERNELS.items():
            if re.search(pattern, name):
                ops[label] = " ".join(re.findall(r"\b((?:LDG|STG)\.[\w.]+)", body))
    return ops


def main(argv=None) -> int:
    device()
    exe, res = run_program("copy_designs.cu")
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", exe], capture_output=True, text=True,
                          check=True).stdout
    res["sass"] = memory_ops(sass)
    emit("copy_designs", res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
