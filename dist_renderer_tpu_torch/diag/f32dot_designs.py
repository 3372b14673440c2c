"""What sets f32dot's (P8's) time on the card: ``f32dot_designs.cu``
(beside this file) built with the port's nvcc flags into the kernel
build directory and run. It times the kernel, its phases (the launch,
the copies, the sums) and the designs it was chosen over, each in a
CUDA graph of 200 at the TPU script's [24, 512] x [1024, 512]^T, and
holds each to an fp64 sum. Prints the card's name and power limit, then
one JSON line {"f32dot_designs": {design: {"us", "max_abs_err"}}}.

    python -m dist_renderer_tpu_torch.diag.f32dot_designs
"""

from __future__ import annotations

import json
import os
import subprocess

from dist_renderer_tpu_torch.diag import device, emit
from dist_renderer_tpu_torch.ops.kernels import build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "f32dot_designs.cu")


def main(argv=None) -> int:
    device()
    out_dir = os.path.join(build.BUILD_ROOT, "f32dot_designs")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, "f32dot_designs")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", exe, SRC],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed building f32dot_designs.cu:\n" + proc.stdout
                           + proc.stderr)
    run = subprocess.run([exe], capture_output=True, text=True, timeout=300)
    if run.returncode:
        raise RuntimeError("f32dot_designs failed:\n" + run.stdout + run.stderr)
    emit("f32dot_designs", json.loads(run.stdout.strip().splitlines()[-1]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
