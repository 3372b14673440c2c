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

from dist_renderer_tpu_torch.diag import device, emit, run_program


def main(argv=None) -> int:
    device()
    emit("f32dot_designs", run_program("f32dot_designs.cu")[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
