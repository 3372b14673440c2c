"""Would the march's MLP run faster in int8 than in bf16 on this card?
The counterpart of scripts/diag_int8.py: STEPS chained evaluations of
an n_layers x width ReLU MLP on every column of x [width, nblocks *
block], (a) bf16 products with fp32 sums (the march's arithmetic), (b)
int8 products with int32 sums and a requantization a layer
(``ops/kernels/mlp_chain.py``). The H100's dense int8 tensor-core rate
is twice its bf16 rate. The TPU's grid block (``--block`` columns) is
kept only as the unit of ``us_per_block_step``: every column is
independent, and the kernel gives each warpgroup 64 of them (a thread
block 128).

Weights and x come from a numpy seed: bf16 weights 0.05 N(0, 1), int8
weights uniform in [-127, 127], x N(0, 1). Each chain is held to its
plain version (int8 bit for bit, bf16 within CHAIN_BF16_BAR) on every
column it is timed on, and timed with CUDA events beside its plain
version, its library chain (bf16 torch.matmul; torch._int_mm) and its
bound.

    python -m dist_renderer_tpu_torch.diag.diag_int8 [--steps 32]
        [--layers 8] [--width 512] [--block 512] [--nblocks 64]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dist_renderer_tpu_torch.diag import check_close, check_equal, device, emit
from dist_renderer_tpu_torch.ops.kernels import mlp_chain as mc
from dist_renderer_tpu_torch.utils.profiling import (
    PEAK_BF16, PEAK_INT8, bound_ms, cuda_ms, timed,
)

SRC = "dist_renderer_tpu_torch/csrc/mlp_chain.cu"
TPU = "scripts/diag_int8.py"
# the bf16 chain against its plain version: the two sum each layer in
# another order, so an activation near a bf16 rounding boundary can round
# the other way (one bf16 step, 2^-8 relative) and carry on through the
# layers and steps; the carry's increment 0.125 h / (1 + h) moves less
# than 0.125 per step. Measured on an NVIDIA H100 80GB HBM3 at 700 W at
# the defaults: max |diff| 5.1e-3 on all 32,768 columns (3.8e-3 on the
# first 1,024). Bar: 1e-2.
CHAIN_BF16_BAR = 1e-2


def inputs(dev, n_layers: int, width: int, cols: int, seed: int = 0):
    """(x [width, cols] fp32, bf16 weights, int8 weights), from a seed."""
    rng = np.random.default_rng(seed)
    wb = torch.from_numpy((0.05 * rng.standard_normal((n_layers, width, width)))
                          .astype(np.float32)).to(torch.bfloat16)
    wi = torch.from_numpy(rng.integers(-127, 128, (n_layers, width, width))
                          .astype(np.int8))
    x = torch.from_numpy(rng.standard_normal((width, cols)).astype(np.float32))
    return x.to(dev), wb.to(dev), wi.to(dev)


def measure(dev, steps=32, layers=8, width=512, block=512, nblocks=64, reps=3) -> dict:
    """Both chains at these sizes: each held to its plain version on every
    column it is timed on (P24 and its torch._int_mm chain bit for bit,
    P23 within CHAIN_BF16_BAR; AssertionError otherwise), with their times,
    rates and kernel rows."""
    cols = nblocks * block
    x, wb, wi = inputs(dev, layers, width, cols)
    macs = mc.chain_macs(layers, width, cols, steps)
    io = 2 * x.nbytes
    out = {"steps": steps, "layers": layers, "width": width, "block": block,
           "nblocks": nblocks, "macs": macs}
    for kind, kern, plain, lib, w, peak, pid, line in (
            ("bf16", mc.chain_bf16, mc.chain_bf16_plain, mc.chain_bf16_library, wb,
             PEAK_BF16, "P23", 59),
            ("int8", mc.chain_int8, mc.chain_int8_plain, mc.chain_int8_library, wi,
             PEAK_INT8, "P24", 82)):
        got = kern(x, w, steps)  # also the warm-up
        ms = cuda_ms(lambda: kern(x, w, steps), reps, warmup=0)
        want, plain_ms = timed(lambda: plain(x, w, steps))
        lib_out = lib(x, w, steps)
        if kind == "int8":
            err = check_equal(pid, got, want)
            check_equal(f"{pid} (torch._int_mm)", lib_out, want)
        else:
            err = check_close(pid, got, want, CHAIN_BF16_BAR)
        del got, want, lib_out
        us = ms * 1e3 / (nblocks * steps)
        b_ms, b_by = bound_ms(io + w.nbytes, 2 * macs, peak)
        out[kind] = dict(
            id=pid, kernel=kern, source=SRC, replaces=f"{TPU}:{line}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=cuda_ms(lambda: lib(x, w, steps), reps, warmup=0), bound_ms=b_ms,
            bound_by=b_by, us_per_block_step=us,
            rate_t=2 * layers * width * width * block / (us * 1e-6) / 1e12)
    out["int8_speedup"] = out["bf16"]["ms"] / out["int8"]["ms"]
    out["library_int8_speedup"] = out["bf16"]["library_ms"] / out["int8"]["library_ms"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--nblocks", type=int, default=64)
    args = ap.parse_args()
    res = measure(device(), args.steps, args.layers, args.width, args.block,
                  args.nblocks)
    for kind in ("bf16", "int8"):
        res[kind] = {k: v for k, v in res[kind].items() if k != "kernel"}
    emit("diag_int8", res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
