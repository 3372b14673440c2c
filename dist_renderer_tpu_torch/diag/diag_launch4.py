"""Per-launch against per-dispatch cost, and the work-queue building
blocks: the counterpart of scripts/diag_launch4.py.

  - P18 copy, P19 add one, P20 a small product ([8, 512] fp32 rounded
    to bf16 times [512, 512] bf16, fp32 sums, on mma.sync) and P21 the
    same inside a one-trip while loop: host us eager and device us in a
    CUDA graph per launch, each beside its PyTorch call's;
  - chain20: 20 chained small products, eager, as one CUDA graph, and as
    20 bf16 ``torch.matmul`` (the TPU script's chain20_xla; its products
    round to bf16 where the kernel's stay fp32, and the next product
    rounds its input to bf16 anyway, so the chains differ only in the
    last output's rounding);
  - P22, compaction with an int position;
  - the scatter of [8, N/4] and [8, N/16] queue results into [8, N], and
    a gather of [8, N/4] (the TPU script's XLA scatter and gather).

    python -m dist_renderer_tpu_torch.diag.diag_launch4
"""

from __future__ import annotations

import numpy as np
import torch

from dist_renderer_tpu_torch.diag import (
    N, check_close, check_equal, device, emit, kernel_row, launch_row, scatter_ms,
)
from dist_renderer_tpu_torch.ops.kernels import probes as pk
from dist_renderer_tpu_torch.utils.profiling import PEAK_BF16, graph_us, host_us, per_call_ms

SRC_L = "dist_renderer_tpu_torch/csrc/probe_launch.cu"
SRC_B = "dist_renderer_tpu_torch/csrc/probe_blocks.cu"
TPU = "scripts/diag_launch4.py"
# small_mm against its plain version (an fp32 GEMM of the same bf16
# values) on seeded x, w in [-1, 1]: the sums of 512 exact products run
# in another order. Measured on an NVIDIA H100 80GB HBM3 at 700 W: max
# |diff| 1.5e-5 with the first kernel, 3.8e-6 with the K split over 8
# warps (sums of a few units, whose fp32 ulp is ~1e-6). Bar: 1e-4.
MM_BAR = 1e-4


def compaction_inputs(dev):
    """The TPU scripts' d24, pos and surv: d [24, 512] = iota * 0.001 + 1,
    even lanes survive and take slots 0..255, odd ones sit at 5000."""
    d24 = torch.arange(24 * 512, dtype=torch.float32).reshape(24, 512) * 0.001 + 1.0
    surv = (torch.arange(512) % 2 == 0).to(torch.float32)[None]
    pos = (torch.cumsum(surv[0], 0) - 1.0)[None] * surv + (1 - surv) * 5000.0
    return d24.to(dev), pos.to(dev), surv.to(dev)


def mm_inputs(dev, seed: int = 0):
    """x [8, 512] fp32 and w [512, 512] bf16, seeded (the TPU script used
    ones, whose products are exact in any order)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (8, 512)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(-1, 1, (512, 512)).astype(np.float32))
    return x, w.to(torch.bfloat16).to(dev)


def chain20(x, w, fn):
    out = x
    for _ in range(20):
        out = fn(out, w)
    return out


def _mm_library(x, w):
    return torch.mm(x.to(torch.bfloat16), w, out_dtype=torch.float32)


def check(dev) -> list:
    """P18-P22 against their plain versions, with their kernel rows."""
    x, w = mm_inputs(dev)
    ones_x = torch.ones((8, 512), dtype=torch.float32, device=dev)
    ones_w = torch.ones((512, 512), dtype=torch.bfloat16, device=dev)
    d24, pos, surv = compaction_inputs(dev)
    rows = []
    err = check_equal("P18", pk.copy(x), pk.copy_plain(x))
    rows.append(kernel_row("P18", pk.copy, SRC_L, f"{TPU}:66", err, lambda: pk.copy(x),
                           lambda: pk.copy_plain(x), lambda: x.clone(), nbytes=2 * x.nbytes,
                           graphs=True))
    err = check_equal("P19", pk.add_one(x), pk.add_one_plain(x))
    rows.append(kernel_row("P19", pk.add_one, SRC_L, f"{TPU}:70", err,
                           lambda: pk.add_one(x), lambda: pk.add_one_plain(x),
                           lambda: x + 1.0, nbytes=2 * x.nbytes, graphs=True))
    mm_bytes = 2 * x.nbytes + w.nbytes
    mm_ops = 2 * 8 * 512 * 512
    for pid, line, looped in (("P20", 74, False), ("P21", 80, True)):
        # the TPU script's ones are exact in any order; seeded values hold
        # the bar
        check_equal(pid + " (ones)", pk.small_mm(ones_x, ones_w, looped),
                    pk.small_mm_plain(ones_x, ones_w, looped))
        err = check_close(pid, pk.small_mm(x, w, looped), pk.small_mm_plain(x, w, looped),
                          MM_BAR)
        rows.append(kernel_row(pid, pk.small_mm, SRC_B, f"{TPU}:{line}", err,
                               lambda lp=looped: pk.small_mm(x, w, lp),
                               lambda lp=looped: pk.small_mm_plain(x, w, lp),
                               lambda: _mm_library(x, w), nbytes=mm_bytes, ops=mm_ops,
                               peak=PEAK_BF16, graphs=True))
    check_equal("P21 (0 trips)", pk.small_mm(x, w, True, 0),
                pk.small_mm_plain(x, w, True, 0))
    got = pk.compact(d24, pos, surv, int_pos=True)
    err = check_equal("P22", got, pk.compact_plain(d24, pos, surv, int_pos=True))
    check_equal("P22 (the script's check)", got[:, :256], d24[:, ::2])
    rows.append(kernel_row("P22", pk.compact, SRC_B, f"{TPU}:123", err,
                           lambda: pk.compact(d24, pos, surv, int_pos=True),
                           lambda: pk.compact_plain(d24, pos, surv, int_pos=True),
                           nbytes=d24.nbytes + pos.nbytes + surv.nbytes + 24 * 1024 * 4,
                           graphs=True))
    return rows


def measure(dev, n: int = 200) -> dict:
    x, w = mm_inputs(dev)
    d24, pos, surv = compaction_inputs(dev)
    table = {
        "P18 copy": launch_row(lambda: pk.copy(x), n),
        "P19 add": launch_row(lambda: pk.add_one(x), n),
        "P20 small_mm": launch_row(lambda: pk.small_mm(x, w), n),
        "P21 small_mm in a while": launch_row(lambda: pk.small_mm(x, w, True), n),
        "P22 compact": launch_row(lambda: pk.compact(d24, pos, surv, int_pos=True), n),
    }
    kern = lambda: chain20(x, w, pk.small_mm)
    lib = lambda: chain20(x, w, lambda a, b: torch.matmul(a.to(torch.bfloat16), b))
    c_k, c_l = kern(), lib().to(torch.float32)
    chain = dict(
        eager_host_us=host_us(kern, 50), eager_ms=per_call_ms(kern, 10),
        graph_ms=graph_us(kern, 10) / 1e3,
        matmul_eager_ms=per_call_ms(lib, 10), matmul_graph_ms=graph_us(lib, 10) / 1e3,
        # the two chains' outputs (bf16 vs fp32 last rounding, summation order)
        vs_matmul_max_rel=((c_k - c_l).abs().max() / c_k.abs().max()).item())
    scatter = scatter_ms(dev)
    tgt = torch.zeros((8, N), dtype=torch.float32, device=dev)
    qpix = (torch.arange(N // 4, dtype=torch.int64, device=dev) * 3) % N
    scatter[f"gather [8,N] -> [8,{N // 4}]"] = per_call_ms(lambda: tgt[:, qpix], 10)
    scatter["clone [8,N] (in the scatters)"] = per_call_ms(lambda: tgt.clone(), 10)
    return dict(launches=n, table=table, chain20=chain, scatter_ms=scatter)


def main() -> int:
    dev = device()
    rows = check(dev)
    emit("diag_launch4", dict(
        kernels=[{k: v for k, v in r.items() if k != "kernel"} for r in rows],
        **measure(dev)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
