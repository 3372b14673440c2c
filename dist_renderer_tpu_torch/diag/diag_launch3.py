"""Which operand kind adds to a launch's cost, and the work-queue's
building blocks: the counterpart of scripts/diag_launch3.py.

  - the operand ladder, each a scalar while of 0 trips: P11 with a
    pointer in and an output never written, P12 with the output the
    defaults' buffer (aliased), P13 with 48 KB of shared scratch and two
    mbarriers, P14 reading a 512-entry list staged in shared memory;
  - P15, a while loop of bulk (TMA) copies through shared memory at 0, 1
    and 64 trips;
  - P16, the prefix sum of a 0/1 bf16 row (the TPU's triangular product);
  - P17, compaction with an fp32 position;
  - the scatter of queue results into a frame, and a where-merge.

Each launch case gives host us eager and device us in a CUDA graph.

    python -m dist_renderer_tpu_torch.diag.diag_launch3
"""

from __future__ import annotations

import torch

from dist_renderer_tpu_torch.diag import (
    N, Operands, check_close, check_equal, check_probe, device, emit, kernel_row,
    launch_row, scatter_ms,
)
from dist_renderer_tpu_torch.diag.diag_launch4 import compaction_inputs
from dist_renderer_tpu_torch.ops.kernels import probes as pk
from dist_renderer_tpu_torch.utils.profiling import per_call_ms

SRC_L = "dist_renderer_tpu_torch/csrc/probe_launch.cu"
SRC_B = "dist_renderer_tpu_torch/csrc/probe_blocks.cu"
TPU = "scripts/diag_launch3.py"
SCRATCH_2 = pk.SCRATCH_BYTES + 2 * 16   # VMEM [16, 512] + [8, 512], 2 barriers
# scan of seeded bf16 values in [-1, 1] against the triangular product's
# fp32 GEMM: sums of up to 512 terms in another order; f32dot's bar, whose
# sums are alike.
TRI_BAR = 1e-4


def ladder() -> dict:
    """P11-P14: id -> (kernel call, plain call), each a function of the
    Operands, and whether the kernel writes its output (P11's is never
    written: unspecified, as on the TPU)."""
    return {
        "P11": (lambda o: pk.scalar_while(o.n_live, rays=o.x16),
                lambda o: pk.scalar_while_plain(o.n_live, rays=o.x16), False),
        "P12": (lambda o: pk.scalar_while(o.n_live, rays=o.x16, defaults=o.x8),
                lambda o: pk.scalar_while_plain(o.n_live, rays=o.x16, defaults=o.x8), True),
        "P13": (lambda o: pk.scalar_while(o.n_live, rays=o.x16, defaults=o.x8,
                                          smem_bytes=SCRATCH_2, n_bars=2),
                lambda o: pk.scalar_while_plain(o.n_live, rays=o.x16, defaults=o.x8), True),
        "P14": (lambda o: pk.index_loop(o.idx512, o.n_live, o.x16, o.x8, mode=1),
                lambda o: pk.index_loop_plain(o.idx512, o.n_live, o.x16, o.x8, mode=1),
                True),
    }


def tri_inputs(dev):
    """The TPU script's xs (a bf16 1 at every third lane of [1, 512]) and
    its upper-triangular ones tri [512, 512] bf16."""
    ar = torch.arange(512)
    xs = (ar % 3 == 0).to(torch.bfloat16)[None]
    tri = (ar[:, None] <= ar[None, :]).to(torch.bfloat16)
    return xs.to(dev), tri.to(dev)


def check(dev) -> list:
    """P11-P17 against their plain versions, with their kernel rows: the
    ladder on seeded operands at the path's n_live = 0 and at 512 trips."""
    seeded = [Operands(dev, seed=1, n_live=n) for n in (0, 512)]
    rows = []
    for (pid, (run, plain, written)), line, kern in zip(
            ladder().items(), (71, 85, 101, 121),
            (pk.scalar_while,) * 3 + (pk.index_loop,)):
        err = max(check_probe(f"{pid} (n_live {int(o.n_live[0])})", run, plain, o, written)
                  for o in seeded)
        o = seeded[0]
        rows.append(kernel_row(pid, kern, SRC_L, f"{TPU}:{line}", err, lambda: run(o),
                               lambda: plain(o), nbytes=4))
    g = torch.Generator().manual_seed(0)
    rays = (torch.rand((16, N), generator=g) * 2 - 1).to(dev)
    err = 0.0
    for trips in (0, 1, 64):
        t = torch.tensor([trips], dtype=torch.int32, device=dev)
        dflt = (torch.rand((8, N), generator=g)).to(dev)
        err = check_equal(f"P15 x{trips}", pk.dma_loop(t, rays, dflt.clone()),
                          pk.dma_loop_plain(t, rays, dflt.clone()))
    t1 = torch.tensor([1], dtype=torch.int32, device=dev)
    d1 = torch.zeros((8, N), dtype=torch.float32, device=dev)
    # one torch add computes P15's function at a trip or more: rays' first
    # 512 columns of rows 0-7, + 1, into the output's first 512 columns
    lib = lambda d: torch.add(rays[:8, :512], 1.0, out=d[:, :512])
    want = pk.dma_loop(t1, rays, d1.clone())
    got = d1.clone()
    lib(got)
    check_equal("P15 (one torch add)", got, want)
    rows.append(kernel_row("P15", pk.dma_loop, SRC_L, f"{TPU}:145", err,
                           lambda: pk.dma_loop(t1, rays, d1),
                           lambda: pk.dma_loop_plain(t1, rays, d1),
                           lambda: lib(d1), nbytes=4 + 24 * 512 * 4))
    xs, tri = tri_inputs(dev)
    got = pk.scan(xs)
    err = check_equal("P16", got, pk.tri_cumsum_plain(xs, tri))
    check_equal("P16 (the script's check)", got[0], torch.cumsum(xs[0].float(), 0))
    gb = (torch.rand((4, 512), generator=g) * 2 - 1).to(torch.bfloat16).to(dev)
    check_close("P16 (seeded)", pk.scan(gb), pk.tri_cumsum_plain(gb, tri), TRI_BAR)
    rows.append(kernel_row("P16", pk.scan, SRC_B, f"{TPU}:182", err, lambda: pk.scan(xs),
                           lambda: pk.tri_cumsum_plain(xs, tri),
                           lambda: torch.cumsum(xs, 1, dtype=torch.float32),
                           nbytes=xs.nbytes + 512 * 4))
    d24, pos, surv = compaction_inputs(dev)
    got = pk.compact(d24, pos, surv)
    err = check_equal("P17", got, pk.compact_plain(d24, pos, surv))
    check_equal("P17 (the script's check)", got[:, :256], d24[:, ::2])
    rows.append(kernel_row("P17", pk.compact, SRC_B, f"{TPU}:204", err,
                           lambda: pk.compact(d24, pos, surv),
                           lambda: pk.compact_plain(d24, pos, surv),
                           nbytes=d24.nbytes + pos.nbytes + surv.nbytes + 24 * 1024 * 4))
    return rows


def measure(dev, n: int = 200) -> dict:
    o = Operands(dev)
    table = {pid: launch_row(lambda run=run: run(o), n)
             for pid, (run, _, _) in ladder().items()}
    rays = torch.zeros((16, N), dtype=torch.float32, device=dev)
    for trips in (0, 1, 64):
        t = torch.tensor([trips], dtype=torch.int32, device=dev)
        table[f"P15 x{trips}"] = launch_row(lambda t=t: pk.dma_loop(t, rays, o.x8), n)
    xs, _ = tri_inputs(dev)
    table["P16 scan (bf16)"] = launch_row(lambda: pk.scan(xs), n)
    d24, pos, surv = compaction_inputs(dev)
    table["P17 compact"] = launch_row(lambda: pk.compact(d24, pos, surv), n)
    merge = scatter_ms(dev)
    tgt = torch.zeros((8, N), dtype=torch.float32, device=dev)
    mask = torch.zeros((N,), dtype=torch.bool, device=dev)
    merge["where-merge [8,N]"] = per_call_ms(lambda: torch.where(mask[None], tgt, tgt), 10)
    return dict(launches=n, table=table, merge_ms=merge)


def main() -> int:
    dev = device()
    rows = check(dev)
    emit("diag_launch3", dict(
        kernels=[{k: v for k, v in r.items() if k != "kernel"} for r in rows],
        **measure(dev)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
