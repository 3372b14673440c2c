"""Card measurements: the counterparts of the JAX package's TPU probe
scripts (``scripts/diag_launch_cost.py``, ``diag_launch2.py``,
``diag_launch3.py``, ``diag_launch4.py``, ``diag_int8.py``). Each module
runs on one CUDA card, ``python -m dist_renderer_tpu_torch.diag.<name>``,
holds every probe kernel it launches to its plain version, and prints
its measurements as one JSON line after the card's name and power
limit. ``chip_smoke.py``'s phase 10 runs them all.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
from typing import Optional

import numpy as np
import torch

from dist_renderer_tpu_torch.utils.profiling import (
    PEAK_BF16, bound_ms, graph_us, host_us, per_call_ms,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N = 512 * 512        # the scripts' [rows, N] operands: one 512x512 frame


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("this measurement needs a CUDA card")
    return torch.device("cuda", 0)


def launch_row(fn, n: int = 200, graph: bool = True) -> dict:
    """A launch's cost: the host us per call, eager (median of n
    back-to-back calls), and the device us per call inside one CUDA graph
    of n calls."""
    row = {"host_us": host_us(fn, n)}
    if graph:
        row["graph_us"] = graph_us(fn, n)
    return row


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Raise unless got equals want (bit for bit where they are numbers;
    NaN where NaN); return the largest absolute difference, 0.0."""
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item() \
            if got.shape == want.shape else float("inf")
        raise AssertionError(f"{name}: the kernel differs from its plain version "
                             f"(max |diff| {diff:.3e})")
    return 0.0


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, bar: float) -> float:
    """Raise unless every |got - want| <= bar; return the largest."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    diff = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    if not diff <= bar:
        raise AssertionError(f"{name}: max |kernel - plain| {diff:.3e} > {bar:.1e}")
    return diff


def emit(name: str, result: dict) -> None:
    """Print the card line and one JSON line {name: result}."""
    print(card_line())
    print(json.dumps({name: result}), flush=True)


def kernel_row(pid: str, kernel, source: str, replaces: str, max_abs_err: float,
               run, plain, library=None, nbytes: float = 0.0, ops: float = 0.0,
               peak: float = PEAK_BF16, calls: int = 20) -> dict:
    """One probe kernel's row: its id (P1-P24), the wrapper that launches
    it, its source and the TPU kernel it replaces (file:line), the largest
    |kernel - plain| of its check, and the device ms per call of the
    kernel (``run``), its plain version and, where one PyTorch call
    computes the same function, that call (eager, CUDA events), beside
    the bound of the bytes and operations its function needs."""
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    return dict(id=pid, kernel=kernel, source=source, replaces=replaces,
                max_abs_err=max_abs_err, ms=per_call_ms(run, calls),
                plain_ms=per_call_ms(plain, calls),
                library_ms=None if library is None else per_call_ms(library, calls),
                bound_ms=b_ms, bound_by=b_by)


class Operands:
    """The TPU scripts' operands on the card: x8 [8, N] and x16 [16, N]
    fp32, the loop bound n_live (int32 [1]), the live list of N / 512
    chunks, a 512-entry list (int32) and the bias columns [total, 128]
    fp32. Without a seed they are the scripts' zeros (n_live = 0, the
    zero-work case); with one, the values and lists are drawn from it and
    n_live is ``n_live``, so that a kernel which wrote or read where it
    should not shows."""

    def __init__(self, dev, total: int = 1, seed: Optional[int] = None,
                 n_live: int = 0):
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.n_live = torch.full((1,), n_live, **i32)
        if seed is None:
            self.x8 = torch.zeros((8, N), **f32)
            self.x16 = torch.zeros((16, N), **f32)
            self.live = torch.zeros((N // 512,), **i32)
            self.idx512 = torch.zeros((512,), **i32)
            self.bias = torch.zeros((total, 128), **f32)
            return
        rng = np.random.default_rng(seed)
        normal = lambda *shape: torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
        self.x8, self.x16, self.bias = normal(8, N), normal(16, N), normal(total, 128)
        self.live = torch.from_numpy(rng.permutation(N // 512).astype(np.int32)).to(dev)
        self.idx512 = torch.from_numpy(rng.integers(1, 512, 512, dtype=np.int32)).to(dev)

    def clone(self) -> "Operands":
        twin = copy.copy(self)
        for name, t in vars(self).items():
            setattr(twin, name, t.clone())
        return twin


def check_probe(name: str, run, plain, o: Operands, written: bool = True) -> float:
    """Hold a probe kernel whose operands are ``o`` to its plain version:
    run(o) launches the kernel, plain(twin) runs the plain version on a
    clone of o taken before. The outputs must be equal (an aliased
    output, o's own buffer, against the untouched clone's), and every
    operand must be as it was: these kernels read, at most, and write
    only their own outputs. ``written=False`` is for an output the kernel
    never writes (its contents unspecified, as on the TPU): its shape and
    type are checked. Returns the largest |kernel - plain|, 0.0."""
    twin = o.clone()
    got = run(o)
    want = plain(twin)
    if written:
        err = check_equal(name, got, want)
    elif (got.shape, got.dtype, got.device) != (want.shape, want.dtype, want.device):
        raise AssertionError(f"{name}: output {tuple(got.shape)} {got.dtype} {got.device}, "
                             f"not {tuple(want.shape)} {want.dtype} {want.device}")
    else:
        err = 0.0
    for op, t in vars(o).items():
        check_equal(f"{name}: operand {op} changed", t, getattr(twin, op))
    return err


def scatter_ms(dev, calls: int = 10) -> dict:
    """The scripts' XLA scatters of queue results into a frame: [8, qn]
    into a copy of [8, N] at qn = N/4 and N/16 (index_copy_; JAX's
    .at[].set copies too), device ms per call."""
    tgt = torch.zeros((8, N), dtype=torch.float32, device=dev)
    out = {}
    for qn in (N // 4, N // 16):
        qpix = (torch.arange(qn, dtype=torch.int64, device=dev) * 3) % N
        qval = torch.ones((8, qn), dtype=torch.float32, device=dev)
        out[f"scatter [8,{qn}] -> [8,N]"] = per_call_ms(
            lambda: tgt.clone().index_copy_(1, qpix, qval), calls)
    return out
