"""The MLP chain probe (scripts/diag_int8.py; P23 and P24 in PERF.md):
does the march's MLP run faster in int8 than in bf16 on this card?

Both chains evaluate an n_layers x width ReLU MLP ``steps`` times on
every column of x [width, cols], feeding each step's output back into
an fp32 carry (so no step can be hoisted):

  bf16 (P23, make_bf16_kernel): h = bf16(h0); per layer
      h = bf16(relu(W_l . h)) with fp32 sums;
  int8 (P24, make_int8_kernel): h = int8(clip(round(16 h0), -127, 127));
      per layer int32 sums, h = int8(clip(round(acc / 512), 0, 127));
  then h0 = h0 + 0.125 h / (1 + |h|).

On a CUDA tensor the wrappers launch ``csrc/mlp_chain.cu`` (wgmma, bf16
m64n128k16 or s8 m64n128k32, on a TMA weight ring a block of 128
columns; the fp32 carry in ``out``); on a CPU tensor
they run the plain versions. The int8 chain is exact, so kernel and
plain version agree bit for bit; the bf16 one sums in another order and
may round an activation the other way (and divides the carry's
increment by a reciprocal). ``round`` is half to even in all of them
(jnp.round, torch.round, rintf). The ``*_library`` functions compute the
same functions with one PyTorch call a layer (a bf16 ``torch.matmul``;
``torch._int_mm``), as yardsticks of speed only.
"""

from __future__ import annotations

import torch

from dist_renderer_tpu_torch.models.decoder import round_bf16
from dist_renderer_tpu_torch.ops.kernels import build

COLS = 64  # the kernel's column granule: a warpgroup's columns


def _carry(h0: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return h0 + 0.125 * h / (1.0 + h.abs())


def _check(x: torch.Tensor, ws: torch.Tensor, dtype) -> None:
    if x.dtype != torch.float32 or ws.dtype != dtype or not (
            x.is_contiguous() and ws.is_contiguous()):
        raise ValueError(f"the chain takes contiguous x fp32 and weights {dtype}")
    width, cols = x.shape
    if ws.dim() != 3 or ws.shape[1:] != (width, width):
        raise ValueError("weights must be [n_layers, width, width]")
    if width not in (128, 256, 384, 512) or cols % COLS:
        raise ValueError(f"the kernel takes width 128, 256, 384 or 512 and a "
                         f"multiple of {COLS} columns")
    if x.device != ws.device:
        raise ValueError("x and the weights must lie on one device")


def chain_bf16_plain(x: torch.Tensor, ws: torch.Tensor, steps: int) -> torch.Tensor:
    """P23's plain version: fp32 products of the bf16 values."""
    wf = ws.to(torch.float32)
    h0 = x.to(torch.float32)
    for _ in range(steps):
        h = round_bf16(h0)
        for w in wf:
            h = round_bf16(torch.relu(torch.matmul(w, h)))
        h0 = _carry(h0, h)
    return h0


def chain_int8_plain(x: torch.Tensor, ws: torch.Tensor, steps: int) -> torch.Tensor:
    """P24's plain version: the integer products in float64 (exact: every
    sum is below 512 * 127 * 127 < 2^24), the requantization and the carry
    in fp32; also where torch has no int32 product."""
    wd = ws.to(torch.float64)
    h0 = x.to(torch.float32)
    for _ in range(steps):
        h = torch.clamp(torch.round(h0 * 16.0), -127.0, 127.0)
        for w in wd:
            acc = torch.matmul(w, h.to(torch.float64)).to(torch.float32)
            h = torch.clamp(torch.round(acc * (1.0 / 512.0)), 0.0, 127.0)
        h0 = _carry(h0, h)
    return h0


def _launch(name: str, x: torch.Tensor, ws: torch.Tensor, steps: int) -> torch.Tensor:
    out = torch.empty_like(x)
    build.load().call(name, build.ptr(x), build.ptr(ws), build.ptr(out), x.shape[0],
                      x.shape[1], ws.shape[0], steps, build.stream_of(x))
    return out


def chain_bf16(x: torch.Tensor, ws: torch.Tensor, steps: int) -> torch.Tensor:
    """P23: x [width, cols] fp32, ws [n_layers, width, width] bf16."""
    if not x.is_cuda:
        return chain_bf16_plain(x, ws, steps)
    _check(x, ws, torch.bfloat16)
    out = _launch("drt_mlp_chain_bf16", x, ws, steps)
    chain_bf16.launches += 1
    return out


chain_bf16.launches = 0


def chain_int8(x: torch.Tensor, ws: torch.Tensor, steps: int) -> torch.Tensor:
    """P24: x [width, cols] fp32, ws [n_layers, width, width] int8 in
    [-127, 127]."""
    if not x.is_cuda:
        return chain_int8_plain(x, ws, steps)
    _check(x, ws, torch.int8)
    out = _launch("drt_mlp_chain_int8", x, ws, steps)
    chain_int8.launches += 1
    return out


chain_int8.launches = 0


def chain_bf16_library(x: torch.Tensor, ws: torch.Tensor, steps: int) -> torch.Tensor:
    """P23 with a bf16 torch.matmul a layer: its output rounded to bf16
    and then relu'd, which equals relu then rounding."""
    h0 = x.to(torch.float32)
    for _ in range(steps):
        h = h0.to(torch.bfloat16)
        for w in ws:
            h = torch.relu(torch.matmul(w, h))
        h0 = _carry(h0, h.to(torch.float32))
    return h0


def chain_int8_library(x: torch.Tensor, ws: torch.Tensor, steps: int) -> torch.Tensor:
    """P24 with torch._int_mm (int8 x int8 -> int32) a layer."""
    h0 = x.to(torch.float32)
    for _ in range(steps):
        h = torch.clamp(torch.round(h0 * 16.0), -127.0, 127.0).to(torch.int8)
        for w in ws:
            acc = torch._int_mm(w, h).to(torch.float32)
            h = torch.clamp(torch.round(acc * (1.0 / 512.0)), 0.0, 127.0).to(torch.int8)
        h0 = _carry(h0, h.to(torch.float32))
    return h0


def chain_macs(n_layers: int, width: int, cols: int, steps: int) -> int:
    """Multiply-adds of one chain."""
    return n_layers * width * width * cols * steps
