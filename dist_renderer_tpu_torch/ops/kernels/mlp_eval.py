"""Bulk point evaluation of the latent-folded decoder (K5): mesh-extraction
SDF grids, color lookups, the forward of the differentiable color head;
and the banked point evaluation of many frames' points (K6), the proxy
verify stage's certification probes (ops/cert.py).

K5, ``point_eval``, replaces the JAX package's
``ops/pallas/mlp_eval.py::pallas_point_eval`` (a loop-free
``march_body.mlp_apply`` per 512-point block). On a CUDA tensor it
launches ``csrc/point_eval.cu``, which runs ``csrc/point_mlp.cuh``'s
tensor-core MLP body (wgmma, activations in shared memory, the weights
streamed from ``SharedDecoder.tiles``) once per 64-point tile; on a CPU
tensor, or with ``use_kernel=False``, it runs the plain version,
``march_body.mlp_apply`` on the folded layers. The numerics are the
march's (bf16 positions and weights, fp32 accumulation, one bf16
rounding per activation). The tensor cores sum in another order than
the plain version's k order; values within an empirical margin of a bf16
rounding boundary (NEAR_TIE in batched_march.py), and the last layer,
are summed again in k order. On the bench 8x512 decoder and the 8x512
color decoder that gave the in-order plain version's bits on every point
an H100 was run on; a tie the margin misses moves one activation by a
bf16 rounding, which K5's bars against the plain version (99% of points
within 1e-5, max 5e-3) hold. A point's bits do not depend on the other
points of its launch. A mesh extracted through K5 is the surface the
march sees; its ~2e-3 bf16 noise is far below the 2/res spacing of any
practical grid.

``make_pallas_point_fn`` and ``make_pallas_color_fn`` keep the JAX
package's names: a latent bound into point functions through K5.

K6, ``point_eval_banked``, replaces ``pallas_point_eval_banked``: points of
many frames against the shared weights and the per-frame bias bank
(``batched_march.pack_shared``, ``fold_bias_bank``), each ``block`` of
points one frame, positions split into two bf16 halves (``precise_x``).
On a CUDA tensor it launches ``csrc/point_eval.cu``'s banked kernel on
the same tensor-core body; every point of a 32-point tile with no active
point returns +POS_BIG, and a 64-point tile with none skips the MLP.
Its plain version evaluates the live 32-point tiles frame by frame.
"""

from __future__ import annotations

import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import Params, round_bf16
from dist_renderer_tpu_torch.models.folded import fold_latent
from dist_renderer_tpu_torch.ops.kernels import build
from dist_renderer_tpu_torch.ops.kernels.batched_march import (
    MMA_STAGE_BYTES, check_cuda_inputs, march_args, plain_layers,
)
from dist_renderer_tpu_torch.ops.kernels.fused_march import PackedFolded, pack_folded
from dist_renderer_tpu_torch.ops.kernels.march_body import POS_BIG, mlp_apply

_FRAME0 = torch.zeros((1,), dtype=torch.int64)  # the folded biases' one column
# csrc/point_mlp.cuh's plan: points per block, ring stages, near-tie queue
# entries, and the shared memory a block may use
MMA_M, MMA_STAGES, MMA_QCAP = 64, 4, 2048
SMEM_LIMIT = 232_448


def mma_smem_bytes(shared, march: bool = False) -> int:
    """The dynamic shared memory K5 and K6 (or, with march, the march
    kernels K1, K1-multi, K1-grid and K2) ask for with this decoder:
    point_mlp.cuh's smem_plan (two [M, w16] bf16 activation buffers, the
    weight ring, a layer's biases, near-tie scales and x weights in fp32,
    positions, frames, row norms, the near-tie queue and its overflow bits,
    barriers, and for the march its rows' carries, geometry, step values
    and ray or pixel indices; w16 the widest layer rounded up to 16). The
    kernels' own sums, drt_point_mlp_smem and drt_march_mma_smem, are held
    equal to this one on the card."""
    t = shared.table
    widths = [t[i] for i in range(0, len(t), 5)] + [t[i + 1] for i in range(0, len(t), 5)]
    return smem_plan_bytes(max([16] + [_round16(w) for w in widths]), march)


def smem_plan_bytes(w16: int, march: bool = False) -> int:
    """point_mlp.cuh's smem_plan(w16, march).bytes."""
    act = (2 * MMA_M * w16 * 2 + 1023) // 1024 * 1024
    point = (act + MMA_STAGES * MMA_STAGE_BYTES + 20 * w16 + 32 * MMA_M
             + 4 * MMA_QCAP + 16 + MMA_M * w16 // 8 + 16 * MMA_STAGES)
    # the march's carries [12][M], geometry [8][M] and step values [M],
    # fp32, and its rows' ray or pixel indices [M], int32
    return point + (4 * 22 * MMA_M if march else 0)


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def check_mma_plan(shared, device, march: bool = False) -> None:
    """Raise if the MMA weight layout is not bf16 on ``device`` or the
    shared-memory plan of K5 and K6 (with march, of the march kernels)
    cannot hold the decoder."""
    if any(t.device != device for t in (shared.tiles, shared.wrows, shared.wscale)) or (
            shared.tiles.dtype, shared.wrows.dtype, shared.wscale.dtype) != (
            torch.bfloat16, torch.bfloat16, torch.float32):
        raise ValueError("the MMA weight tiles and rows (bf16) and near-tie scales "
                         "(fp32) must be on the kernel inputs' device")
    need = mma_smem_bytes(shared, march)
    if need > SMEM_LIMIT:
        t = shared.table
        width = max(t[i] for i in range(0, len(t), 5))
        who = "the march kernels K1/K1-multi/K1-grid/K2" if march else "K5/K6"
        raise ValueError(f"a decoder of width {width} needs {need} bytes of shared "
                         f"memory per block for {who}, more than the {SMEM_LIMIT} an "
                         "H100 block can use")


def point_eval_plain(packed: PackedFolded, points: torch.Tensor,
                     out_rows: int = 1) -> torch.Tensor:
    """The plain PyTorch version of K5 (see point_eval)."""
    layers = plain_layers(packed.shared, packed.bias, _FRAME0, True)
    return mlp_apply(layers, round_bf16(points.to(torch.float32)),
                     packed.shared.final_tanh, out_rows)


def point_eval(packed: PackedFolded, points: torch.Tensor, block: int = 512,
               out_rows: int = 1, use_kernel: bool = True) -> torch.Tensor:
    """Evaluate a packed folded decoder at points [N, 3] fp32 -> [N] fp32
    (out_rows == 1), or its first out_rows outputs [N, out_rows] (3 for an
    RGB head). Forward only: no gradient reaches the points. A CUDA tensor
    launches K5; a CPU tensor, or use_kernel=False, runs the plain
    version. ``block`` (the TPU kernel's block width) has no effect: the
    CUDA grid is one block per 64-point tile."""
    if out_rows not in (1, 3):
        raise ValueError(f"out_rows must be 1 or 3, got {out_rows}")
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {tuple(points.shape)}")
    points = points.detach()
    if not (use_kernel and points.is_cuda):
        return point_eval_plain(packed, points, out_rows)
    n = points.shape[0]
    check_cuda_inputs(packed.shared, packed.bias, points)
    check_mma_plan(packed.shared, points.device)
    shape = (n,) if out_rows == 1 else (n, out_rows)
    out = torch.empty(shape, dtype=torch.float32, device=points.device)
    w, tab, n_layers, bias_ptr, stride, tanh = march_args(packed.shared, packed.bias)
    build.load().call("drt_point_eval", build.ptr(points), n, w,
                      build.ptr(packed.shared.tiles), build.ptr(packed.shared.wrows),
                      build.ptr(packed.shared.wscale),
                      tab, n_layers, bias_ptr, stride,
                      tanh, out_rows, build.ptr(out),
                      build.stream_of(points))
    point_eval.launches += 1
    return out


point_eval.launches = 0


def _live_tiles(active: torch.Tensor, tile: int = 32) -> torch.Tensor:
    """[n] bool: the point's 32-point tile holds an active point."""
    n = active.shape[0]
    pad = (-n) % tile
    a = torch.cat([active, active.new_zeros(pad)]) if pad else active
    return a.reshape(-1, tile).any(dim=1).repeat_interleave(tile)[:n]


def point_eval_banked_plain(shared, bank: torch.Tensor, frame_of_block: torch.Tensor,
                            points: torch.Tensor, active: torch.Tensor,
                            block: int = 512, precise_x: bool = True) -> torch.Tensor:
    """The plain PyTorch version of K6 (see point_eval_banked): the points
    of live 32-point tiles evaluated frame by frame, each frame's bias
    column one row broadcast over its points."""
    n = points.shape[0]
    p = points.to(torch.float32)
    hi = round_bf16(p)
    lo = round_bf16(p - hi) if precise_x else None
    frame = frame_of_block.to(torch.int64).repeat_interleave(block)[:n]
    live = _live_tiles(active.to(torch.bool))
    out = torch.full((n,), POS_BIG, dtype=torch.float32, device=points.device)
    for f in torch.unique(frame[live]).tolist():
        rows = torch.nonzero(live & (frame == f)).reshape(-1)
        layers = plain_layers(shared, bank, frame[rows[:1]], True)
        out[rows] = mlp_apply(layers, hi[rows], shared.final_tanh,
                              p_lo=None if lo is None else lo[rows])
    return out


def point_eval_banked(shared, bank: torch.Tensor, frame_of_block: torch.Tensor,
                      points: torch.Tensor, active: torch.Tensor, block: int = 512,
                      precise_x: bool = True, use_kernel: bool = True) -> torch.Tensor:
    """Multi-frame point evaluation against the shared-weights + bias-bank
    packing of a decoder (the JAX package's ``pallas_point_eval_banked``):
    points [n, 3] fp32, frame-major, n a multiple of ``block``; each block
    of points reads the bank column frame_of_block[i] (int, [n // block])
    of bank [total, F_pad]; active [n] bool. Returns [n] fp32 values,
    +POS_BIG (3e38) on every point of a 32-point tile with no active point.
    precise_x splits each position into bf16 high and low halves. A CUDA
    tensor launches K6; a CPU tensor, or use_kernel=False, runs the plain
    version. Forward only."""
    n = points.shape[0]
    if n % block:
        raise ValueError(f"point count {n} not a multiple of block {block}")
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [n, 3], got {tuple(points.shape)}")
    if frame_of_block.shape != (n // block,) or active.shape != (n,):
        raise ValueError("frame_of_block must be [n // block] and active [n]")
    if frame_of_block.numel():
        lo, hi = (int(x) for x in torch.aminmax(frame_of_block))
        if lo < 0 or hi >= bank.shape[1]:
            raise ValueError(f"frame_of_block holds columns {lo}..{hi} of a bank "
                             f"with {bank.shape[1]}")
    points = points.detach()
    if not (use_kernel and points.is_cuda):
        return point_eval_banked_plain(shared, bank, frame_of_block, points, active,
                                       block, precise_x)
    check_cuda_inputs(shared, bank, points)
    check_mma_plan(shared, points.device)
    act = active.to(torch.bool).contiguous()
    fob = frame_of_block.to(torch.int32).contiguous()
    if act.device != points.device or fob.device != points.device:
        raise ValueError("CUDA kernel inputs must be CUDA tensors on one device")
    out = torch.empty((n,), dtype=torch.float32, device=points.device)
    w, tab, n_layers, bank_ptr, stride, tanh = march_args(shared, bank)
    build.load().call("drt_point_eval_banked", build.ptr(points), build.ptr(act),
                      build.ptr(fob), block, n, w, build.ptr(shared.tiles),
                      build.ptr(shared.wrows), build.ptr(shared.wscale), tab,
                      n_layers, bank_ptr, stride, tanh, int(precise_x), build.ptr(out),
                      build.stream_of(points))
    point_eval_banked.launches += 1
    return out


point_eval_banked.launches = 0


def _flat_points(points: torch.Tensor) -> torch.Tensor:
    return points.reshape(-1, 3).to(torch.float32).contiguous()


def make_pallas_point_fn(params: Params, latent: torch.Tensor,
                         cfg: DecoderConfig = DecoderConfig(), block: int = 512,
                         use_kernel: bool = True):
    """(points [..., 3]) -> sdf [...] through K5, the latent folded in
    once: a forward-only drop-in for models.folded.make_point_fn's
    function. use_kernel=False runs K5's plain version."""
    packed = pack_folded(fold_latent(params, latent.detach(), cfg), cfg)

    def point_fn(points):
        return point_eval(packed, _flat_points(points), block,
                          use_kernel=use_kernel).reshape(points.shape[:-1])

    return point_fn


def make_pallas_color_fn(params: Params, latent: torch.Tensor,
                         cfg: DecoderConfig, block: int = 512,
                         use_kernel: bool = True):
    """(points [..., 3]) -> RGB [..., 3] in [0, 1] through K5 (3 output
    rows, the sigmoid applied outside): a forward-only drop-in for
    models.color_decoder.color_apply with a bound latent. For a
    differentiable color head use recompute.make_color_vjp."""
    packed = pack_folded(fold_latent(params, latent.detach(), cfg), cfg)

    def color_fn(points):
        logits = point_eval(packed, _flat_points(points), block, out_rows=3,
                            use_kernel=use_kernel)
        return torch.sigmoid(logits).reshape(points.shape[:-1] + (3,))

    return color_fn
