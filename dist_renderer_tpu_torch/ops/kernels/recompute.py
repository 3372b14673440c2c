"""Fused precise recompute (K3): the precise SDF value, the spatial
gradient g = ds/dx and the directional derivative dd = <g, v> of each
point, in one evaluation; and its cotangent-seeded backward (K4).

Replaces the JAX package's ``ops/pallas/recompute.py::precise_sdg_call``
(``_make_fwd_kernel``: ``_forward``, ``_seed_last``, ``_reverse``) and
``precise_bias_grads_call`` (``_make_bwd_kernel``). The renderer takes
the IFT depth denominator and the normals from K3, and the gradients of
depth and margins to the latent and the points from K4, through
``make_precise_sdg``'s ``torch.autograd.Function``.

Rounding points (the JAX kernel's):
  - layers that consume the raw input (layer 0 and the skip layer) use a
    bf16 hi/lo split: W_hi.x_hi + W_lo.x_hi + W_hi.x_lo, on both their
    hidden input and the xyz input, accumulated in fp32;
  - other hidden layers take one bf16 product (bf16 W, bf16(h));
  - the reverse sweep multiplies bf16(delta) by bf16 W in its original
    orientation, accumulated in fp32, and gates by the forward's ReLU
    masks.

``precise_sdg_call`` and ``precise_bias_grads_call`` launch
``csrc/recompute.cu`` on a CUDA tensor and run their plain versions
(``precise_sdg_plain``, ``precise_bias_grads_plain``, which share the
forward and the reverse sweep as the kernels do) on a CPU tensor or with
``use_kernel=False``.

The kernels run on Hopper's tensor cores (``csrc/point_mlp.cuh``'s
machinery): 64-point tiles on a persistent grid, every hidden product of
the forward and of the reverse as wgmma N-chunks over all of K, the
weights streamed from ``PackedPrecise.ftiles`` and ``.rtiles``. A value
whose gate or bf16 rounding the tensor cores' summation order may have
moved (within ``NEAR_TIE * 2^-24 * |w| |h|``, the scales in ``fscale``
and ``rscale``) is summed again in the plain version's order, so s, dd,
g and gx are the in-order plain version's bits up to a tie the empirical
margin misses. The layer feeding a split layer runs on CUDA cores in k
order: its consumer reads bf16(h - bf16(h)), whose boundaries put ~23%
of its values within the margin (settled one by one on the tensor cores,
K3 took 1.8x as long). K4 also computes the fp32 deltas u sums (the reverse of the
layer above each layer the latent enters) in o order on CUDA cores and
sums them per 32 points in the order of K4's CUDA-core kernel, so u keeps
its bits. What bounds them: the hidden weights streamed through shared
memory once forward and once in reverse per 64 points (6.5 MB for the
8x512 decoder), as for K5.

``precise_value_call`` is K3's value mode (``precise_value_kernel``):
K3's forward and s alone, no gates and no reverse, for points whose
gradient nobody reads (the renderer's misses where a frame's hits
overflow the compose bucket); its s is K3's bit for bit. It replaces no
TPU kernel.

``make_color_vjp`` is the differentiable color head: K5 (mlp_eval.py)
forward, K4 backward with 3 seed rows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import Params, dot_f32, round_bf16
from dist_renderer_tpu_torch.ops.camera import dot3
from dist_renderer_tpu_torch.ops.kernels import build
from dist_renderer_tpu_torch.ops.kernels.batched_march import NEAR_TIE, pack_mma_tiles
from dist_renderer_tpu_torch.utils.profiling import count

TILE = 64        # points per tensor-core tile (csrc/recompute.cu)
SUM_CHUNK = 64   # per-32-point partials K4 adds per thread, per pass
K4_SLOTS = 2     # K4's partial sums a tile: one per 32 points
# csrc/recompute.cu's plan: ring stages, near-tie queue entries, and the
# shared memory a block may use
RING_STAGES, QCAP, STAGE_BYTES, SMEM_LIMIT = 3, 1024, 16384, 232_448


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _split_pair(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 hi/lo split of an fp32 array (w == hi + lo to ~2^-16 rel)."""
    hi = w.to(torch.bfloat16)
    lo = (w - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


class LayerMeta(NamedTuple):
    has_wh: bool
    has_wx: bool
    split: bool      # bf16 hi/lo split products (layers consuming the input)
    takes_z: bool    # the latent enters this layer's bias
    out_p: int
    in_p: int        # padded h-input width (0 without a hidden input)


class PackedPrecise(NamedTuple):
    """Recompute weights. ``layers`` holds per layer the fp32 images of
    the bf16 operands the plain version multiplies: wh_hi/wh_lo
    [in_p, out_p] (forward), wx_hi/wx_lo [3, out_p]; the reverse reuses
    wh_hi and wx_hi in their original orientation. ``flat``/``table`` are
    the CUDA layout: one bf16 buffer holding, per layer, the hi weights
    input-major ([in_p][out_p]: the reverse's rows), for split layers the
    lo weights output-major ([out_p][in_p]: the forward's in-order rows),
    the hi weights output-major ([out_p][in_p]) and the x weights
    ([3][out_p] hi, then lo); ``table`` starts with (use_tanh,
    final_tanh) and holds per layer (out_p, in_p, split, fwd_hi, lo_rows,
    rev, wx_hi, wx_lo, bias offset), -1 = absent. ``wz`` keeps
    (layer, W_z [L, out]) for the latent fold.

    The tensor-core layout (``precise_mma``): ``ftiles`` and ``rtiles``
    the forward's and the reverse's weight tiles in stream order,
    ``fscale`` and ``rscale`` fp32 near-tie scales at the bias rows
    (forward: the layer's own; reverse of layer l: layer l - 1's)."""

    meta: Tuple[LayerMeta, ...]
    layers: Tuple[dict, ...]
    wz: Tuple[Tuple[int, torch.Tensor], ...]
    use_tanh: bool
    final_tanh: bool
    flat: torch.Tensor
    table: Tuple[int, ...]
    ftiles: torch.Tensor
    rtiles: torch.Tensor
    fscale: torch.Tensor
    rscale: torch.Tensor


def pack_precise(params: Params, cfg: DecoderConfig) -> PackedPrecise:
    """Pack decoder weights for the recompute (latent-free)."""
    L = cfg.latent_size
    meta, layers, wz_list = [], [], []
    flat, table = [], [int(cfg.use_tanh), int(cfg.final_tanh)]
    flat_len = 0
    bias_off = 0
    n_layers = len(params["layers"])
    prev_out_p = 0
    f32 = torch.float32

    def put(t: torch.Tensor) -> int:
        nonlocal flat_len
        off = flat_len
        flat.append(t.reshape(-1))
        flat_len += t.numel()
        return off

    for i, layer in enumerate(params["layers"]):
        w = layer["w"].to(f32)
        dev = w.device
        out_dim = layer["b"].shape[0]
        out_p = _round_up(out_dim, 8)
        takes_z = i == 0 or i in cfg.latent_in
        split = takes_z
        if i == 0:
            wz, wx, wh = w[:L], w[L:L + 3], None
        elif i in cfg.latent_in:
            dh = w.shape[0] - L - 3
            wh, wz, wx = w[:dh], w[dh:dh + L], w[dh + L:]
        elif cfg.xyz_in_all and i < n_layers - 1:
            wh, wz, wx = w[:-3], None, w[-3:]
        else:
            wh, wz, wx = w, None, None
        if wz is not None:
            wz_list.append((i, wz))

        ops = {}
        in_p = 0
        fwd_hi = lo_rows = rev = wx_hi = wx_lo = -1
        if wh is not None:
            in_dim = wh.shape[0]
            in_p = prev_out_p if prev_out_p else _round_up(in_dim, 8)
            wp = torch.zeros((in_p, out_p), dtype=f32, device=dev)
            wp[:in_dim, :out_dim] = wh
            hi, lo = _split_pair(wp)
            ops["wh_hi"] = hi.to(f32)
            fwd_hi = put(hi)
            if split:
                ops["wh_lo"] = lo.to(f32)
                lo_rows = put(lo.T.contiguous())
            rev = put(hi.T.contiguous())
        if wx is not None:
            wp = torch.zeros((3, out_p), dtype=f32, device=dev)
            wp[:, :out_dim] = wx
            hi, lo = _split_pair(wp)
            ops["wx_hi"], ops["wx_lo"] = hi.to(f32), lo.to(f32)
            wx_hi, wx_lo = put(hi), put(lo)
        meta.append(LayerMeta(wh is not None, wx is not None, split, takes_z,
                              out_p, in_p))
        layers.append(ops)
        table += [out_p, in_p, int(split), fwd_hi, lo_rows, rev, wx_hi, wx_lo,
                  bias_off]
        bias_off += out_p
        prev_out_p = out_p
    return PackedPrecise(tuple(meta), tuple(layers), tuple(wz_list),
                         cfg.use_tanh, cfg.final_tanh,
                         torch.cat(flat).contiguous(), tuple(table),
                         *precise_mma(tuple(meta), tuple(layers)))


def exact_layers(meta) -> Tuple[bool, ...]:
    """Per layer: computed on CUDA cores in k order by the kernels (layer
    0, which has no hidden input, and a layer whose consumer splits its
    input); the others' hidden products run on the tensor cores."""
    n = len(meta)
    return tuple(i == 0 or (i + 1 < n and meta[i + 1].split) for i in range(n))


def fwd_mma_mats(meta, layers):
    """The forward's B matrices, [out_p, K] bf16 per tensor-core layer
    (None elsewhere, the last layer included): K = round_up(in_p, 16) of
    W_hi^T, and for a split layer three such blocks, W_hi^T, W_lo^T,
    W_hi^T, against its input read as [hi | hi | lo]."""
    exact = exact_layers(meta)
    mats = []
    for i, (m, ops) in enumerate(zip(meta, layers)):
        if exact[i] or i == len(meta) - 1:
            mats.append(None)
            continue
        kh = _round_up(m.in_p, 16)
        blocks = [ops["wh_hi"], ops["wh_lo"], ops["wh_hi"]] if m.split else [ops["wh_hi"]]
        mat = torch.zeros((m.out_p, kh * len(blocks)), dtype=torch.float32,
                          device=ops["wh_hi"].device)
        for j, w in enumerate(blocks):
            mat[:, j * kh:j * kh + m.in_p] = w.T
        mats.append(mat.to(torch.bfloat16))
    return mats


def rev_mma_mats(meta, layers):
    """The reverse's B matrices in stream order, layers L-1 down to 1:
    W_hi [in_p, out_p] bf16 (N = in_p, K = out_p)."""
    return [layers[i]["wh_hi"].to(torch.bfloat16) for i in range(len(meta) - 2, 0, -1)]


def precise_mma(meta, layers):
    """(ftiles, rtiles, fscale, rscale): the kernels' tensor-core
    layout of the packed weights (see PackedPrecise), built once per
    packing."""
    dev = layers[-1]["wh_hi"].device
    offs = [0]
    for m in meta:
        offs.append(offs[-1] + m.out_p)
    fmats = fwd_mma_mats(meta, layers)
    unit = NEAR_TIE * 2.0 ** -24
    fscale = torch.zeros(offs[-1], dtype=torch.float32, device=dev)
    rscale = torch.zeros(offs[-1], dtype=torch.float32, device=dev)
    for i, mat in enumerate(fmats):
        if mat is not None:
            fscale[offs[i]:offs[i + 1]] = unit * torch.linalg.vector_norm(
                mat.to(torch.float32), dim=1)
    for i in range(1, len(meta) - 1):
        rscale[offs[i - 1]:offs[i]] = unit * torch.linalg.vector_norm(
            layers[i]["wh_hi"], dim=1)
    return (pack_mma_tiles(fmats).to(dev), pack_mma_tiles(rev_mma_mats(meta, layers)).to(dev),
            fscale, rscale)


def gate_words(meta) -> int:
    """The kernels' gate bitmask words a tile: [64][ceil(out_p / 32)] for
    every layer but the last."""
    return sum(TILE * ((m.out_p + 31) // 32) for m in meta[:-1])


def act_width(meta) -> int:
    """The kernels' activation buffer width: every layer's outputs and
    inputs rounded up to 16, a split layer's input twice ([hi | lo])."""
    w = 16
    for m in meta:
        w = max(w, _round_up(m.out_p, 16),
                (2 if m.split and m.has_wh else 1) * _round_up(m.in_p, 16))
    return w


def precise_smem_bytes(packed: PackedPrecise) -> int:
    """The dynamic shared memory K3 and K4 ask for with this decoder:
    csrc/recompute.cu's smem_plan (two [64, w16] bf16 activation buffers,
    the weight ring, the gates, a layer's biases and near-tie scales,
    positions, directions, the xyz gradient, row 0's preactivation and s,
    row norms, the near-tie queue and its overflow bits, barriers). The
    kernels' own sum, drt_precise_smem, is held equal to this one on the
    card."""
    w16 = act_width(packed.meta)
    act = (2 * TILE * w16 * 2 + 1023) // 1024 * 1024
    return (act + RING_STAGES * STAGE_BYTES + 4 * gate_words(packed.meta) + 8 * w16
            + 4 * TILE * 15 + 4 * QCAP + 16 + TILE * w16 // 8 + 16 * RING_STAGES)


def mma_values(packed: PackedPrecise, n: int, k4: bool = False,
               value: bool = False) -> int:
    """The values K3 (or, with k4, K4; with value, K3's value mode, the
    forward alone) computes on the tensor cores for n points (the tiles'
    padded rows included): the near-tie queue's denominator. K4 runs the
    reverse of a layer on CUDA cores where the latent enters the layer
    below it."""
    meta, exact = packed.meta, exact_layers(packed.meta)
    per_row = sum(m.out_p for i, m in enumerate(meta[:-1]) if not exact[i])
    if not value:
        per_row += sum(m.in_p for i, m in enumerate(meta) if 0 < i < len(meta) - 1
                       and not (k4 and meta[i - 1].takes_z))
    return _round_up(max(n, 0), TILE) * per_row


def check_precise_plan(packed: PackedPrecise, device) -> None:
    """Raise if the packed weights are not on ``device`` or the
    shared-memory plan of K3 and K4 cannot hold the decoder."""
    bufs = (packed.flat, packed.ftiles, packed.rtiles, packed.fscale, packed.rscale)
    if any(t.device != device for t in bufs):
        raise ValueError("packed weights must sit on the points' device")
    need = precise_smem_bytes(packed)
    if need > SMEM_LIMIT:
        width = max(m.out_p for m in packed.meta)
        raise ValueError(f"a decoder of width {width} needs {need} bytes of shared memory "
                         f"per block for K3/K4, more than the {SMEM_LIMIT} an H100 block "
                         "can use")


def _k3_bias(name: str, packed: PackedPrecise, biases, points: torch.Tensor,
             *rows: torch.Tensor) -> torch.Tensor:
    """The folded biases as K3's one buffer, once the launch's points (and
    rows, [N, 3] each) pass its checks and the decoder's plan fits."""
    n = points.shape[0]
    bias = torch.cat([b.reshape(-1) for b in biases]).contiguous()
    for t in (points, *rows, bias):
        if t.device != points.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors on one "
                             "CUDA device")
    if any(t.shape != (n, 3) for t in (points, *rows)):
        raise ValueError(f"{name}: points{' and dirs' if rows else ''} must be [N, 3]")
    check_precise_plan(packed, points.device)
    return bias


def _mma_ptrs(packed: PackedPrecise):
    return (build.ptr(packed.flat), build.ptr(packed.ftiles), build.ptr(packed.rtiles),
            build.ptr(packed.fscale), build.ptr(packed.rscale))


def fold_bias_precise(params: Params, latent: torch.Tensor,
                      cfg: DecoderConfig,
                      packed: PackedPrecise) -> Tuple[torch.Tensor, ...]:
    """Per-layer [out_p] fp32 biases with z @ W_z folded in by an fp32
    product (the JAX package's bf16x3 split fold is its TPU counterpart)."""
    wz = dict(packed.wz)
    z = latent.reshape(1, -1).to(torch.float32)
    cols = []
    for i, (layer, m) in enumerate(zip(params["layers"], packed.meta)):
        b = layer["b"].to(torch.float32)
        if i in wz:
            b = (z @ wz[i] + b)[0]
        col = torch.zeros(m.out_p, dtype=torch.float32, device=b.device)
        col[:b.shape[0]] = b
        cols.append(col)
    return tuple(cols)


def _forward_plain(packed: PackedPrecise, biases, points: torch.Tensor):
    """The precise forward: (last layer's preactivation [N, out_p], the
    hidden layers' ReLU gates)."""
    x = points.to(torch.float32)
    xi = round_bf16(x)
    xl = round_bf16(x - xi)
    meta = packed.meta
    h = None
    gates = []
    for i, (m, ops) in enumerate(zip(meta, packed.layers)):
        acc = biases[i][None, :]
        if m.has_wh:
            if m.split:
                hi = round_bf16(h)
                lo = round_bf16(h - hi)
                acc = acc + dot_f32(hi, ops["wh_hi"])
                acc = acc + dot_f32(hi, ops["wh_lo"])
                acc = acc + dot_f32(lo, ops["wh_hi"])
            else:
                acc = acc + dot_f32(round_bf16(h), ops["wh_hi"])
        if m.has_wx:
            acc = acc + dot_f32(xi, ops["wx_hi"])
            acc = acc + dot_f32(xi, ops["wx_lo"])
            acc = acc + dot_f32(xl, ops["wx_hi"])
        if i < len(meta) - 1:
            gates.append(acc > 0.0)
            h = torch.relu(acc)
        else:
            h = acc
    return h, gates


def _seed_last(packed: PackedPrecise, pre: torch.Tensor, seed: torch.Tensor):
    """(s, delta): the SDF value from row 0 of the last preactivation, and
    the reverse seed there, ``seed`` times the tanh chain, on row 0."""
    pre0 = pre[:, 0]
    s = pre0
    if packed.use_tanh:
        s = torch.tanh(s)
    if packed.final_tanh:
        s = torch.tanh(s)
    dchain = seed
    if packed.use_tanh:
        t1 = torch.tanh(pre0)
        dchain = dchain * (1.0 - t1 * t1)
    if packed.final_tanh:
        dchain = dchain * (1.0 - s * s)
    delta = torch.zeros_like(pre)
    delta[:, 0] = dchain
    return s, delta


def _reverse_plain(packed: PackedPrecise, gates, delta: torch.Tensor,
                   want_gx: bool, want_u: bool):
    """The reverse sweep from the last layer's preactivation gradient:
    (gx [N, 3] or None, [u_l] for the layers the latent enters, in
    ascending order). u_l sums delta_l over the points in fp64, rounded
    once to fp32, as K4 does."""
    meta = packed.meta
    gx = None
    us = []
    for i in range(len(meta) - 1, -1, -1):
        m, ops = meta[i], packed.layers[i]
        if want_u and m.takes_z:
            us.append(delta.to(torch.float64).sum(0).to(torch.float32))
        db = round_bf16(delta)
        if want_gx and m.has_wx:
            c = dot_f32(db, ops["wx_hi"].T)
            gx = c if gx is None else gx + c
        if not m.has_wh:
            break
        delta = dot_f32(db, ops["wh_hi"].T) * gates[i - 1].to(torch.float32)
    us.reverse()
    return gx, us


def precise_sdg_plain(packed: PackedPrecise, biases, points: torch.Tensor,
                      dirs: torch.Tensor, block: int = 512):
    """The plain PyTorch version of K3 -> (s [N], dd [N], g [N, 3])."""
    pre, gates = _forward_plain(packed, biases, points)
    s, delta = _seed_last(packed, pre, torch.ones_like(pre[:, 0]))
    gx, _ = _reverse_plain(packed, gates, delta, True, False)
    return s, dot3(gx, dirs), gx


def precise_sdg_call(packed: PackedPrecise, biases, points: torch.Tensor,
                     dirs: torch.Tensor, block: int = 512,
                     use_kernel: bool = True):
    """(s, dd, g) for points/dirs [N, 3] fp32. A CUDA tensor launches K3;
    a CPU tensor, or use_kernel=False, runs the plain version. ``block``
    only steered the TPU's scheduling and has no effect."""
    count("k3_points", points.shape[0])
    if not (use_kernel and points.is_cuda):
        return precise_sdg_plain(packed, biases, points, dirs, block)
    n = points.shape[0]
    bias = _k3_bias("precise_sdg_call", packed, biases, points, dirs)
    out = torch.empty((5, n), dtype=torch.float32, device=points.device)
    ties = torch.zeros(2, dtype=torch.int32, device=points.device)
    tab = (ctypes.c_int * len(packed.table))(*packed.table)
    lib = build.load()
    lib.call("drt_precise_sdg", build.ptr(points), build.ptr(dirs), n,
             *_mma_ptrs(packed), build.ptr(bias), tab, len(packed.meta),
             build.ptr(out), build.ptr(ties), build.stream_of(points))
    precise_sdg_call.launches += 1
    precise_sdg_call.ties = ties
    # g contiguous [N, 3] like the plain version's: a reduction over it
    # (the normal's length) then runs the same way on either
    return out[0], out[1], out[2:5].T.contiguous()


precise_sdg_call.launches = 0
# the last launch's [values queued as near ties, values past the queue]
precise_sdg_call.ties = None


def precise_value_plain(packed: PackedPrecise, biases, points: torch.Tensor):
    """The plain PyTorch version of K3's value mode -> s [N]: the s of
    precise_sdg_plain, from the same forward and seed."""
    pre, _ = _forward_plain(packed, biases, points)
    s, _ = _seed_last(packed, pre, torch.ones_like(pre[:, 0]))
    return s


def precise_value_call(packed: PackedPrecise, biases, points: torch.Tensor,
                       use_kernel: bool = True):
    """s [N] for points [N, 3] fp32: K3's value, bit for bit, from its
    forward alone. A CUDA tensor launches K3's value mode; a CPU tensor,
    or use_kernel=False, runs the plain version."""
    count("k3_value_points", points.shape[0])
    if not (use_kernel and points.is_cuda):
        return precise_value_plain(packed, biases, points)
    n = points.shape[0]
    bias = _k3_bias("precise_value_call", packed, biases, points)
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    ties = torch.zeros(2, dtype=torch.int32, device=points.device)
    tab = (ctypes.c_int * len(packed.table))(*packed.table)
    lib = build.load()
    lib.call("drt_precise_value", build.ptr(points), n, *_mma_ptrs(packed),
             build.ptr(bias), tab, len(packed.meta), build.ptr(out), build.ptr(ties),
             build.stream_of(points))
    precise_value_call.launches += 1
    precise_value_call.ties = ties
    return out


precise_value_call.launches = 0
precise_value_call.ties = None


def _seed_cols(ct: torch.Tensor, n: int) -> torch.Tensor:
    """ct [N] or [N, seed_rows] -> contiguous fp32 [N, seed_rows]."""
    if ct.shape[0] != n or ct.ndim not in (1, 2):
        raise ValueError("ct must be [N] or [N, seed_rows] for N points")
    return (ct[:, None] if ct.ndim == 1 else ct).to(torch.float32).contiguous()


def precise_bias_grads_plain(packed: PackedPrecise, biases,
                             points: torch.Tensor, ct: torch.Tensor,
                             block: int = 512, scalar_chain: bool = True,
                             want_gx: bool = False):
    """The plain PyTorch version of K4 (see precise_bias_grads_call)."""
    pre, gates = _forward_plain(packed, biases, points)
    cols = _seed_cols(ct, points.shape[0])
    if scalar_chain:
        _, delta = _seed_last(packed, pre, cols[:, 0])
    else:
        delta = torch.zeros_like(pre)
        delta[:, :cols.shape[1]] = cols
    gx, us = _reverse_plain(packed, gates, delta, want_gx, True)
    return (us, gx) if want_gx else us


def precise_bias_grads_call(packed: PackedPrecise, biases,
                            points: torch.Tensor, ct: torch.Tensor,
                            block: int = 512, use_kernel: bool = True,
                            scalar_chain: bool = True, want_gx: bool = False):
    """Cotangent-weighted bias gradients u_l = sum over points of delta_l,
    one [out_p] fp32 vector for each layer the latent enters (ascending
    layer order), where delta_l is the preactivation gradient of layer l
    in a reverse sweep seeded by ``ct``:

      - scalar_chain=True: ct [N] (or the first column of [N, rows])
        seeds row 0 of the last layer through the tanh chain (the sdg's
        value s);
      - scalar_chain=False: ct [N, seed_rows] are the preactivation
        cotangents of the last layer's first seed_rows rows.

    With want_gx, returns (us, gx) where gx [N, 3] is the ct-weighted
    gradient to each point's xyz. The sum over points is taken in fp64 in
    a fixed order and rounded once, so two launches agree bit for bit. A
    CUDA tensor launches K4; a CPU tensor, or use_kernel=False, runs the
    plain version. ``block`` only steered the TPU and has no effect."""
    if not (use_kernel and points.is_cuda):
        return precise_bias_grads_plain(packed, biases, points, ct, block,
                                        scalar_chain, want_gx)
    n = points.shape[0]
    meta = packed.meta
    cols = _seed_cols(ct, n)
    bias = torch.cat([b.reshape(-1) for b in biases]).contiguous()
    for t in (points, cols, bias):
        if t.device != points.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("precise_bias_grads_call takes contiguous "
                             "float32 tensors on one CUDA device")
    if points.shape != (n, 3):
        raise ValueError("points must be [N, 3]")
    if cols.shape[1] > meta[-1].out_p:
        raise ValueError(f"ct has {cols.shape[1]} seed rows; the last layer "
                         f"has {meta[-1].out_p}")
    check_precise_plan(packed, points.device)
    dev = points.device
    u_rows = sum(m.out_p for m in meta if m.takes_z)
    slots = k4_slots(n)
    partials = torch.empty(slots * u_rows, dtype=torch.float64, device=dev)
    scratch = torch.empty(((slots + SUM_CHUNK - 1) // SUM_CHUNK) * u_rows,
                          dtype=torch.float64, device=dev)
    u = torch.empty(u_rows, dtype=torch.float32, device=dev)
    gx = torch.empty((n, 3), dtype=torch.float32, device=dev) if want_gx else None
    ties = torch.zeros(2, dtype=torch.int32, device=dev)
    tab = (ctypes.c_int * len(packed.table))(*packed.table)
    lib = build.load()
    lib.call("drt_precise_bias_grads", build.ptr(points), build.ptr(cols), n,
             cols.shape[1], int(scalar_chain), *_mma_ptrs(packed),
             build.ptr(bias), tab, len(meta),
             build.ptr(gx) if want_gx else None, build.ptr(partials),
             build.ptr(scratch), slots, SUM_CHUNK, build.ptr(u),
             build.ptr(ties), build.stream_of(points))
    precise_bias_grads_call.launches += 1
    precise_bias_grads_call.ties = ties
    us, off = [], 0
    for m in meta:
        if m.takes_z:
            us.append(u[off:off + m.out_p])
            off += m.out_p
    return (us, gx) if want_gx else us


precise_bias_grads_call.launches = 0
precise_bias_grads_call.ties = None


def k4_slots(n: int) -> int:
    """K4's partial sums for n points: one per 32 points of each 64-point
    tile (at least one tile, so n = 0 still has a buffer)."""
    return K4_SLOTS * max((n + TILE - 1) // TILE, 1)


def latent_grad(packed: PackedPrecise, us) -> torch.Tensor:
    """The latent's gradient from K4's u_l: sum_l W_z,l u_l (two small
    products, as the JAX package takes them outside its kernel)."""
    gz = None
    for (_, wz_l), u in zip(packed.wz, us):
        c = wz_l @ u[:wz_l.shape[1]]
        gz = c if gz is None else gz + c
    return gz


class _PreciseSDG(torch.autograd.Function):
    """(latent, points, dirs) -> (s, dd, g): K3 forward, K4 backward."""

    @staticmethod
    def forward(ctx, latent, points, dirs, params, cfg, packed, block,
                use_kernel):
        biases = fold_bias_precise(params, latent, cfg, packed)
        s, dd, g = precise_sdg_call(packed, biases, points, dirs, block,
                                    use_kernel=use_kernel)
        ctx.mark_non_differentiable(dd, g)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(points, g)
        ctx.biases, ctx.packed, ctx.block = biases, packed, block
        ctx.use_kernel = use_kernel
        ctx.latent_shape = latent.shape
        return s, dd, g

    @staticmethod
    def backward(ctx, ct_s, ct_dd, ct_g):
        # dd and g carry no gradient: their cotangents are dropped
        if ct_s is None:
            return (None,) * 8
        points, g = ctx.saved_tensors
        gz = gp = None
        if ctx.needs_input_grad[0]:
            us = precise_bias_grads_call(
                ctx.packed, ctx.biases, points.contiguous(),
                ct_s.to(torch.float32).contiguous(), ctx.block,
                use_kernel=ctx.use_kernel)
            gz = latent_grad(ctx.packed, us).reshape(ctx.latent_shape)
        if ctx.needs_input_grad[1]:
            gp = ct_s[:, None] * g
        return gz, gp, None, None, None, None, None, None


def make_precise_sdg(params: Params, cfg: DecoderConfig, block: int = 512,
                     use_kernel: bool = True,
                     packed: Optional[PackedPrecise] = None):
    """(latent [L], points [N, 3], dirs [N, 3]) -> (s, dd, g), with a
    backward.

    s is differentiable to the latent and the points: d s / d points = g
    (already computed), and the latent, which enters only through the
    folded biases, gets sum_l W_z,l u_l from K4 and two small products.
    dd and g are value-exact but carry no gradient (the renderer takes
    the IFT denominator and the normals from them as constants). dirs
    gets no gradient. The decoder parameters are constants here: they
    get no gradient, as in the JAX package, where they are closed over.

    ``sdg.value(latent, points)`` is s alone (K3's value mode), with no
    gradient.

    A CUDA tensor launches K3 forward and K4 backward; a CPU tensor, or
    use_kernel=False, runs their plain versions."""
    if packed is None:
        packed = pack_precise(params, cfg)

    def one_latent(latent):
        if latent.ndim != 1:
            raise ValueError(
                "precise_sdg folds ONE latent per call (got shape "
                f"{tuple(latent.shape)})")

    def sdg(latent, points, dirs):
        one_latent(latent)
        return _PreciseSDG.apply(latent, points, dirs, params, cfg, packed,
                                 block, use_kernel)

    @torch.no_grad()
    def value(latent, points):
        one_latent(latent)
        biases = fold_bias_precise(params, latent, cfg, packed)
        return precise_value_call(packed, biases, points, use_kernel=use_kernel)

    sdg.value = value
    return sdg


class _ColorVJP(torch.autograd.Function):
    """(latent, points) -> RGB: K5 forward (3 rows, then the sigmoid), K4
    backward (the sigmoid's preactivation cotangents as 3 seed rows)."""

    @staticmethod
    def forward(ctx, latent, points, params, cfg, shared, packed, block,
                use_kernel):
        from dist_renderer_tpu_torch.models.folded import fold_latent
        from dist_renderer_tpu_torch.ops.kernels.fused_march import pack_folded
        from dist_renderer_tpu_torch.ops.kernels.mlp_eval import point_eval

        folded = pack_folded(fold_latent(params, latent.detach(), cfg), cfg, shared)
        rgb = torch.sigmoid(point_eval(folded, points.contiguous(), block,
                                       out_rows=3, use_kernel=use_kernel))
        ctx.save_for_backward(latent, points, rgb)
        ctx.params, ctx.cfg, ctx.packed = params, cfg, packed
        ctx.block, ctx.use_kernel = block, use_kernel
        return rgb

    @staticmethod
    def backward(ctx, ct):
        latent, points, rgb = ctx.saved_tensors
        ct_pre = ct * rgb * (1.0 - rgb)  # the sigmoid's derivative
        biases = fold_bias_precise(ctx.params, latent, ctx.cfg, ctx.packed)
        us, gx = precise_bias_grads_call(
            ctx.packed, biases, points.contiguous(), ct_pre, ctx.block,
            use_kernel=ctx.use_kernel, scalar_chain=False, want_gx=True)
        gz = (latent_grad(ctx.packed, us).reshape(latent.shape)
              if ctx.needs_input_grad[0] else None)
        gp = gx if ctx.needs_input_grad[1] else None
        return gz, gp, None, None, None, None, None, None


def make_color_vjp(params: Params, cfg: DecoderConfig, block: int = 512,
                   use_kernel: bool = True):
    """(latent [L], points [N, 3]) -> RGB [N, 3] with a backward: the
    differentiable color head (photometric losses reach the texture latent
    and, through the surface points, the geometry and the pose).

    Forward: K5 with 3 output rows and the sigmoid outside, bf16 like the
    march. Backward: one K4 sweep seeded by the sigmoid's preactivation
    cotangents (scalar_chain=False), giving the latent's bias-path
    gradient and the points' gradient together. The decoder parameters
    get no gradient. The head must end in a sigmoid, not a tanh
    (models/color_decoder.py's convention). use_kernel=False runs both
    kernels' plain versions; a CPU tensor runs them regardless."""
    if cfg.final_tanh or cfg.use_tanh:
        raise ValueError("make_color_vjp expects a sigmoid-output head "
                         "(final_tanh=False, use_tanh=False)")
    from dist_renderer_tpu_torch.ops.kernels.batched_march import pack_shared

    shared = pack_shared(params, cfg)
    packed = pack_precise(params, cfg)

    def rgb_fn(latent, points):
        if latent.ndim != 1:
            raise ValueError("make_color_vjp folds one latent per call (got "
                             f"shape {tuple(latent.shape)})")
        return _ColorVJP.apply(latent, points, params, cfg, shared, packed,
                               block, use_kernel)

    return rgb_fn
