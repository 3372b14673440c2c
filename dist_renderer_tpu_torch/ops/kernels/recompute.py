"""Fused precise recompute (K3): the precise SDF value, the spatial
gradient g = ds/dx and the directional derivative dd = <g, v> of each
point, in one evaluation.

Replaces the JAX package's ``ops/pallas/recompute.py::precise_sdg_call``
(``_make_fwd_kernel``: ``_forward``, ``_seed_last``, ``_reverse``). The
renderer takes the IFT depth denominator and the normals from it.

Rounding points (the JAX kernel's):
  - layers that consume the raw input (layer 0 and the skip layer) use a
    bf16 hi/lo split: W_hi.x_hi + W_lo.x_hi + W_hi.x_lo, on both their
    hidden input and the xyz input, accumulated in fp32;
  - other hidden layers take one bf16 product (bf16 W, bf16(h));
  - the reverse sweep multiplies bf16(delta) by bf16 W in its original
    orientation, accumulated in fp32, and gates by the forward's ReLU
    masks.

``precise_sdg_call`` launches ``csrc/recompute.cu`` on a CUDA tensor and
runs ``precise_sdg_plain`` on a CPU tensor or with ``use_kernel=False``.
Forward only: the cotangent-seeded backward (the latent gradient)
arrives with its own kernel, and then this becomes a
``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import Params, dot_f32, round_bf16
from dist_renderer_tpu_torch.ops.camera import dot3
from dist_renderer_tpu_torch.ops.kernels import build


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
    the CUDA layout: one bf16 buffer holding, per layer, the forward
    weights input-major ([in_p][out_p]: hi, then lo for split layers), the
    reverse weights output-major ([out_p][in_p]) and the x weights
    ([3][out_p] hi, then lo); ``table`` starts with (use_tanh,
    final_tanh) and holds per layer (out_p, in_p, split, fwd_hi, fwd_lo,
    rev, wx_hi, wx_lo, bias offset), -1 = absent. ``wz`` keeps
    (layer, W_z [L, out]) for the latent fold."""

    meta: Tuple[LayerMeta, ...]
    layers: Tuple[dict, ...]
    wz: Tuple[Tuple[int, torch.Tensor], ...]
    use_tanh: bool
    final_tanh: bool
    flat: torch.Tensor
    table: Tuple[int, ...]


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
        fwd_hi = fwd_lo = rev = wx_hi = wx_lo = -1
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
                fwd_lo = put(lo)
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
        table += [out_p, in_p, int(split), fwd_hi, fwd_lo, rev, wx_hi, wx_lo,
                  bias_off]
        bias_off += out_p
        prev_out_p = out_p
    return PackedPrecise(tuple(meta), tuple(layers), tuple(wz_list),
                         cfg.use_tanh, cfg.final_tanh,
                         torch.cat(flat).contiguous(), tuple(table))


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


def precise_sdg_plain(packed: PackedPrecise, biases, points: torch.Tensor,
                      dirs: torch.Tensor, block: int = 512):
    """The plain PyTorch version of K3 -> (s [N], dd [N], g [N, 3])."""
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
    pre0 = h[:, 0]
    s = pre0
    if packed.use_tanh:
        s = torch.tanh(s)
    if packed.final_tanh:
        s = torch.tanh(s)

    # reverse seed at the last preactivation: row 0 = the tanh chain
    dchain = torch.ones_like(s)
    if packed.use_tanh:
        t1 = torch.tanh(pre0)
        dchain = dchain * (1.0 - t1 * t1)
    if packed.final_tanh:
        dchain = dchain * (1.0 - s * s)
    delta = torch.zeros_like(h)
    delta[:, 0] = dchain
    gx = None
    for i in range(len(meta) - 1, -1, -1):
        m, ops = meta[i], packed.layers[i]
        db = round_bf16(delta)
        if m.has_wx:
            c = dot_f32(db, ops["wx_hi"].T)
            gx = c if gx is None else gx + c
        if not m.has_wh:
            break
        delta = dot_f32(db, ops["wh_hi"].T) * gates[i - 1].to(torch.float32)
    return s, dot3(gx, dirs), gx


def precise_sdg_call(packed: PackedPrecise, biases, points: torch.Tensor,
                     dirs: torch.Tensor, block: int = 512,
                     use_kernel: bool = True):
    """(s, dd, g) for points/dirs [N, 3] fp32. A CUDA tensor launches K3;
    a CPU tensor, or use_kernel=False, runs the plain version. ``block``
    only steered the TPU's scheduling and has no effect."""
    if not (use_kernel and points.is_cuda):
        return precise_sdg_plain(packed, biases, points, dirs, block)
    n = points.shape[0]
    bias = torch.cat([b.reshape(-1) for b in biases]).contiguous()
    for t in (points, dirs, bias):
        if t.device != points.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("precise_sdg_call takes contiguous float32 "
                             "tensors on one CUDA device")
    if points.shape != (n, 3) or dirs.shape != (n, 3):
        raise ValueError("points and dirs must both be [N, 3]")
    if packed.flat.device != points.device:
        raise ValueError("packed weights must sit on the points' device")
    out = torch.empty((5, n), dtype=torch.float32, device=points.device)
    tab = (ctypes.c_int * len(packed.table))(*packed.table)
    lib = build.load()
    lib.call("drt_precise_sdg", build.ptr(points), build.ptr(dirs), n,
             build.ptr(packed.flat), build.ptr(bias), tab, len(packed.meta),
             build.ptr(out), build.stream_of(points))
    precise_sdg_call.launches += 1
    # g contiguous [N, 3] like the plain version's: a reduction over it
    # (the normal's length) then runs the same way on either
    return out[0], out[1], out[2:5].T.contiguous()


precise_sdg_call.launches = 0
