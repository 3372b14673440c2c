"""DeepSDF latent-conditioned MLP decoder on plain torch tensors.

Params keep the JAX package's layout, ``{"layers": [{"w": [in, out],
"b": [out]}, ...]}``, so weights carry across with ``params_from_numpy``.

Precision: the JAX package's precise value path uses a bf16x3 split
(``_matmul_split``) because fp32 products were not available on its TPU
compile service. Its counterpart here is a plain fp32 product with TF32
switched off (``torch.backends.*.allow_tf32 = False``, set by
``decoder_apply``'s callers through ``set_fp32_matmul``). The one
exception is ``decoder_apply_with_dd``, the hit finalize's evaluation,
which keeps the JAX package's roundings: its value and slope decide
which proxy hits are demoted, and an fp32 pass demotes other rays.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from dist_renderer_tpu_torch.config import DecoderConfig

Params = Dict[str, Any]


def set_fp32_matmul() -> None:
    """Make float32 products full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_decoder_params(generator: torch.Generator, cfg: DecoderConfig,
                        device="cpu", dtype: torch.dtype = torch.float32
                        ) -> Params:
    """He-style init (std sqrt(2 / d_in), zero biases), the JAX package's
    ``init_decoder_params``. The draws come from ``generator`` on its own
    device and move to ``device``, so one seed gives one set of weights
    on any device; they differ from the JAX package's for the same seed."""
    layers = []
    for d_in, d_out in cfg.layer_dims:
        w = torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                        device=generator.device) * float(np.sqrt(2.0 / d_in))
        layers.append({"w": w.to(device),
                       "b": torch.zeros(d_out, dtype=dtype, device=device)})
    return {"layers": layers}


def numpy_f32(t) -> np.ndarray:
    """A tensor (any device, detached) or array as a float32 numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def params_from_numpy(params_np: Params, device="cpu") -> Params:
    """Carry a params tree (numpy, JAX or torch leaves) to fp32 torch
    tensors on ``device``."""
    return {
        "layers": [
            {
                "w": torch.tensor(np.array(l["w"], np.float32), device=device),
                "b": torch.tensor(np.array(l["b"], np.float32), device=device),
            }
            for l in params_np["layers"]
        ]
    }


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 (nearest-even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, K] @ b [K, M] in fp32: the one product of the kernels' plain
    versions (march_body.mlp_apply, recompute.precise_sdg_plain). Their
    operands are bf16-valued, so every term is exact in fp32 and results
    differ from the CUDA kernels' only by the order of the k sum."""
    return a @ b


def dot_f32_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dot_f32 with the k sum taken in order from 0, one rounding per
    product and per add: the march kernels' order. Put in dot_f32's place,
    it makes the plain versions give the kernels' bits (a verification
    aid; no render path calls it). On a CUDA tensor it launches
    csrc/dot_in_order.cu, on the CPU it loops over k."""
    if a.is_cuda:
        from dist_renderer_tpu_torch.ops.kernels.build import load, ptr, stream_of

        a = a.to(torch.float32).contiguous()
        b = b.to(device=a.device, dtype=torch.float32).contiguous()
        out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                          device=a.device)
        load().call("drt_dot_in_order", ptr(a), ptr(b), ptr(out), a.shape[0],
                    a.shape[1], b.shape[1], stream_of(a))
        return out
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(a.shape[1]):
        out = out + a[:, k:k + 1] * b[k]
    return out


def decoder_apply(
    params: Params,
    latent: torch.Tensor,
    points: torch.Tensor,
    cfg: DecoderConfig = DecoderConfig(),
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Evaluate f_theta(z, x) -> sdf for latent [L] or [N, L] and points
    [..., 3]; returns [...] fp32. With bf16 compute every product takes
    bf16-rounded operands and accumulates in fp32 (the JAX package's
    bf16 dots with fp32 accumulation); the bias add stays fp32."""
    cast = round_bf16 if compute_dtype == torch.bfloat16 else (lambda a: a)
    pts_shape = points.shape[:-1]
    x = points.reshape(-1, 3).to(torch.float32)
    n = x.shape[0]
    z = latent.reshape(-1, latent.shape[-1]).to(torch.float32).expand(n, -1)
    inp = torch.cat([z, x], dim=-1)
    h = inp
    n_layers = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        if i in cfg.latent_in:
            h = torch.cat([h, inp], dim=-1)
        elif cfg.xyz_in_all and 0 < i < n_layers - 1:
            h = torch.cat([h, x], dim=-1)
        h = cast(h) @ cast(layer["w"]) + layer["b"]
        if i == n_layers - 1:
            if cfg.use_tanh:
                h = torch.tanh(h)
        else:
            h = torch.relu(h)
    sdf = h[..., 0]
    if cfg.final_tanh:
        sdf = torch.tanh(sdf)
    return sdf.reshape(pts_shape)


def _dot_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, K] @ b [K, M] on bf16-rounded operands with fp32 sums (the
    JAX package's bf16 dot with an fp32 result): one bf16 GEMM with an
    fp32 output on the card, the rounded operands' fp32 product on the
    CPU (exact products; the two differ in the order of the sums)."""
    if a.is_cuda:
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                        out_dtype=torch.float32)
    return round_bf16(a) @ round_bf16(b)


def _matmul_split(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h @ w + b from three bf16 products with fp32 sums, x = xh + xl and
    W = Wh + Wl split at bf16: xh@Wh + xh@Wl + xl@Wh (the xl@Wl term,
    O(2^-16) relative, is dropped), as the JAX package's
    ``_matmul_split``."""
    xh = round_bf16(h)
    xl = h - xh
    wh = round_bf16(w)
    wl = w - wh
    return _dot_bf16(xh, wh) + _dot_bf16(xh, wl) + _dot_bf16(xl, wh) + b


def decoder_apply_with_dd(
    params: Params,
    latent: torch.Tensor,
    points: torch.Tensor,
    dirs: torch.Tensor,
    cfg: DecoderConfig = DecoderConfig(),
):
    """(sdf, directional derivative of sdf along dirs) in one pass: the
    tangent chain rides the value's forward pass, gated by the shared
    pre-activations. The roundings are the JAX package's: the value takes
    the bf16x3 split (``_matmul_split``) on the layers that read the
    input and one bf16 product (``_dot_bf16``) on the hidden ones, the
    tangent one bf16 product per layer; every sum is fp32."""
    pts_shape = points.shape[:-1]
    x = points.reshape(-1, 3).to(torch.float32)
    v = dirs.reshape(-1, 3).to(torch.float32)
    n = x.shape[0]
    lat = latent.shape[-1]
    z = latent.reshape(-1, lat).to(torch.float32).expand(n, -1)
    inp = torch.cat([z, x], dim=-1)
    # d(inp)/dd along the ray: the latent rows are constant, xyz moves by v
    t_inp = torch.cat([torch.zeros_like(z), v], dim=-1)
    h, t = inp, t_inp
    n_layers = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        if i in cfg.latent_in:
            h = torch.cat([h, inp], dim=-1)
            t = torch.cat([t, t_inp], dim=-1)
        elif cfg.xyz_in_all and 0 < i < n_layers - 1:
            h = torch.cat([h, x], dim=-1)
            t = torch.cat([t, v], dim=-1)
        if i == 0 or i in cfg.latent_in:
            pre = _matmul_split(h, layer["w"], layer["b"])
        else:
            pre = _dot_bf16(h, layer["w"]) + layer["b"]
        t = _dot_bf16(t, layer["w"])
        if i == n_layers - 1:
            if cfg.use_tanh:
                pre = torch.tanh(pre)
                t = t * (1.0 - pre * pre)
            h = pre
        else:
            gate = pre > 0
            h = torch.relu(pre)
            t = torch.where(gate, t, torch.zeros_like(t))
    s, dd = h[..., 0], t[..., 0]
    if cfg.final_tanh:
        s = torch.tanh(s)
        dd = dd * (1.0 - s * s)
    return s.reshape(pts_shape), dd.reshape(pts_shape)


class PreciseSDF:
    """(latent, points) -> sdf with the fp32 value and its fp32 autograd
    backward, plus the siblings the renderer reads:

      - ``cheap``: the same decoder with bf16 products (fp32
        accumulation), for values that tolerate ~1e-3 relative error
        (miss-ray margins, spatial gradients that are normalized);
      - ``sdg_builder``: the fused value + spatial-gradient kernel K3 with
        its backward K4 (ops/kernels/recompute.py).

    ``use_kernel=False`` makes ``sdg_builder`` run K3/K4's plain versions
    on any device (on a CPU tensor they run regardless)."""

    def __init__(self, params: Params, cfg: DecoderConfig,
                 use_kernel: bool = True):
        self.params = params
        self.cfg = cfg
        self.use_kernel = use_kernel
        self._packed = None  # kernel weight layout, packed at first use

    def __call__(self, latent, points):
        return decoder_apply(self.params, latent, points, self.cfg)

    def cheap(self, latent, points):
        return decoder_apply(self.params, latent, points, self.cfg,
                             torch.bfloat16)

    def sdg_builder(self, block: int = 512):
        """(latent, points, dirs) -> (s, dd, g): precise value, directional
        derivative <g, dirs> and spatial gradient, one fused evaluation; s
        is differentiable to the latent and the points (dd and g are
        constants). This function's use_kernel=False runs the plain
        PyTorch versions on any device."""
        from dist_renderer_tpu_torch.ops.kernels.recompute import (
            make_precise_sdg, pack_precise,
        )

        if self._packed is None:
            self._packed = pack_precise(self.params, self.cfg)
        return make_precise_sdg(self.params, self.cfg, block, self.use_kernel,
                                packed=self._packed)


def make_precise_sdf(params: Params, cfg: DecoderConfig = DecoderConfig(),
                     use_kernel: bool = True) -> PreciseSDF:
    return PreciseSDF(params, cfg, use_kernel)


def decode_sdf(params: Params, latent: torch.Tensor, points: torch.Tensor,
               cfg: DecoderConfig = DecoderConfig(),
               compute_dtype: torch.dtype = torch.float32,
               chunk: Optional[int] = None) -> torch.Tensor:
    """decoder_apply over one latent in chunks of ``chunk`` points (None:
    one pass), the reference's ``decode_sdf``, for grids too large for one
    pass. A value may move in its last bit with the chunking (the GEMM
    blocks by row count), as with the JAX package's padded ``lax.map``."""
    if chunk is None:
        return decoder_apply(params, latent, points, cfg, compute_dtype)
    pts = points.reshape(-1, 3)
    out = [decoder_apply(params, latent, pts[i:i + chunk], cfg, compute_dtype)
           for i in range(0, pts.shape[0], chunk)]
    flat = torch.cat(out) if out else pts.new_zeros((0,))
    return flat.reshape(points.shape[:-1])


def sdf_gradient(params: Params, latent: torch.Tensor, points: torch.Tensor,
                 cfg: DecoderConfig = DecoderConfig(), eps: float = 0.0
                 ) -> torch.Tensor:
    """d sdf / d x at each point ([..., 3]), for surface normals.

    eps == 0: autograd of the sum of the values (each value depends on its
    own point only, so one backward gives every point's gradient).
    eps > 0: central differences with step eps (six more evaluations)."""
    if eps > 0.0:
        offs = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                             [0, 0, 1], [0, 0, -1]], dtype=points.dtype,
                            device=points.device) * eps
        probe = points[..., None, :] + offs
        s = decoder_apply(params, latent, probe.reshape(-1, 3), cfg)
        s = s.reshape(points.shape[:-1] + (6,))
        return torch.stack([s[..., 0] - s[..., 1], s[..., 2] - s[..., 3],
                            s[..., 4] - s[..., 5]], dim=-1) / (2.0 * eps)
    with torch.enable_grad():
        p = points.detach().requires_grad_(True)
        total = decoder_apply(params, latent.detach(), p, cfg).sum()
        (g,) = torch.autograd.grad(total, p)
    return g


class DeepSDFDecoder(nn.Module):
    """The decoder as an ``nn.Module`` (the reference's ``Decoder``): its
    parameters are each layer's ``w`` [in, out] and ``b`` [out], named
    ``w{i}`` and ``b{i}``, made from ``params`` (sharing its tensors) or a
    seeded init. ``forward`` is ``decode_sdf``, ``gradient``
    ``sdf_gradient``; ``params()`` gives the functional ``Params`` dict
    back."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(),
                 params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None, device="cpu"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_decoder_params(
                generator if generator is not None
                else torch.Generator().manual_seed(0), cfg, device)
        for i, layer in enumerate(params["layers"]):
            self.register_parameter(f"w{i}", nn.Parameter(layer["w"]))
            self.register_parameter(f"b{i}", nn.Parameter(layer["b"]))

    def params(self) -> Params:
        n = len(self.cfg.layer_dims)
        return {"layers": [{"w": getattr(self, f"w{i}"), "b": getattr(self, f"b{i}")}
                           for i in range(n)]}

    def forward(self, latent: torch.Tensor, points: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                chunk: Optional[int] = None) -> torch.Tensor:
        return decode_sdf(self.params(), latent, points, self.cfg, compute_dtype,
                          chunk)

    def gradient(self, latent: torch.Tensor, points: torch.Tensor,
                 eps: float = 0.0) -> torch.Tensor:
        return sdf_gradient(self.params(), latent, points, self.cfg, eps)
