"""Plain float32 DeepSDF decoder, sphere trace and normals.

The decoder follows DeepSDF's specs.json NetworkSpecs: linear layers with
ReLU, the network input (latent, xyz) concatenated again before each
``latent_in`` layer, a final tanh. The latent is constant over a frame,
so its rows of each layer that reads it fold into that layer's bias
(``Decoder.fold``), which the reference works out itself from the
weights file.

``sphere_trace`` is the textbook march (step = SDF value, from the
bounding sphere's entry) with a hit where the value falls under eps. It
also sorts each ray into the classes the comparison needs: a sure hit
(past the hit the field goes below -tau within a few probes: the ray
crosses the surface), a sure miss (never under eps, its smallest sample
above eps + tau), or neither (a grazing ray, whose answer depends on the
march's step rule, or one still marching at the step cap).

Products run in float32 with TF32 off (``no_tf32``). ``quant`` puts a
rounding of every product's operands in place: the comparison's control
computes the same reference in float8 (e4m3, scaled by each operand's
largest magnitude), the precision below the program's bfloat16.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

Quant = Callable[[torch.Tensor], torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp32(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 after scaling each row (a vector: the whole
    of it) so that its largest magnitude lands on the format's 448;
    straight-through under autograd."""
    scale = x.detach().abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


class Decoder:
    """The DeepSDF decoder of a weights file (w0, b0, w1, ... in [in, out]
    layout, and the fixture's ``latent``) on ``device``, float32."""

    def __init__(self, path: str, spec: dict, device):
        with np.load(path) as data:
            n = 0
            while f"w{n}" in data:
                n += 1
            self.w = [torch.tensor(np.asarray(data[f"w{i}"], np.float32), device=device)
                      for i in range(n)]
            self.b = [torch.tensor(np.asarray(data[f"b{i}"], np.float32), device=device)
                      for i in range(n)]
            self.latent = torch.tensor(np.asarray(data["latent"], np.float32), device=device)
        self.latent_size = int(spec["latent_size"])
        self.latent_in = tuple(int(i) for i in spec.get("latent_in", ()))
        self.final_tanh = bool(spec.get("final_tanh", True))
        widths = [int(d) for d in spec["hidden_dims"]]
        if len(self.w) != len(widths) + 1:
            raise ValueError(f"{path}: {len(self.w)} layers, the configuration says "
                             f"{len(widths) + 1}")

    def fold(self, latent: torch.Tensor) -> list:
        """Per layer (w_h, w_x, bias): the weight rows that read the
        previous layer's output (None for layer 0) and xyz (None where the
        layer reads no input), and the bias with the latent's rows folded
        in."""
        lat = self.latent_size
        z = latent.to(torch.float32)
        layers = []
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            if i == 0:
                layers.append((None, w[lat:], b + z @ w[:lat]))
            elif i in self.latent_in:
                h = w.shape[0] - lat - 3
                layers.append((w[:h], w[h + lat:], b + z @ w[h:h + lat]))
            else:
                layers.append((w, None, b))
        return layers

    def sdf(self, folded: list, x: torch.Tensor, quant: Quant = fp32,
            chunk: int = 131072) -> torch.Tensor:
        """SDF at points x [n, 3], in chunks of ``chunk`` points."""
        if x.shape[0] > chunk:
            return torch.cat([self.sdf(folded, x[i:i + chunk], quant, chunk)
                              for i in range(0, x.shape[0], chunk)])
        x = x.to(torch.float32)
        qx = quant(x)
        h = None
        last = len(folded) - 1
        for i, (w_h, w_x, b) in enumerate(folded):
            acc = b.expand(x.shape[0], -1)
            if w_h is not None:
                acc = acc + quant(h) @ quant(w_h.T).T
            if w_x is not None:
                acc = acc + qx @ quant(w_x.T).T
            h = torch.relu(acc) if i < last else acc
        s = h[:, 0]
        return torch.tanh(s) if self.final_tanh else s

    def gradient(self, folded: list, x: torch.Tensor, quant: Quant = fp32,
                 chunk: int = 65536) -> torch.Tensor:
        """The SDF's gradient at x [n, 3] (autograd), in chunks."""
        out = []
        for i in range(0, x.shape[0], chunk):
            with torch.enable_grad():
                p = x[i:i + chunk].detach().clone().requires_grad_(True)
                g, = torch.autograd.grad(self.sdf(folded, p, quant).sum(), p)
            out.append(g)
        return torch.cat(out) if out else x.new_zeros((0, 3))

    def normals(self, folded: list, x: torch.Tensor, quant: Quant = fp32) -> torch.Tensor:
        """Unit gradients of the SDF at x [n, 3]."""
        g = self.gradient(folded, x, quant)
        return g / g.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def sphere_entry(o: torch.Tensor, v: torch.Tensor, radius: float):
    """(t_near, t_far, enters) of rays o + t v against the sphere."""
    b = (o * v).sum(-1)
    c = (o * o).sum(-1) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(disc.clamp(min=0.0))
    t_far = -b + sq
    return (-b - sq).clamp(min=0.0), t_far, (disc > 0) & (t_far > 0)


@torch.no_grad()
def sphere_trace(sdf: Callable[[torch.Tensor], torch.Tensor], o: torch.Tensor,
                 v: torch.Tensor, eps: float, radius: float = 1.0,
                 max_steps: int = 400, probe_h: float = 2e-3, probe_k: int = 8,
                 tau: float = 4e-3, polish: int = 0,
                 slope: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """March rays o [1 or n, 3] + t v [n, 3] through ``sdf(points) ->
    values``. Returns per ray: depth (NaN where no hit), hit, min_sdf (the
    smallest sample), sure_hit, sure_miss. ``polish`` Newton steps move
    each hit onto the zero level along its ray (``slope(points, dirs)``
    gives the SDF's derivative along the ray)."""
    n = v.shape[0]
    o = o.expand(n, 3)
    t_near, t_far, enters = sphere_entry(o, v, radius)
    t = t_near.clone()
    depth = torch.full((n,), float("nan"), device=v.device)
    hit = torch.zeros(n, dtype=torch.bool, device=v.device)
    min_sdf = torch.full((n,), float("inf"), device=v.device)
    live = enters.nonzero().squeeze(1)
    for _ in range(max_steps):
        if live.numel() == 0:
            break
        tl = t[live]
        f = sdf(o[live] + tl[:, None] * v[live])
        min_sdf[live] = torch.minimum(min_sdf[live], f)
        conv = f < eps
        depth[live[conv]] = tl[conv]
        hit[live[conv]] = True
        tn = tl + f
        go = ~conv & (tn <= t_far[live])
        live = live[go]
        t[live] = tn[go]
    unresolved = torch.zeros(n, dtype=torch.bool, device=v.device)
    unresolved[live] = True
    hits = hit.nonzero().squeeze(1)
    for _ in range(polish):
        p = o[hits] + depth[hits, None] * v[hits]
        d = slope(p, v[hits])
        step = sdf(p) / torch.where(d.abs() < 1e-6, torch.full_like(d, -1e-6), d)
        depth[hits] = depth[hits] - step.clamp(-0.05, 0.05)
    below = torch.full((n,), float("inf"), device=v.device)
    for k in range(1, probe_k + 1):
        if hits.numel() == 0:
            break
        tk = depth[hits] + k * probe_h
        below[hits] = torch.minimum(below[hits], sdf(o[hits] + tk[:, None] * v[hits]))
    return dict(depth=depth, hit=hit, min_sdf=min_sdf,
                sure_hit=hit & (below < -tau),
                sure_miss=~hit & ~unresolved & (min_sdf > eps + tau))


def ray_slope(decoder: Decoder, folded: list, quant: Quant = fp32):
    """slope(points, dirs): the SDF's derivative along each ray."""
    def slope(p, v):
        return (decoder.gradient(folded, p, quant) * v).sum(-1)
    return slope
