"""The bracket-secant march step and the latent-folded MLP, in plain
PyTorch: the oracle that the CUDA march kernels (K1 in batched_march.py,
K2 in queue_march.py) are held to, and what their wrappers run on a CPU
tensor.

Layout: rays are rows ([N] per field, [N, features] activations), the
transpose of the TPU kernels' [feature, lane] tiles.

Rounding points follow the TPU kernel body (``march_body.py``
``mlp_apply``/``march_loop`` in the JAX package): the sample position is
rounded to bf16 before the x-product, weights are bf16, every product
accumulates in fp32, each ReLU output is rounded to bf16, and the final
tanh is applied in fp32.

Every step evaluates the MLP at the full ray width, with per-ray masks
(never gathers): a CPU BLAS may sum a row in another order at another
batch size, and the queue march's exactness contract needs every
schedule to produce the same row sums.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from dist_renderer_tpu_torch.models.decoder import dot_f32, round_bf16

NEG_BIG = -3.0e38  # stand-ins for +-inf that survive fp32 where-games
POS_BIG = 3.0e38

_HOST_FREE = [False]


@contextlib.contextmanager
def host_free():
    """A mode in which the multi-frame render (``render_batched_c2f`` on
    the rounds scheduler, and ``finalize_hits_batched``) reads nothing
    from the device on the host, so a CUDA graph can hold it, with the
    eager call's bits. The rounds scheduler marches the full width (its
    rounds are a pure function of each ray, whatever the width), the
    finalize evaluates both of its branches and picks one on the device,
    and the plain march runs its whole step budget instead of stopping
    when no ray is live (a step changes no dead ray)."""
    prev = _HOST_FREE[0]
    _HOST_FREE[0] = True
    try:
        yield
    finally:
        _HOST_FREE[0] = prev


def in_host_free() -> bool:
    """Whether the caller runs inside ``host_free()``."""
    return _HOST_FREE[0]


class Carry(NamedTuple):
    """The 12-field march carry, each [N] fp32 (flags as 0/1). The step is
    Markov in it: a paused ray resumed from its carry follows the same
    trajectory as an uninterrupted march."""

    d: torch.Tensor
    act: torch.Tensor
    hit: torch.Tensor
    d_lo: torch.Tensor
    f_lo: torch.Tensor
    d_hi: torch.Tensor
    f_hi: torch.Tensor
    min_sdf: torch.Tensor
    d_at_min: torch.Tensor
    last_f: torch.Tensor
    steps: torch.Tensor
    unres: torch.Tensor


def make_carry(d0: torch.Tensor, act0: torch.Tensor) -> Carry:
    """A fresh carry: depth d0, active flag act0 (fp32 0/1)."""
    full = lambda v: torch.full_like(d0, v)
    zeros = torch.zeros_like(d0)
    return Carry(d=d0, act=act0, hit=zeros, d_lo=full(NEG_BIG),
                 f_lo=full(POS_BIG), d_hi=full(POS_BIG), f_hi=full(NEG_BIG),
                 min_sdf=full(POS_BIG), d_at_min=d0, last_f=full(POS_BIG),
                 steps=zeros, unres=zeros)


def rows_from_carry(c: Carry) -> torch.Tensor:
    """[8, N] output rows: depth, hit, min_sdf, depth_at_min, last_f,
    steps, unresolved-at-exit, owns-a-bracket."""
    brk = ((c.d_lo > NEG_BIG / 2) & (c.d_hi < POS_BIG / 2)).to(torch.float32)
    return torch.stack([c.d, c.hit, c.min_sdf, c.d_at_min, c.last_f, c.steps,
                        torch.maximum(c.act, c.unres), brk])


def mlp_apply(layers, p: torch.Tensor, final_tanh: bool,
              out_rows: int = 1, p_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One folded-MLP eval at bf16-rounded positions p [N, 3] -> sdf [N]
    (out_rows == 1), else the last layer's first out_rows outputs
    [N, out_rows] (an RGB head: 3).

    layers: per layer (wh [in_p, out_p] or None, wx [3, out_p] or None,
    bias [N or 1, out_p]), weights bf16-valued fp32. p_lo: the bf16 low
    halves of the positions (p_lo = bf16(p_fp32 - p)); with it every
    x-product runs on each half and the two sums are added (the banked
    point eval's precise positions)."""
    h = None
    n_layers = len(layers)
    for li, (wh, wx, bias) in enumerate(layers):
        acc = None
        if wh is not None:
            acc = dot_f32(h, wh)
        if wx is not None:
            xz = dot_f32(p, wx)
            if p_lo is not None:
                xz = xz + dot_f32(p_lo, wx)
            acc = xz if acc is None else acc + xz
        acc = acc + bias
        h = round_bf16(torch.relu(acc)) if li < n_layers - 1 else acc
    out = h[:, 0] if out_rows == 1 else h[:, :out_rows]
    return torch.tanh(out) if final_tanh else out


def march_loop(mlp: Callable[[torch.Tensor], torch.Tensor],
               o: torch.Tensor, v: torch.Tensor, near: torch.Tensor,
               far: torch.Tensor, march, max_steps: int, salvage: bool,
               c: Carry, kmax: Optional[int] = None) -> Carry:
    """Run the bracket-secant march from carry ``c`` for at most ``kmax``
    iterations (None = max_steps) or until no ray is active. max_steps is
    each ray's total budget, compared with its carried step count. Under
    ``host_free()`` it runs all kmax iterations: a step with no active
    ray changes no field of the carry, so the result is the same.

    mlp: bf16-rounded positions [N, 3] -> sdf [N]."""
    eps, deps = march.convergence_eps, march.depth_eps
    alpha, margin = march.alpha, march.far_margin
    kmax = max_steps if kmax is None else kmax
    near_lo = near - margin
    k = 0
    while k < kmax and (in_host_free() or bool((c.act > 0.5).any())):
        (d, act_f, hit_f, d_lo, f_lo, d_hi, f_hi, min_sdf, d_at_min,
         last_f, steps, unres_f) = c
        act = act_f > 0.5
        p = o + d[:, None] * v
        f = mlp(round_bf16(p))

        better = act & (f < min_sdf)
        min_sdf = torch.where(better, f, min_sdf)
        d_at_min = torch.where(better, d, d_at_min)

        outside = f > 0.0
        d_lo = torch.where(act & outside, d, d_lo)
        f_lo = torch.where(act & outside, f, f_lo)
        d_hi = torch.where(act & ~outside, d, d_hi)
        f_hi = torch.where(act & ~outside, f, f_hi)
        bracketed = (d_lo > NEG_BIG / 2) & (d_hi < POS_BIG / 2)
        width = d_hi - d_lo

        converged = act & ((torch.abs(f) < eps) | (bracketed & (width < deps)))

        d_aggr = d + alpha * f
        denom = f_hi - f_lo
        secant = (d_lo * f_hi - d_hi * f_lo) / torch.where(
            denom == 0.0, torch.ones_like(denom), denom)
        secant = torch.minimum(torch.maximum(secant, d_lo + 0.05 * width),
                               d_hi - 0.05 * width)
        d_back = d + f
        d_next = torch.where(bracketed, secant,
                             torch.where(outside, d_aggr, d_back))

        steps = steps + act.to(torch.float32)
        exhausted = steps >= float(max_steps)
        escaped = (~bracketed) & ((d_next > far) | (d_next < near_lo))
        missed = act & ~converged & (escaped | exhausted)
        if salvage:
            # final march: accept the bracket midpoint on exhaustion
            salvaged = act & ~converged & exhausted & bracketed
        else:
            salvaged = torch.zeros_like(act)
        missed = missed & ~salvaged
        converged = converged | salvaged

        still = act & ~converged & ~missed
        d = torch.where(still, d_next,
                        torch.where(salvaged, 0.5 * (d_lo + d_hi), d))
        last_f = torch.where(act, f, last_f)
        hit_f = torch.maximum(hit_f, converged.to(torch.float32))
        open_exh = act & ~converged & exhausted
        if salvage:
            open_exh = open_exh & ~bracketed
        unres_f = torch.maximum(unres_f, open_exh.to(torch.float32))
        c = Carry(d, still.to(torch.float32), hit_f, d_lo, f_lo, d_hi, f_hi,
                  min_sdf, d_at_min, last_f, steps, unres_f)
        k += 1
    return c
