"""The differentiable recompute's routes in the whole render: the
counterpart of scripts/diag_recompute.py.

render() of the bench latent (the 8x512 decoder without its proxy,
512^2, 50 steps, strides (16, 4), IFT on an n/4 bucket), fwd (depth +
min_sdf) and fwd+bwd (a depth L1 to the latent), per route:

  xla     the precise value by autograd, the IFT denominator from the
          march function's gradient (GradConfig.recompute="xla")
  fused   GradConfig.fused_dd: the denominator a tangent riding the
          value's bf16 pass
  pallas  GradConfig.recompute="pallas": K3 (value, denominator and
          spatial gradient in one kernel) and K4 for the backward

The script's "xla" row builds GradConfig(mode="ift", compact_frac=4),
whose recompute defaults to "pallas" in both packages' config.py; here
each row names the route it runs. Each later route is compared with the first:
the script's depth p95 and max over every pixel and gradient cosine,
and ``diag.ROUTE_BARS`` (chip_smoke.py phase 12 (f)'s: hits >= 0.999,
p95 <= 1e-3 on frontal common hits, gradient cos >= 0.999 and relative
L2 <= 3e-2), which it must hold. Every fwd render is held to the same
render through the plain versions with the in-order product, bit for
bit.

    python -m dist_renderer_tpu_torch.diag.diag_recompute [--img 512]
        [--modes xla,pallas]
"""

from __future__ import annotations

from dist_renderer_tpu_torch.diag import (
    BenchCell, compare_routes, device, emit, parser, quantiles, routes_within, time_ms,
)

ROUTES = ("xla", "fused", "pallas")


def grad_config(route: str):
    """The GradConfig of a route (bench.py's IFT on an n/4 bucket)."""
    from dist_renderer_tpu_torch.config import GradConfig

    if route == "fused":
        return GradConfig(mode="ift", compact_frac=4, fused_dd=True)
    if route in ("xla", "pallas"):
        return GradConfig(mode="ift", compact_frac=4, recompute=route)
    raise SystemExit(f"unknown route {route!r} (routes: {', '.join(ROUTES)})")


def route(cell: BenchCell, grad, reps: int, fwd: bool = True):
    """One route's render: (row, fwd output, latent gradient). The row
    has fwd ms (when fwd), fwd+bwd ms, the hit share and the fwd render
    held to its plain versions."""
    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul

    set_fp32_matmul()
    cfg = cell.frame_cfg(grad)
    f_fwd, f_fb = cell.frame_fns(cfg, cell.factory(cfg))
    row = {}
    if fwd:
        out, row["fwd_ms"] = time_ms(f_fwd, reps)
    (out_g, g), row["fwdbwd_ms"] = time_ms(f_fb, reps)
    out = out if fwd else out_g
    row["hit_frac"] = out.mask.float().mean().item()
    row["plain"] = cell.hold_frame(f"{grad}", cfg, out)
    return row, out, g


def versus(first, out, g, dirs) -> dict:
    """The script's comparison with the first route (depth over every
    pixel) beside compare_routes' (``dirs``: the rays'), held to
    ROUTE_BARS."""
    name, out0, g0 = first
    cmp = compare_routes(out0, g0, out, g, dirs)
    cmp["depth_all_pixels"] = quantiles((out.depth - out0.depth).abs(), (95,))
    routes_within(f"against {name}", cmp)
    return cmp


def measure(dev, cell: BenchCell, modes: str = "xla,pallas", reps: int = 3) -> dict:
    rows, first = {}, None
    for name in modes.split(","):
        row, out, g = route(cell, grad_config(name), reps)
        if first is None:
            first = (name, out, g)
        else:
            row["vs_" + first[0]] = versus(first, out, g, cell.dirs)
        rows[name] = row
    return dict(img=cell.img, routes=rows)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--modes", default="xla,pallas", help=f"comma list of {', '.join(ROUTES)}")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, 1, args.img)
    emit("diag_recompute", measure(dev, cell, args.modes, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
