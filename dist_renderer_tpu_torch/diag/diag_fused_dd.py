"""The fused value + directional derivative (GradConfig.fused_dd) in the
whole render: the counterpart of scripts/diag_fused_dd.py.

render() fwd+bwd (a depth L1 to the latent) of the bench latent (the
8x512 decoder without its proxy, 512^2, 50 steps, strides (16, 4), IFT
on an n/4 bucket) with fused_dd=False and True. As in the script, False
is GradConfig's default route, whose recompute is "pallas" (K3 and K4);
True takes the value and the IFT denominator from one bf16 pass of
``decoder_apply_with_dd``. The fused render is held to the K3 route
under ``diag.ROUTE_BARS`` (chip_smoke.py phase 12 (f)'s bars) and each
render to its plain versions with the in-order product, bit for bit.

``measure(..., reading=)`` takes a reading already made of the same two
routes (chip_smoke.py phase 12 (f)'s, whose request marches the proxy
and whose loss is the masked depth sum) in place of timing them again.

    python -m dist_renderer_tpu_torch.diag.diag_fused_dd [--img 512]
"""

from __future__ import annotations

from dist_renderer_tpu_torch.diag import BenchCell, device, emit, parser, routes_within
from dist_renderer_tpu_torch.diag.diag_recompute import route, versus


def measure(dev, cell: BenchCell, reps: int = 3, reading=None) -> dict:
    from dist_renderer_tpu_torch.config import GradConfig

    if reading is not None:
        routes_within("fused_dd against the K3 route (the reading given)", reading)
        return dict(img=cell.img, source="a reading given (chip_smoke.py phase 12 (f))",
                    fwdbwd_ms={"False": reading["k3_ms"], "True": reading["fused_ms"]},
                    fused_over_k3=reading["fused_ms"] / reading["k3_ms"],
                    vs_false={k: v for k, v in reading.items()
                              if k not in ("k3_ms", "fused_ms")})
    rows, first = {}, None
    for fused in (False, True):
        row, out, g = route(cell, GradConfig(mode="ift", compact_frac=4, fused_dd=fused),
                            reps, fwd=False)
        if first is None:
            first = ("fused_dd=False", out, g)
        else:
            row["vs_false"] = versus(first, out, g, cell.dirs)
        rows[str(fused)] = row
    return dict(img=cell.img, source="timed here",
                fwdbwd_ms={k: r["fwdbwd_ms"] for k, r in rows.items()},
                fused_over_k3=rows["True"]["fwdbwd_ms"] / rows["False"]["fwdbwd_ms"],
                rows=rows)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, 1, args.img)
    emit("diag_fused_dd", measure(dev, cell, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
