"""The proxy's cost per tile-step against the full decoder's: the
counterpart of scripts/diag_proxy_cost.py.

diag_kernel's forced march (every entering ray exactly ``--steps``
steps, every ray inactive for the dead-tile cost) of the bench cell's
512x512 rays at one latent, on the 8x512 bench decoder and on its 4x256
distilled proxy, through K1 and K1-multi: whether a proxy tile-step
costs what its ~8x fewer multiply-adds say on the card, or is floored by
the march's fixed work a step. The TPU script's block widths (512-2048
lanes) have no counterpart: the card's tile is 64 rows.

    python -m dist_renderer_tpu_torch.diag.diag_proxy_cost [--steps 32] [--reps 3]
"""

from __future__ import annotations

from dist_renderer_tpu_torch.diag import device, emit, parser
from dist_renderer_tpu_torch.diag.diag_kernel import CHECK_RAYS, measure as kernel_measure


def measure(dev, steps: int = 32, reps: int = 3, check_rays: int = CHECK_RAYS,
            img: int = 512, fixture=None) -> dict:
    from dist_renderer_tpu_torch.diag import load_bench
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.profile_render import macs_per_eval

    fixture = fixture or load_bench(dev)
    params, dcfg, _, proxy, _ = fixture
    res = kernel_measure(dev, decoders=("full", "proxy"), frames=(1,), steps=steps,
                         reps=reps, img=img, check_rays=check_rays, fixture=fixture)
    rows = {(r["decoder"], r["kernel"]): r for r in res["rows"]}
    macs = {"full": macs_per_eval(bm.pack_shared(params, dcfg)),
            "proxy": macs_per_eval(bm.pack_shared(*proxy))}
    res["macs_per_eval"] = macs
    res["proxy_over_full"] = {
        k: dict(tile_step=rows[("proxy", k)]["us_per_tile_step"]
                / rows[("full", k)]["us_per_tile_step"],
                dead_tile=rows[("proxy", k)]["us_per_dead_tile"]
                / rows[("full", k)]["us_per_dead_tile"],
                macs=macs["proxy"] / macs["full"])
        for k in ("K1", "K1-multi")}
    return res


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check-rays", type=int, default=CHECK_RAYS)
    args = ap.parse_args(argv)
    dev = device()
    emit("diag_proxy_cost", measure(dev, args.steps, args.reps, args.check_rays))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
