"""The single-frame 512^2 render stage by stage: the counterpart of
scripts/diag_f1_stages.py.

On the bench fixture (the 8x512 decoder, 50 steps, eps 2e-3 / 5e-4,
strides (16, 4), bench.py's IFT gradient on an n/4 bucket):

  pyramid   the coarse pyramid, classify and plan alone: K1 through
            batched_trace_padded on the marched decoder, classify_pyramid
            and plan_from_maps (the pre-march glue)
  trace     trace_frame alone (pyramid + classify + fine march + verify)
  compose   render_rays given that trace, per recompute mode
  fwd       render() (depth + min_sdf), per recompute mode
  fwd+bwd   bench.py's depth L1 to the latent, per recompute mode

per recompute mode of ``--modes``: "xla" (the autograd route: the
precise value, the march function's gradient for the IFT denominator)
and "pallas" (K3 forward, K4 backward). ``--proxy`` marches the bench
proxy with its margins (bench.py's path) for the pyramid, the trace and
compose; as in the script, each mode's fwd and fwd+bwd render through a
factory without the proxy, and every line names its factory. One
untimed render() through the trace's own factory checks that compose
given the trace is that render's depth and min_sdf bit for bit. The
stage sum (trace + compose) against fwd locates the rest. After every
timing, each stage runs once more under torch.profiler
(``diag.busy_split``): its kernels' device ms, the idle share of its
CUDA-event time, its launches and its largest kernels, so the host's
share of each stage is read in the same process as its time. (The
profiler leaves each later launch dearer on the host, so nothing is
timed after it: chip_smoke.py runs this module last in its phase.)

Every render is held to the same render through the plain versions
with the in-order product, bit for bit, and the pyramid's plan too; the
modes are held to each other under ``diag.ROUTE_BARS`` (the autograd
route's IFT denominator is a bf16 slope).

    python -m dist_renderer_tpu_torch.diag.diag_f1_stages [--img 512]
        [--modes xla,pallas] [--proxy] [--reps 3]
"""

from __future__ import annotations

import dataclasses

import torch

from dist_renderer_tpu_torch.diag import (
    TRACE_FIELDS, BenchCell, busy_split, compare_routes, device, differ, emit,
    hold_to_plain, in_order, parser, routes_within, time_ms,
)

PLAN_FIELDS = ("key", "init_depth", "skip")


def pyramid(cell: BenchCell, cfg, proxy: bool, use_kernel: bool = True):
    """The coarse pyramid, classification and plan of the bench frame on
    the marched decoder (the proxy when proxy=True): (key, init_depth,
    skip), each [1, N]."""
    from dist_renderer_tpu_torch.ops.c2f import classify_pyramid, plan_from_maps
    from dist_renderer_tpu_torch.ops.kernels.batched_march import (
        batched_trace_padded, fold_bias_bank,
    )

    mm, img = cfg.march, cell.img
    mp, md = cell.proxy if proxy else (cell.params, cell.dcfg)
    shared = cell.packed[1] if proxy else cell.packed[0]
    coarse = dataclasses.replace(mm, max_steps=min(mm.max_steps, 16))
    with torch.no_grad():
        bank = fold_bias_bank(mp, cell.latent[None], md, shared)

        def trace_level(o_l, v_l, seed, active, stride):
            return batched_trace_padded(shared, bank, o_l, v_l, coarse, seed, active,
                                        block=512, salvage=True, use_kernel=use_kernel)

        maps = classify_pyramid(trace_level, cell.origins.reshape(1, img, img, 3),
                                cell.dirs.reshape(1, img, img, 3), (16, 4), mm.c2f_backoff)
        return plan_from_maps(maps)


def measure(dev, cell: BenchCell, modes: str = "xla,pallas", proxy: bool = False,
            reps: int = 3) -> dict:
    from dist_renderer_tpu_torch.config import GradConfig
    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul
    from dist_renderer_tpu_torch.ops.renderer import render_rays

    set_fp32_matmul()
    img = cell.img
    o, v, z = cell.origins, cell.dirs, cell.latent
    base = cell.frame_cfg(GradConfig(mode="ift", compact_frac=4), proxy=proxy)
    trace_factory = "proxy" if proxy else "full"
    factory = cell.factory(base, proxy)
    march_fn = factory(z)
    sdf = cell.sdf()
    res = dict(img=img, proxy=proxy, trace_factory=trace_factory)

    plan, res["pyramid_ms"] = time_ms(lambda: pyramid(cell, base, proxy), reps)
    profiled = [(res, "pyramid", lambda: pyramid(cell, base, proxy))]
    with in_order():
        plain_plan = pyramid(cell, base, proxy, use_kernel=False)
    res["pyramid_plain"] = {k: int(differ(a, b).sum())
                            for k, a, b in zip(PLAN_FIELDS, plan, plain_plan)}
    if any(res["pyramid_plain"].values()):
        raise AssertionError(f"the pyramid's plan differs from its plain version's: "
                             f"{res['pyramid_plain']} rays")

    with torch.no_grad():
        trace0, res["trace_ms"] = time_ms(
            lambda: march_fn.trace_frame(o, v, base.march, (img, img)), reps)
        profiled.append((res, "trace", lambda: march_fn.trace_frame(o, v, base.march,
                                                                    (img, img))))
        with in_order():
            plain_trace = cell.factory(base, proxy, use_kernel=False)(z).trace_frame(
                o, v, base.march, (img, img))
    res["trace_plain"] = hold_to_plain("trace_frame", trace0, plain_trace, TRACE_FIELDS)
    res["hits"] = int(trace0.hit.sum())

    rows, first = {}, None
    for name in modes.split(","):
        cfg = dataclasses.replace(base, grad=dataclasses.replace(base.grad, recompute=name))
        row = dict(trace_factory=trace_factory, fwd_factory="full")

        def comp(cfg=cfg):   # profiled after the loop: bind this mode's config
            with torch.no_grad():
                return render_rays(sdf, z, o, v, cfg, march_fn=march_fn, trace=trace0)

        c_out, row["compose_ms"] = time_ms(comp, reps)
        # compose given the trace is the render through the trace's own factory
        r_out = cell.frame_fns(cfg, factory, sdf)[0]()
        row["compose_vs_render_rays_differing"] = same = {
            k: int(differ(getattr(c_out, k).reshape(img, img), getattr(r_out, k)).sum())
            for k in ("depth", "min_sdf")}
        if any(same.values()):
            raise AssertionError(f"{name}: compose given the trace differs from the render "
                                 f"through the trace's factory: {same} rays")

        fwd, fwdbwd = cell.frame_fns(cfg, cell.factory(cfg), sdf)
        out, row["fwd_ms"] = time_ms(fwd, reps)
        row["plain"] = cell.hold_frame(f"{name} fwd", cfg, out)
        (_, grad), row["fwdbwd_ms"] = time_ms(fwdbwd, reps)
        profiled += [(row, "compose", comp), (row, "fwd", fwd), (row, "fwdbwd", fwdbwd)]
        row["stage_sum_ms"] = res["trace_ms"] + row["compose_ms"]
        row["hit_frac"] = out.mask.float().mean().item()
        if first is None:
            first = (name, out, grad)
        else:
            row["vs_" + first[0]] = cmp = compare_routes(first[1], first[2], out, grad, v)
            # chip_smoke.py phase 5's bars, reported: hits >= 0.99, depth
            # within 1e-3 on >= 0.999 of common hits, gradient cos >= 0.9999
            row["phase5_bars_held"] = (cmp["hit_agree"] >= 0.99 and cmp["within_1e3"] >= 0.999
                                       and cmp["grad_cos"] >= 0.9999)
            routes_within(f"{name} against {first[0]}", cmp)
        rows[name] = row
    res["modes"] = rows
    for where, stage, fn in profiled:
        where.setdefault("busy", {})[stage] = busy_split(fn, where[stage + "_ms"])
    return res


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--modes", default="xla,pallas")
    ap.add_argument("--proxy", action="store_true",
                    help="march the bench proxy (.bench_proxy.npz), bench.py's path")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, 1, args.img)
    emit("diag_f1_stages", measure(dev, cell, args.modes, args.proxy, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
