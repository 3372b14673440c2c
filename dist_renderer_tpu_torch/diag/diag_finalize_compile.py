"""The batched polish headline split into its trace and its finalize:
the counterpart of scripts/diag_finalize_compile.py.

The script isolated a compile failure of the TPU's service (the trace
and the finalize in one program at F=64, 512^2). On the card nothing is
compiled per program, so its stages time the split of the batched
polish step instead, on the script's own scene (below):

  finalize   finalize_hits_batched alone (polish_iters 2) on the trace's
             outputs
  trace      render_batched_c2f alone, verify_hits="polish"
  combined   the trace then its finalize, as the bench step runs them
  polish-all the trace with verify_hits="polish-all", then the script's
             per-frame finalize (compact_frac 3, the weak candidates),
             with its parity against verify_hits="march": flips, the
             flips' largest |min_sdf| and the common hits' depth
             difference (median, p95, max)

on the script's scene: the bench decoder and proxy, F frames of img^2
(the bench latent + 0.001 N(0, 1), seed 9) from a camera at (0.9, 0.65,
-1.9), focal 1.2 img, MarchConfig(max_steps=``--steps``) otherwise at
its defaults, strides (16, 4), 16 coarse steps, the proxy's margins at
that eps. ms per frame of each stage. The combined output equals the
trace then the finalize run apart, bit for bit; each trace is held to
the same trace through the plain versions with the in-order product on
its first PLAIN_FRAMES frames.

The script's scene is not the bench cell: its camera and eps 5e-5 give
more hits a frame than the finalize's n/4 bucket holds, so there the
finalize evaluates every ray. ``bench_split`` (the "bench_b" entry)
times the same three stages on the (b) polish cell of chip_smoke.py's
phase 8 and bench.py (``profile_render.batched_setup``: the bench
camera, eps 2e-3 / 5e-4, verify caps, 50 steps): the finalize's share
of (b)'s frame.

    python -m dist_renderer_tpu_torch.diag.diag_finalize_compile
        [--img 512] [--frames 64] [--steps 50] [--skip finalize,trace,...]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dist_renderer_tpu_torch.diag import (
    PLAIN_FRAMES, ROOT, TRACE_FIELDS, BenchCell, bench_latents, device, differ, emit,
    hold_to_plain, in_order, parser, quantiles, time_ms,
)

STAGES = ("finalize", "trace", "combined", "polish-all", "bench_b")


def measure(dev, img: int = 512, frames: int = 64, steps: int = 50, skip=(),
            reps: int = 3, fixture=None) -> dict:
    from dist_renderer_tpu_torch.config import MarchConfig
    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul
    from dist_renderer_tpu_torch.models.proxy import load_proxy_meta, proxy_march_margins
    from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
    from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f
    from dist_renderer_tpu_torch.ops.renderer import finalize_hits_batched

    set_fp32_matmul()
    cell = BenchCell(dev, frames, img, steps, fixture=fixture)
    params, dcfg, proxy = cell.params, cell.dcfg, cell.proxy
    march = MarchConfig(max_steps=steps)
    meta = load_proxy_meta(os.path.join(ROOT, ".bench_proxy.npz"))
    pbo, pband = (proxy_march_margins(meta, march.convergence_eps) if meta
                  else (cell.backoff, cell.band))
    cam = Camera.looking_at((0.9, 0.65, -1.9), focal=float(img) * 1.2, img_hw=(img, img),
                            device=dev)
    o, v = pixel_rays(cam, img, img)
    lat = bench_latents(cell.latent, frames)
    of, vf = o[None, :1].expand(frames, 1, 3), v[None].expand(frames, -1, 3)

    def trace(verify_hits="polish", f=frames, use_kernel=True):
        with torch.no_grad():
            return render_batched_c2f(
                params, dcfg, lat[:f], of[:f], vf[:f], (img, img), march,
                strides=(16, 4), coarse_steps=16, shared_origin=True, proxy=proxy,
                proxy_backoff=pbo, proxy_band=pband, verify_hits=verify_hits,
                verify_round_caps=march.proxy_verify_caps, packed=cell.packed,
                use_kernel=use_kernel)

    def fin(st, **kw):
        return finalize_hits_batched(params, dcfg, lat, of, vf, st.depth, st.hit,
                                     st.min_sdf, convergence_eps=march.convergence_eps,
                                     polish_iters=2, **kw)

    def held(vh, st):
        with in_order():
            return hold_to_plain(f"verify_hits={vh} trace", st,
                                 trace(vh, PLAIN_FRAMES, use_kernel=False), TRACE_FIELDS)

    res = dict(img=img, frames=frames, steps=steps, eps=march.convergence_eps,
               backoff=pbo, band=pband, ms_per_frame={}, plain={})
    per = res["ms_per_frame"]
    st, t = time_ms(trace, reps)
    res["plain"]["polish"] = held("polish", st)
    # finalize_hits_batched evaluates a bucket of n // 4 rays a frame when
    # the largest frame's hits fit it, else every ray
    res.update(trace_hits_max_frame=int(st.hit.sum(1).max()), bucket=(img * img) // 4)
    if "trace" not in skip:
        per["trace"] = t / frames
    if "finalize" not in skip:
        _, t = time_ms(lambda: fin(st), reps)
        per["finalize"] = t / frames
    if "combined" not in skip:
        out, t = time_ms(lambda: fin(trace()), reps)
        per["combined"] = t / frames
        apart = fin(st)
        res["combined_vs_apart_differing"] = bad = {
            k: int(differ(a, b).sum()) for k, a, b in zip(("depth", "hit", "min_sdf"),
                                                         out, apart)}
        if any(bad.values()):
            raise AssertionError(f"the trace and finalize together differ from the two "
                                 f"run apart: {bad}")
        res["hits_per_frame"] = int(out[1].sum()) / frames
    if "polish-all" not in skip:
        st_all = trace("polish-all")
        res["plain"]["polish-all"] = held("polish-all", st_all)

        def per_frame():
            outs = [finalize_hits_batched(
                params, dcfg, lat[i:i + 1], of[:1], vf[:1], st_all.depth[i:i + 1],
                st_all.hit[i:i + 1], st_all.min_sdf[i:i + 1],
                convergence_eps=march.convergence_eps, polish_iters=2, compact_frac=3,
                weak=st_all.weak[i:i + 1]) for i in range(frames)]
            return tuple(torch.cat([u[j] for u in outs]) for j in range(3))

        (pd, ph, _), t = time_ms(lambda: (trace("polish-all"), per_frame())[1], reps)
        per["polish-all"] = t / frames
        ref = trace("march")
        res["plain"]["march"] = held("march", ref)
        res["polish_all_vs_march"] = parity(ref.hit, ph, ref.depth, pd, ref.min_sdf)
    if "bench_b" not in skip:
        res["bench_b"] = bench_split(dev, img, frames, reps)
    return res


def bench_split(dev, img: int = 512, frames: int = 64, reps: int = 3) -> dict:
    """The trace / finalize / combined split of the (b) polish cell
    (verify_hits="polish", finalize_hits_batched with polish_iters 2 on
    an n/4 bucket), ms per frame; the combined output equals the two run
    apart bit for bit, and the trace its plain version on its first
    PLAIN_FRAMES frames."""
    from dist_renderer_tpu_torch.profile_render import batched_setup

    batch, _, _ = batched_setup(dev, frames, img)
    st, t_trace = time_ms(lambda: batch("polish", finalize=False), reps)
    with in_order():
        plain = hold_to_plain("(b) trace", st, batch("polish", PLAIN_FRAMES, use_kernel=False,
                                                      finalize=False), TRACE_FIELDS)
    _, t_fin = time_ms(lambda: batch.finalize("polish", st), reps)
    out, t_comb = time_ms(lambda: batch("polish"), reps)
    apart = batch.finalize("polish", st)
    bad = {k: int(differ(getattr(out, k), getattr(apart, k)).sum())
           for k in ("depth", "hit", "min_sdf")}
    if any(bad.values()):
        raise AssertionError(f"(b): the trace and finalize together differ from the two "
                             f"run apart: {bad}")
    return dict(frames=frames, plain=plain, combined_vs_apart_differing=bad,
                trace_hits_max_frame=int(st.hit.sum(1).max()), bucket=(img * img) // 4,
                hits_per_frame=int(out.hit.sum()) / frames,
                ms_per_frame=dict(trace=t_trace / frames, finalize=t_fin / frames,
                                  combined=t_comb / frames))


def parity(ref_hit, hit, ref_depth, depth, ref_min_sdf) -> dict:
    """The script's parity of a finalized render against the march-verify
    trace: flips (count, share), the flips' largest |min_sdf| in the
    march trace, the common hits' depth difference (median, p95, max)."""
    rh, ph = (np.asarray(x.cpu(), bool) for x in (ref_hit, hit))
    flips = rh != ph
    both = rh & ph
    dd = np.abs(ref_depth.double().cpu().numpy() - depth.double().cpu().numpy())[both]
    rm = np.abs(ref_min_sdf.double().cpu().numpy())
    return dict(flips=int(flips.sum()), flip_frac=float(flips.mean()),
                flip_min_sdf_max=float(rm[flips].max()) if flips.any() else 0.0,
                common=quantiles(dd))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--skip", default="", help=f"comma list of stages to skip ({STAGES})")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    emit("diag_finalize_compile", measure(dev, args.img, args.frames, args.steps,
                                          {s for s in args.skip.split(",") if s}, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
