"""Where the milliseconds of the two bench workloads go: the counterpart
of scripts/diag_perf.py.

- The batched path: render_batched_c2f of F frames of the bench cell on
  the 8x512 decoder without its proxy (``--strides``, ``--coarse-steps``),
  ms, ms/frame, Mrays/s and hit share; then the same render with
  ``with_diag``: each march launch's residency (the steps of each 64-row
  tile, ``march_tile_steps``) against its active ray-steps, each coarse
  level's ray steps, and the device time per tile-step the render's
  time implies were the kernels its whole cost.
- The single-frame path: ``render()`` of the bench latent at the same
  march (fwd, and fwd+bwd of a depth L1 to the latent), and its pieces:
  the batched pipeline's F=1 trace (``trace_frame``; the forward's rest,
  compose on the IFT bucket and its glue, is fwd less it), the K1-grid
  path's ``c2f_plan`` and its seeded fine trace, and the precise value of
  every pixel's point and its backward to the latent (the TPU script's
  pieces: its forward composed every pixel).

Every render is held to the same render through the plain versions
with the in-order product, bit for bit.

    python -m dist_renderer_tpu_torch.diag.diag_perf [--img 512] [--frames 8]
"""

from __future__ import annotations

import torch

from dist_renderer_tpu_torch.diag import (
    BenchCell, device, emit, parser, residency, stage_lanes, summary, time_ms,
)


def batched(cell: BenchCell, strides, coarse_steps: int, reps: int) -> dict:
    """The batched path without the proxy, and its telemetry."""
    kw = dict(proxy=False, strides=tuple(strides), coarse_steps=coarse_steps)
    out, ms, held = cell.timed_render(reps, **kw)
    f, n = out.depth.shape
    (st, diag), diag_ms, _ = cell.timed_render(reps, held=False, with_diag=True,
                                                return_steps=True, **kw)
    res = residency(diag)
    total = sum(r.get("sum", 0.0) for r in res.values())
    return dict(
        frames=f, strides=list(strides), coarse_steps=coarse_steps, ms=ms,
        ms_per_frame=ms / f, mrays_s=f * n / ms / 1e3,
        hit_frac=out.hit.float().mean().item(), plain=held, diag_ms=diag_ms,
        residency=res, stages=stage_lanes(diag, int(st.steps.sum())),
        ray_steps={k: summary(v) for k, v in diag.items() if k.endswith("_ray_steps")},
        tile_steps=total, us_per_tile_step=1e3 * ms / total if total else None)


def single_frame(cell: BenchCell, strides, coarse_steps: int, reps: int) -> dict:
    """render() of the bench latent and its pieces, no proxy."""
    from dist_renderer_tpu_torch.ops.renderer import _trace, c2f_plan

    img = cell.img
    cfg = cell.frame_cfg(c2f_strides=tuple(strides), c2f_coarse_steps=coarse_steps)
    march = cfg.march
    z = cell.latent
    sdf_fn = cell.sdf()
    factory = cell.factory(cfg)
    o, v = cell.origins, cell.dirs
    fwd, fwdbwd = cell.frame_fns(cfg, factory, sdf_fn)
    out, t_fwd = time_ms(fwd, reps)
    held = cell.hold_frame("render() fwd", cfg, out)
    _, t_fb = time_ms(fwdbwd, reps)
    mf = factory(z)
    with torch.no_grad():
        _, t_frame = time_ms(lambda: mf.trace_frame(o, v, march, (img, img)), reps)
        plan, t_plan = time_ms(lambda: c2f_plan(mf, o, v, cfg), reps)
        perm = plan.order
        o_s, v_s = o[perm], v[perm]
        id_s, ia_s = plan.init_depth[perm], plan.init_active[perm]
        _, t_trace = time_ms(lambda: _trace(mf, o_s, v_s, cfg, id_s, ia_s), reps)
        p_surf = o + v    # one unit along every pixel's ray
        _, t_prec = time_ms(lambda: sdf_fn(z, p_surf), reps)

    def prec_bwd():
        zz = z.detach().clone().requires_grad_(True)
        return torch.autograd.grad(sdf_fn(zz, p_surf).sum(), zz)[0]

    _, t_pbwd = time_ms(prec_bwd, reps)
    return dict(
        fwd_ms=t_fwd, fwdbwd_ms=t_fb, hit_frac=out.mask.float().mean().item(),
        plain=held, trace_frame_ms=t_frame, c2f_plan_ms=t_plan, fine_trace_ms=t_trace,
        precise_eval_ms=t_prec, precise_bwd_ms=t_pbwd, points=int(p_surf.shape[0]),
        beyond_trace_ms=t_fwd - t_frame)


def measure(dev, cell: BenchCell, strides=(4,), coarse_steps: int = 24,
            reps: int = 3) -> dict:
    return dict(img=cell.img, steps=cell.march.max_steps,
                batched=batched(cell, strides, coarse_steps, reps),
                single_frame=single_frame(cell, strides, coarse_steps, reps))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--strides", type=int, nargs="*", default=[4])
    ap.add_argument("--coarse-steps", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, args.frames, args.img, args.steps)
    emit("diag_perf", measure(dev, cell, args.strides, args.coarse_steps, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
