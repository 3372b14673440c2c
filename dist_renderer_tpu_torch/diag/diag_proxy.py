"""The proxy march and its verify stage, stage by stage: the counterpart
of scripts/diag_proxy.py.

On the bench cell (the 8x512 decoder, its 4x256 proxy and the proxy's
margins, strides (16, 4), 50 steps, F frames of 512x512):

- one with_diag render on the rounds scheduler: the plan's class shares
  (rim, interior, skip) from the proxy's pyramid, the verify key's
  (re-march, seeded hit, skip), each stage's residency;
- timed renders (``--scheduler``, return_steps and return_last): the
  full decoder alone, the proxy with its verify stage, verify_hits
  "polish", the polish trace with ``finalize_hits_batched`` in the timed
  region, "polish-all" with it, and the unverified proxy trace
  (``proxy_verify=False``): ms/frame, hits, unresolved rays and step
  sums a frame. The proxy's time less the unverified trace's is the
  verify stage's cost; the proxy's steps less the unverified trace's
  are the verify stage's ray-steps, which with the diag render's
  residency give each stage's lane-steps against its ray-steps.

Every render is held to the same render through the plain versions (the
finalize, which has no kernel, on its trace).

    python -m dist_renderer_tpu_torch.diag.diag_proxy [--frames 1] [--scheduler auto]
"""

from __future__ import annotations

import numpy as np

from dist_renderer_tpu_torch.diag import (
    BenchCell, device, emit, hold_to_plain, in_order, parser, residency, stage_lanes,
    time_ms,
)


def verify_kw(vcaps=None, band=None) -> dict:
    """The scripts' --vcaps (verify_round_caps) and --band (verify_band)."""
    kw = {}
    if vcaps:
        kw["verify_round_caps"] = tuple(int(c) for c in vcaps.split(","))
    if band:
        kw["verify_band"] = band
    return kw


def row(out, ms: float, f: int) -> dict:
    """A timed render's line: ms/frame, hits, unresolved rays and step
    counts a frame."""
    steps = out.steps.double()
    return dict(ms=ms, ms_per_frame=ms / f, hits=out.hit.sum().item() / f,
                unres=(0.0 if out.unresolved is None else out.unresolved.sum().item() / f),
                steps_per_frame=steps.sum().item() / f, steps_mean=steps.mean().item(),
                steps_p99=float(np.percentile(out.steps.cpu().numpy(), 99)))


def measure(dev, cell: BenchCell, scheduler: str = "auto", backoff=None,
            vkw=None, reps: int = 3) -> dict:
    from dist_renderer_tpu_torch.ops.renderer import finalize_hits_batched

    vkw = dict(vkw or {})
    if backoff is not None:
        vkw["proxy_backoff"] = backoff
    f = cell.frames
    flags = dict(return_steps=True, return_last=True, scheduler=scheduler)

    (_, diag), diag_ms, _ = cell.timed_render(reps, held=False, with_diag=True,
                                              scheduler="rounds", **vkw)
    pk, vk = diag["plan_key"], diag["verify_key"]
    share = lambda k, c: (k == c).float().mean().item()
    out = dict(frames=f, scheduler=scheduler, backoff=vkw.get("proxy_backoff", cell.backoff),
               band=cell.band, diag_ms=diag_ms,
               plan_key=dict(rim=share(pk, 0), interior=share(pk, 1), skip=share(pk, 2)),
               verify_key=dict(remarch=share(vk, 0), seeded_hit=share(vk, 1),
                               skip=share(vk, 2)),
               residency=residency(diag), rows={}, plain={})

    def timed(tag, proxy=True, **kw):
        res, ms, held = cell.timed_render(reps, proxy=proxy, **flags, **vkw, **kw)
        out["rows"][tag] = row(res, ms, f)
        out["plain"][tag] = held
        return res

    timed("full", proxy=False)
    verified = timed("proxy")
    timed("proxy-polish", verify_hits="polish")

    def finalized(vh, **fkw):
        ob, vb = cell.rays(f)

        def step():
            st = cell.render(verify_hits=vh, scheduler=scheduler, **vkw)
            fin = finalize_hits_batched(
                cell.params, cell.dcfg, cell.lats[:f], ob, vb, st.depth, st.hit,
                st.min_sdf, convergence_eps=cell.march.convergence_eps, polish_iters=2,
                **({"weak": st.weak} if vh == "polish-all" else {}), **fkw)
            return st, fin

        (st, fin), ms = time_ms(step, reps)
        with in_order():
            plain = cell.render(f=1, use_kernel=False, verify_hits=vh, **vkw,
                                scheduler="queue" if scheduler == "auto" and f == 1 else
                                "rounds" if scheduler == "auto" else scheduler)
        tag = f"proxy-{vh}+finalize"
        out["plain"][tag] = hold_to_plain(tag, st, plain)
        out["rows"][tag] = dict(ms=ms, ms_per_frame=ms / f, hits=fin[1].sum().item() / f)

    finalized("polish")
    finalized("polish-all", compact_frac=3)
    unverified = timed("proxy-noverify", proxy_verify=False)
    v_steps = int(verified.steps.sum()) - int(unverified.steps.sum())
    out["verify_stage"] = dict(
        ms=out["rows"]["proxy"]["ms"] - out["rows"]["proxy-noverify"]["ms"],
        ray_steps=v_steps)
    if scheduler == "rounds" or (scheduler == "auto" and f > 1):
        # the timed renders ran the diag render's scheduler: the same steps
        out["stages"] = stage_lanes(diag, int(unverified.steps.sum()), v_steps)
    return out


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--scheduler", default="auto")
    ap.add_argument("--backoff", type=float, default=None,
                    help="proxy_backoff in place of the proxy's measured one")
    ap.add_argument("--vcaps", default=None, help="verify_round_caps, e.g. 1,4,12")
    ap.add_argument("--band", default=None, choices=["march", "probe"],
                    help="verify_band (probe: the hybrid)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, args.frames, args.img)
    emit("diag_proxy", measure(dev, cell, args.scheduler, args.backoff,
                               verify_kw(args.vcaps, args.band), args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
