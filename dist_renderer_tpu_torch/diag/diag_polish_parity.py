"""The parity of proxy_verify_hits="polish" against "march" on the bench
frame: the counterpart of scripts/diag_polish_parity.py.

render() of the bench latent through the proxy (its margins), twice:
verify_hits "march" (every proxy hit confirmed by a full-decoder march,
the exactness anchor) and "polish" (hits skip the verify march; the
composition's full-decoder Newton polish, ``--polish-iters`` steps,
re-anchors depth and demotes false hits). Reported:

  - hit flips (count, share of rays) and their confinement: every
    flipped ray's |min_sdf| in the march render below twice the proxy
    band;
  - the depth difference on common hits, and on the frontal ones
    (|normal_z| > 0.2): median, p95, max, beside the script's gate, p95
    < 1e-3 (a finding, reported, not a check);
  - fwd and fwd+bwd ms of both modes (``--reps`` each).

Both renders are held to the same renders through the plain versions
with the in-order product, bit for bit.

    python -m dist_renderer_tpu_torch.diag.diag_polish_parity [--img 512]
        [--steps 50] [--polish-iters 2] [--reps 10]
"""

from __future__ import annotations

import numpy as np

from dist_renderer_tpu_torch.diag import BenchCell, device, emit, parser, quantiles, time_ms

GATE_P95 = 1e-3   # the script's production bar on the frontal p95


def parity_stats(ref_mask, pol_mask, ref_depth, pol_depth, ref_min_sdf, ref_normal,
                 band: float) -> dict:
    """The script's numbers from the two renders' maps (numpy): hits of
    each, flips and their share, the flips' largest |min_sdf| in the
    march render against 2 x band, and the depth difference's median,
    p95 and max on common hits and on frontal common hits."""
    rh, ph = np.asarray(ref_mask, bool), np.asarray(pol_mask, bool)
    flips = rh != ph
    out = dict(hits_march=int(rh.sum()), hits_polish=int(ph.sum()), flips=int(flips.sum()),
               flip_frac=float(flips.mean()), band=float(band))
    if flips.any():
        ms = np.abs(np.asarray(ref_min_sdf))[flips]
        out.update(flip_min_sdf_max=float(ms.max()), confined=bool(ms.max() < 2 * band))
    common = rh & ph
    dd = np.abs(np.asarray(pol_depth, np.float64) - np.asarray(ref_depth, np.float64))
    frontal = (np.abs(np.asarray(ref_normal)[..., 2]) > 0.2) & common
    out.update(common=quantiles(dd[common]), frontal=quantiles(dd[frontal]))
    out["gate_p95_met"] = bool(frontal.any() and out["frontal"]["p95"] < GATE_P95)
    return out


def measure(dev, cell: BenchCell, steps: int = 50, polish_iters: int = 2,
            reps: int = 10) -> dict:
    from dist_renderer_tpu_torch.config import GradConfig
    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul

    set_fp32_matmul()
    renders, times = {}, {}
    for mode in ("march", "polish"):
        grad = GradConfig(mode="ift", compact_frac=4, recompute="pallas",
                          polish_iters=polish_iters if mode == "polish" else 1)
        cfg = cell.frame_cfg(grad, proxy=True, max_steps=steps, proxy_verify_hits=mode)
        fwd, fwdbwd = cell.frame_fns(cfg, cell.factory(cfg, proxy=True))
        out, t_f = time_ms(fwd, reps)
        _, t_fb = time_ms(fwdbwd, reps)
        times[mode] = dict(fwd_ms=t_f, fwdbwd_ms=t_fb,
                           plain=cell.hold_frame(f"verify_hits={mode}", cfg, out, proxy=True))
        renders[mode] = out
    ref, pol = renders["march"], renders["polish"]
    n = lambda t: t.detach().cpu().numpy()
    stats = parity_stats(n(ref.mask), n(pol.mask), n(ref.depth), n(pol.depth),
                         n(ref.min_sdf), n(ref.normal), cell.band)
    return dict(img=cell.img, steps=steps, polish_iters=polish_iters, reps=reps,
                gate_p95=GATE_P95, modes=times, **stats)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--polish-iters", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, 1, args.img)
    emit("diag_polish_parity", measure(dev, cell, args.steps, args.polish_iters, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
