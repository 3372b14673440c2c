"""The band margins of verify_band="probe" against "march" on the bench
proxy: the counterpart of scripts/diag_band_fidelity.py.

render_batched_c2f of the bench cell (F frames of 512^2, strides (16,
4), 50 steps, the proxy with the margins of its error report) with
verify_mode="march" and with verify_mode="cert", verify_band="probe".
Reported: the proxy's error report, hit agreement and flips, the hits
the probe promotes (a hit only there) and demotes (a hit only in the
march), the margin |probe - march| on the band rays (a miss in both
with the march's min_sdf below the band): p50, p95, max, and the depth
|probe - march| on common hits. Both renders are held to the same
renders through the plain versions with the in-order product, bit for
bit, on their first PLAIN_FRAMES frames.

    python -m dist_renderer_tpu_torch.diag.diag_band_fidelity [--img 512]
        [--frames 8]
"""

from __future__ import annotations

import os

import numpy as np

from dist_renderer_tpu_torch.diag import (
    ROOT, BenchCell, device, emit, parser, quantiles,
)


def band_stats(h_m, h_p, ms_m, ms_p, d_m, d_p, band: float) -> dict:
    """The script's numbers from the two renders' [F, N] fields (numpy),
    and the promoted (hit only in the probe render) and demoted (hit
    only in the march render) counts."""
    h_m, h_p = np.asarray(h_m, bool), np.asarray(h_p, bool)
    ms_m, ms_p = np.asarray(ms_m, np.float64), np.asarray(ms_p, np.float64)
    sel = ~h_m & ~h_p & (ms_m < band)
    both = h_m & h_p
    return dict(hit_agree=float((h_m == h_p).mean()), flips=int((h_m != h_p).sum()),
                rays=int(h_m.size), promoted=int((h_p & ~h_m).sum()),
                demoted=int((h_m & ~h_p).sum()), band_rays=int(sel.sum()),
                band_margin=quantiles(np.abs(ms_p[sel] - ms_m[sel])),
                hit_depth=quantiles(np.abs(np.asarray(d_p, np.float64)
                                           - np.asarray(d_m, np.float64))[both]))


def measure(dev, cell: BenchCell, reps: int = 1) -> dict:
    from dist_renderer_tpu_torch.models.proxy import load_proxy_meta

    outs, rows = {}, {}
    for name, kw in (("march", dict(verify_mode="march")),
                     ("probe", dict(verify_mode="cert", verify_band="probe"))):
        out, ms, held = cell.timed_render(reps, **kw)
        outs[name] = out
        rows[name] = dict(ms=ms, ms_per_frame=ms / cell.frames, plain=held)
    n = lambda t: t.detach().cpu().numpy()
    m, p = outs["march"], outs["probe"]
    return dict(frames=cell.frames, img=cell.img, backoff=cell.backoff, band=cell.band,
                proxy_err=load_proxy_meta(os.path.join(ROOT, ".bench_proxy.npz")),
                renders=rows, **band_stats(n(m.hit), n(p.hit), n(m.min_sdf), n(p.min_sdf),
                                           n(m.depth), n(p.depth), cell.band))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, args.frames, args.img)
    emit("diag_band_fidelity", measure(dev, cell, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
