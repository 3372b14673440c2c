"""The proxy render's band margin against the full march's sampled
minimum and the true ray minimum: the counterpart of
scripts/debug_band_probe.py.

The script's scene, made on the card: a 4x48 decoder (latent 8, skip at
layer 2) fitted to a sphere of radius 0.5 for 400 steps (batch 2,048),
its 3x32 proxy distilled for 1,500 steps (batch 2,048, lr 2e-3), two
frames of 32x32 of the fitted latent from (0, 0, -2), focal 40.
render_batched_c2f (strides (4,), 50 steps, eps 2e-3 / 5e-4) without the
proxy (the full march) and with it; the true minimum of each ray is the
least full-decoder value over 2,401 samples t in [0.8, 3.2] (a step of
1e-3). On the band rays of frame 0 (a miss in both renders, the full
march's min_sdf below MarchConfig().proxy_band): the errors march - true,
probe - true and probe - march (p50, p95, max), and the 8 rays where
probe and march differ most. Both renders are held to the same renders
through the plain versions with the in-order product, bit for bit.

    python -m dist_renderer_tpu_torch.diag.debug_band_probe
"""

from __future__ import annotations

import torch

from dist_renderer_tpu_torch.diag import (
    TRACE_FIELDS, device, emit, hold_to_plain, in_order, parser, quantiles,
)

IMG, F = 32, 2
KW = dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,))


def scene(dev, fit_steps: int = 400, distill_steps: int = 1500):
    """(params, dcfg, z0, (proxy, pcfg)): the script's fitted decoder and
    distilled proxy on ``dev``."""
    from dist_renderer_tpu_torch.config import DecoderConfig
    from dist_renderer_tpu_torch.models.analytic import sphere_sdf
    from dist_renderer_tpu_torch.models.pretrain import fit_decoder_to_sdf
    from dist_renderer_tpu_torch.models.proxy import default_proxy_cfg, distill_proxy

    dcfg = DecoderConfig(**KW)
    params, z0 = fit_decoder_to_sdf(lambda p: sphere_sdf(0.5)(None, p), dcfg,
                                    steps=fit_steps, batch=2048, device=dev)
    proxy = distill_proxy(params, dcfg, z0[None],
                          proxy_cfg=default_proxy_cfg(dcfg, width=32, depth=3),
                          steps=distill_steps, batch=2048, lr=2e-3)
    return params, dcfg, z0, proxy


def true_min(params, dcfg, z0, o, v, n: int = 2401) -> torch.Tensor:
    """Each ray's least full-decoder value (fp32) over n samples t in
    [0.8, 3.2]."""
    from dist_renderer_tpu_torch.models.decoder import decoder_apply

    ts = torch.linspace(0.8, 3.2, n, device=o.device)
    with torch.no_grad():
        pts = o[:, None] + ts[None, :, None] * v[:, None]
        return decoder_apply(params, z0, pts.reshape(-1, 3), dcfg).reshape(o.shape[0], n) \
            .min(dim=1).values


def measure(dev, fit_steps: int = 400, distill_steps: int = 1500) -> dict:
    from dist_renderer_tpu_torch.config import MarchConfig
    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul
    from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
    from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f

    set_fp32_matmul()
    params, dcfg, z0, proxy = scene(dev, fit_steps, distill_steps)
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG), device=dev)
    o, v = pixel_rays(cam, IMG, IMG)
    lat = torch.stack([z0, z0])
    march = MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                        coarse_to_fine=True)

    def run(use_kernel=True, **kw):
        with torch.no_grad():
            return render_batched_c2f(params, dcfg, lat, o[None].expand(F, -1, 3),
                                      v[None].expand(F, -1, 3), (IMG, IMG), march,
                                      strides=(4,), shared_origin=True,
                                      use_kernel=use_kernel, **kw)

    outs, held = {}, {}
    for name, kw in (("full", {}), ("probe", dict(proxy=proxy))):
        outs[name] = run(**kw)
        with in_order():
            held[name] = hold_to_plain(f"{name} render", outs[name],
                                       run(use_kernel=False, **kw), TRACE_FIELDS)
    tm = true_min(params, dcfg, z0, o, v)
    full, prox = outs["full"], outs["probe"]
    msf, msp = full.min_sdf[0], prox.min_sdf[0]
    sel = ~full.hit[0] & ~prox.hit[0] & (msf < MarchConfig().proxy_band)
    dd = (msp - msf).abs()[sel]
    idx = sel.nonzero().flatten()
    worst = [dict(ray=int(idx[k]), march=float(msf[idx[k]]), probe=float(msp[idx[k]]),
                  true=float(tm[idx[k]]))
             for k in torch.argsort(-dd)[:8].tolist()]
    return dict(img=IMG, frames=F, fit_steps=fit_steps, distill_steps=distill_steps,
                plain=held, band_rays=int(sel.sum()),
                hits=dict(full=int(full.hit.sum()), probe=int(prox.hit.sum())),
                march_vs_true=quantiles((msf - tm).abs()[sel]),
                probe_vs_true=quantiles((msp - tm).abs()[sel]),
                probe_vs_march=quantiles(dd), worst=worst)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.parse_args(argv)
    dev = device()
    emit("debug_band_probe", measure(dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
