"""The compose stage (render_rays given a trace) piece by piece: the
counterpart of scripts/diag_compose.py.

On one real bench trace (trace_frame of the bench latent; ``--proxy``
marches the proxy with its margins), each piece timed on its own at the
bucket width n / compact_frac that the trace's hits give:

  noop       a one-op launch on 8 floats (the dispatch floor every
             piece below pays once)
  sort       the hit-first stable sort compose runs (torch.sort of the
             miss flag), [:bucket]
  csort      counting_sort_perm with 2 classes
  packsort   one int32 array, flag << 20 | pixel, sorted alone
  nonzero    a static-size nonzero (cumsum and one scatter of the hits'
             pixels, filled with n)
  gathers    the 5 bucket gathers (origins, dirs, depth, anchor, hit)
  sdg        K3 (precise_sdg_call) alone at the bucket width
  scatters   the script's fused depth + normal scatter and the margin's,
             and compose's own four (min_sdf, depth, normal, mask)
  margin     p_anchor, origins + anchor * dirs, at full width
  compose    render_rays(trace=...) (depth + min_sdf), and with only its
             depth read (the same eager work)
  bwd        a depth L1 through compose to the latent (the trace fixed)

Each reordering piece gives the permutation of a stable torch.sort of
the same key (nonzero: its hits, then the fill); compose's depth-only
reading is its depth bit for bit; K3 and compose are held to their plain
versions with the in-order product, bit for bit.

    python -m dist_renderer_tpu_torch.diag.diag_compose [--img 512] [--proxy]
"""

from __future__ import annotations

import torch

from dist_renderer_tpu_torch.diag import (
    RENDER_FIELDS, BenchCell, device, differ, emit, hold_to_plain, in_order, parser,
    time_ms,
)

def hit_first(hit: torch.Tensor, bucket: int) -> dict:
    """The four hit-first orderings of the pieces, each [:bucket] of the
    rays (nonzero: the hits' pixels in order, then n)."""
    from dist_renderer_tpu_torch.ops.binning import counting_sort_perm

    n = hit.shape[0]
    key = (~hit).to(torch.int32)
    pix = torch.arange(n, dtype=torch.int32, device=hit.device)
    return dict(
        sort=lambda: torch.sort(key, stable=True).indices[:bucket],
        csort=lambda: counting_sort_perm(key, 2)[0][:bucket],
        packsort=lambda: torch.sort((key << 20) | pix).values[:bucket] & ((1 << 20) - 1),
        nonzero=lambda: nonzero_static(hit, bucket))


def nonzero_static(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The first ``size`` indices where ``mask`` is set, in order, the
    rest filled with n (jnp.nonzero(size=, fill_value=n)): a cumsum and
    one scatter, no host wait."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), n, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(n, device=mask.device))
    return out[:size]


def check_orders(orders: dict, hit: torch.Tensor, bucket: int) -> dict:
    """Raise unless every ordering is the stable sort's [:bucket]
    (nonzero's hits, then n); returns the pieces' mismatches (all 0)."""
    n, n_hit = hit.shape[0], int(hit.sum())
    ref = torch.sort((~hit).to(torch.int32), stable=True).indices[:bucket]
    bad = {}
    for k, got in orders.items():
        got = got.to(torch.int64)
        if k == "nonzero":
            m = min(n_hit, bucket)
            bad[k] = int((got[:m] != ref[:m]).sum()) + int((got[m:] != n).sum())
        else:
            bad[k] = int((got != ref).sum())
    if any(bad.values()):
        raise AssertionError(f"a reordering piece is not the stable sort's order: {bad}")
    return bad


def measure(dev, cell: BenchCell, proxy: bool = False, reps: int = 3) -> dict:
    from dist_renderer_tpu_torch.config import GradConfig
    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul
    from dist_renderer_tpu_torch.ops.renderer import render_rays
    from dist_renderer_tpu_torch.utils.losses import masked_l1

    set_fp32_matmul()
    img = cell.img
    o, v, z = cell.origins, cell.dirs, cell.latent
    n = o.shape[0]
    cfg = cell.frame_cfg(GradConfig(mode="ift", compact_frac=4, recompute="pallas"),
                         proxy=proxy)
    march_fn = cell.factory(cfg, proxy)(z)
    sdf, plain_sdf = cell.sdf(), cell.sdf(False)
    res = dict(img=img, proxy=proxy, pieces_ms={})
    ms = res["pieces_ms"]

    tiny = torch.zeros((8,), device=dev)
    _, ms["noop"] = time_ms(lambda: tiny + 1.0, reps)
    with torch.no_grad():
        trace0, res["trace_ms"] = time_ms(
            lambda: march_fn.trace_frame(o, v, cfg.march, (img, img)), reps)
    n_hit = int(trace0.hit.sum())
    bucket = min(((n // cfg.grad.compact_frac + 511) // 512) * 512, n)
    res.update(rays=n, hits=n_hit, hit_frac=n_hit / n, bucket=bucket,
               bucket_used=n_hit <= bucket)

    d0 = trace0.depth
    anchor = torch.where(trace0.hit, d0, trace0.depth_at_min)
    orders = {}
    for k, fn in hit_first(trace0.hit, bucket).items():
        orders[k], ms[k] = time_ms(fn, reps)
    res["orders_differing"] = check_orders(orders, trace0.hit, bucket)
    idx_b = orders["sort"]

    def gathers():
        return tuple(a[idx_b] for a in (o, v, d0, anchor, trace0.hit))

    (o_b, v_b, d_b, a_b, h_b), ms["gathers"] = time_ms(gathers, reps)
    p_b = o_b + torch.where(h_b, d_b, a_b)[:, None] * v_b
    with torch.no_grad():
        got, ms["sdg"] = time_ms(lambda: sdf.sdg_builder(cfg.grad.recompute_block)(
            z, p_b, v_b), reps)
        with in_order():
            want = plain_sdf.sdg_builder(cfg.grad.recompute_block)(z, p_b, v_b)
    res["sdg_plain_differing"] = bad = {k: int(differ(a, b).sum())
                                        for k, a, b in zip(("s", "dd", "g"), got, want)}
    if any(bad.values()):
        raise AssertionError(f"K3 at the bucket width differs from its plain version: {bad}")

    db = torch.ones((bucket,), device=dev)
    nb = torch.ones((bucket, 3), device=dev)
    sb = torch.ones((bucket,), device=dev)

    def scatters():
        vals = torch.cat([db[None], nb.T], dim=0)
        outp = torch.zeros((4, n), device=dev).index_copy_(1, idx_b, vals)
        return outp[0], trace0.min_sdf.index_put((idx_b,), sb), outp[1:4].T

    def compose_scatters():
        return (trace0.min_sdf.index_put((idx_b,), sb),
                torch.full((n,), cfg.background_depth, device=dev).index_put((idx_b,), db),
                torch.zeros((n, 3), device=dev).index_put((idx_b,), nb),
                torch.zeros_like(trace0.hit).index_put((idx_b,), h_b))

    _, ms["scatters"] = time_ms(scatters, reps)
    _, ms["compose_scatters"] = time_ms(compose_scatters, reps)
    _, ms["margin"] = time_ms(lambda: o + anchor[:, None] * v, reps)

    def comp(sdf_fn=sdf):
        with torch.no_grad():
            return render_rays(sdf_fn, z, o, v, cfg, march_fn=march_fn, trace=trace0)

    out, ms["compose"] = time_ms(comp, reps)
    depth_only, ms["compose_depth"] = time_ms(lambda: comp().depth, reps)
    if not torch.equal(depth_only, out.depth):
        raise AssertionError("compose's depth read alone differs from compose's depth")
    with in_order():
        plain = comp(plain_sdf)
    res["compose_plain"] = hold_to_plain("compose given the trace", out, plain,
                                         RENDER_FIELDS)

    target = torch.full((n,), 1.5, device=dev)
    everywhere = torch.ones((n,), dtype=torch.bool, device=dev)

    def fwdbwd():
        zz = z.detach().clone().requires_grad_(True)
        d = render_rays(sdf, zz, o, v, cfg, march_fn=march_fn, trace=trace0).depth
        return torch.autograd.grad(masked_l1(d, target, everywhere), zz)[0]

    _, ms["compose_fwdbwd"] = time_ms(fwdbwd, reps)
    ms["bwd_alone"] = ms["compose_fwdbwd"] - ms["compose_depth"]
    res["pieces_less_noop_ms"] = {k: t - ms["noop"] for k, t in ms.items()
                                  if k not in ("noop", "bwd_alone")}
    return res


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--proxy", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, 1, args.img)
    emit("diag_compose", measure(dev, cell, args.proxy, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
