"""Cost attribution of the proxy pipeline at batch: the counterpart of
scripts/diag_proxy_ab.py.

render_batched_c2f of the bench cell (F frames of 512x512, strides
(16, 4), 50 steps) under ablations, each timed on its own:

  full    no proxy
  march   the proxy and its march verify (the default)
  hybrid  march verify of hits, 3-probe band rays (verify_band="probe")
  cert    verify_mode="cert" (band rays re-marched)
  certp   verify_mode="cert" with probed band rays
  nv      the proxy's trace, verify skipped (proxy_verify=False): its
          time against march's is the verify stage's true cost, full's
          against it the proxy march's true saving

``MODE-bN`` (N from ``--blocks``) is the TPU script's proxy_block=N,
which only steered the TPU's scheduling: in the port it is MODE's
render, timed again and marked so. Every render is held to the same
render through the plain versions.

    python -m dist_renderer_tpu_torch.diag.diag_proxy_ab [--frames 8]
        [--modes full,march,nv] [--vcaps 1,3,8,24] [--backoff 0.0]
"""

from __future__ import annotations

from dist_renderer_tpu_torch.diag import BenchCell, device, emit, parser

# mode -> render_batched_c2f's options
MODES = {
    "full": dict(proxy=False),
    "march": dict(verify_mode="march"),
    "hybrid": dict(verify_mode="march", verify_band="probe"),
    "cert": dict(verify_mode="cert"),
    "certp": dict(verify_mode="cert", verify_band="probe"),
    "nv": dict(proxy_verify=False),
}
ALL_MODES = "full,march,hybrid,cert,certp,nv"


def measure(dev, cell: BenchCell, modes: str = "full,march,nv", blocks: str = "1024,2048",
            vcaps=None, backoff=None, reps: int = 3) -> dict:
    pkw = {}
    if vcaps:
        pkw["verify_round_caps"] = tuple(int(c) for c in vcaps.split(","))
    if backoff is not None:
        pkw["proxy_backoff"] = backoff
    f = cell.frames
    rows = {}
    for m in modes.split(","):
        base, _, block = m.partition("-b")
        if base not in MODES or (block and block not in blocks.split(",")):
            raise SystemExit(f"unknown mode {m!r} (modes: {ALL_MODES}, each also as "
                             f"MODE-bN with N in --blocks {blocks})")
        kw = dict(MODES[base], **({} if base == "full" else pkw))
        out, ms, held = cell.timed_render(reps, **kw)
        rows[m] = dict(ms=ms, ms_per_frame=ms / f, hits=out.hit.sum().item() / f,
                       plain=held)
        if block:
            rows[m]["note"] = (f"proxy_block={block} has no effect in the port: the "
                               f"render is {base!r}'s")
    out = dict(frames=f, backoff=pkw.get("proxy_backoff", cell.backoff), band=cell.band,
               verify_round_caps=pkw.get("verify_round_caps"), rows=rows)
    if {"full", "march", "nv"} <= rows.keys():
        out["verify_stage_ms_per_frame"] = (rows["march"]["ms_per_frame"]
                                            - rows["nv"]["ms_per_frame"])
        out["proxy_saving_ms_per_frame"] = (rows["full"]["ms_per_frame"]
                                            - rows["nv"]["ms_per_frame"])
    return out


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--blocks", default="1024,2048")
    ap.add_argument("--modes", default="full,march,nv",
                    help=f"comma list of {ALL_MODES}, or MODE-bN (N from --blocks)")
    ap.add_argument("--vcaps", default=None, help="verify_round_caps, e.g. 1,3,8,24")
    ap.add_argument("--backoff", type=float, default=None,
                    help="proxy_backoff in place of the proxy's measured one")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, args.frames, args.img)
    emit("diag_proxy_ab", measure(dev, cell, args.modes, args.blocks, args.vcaps,
                                  args.backoff, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
