"""Re-distill the bench proxy with a larger budget and report whether it
beats the committed one: the counterpart of scripts/retrain_proxy.py.

The proxy's near-surface error sets the verify stage's margins: its max
the proxy band (band rays are re-marched from sphere entry), its p99 the
backoff (proxy_march_margins). This distills a new proxy of the bench
8x512 decoder on the card (``--steps`` Adam steps of ``--batch`` points,
a ``--depth`` x ``--width`` trunk, near-surface weight ``--near-weight``
within ``--near-band``, latent jitter 0.002, noise scales 0.05, 0.01,
2e-3, 5e-4, lr ``--lr`` on a cosine), prints both proxies'
proxy_error_report (seed 0 on the card) and writes the new one to
``.bench_proxy_v2.npz`` or ``--out``. ``.bench_proxy.npz`` is replaced
only with ``--promote``, and then only when the new proxy's max and p99
are both below the committed one's (the bench decoder is never
touched).

    python -m dist_renderer_tpu_torch.diag.retrain_proxy [--steps 30000]
        [--out PATH] [--promote]
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from dist_renderer_tpu_torch.diag import ROOT, device, emit, parser

BENCH_PROXY = ".bench_proxy.npz"
NEW_PROXY = ".bench_proxy_v2.npz"


def improved(old: Optional[dict], new: dict) -> bool:
    """The script's promotion rule: no committed proxy, or the new max
    and p99 both below the committed one's."""
    return old is None or (new["max"] < old["max"] and new["p99"] < old["p99"])


def output_files(root: str, out: Optional[str] = None, promote: bool = False,
                 old: Optional[dict] = None, new: Optional[dict] = None) -> list:
    """The files a run writes, in order: the new proxy's (``out``, default
    root/.bench_proxy_v2.npz), then root/.bench_proxy.npz only when
    ``promote`` and the new error report ``new`` improves on ``old``.
    An ``out`` naming the committed proxy raises: it is replaced only
    through ``promote``."""
    path = out or os.path.join(root, NEW_PROXY)
    if os.path.realpath(path) == os.path.realpath(os.path.join(root, BENCH_PROXY)):
        raise SystemExit(f"--out {path} is the committed proxy: it is replaced only "
                         f"with --promote, on an improvement")
    files = [path]
    if promote and new is not None and improved(old, new):
        files.append(os.path.join(root, BENCH_PROXY))
    return files


def measure(dev, steps: int = 30000, batch: int = 16384, width: int = 256, depth: int = 4,
            near_weight: float = 8.0, near_band: float = 0.015, lr: float = 1.5e-3,
            out: Optional[str] = None, promote: bool = False, root: str = ROOT) -> dict:
    from dist_renderer_tpu_torch.config import DecoderConfig
    from dist_renderer_tpu_torch.models.pretrain import load_params_npz
    from dist_renderer_tpu_torch.models.proxy import (
        default_proxy_cfg, distill_proxy, load_proxy_npz, proxy_error_report,
        save_proxy_npz,
    )

    output_files(root, out, promote)    # refuse the committed file early
    dcfg = DecoderConfig()
    params, z0 = load_params_npz(os.path.join(root, ".bench_decoder.npz"), dev)
    lat = z0[None]
    report = lambda p, c: proxy_error_report(params, dcfg, p, c, lat,
                                             torch.Generator(device=dev).manual_seed(0))
    old = None
    bench = os.path.join(root, BENCH_PROXY)
    if os.path.exists(bench):
        old = report(*load_proxy_npz(bench, dev))
        print("old:", old, flush=True)
    t0 = time.perf_counter()
    proxy, pcfg = distill_proxy(params, dcfg, lat,
                                proxy_cfg=default_proxy_cfg(dcfg, width=width, depth=depth),
                                steps=steps, batch=batch, lr=lr, latent_jitter=0.002,
                                noise_scales=(0.05, 0.01, 2e-3, 5e-4),
                                near_weight=near_weight, near_band=near_band)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    new = report(proxy, pcfg)
    print("new:", new, flush=True)
    files = output_files(root, out, promote, old, new)
    for path in files:
        save_proxy_npz(path, proxy, pcfg, err_report=new)
    return dict(steps=steps, batch=batch, width=width, depth=depth, near_weight=near_weight,
                near_band=near_band, lr=lr, distill_seconds=seconds,
                ms_per_step=1e3 * seconds / max(steps, 1), old=old, new=new,
                improved=improved(old, new), written=files,
                promoted=len(files) > 1)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--near-weight", type=float, default=8.0)
    ap.add_argument("--near-band", type=float, default=0.015)
    ap.add_argument("--lr", type=float, default=1.5e-3)
    ap.add_argument("--out", default=None, help=f"the new proxy's file (default {NEW_PROXY})")
    ap.add_argument("--promote", action="store_true",
                    help=f"replace {BENCH_PROXY} when the new proxy improves on it")
    args = ap.parse_args(argv)
    dev = device()
    emit("retrain_proxy", measure(dev, args.steps, args.batch, args.width, args.depth,
                                  args.near_weight, args.near_band, args.lr, args.out,
                                  args.promote))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
