"""The precise value's paths and their error: the counterpart of
scripts/diag_precision.py.

decoder_apply of the bench 8x512 decoder on the card, per variant:

  split     precision="split": every layer the bf16x3 split (the JAX
            package's precise value path)
  bf16      compute_dtype=bfloat16: one bf16 product a layer
  split_x   precision="split_x": the split on the layers that read the
            raw (z, x) input, one bf16 product on the hidden ones
  fp32      compute_dtype=float32 with TF32 off (set_fp32_matmul; the
            setting is in the JSON): the port's precise value path

Each variant's time at 262,144 points (one 512^2 frame; uniform in
[-0.9, 0.9]^3 from numpy seed 1), and its error against the fp32 value
on the CPU at 200,000 points (numpy seed 0): p50, p95 and max over all
of them and over the near-surface ones (|f| < 0.05). The fp32 variant
must have the smallest error of the four.

    python -m dist_renderer_tpu_torch.diag.diag_precision
"""

from __future__ import annotations

import numpy as np
import torch

from dist_renderer_tpu_torch.diag import (
    BenchCell, device, emit, parser, quantiles, time_ms,
)

VARIANTS = {
    "split": dict(precision="split"),
    "bf16": dict(compute_dtype=torch.bfloat16),
    "split_x": dict(precision="split_x"),
    "fp32": dict(compute_dtype=torch.float32),
}
NEAR = 0.05


def points(n: int, seed: int) -> np.ndarray:
    """n points uniform in [-0.9, 0.9]^3 from a numpy seed."""
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (n, 3)).astype(np.float32)


def cpu_reference(params, latent, pts: np.ndarray, dcfg, chunk: int = 50000) -> np.ndarray:
    """decoder_apply in fp32 on the CPU, in chunks."""
    from dist_renderer_tpu_torch.models.decoder import decoder_apply

    p_cpu = {"layers": [{k: t.detach().cpu() for k, t in l.items()}
                        for l in params["layers"]]}
    z = latent.detach().cpu()
    with torch.no_grad():
        return np.concatenate([decoder_apply(p_cpu, z, torch.from_numpy(pts[i:i + chunk]),
                                             dcfg).numpy()
                               for i in range(0, len(pts), chunk)])


def error_stats(f_v: np.ndarray, f_ref: np.ndarray, near=None) -> dict:
    """The error's p50, p95 and max over every point and over the near-
    surface ones (|f_ref| < NEAR unless ``near`` is given)."""
    err = np.abs(np.asarray(f_v, np.float64) - np.asarray(f_ref, np.float64))
    near = np.abs(f_ref) < NEAR if near is None else near
    return dict(all=quantiles(err), near=quantiles(err[near]))


def measure(dev, cell: BenchCell, n_err: int = 200000, n_time: int = 262144,
            reps: int = 3) -> dict:
    from dist_renderer_tpu_torch.models.decoder import decoder_apply, set_fp32_matmul

    set_fp32_matmul()
    params, dcfg, z = cell.params, cell.dcfg, cell.latent
    pts = points(n_err, 0)
    f_ref = cpu_reference(params, z, pts, dcfg)
    near = np.abs(f_ref) < NEAR
    p_err = torch.from_numpy(pts).to(dev)
    p_time = torch.from_numpy(points(n_time, 1)).to(dev)
    rows = {}
    for name, kw in VARIANTS.items():
        with torch.no_grad():
            _, t = time_ms(lambda: decoder_apply(params, z, p_time, dcfg, **kw), reps)
            f_v = decoder_apply(params, z, p_err, dcfg, **kw).cpu().numpy()
        rows[name] = dict(ms=t, **error_stats(f_v, f_ref, near))
    best = {k: min(rows, key=lambda r: rows[r]["all"][k]) for k in ("p95", "max")}
    if set(best.values()) != {"fp32"}:
        raise AssertionError(f"the fp32 variant's error is not the smallest: {best} "
                             f"({ {k: r['all'] for k, r in rows.items()} })")
    return dict(points=n_err, near_points=int(near.sum()), time_points=n_time,
                tf32=bool(torch.backends.cuda.matmul.allow_tf32), variants=rows)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, 1)
    emit("diag_precision", measure(dev, cell, reps=args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
