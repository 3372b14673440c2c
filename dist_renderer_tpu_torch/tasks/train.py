"""DeepSDF auto-decoder training: train a decoder and a latent table, and
export them as a DeepSDF experiment directory (specs.json,
ModelParameters/latest.pth, LatentCodes/latest.pth, and shapes.txt naming
the latents' shapes in order), which every task loads with
--experiment-dir. Runs on the card unless --cpu is given.

    # analytic shapes
    python -m dist_renderer_tpu_torch.tasks.train --shapes sphere torus union \\
        --steps 3000 --out experiments/analytic3

    # DeepSDF-format sample files: npz with pos / neg rows, or [N, 4] npy
    python -m dist_renderer_tpu_torch.tasks.train --samples 'data/sdf/*.npz' --out exp/
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.checkpoint import save_deepsdf_experiment
from dist_renderer_tpu_torch.models.train_deepsdf import (
    train_deepsdf_analytic, train_deepsdf_samples,
)
from dist_renderer_tpu_torch.tasks.common import analytic_shape, synchronize, task_device


def read_samples(path: str) -> np.ndarray:
    """One shape's [N, 4] (x, y, z, sdf) rows: a DeepSDF SdfSamples npz
    (its pos and neg arrays, concatenated) or an [N, >= 4] npy."""
    d = np.load(path)
    if hasattr(d, "files"):
        with d:
            arr = np.concatenate([d[k][:, :4] for k in ("pos", "neg") if k in d.files])
    else:
        arr = np.asarray(d)[:, :4]
    return arr.astype(np.float32)


def main(argv=None):
    """Returns (params, latents, losses [steps] as numpy, ms per step)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shapes", nargs="*", default=None,
                    choices=["sphere", "torus", "union"],
                    help="analytic training shapes (default: all three)")
    ap.add_argument("--samples", nargs="*", default=None,
                    help="DeepSDF-format sample files or globs ([N, 4] npy / npz)")
    ap.add_argument("--out", required=True, help="experiment dir to export")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch-shapes", type=int, default=4)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--latent-lr", type=float, default=1e-3)
    ap.add_argument("--decoder-width", type=int, default=512)
    ap.add_argument("--decoder-depth", type=int, default=8)
    ap.add_argument("--latent-size", type=int, default=256)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = task_device(args)
    depth = args.decoder_depth
    dcfg = DecoderConfig(latent_size=args.latent_size,
                         hidden_dims=(args.decoder_width,) * depth,
                         latent_in=(depth // 2,) if depth >= 2 else ())
    kw = dict(steps=args.steps, batch_shapes=args.batch_shapes,
              points_per_shape=args.points, lr=args.lr, latent_lr=args.latent_lr,
              device=dev)
    t0 = time.perf_counter()
    if args.samples:
        files = [f for pat in args.samples for f in sorted(glob.glob(pat))]
        if not files:
            raise SystemExit(f"no sample files matched {args.samples}")
        params, latents, losses = train_deepsdf_samples(
            [read_samples(f) for f in files], dcfg, **kw)
        names = [os.path.basename(f) for f in files]
    else:
        names = args.shapes or ["sphere", "torus", "union"]
        fns = [(lambda p, s=analytic_shape(n): s(None, p)) for n in names]
        params, latents, losses = train_deepsdf_analytic(fns, dcfg, **kw)
    synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0) / max(args.steps, 1)
    h = losses.cpu().numpy()
    print(f"trained {len(names)} shapes: loss {h[:50].mean():.4f} -> "
          f"{h[-50:].mean():.4f} over {args.steps} steps, {ms:.2f} ms/step")
    save_deepsdf_experiment(args.out, params, dcfg, latents=latents)
    with open(os.path.join(args.out, "shapes.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    print(f"exported DeepSDF experiment dir -> {args.out}")
    return params, latents, h, ms


if __name__ == "__main__":
    main()
