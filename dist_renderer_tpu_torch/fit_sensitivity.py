"""How far the tasks' short fits follow a tiny change of K4's u, on one
CUDA card.

Runs the two ``--mesh`` fits that ``chip_smoke.py``'s phase 7 checks
(depth_completion, 8 steps at 256x256; multiview, 10 steps at 128x128
with ``--w-photo 0.1``; both from the zero latent at lr 5e-2, on the
committed torus decoder), each:

  - twice as they are (the fit is a function of its inputs: both runs
    must agree);
  - once per ``--seeds`` with every u that K4 returns moved by ``--rel``
    relative L2 (default 3e-7, the difference K4's u showed when its
    deltas came from the tensor cores' order) along a seeded direction,
    before ``latent_grad`` turns it into the latent's gradient.

u on the card is the in-order plain version's fp32 deltas summed in a
fixed order, so a perturbed run is the plain path with u perturbed.
Prints, per run, the loss history and the mesh's vertex and face counts,
and one JSON line with all of them and the card's name and power limit.

    python -m dist_renderer_tpu_torch.fit_sensitivity [--rel 3e-7]
                                                      [--seeds 3] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def _obj_counts(path):
    if not os.path.exists(path):
        return 0, 0
    with open(path) as f:
        lines = f.read().splitlines()
    return sum(l.startswith("v ") for l in lines), sum(l.startswith("f ") for l in lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rel", type=float, default=3e-7)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", help="JSON file for the results")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fit_sensitivity: needs a CUDA card", file=sys.stderr)
        return 1
    from dist_renderer_tpu_torch.ops.kernels import recompute as rc
    from dist_renderer_tpu_torch.tasks import depth_completion, multiview

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    tasks = (
        ("depth_completion", depth_completion.main, "fitted.obj",
         ["--fast", "--img", "256", "--steps", "8", "--lr", "5e-2", "--mesh",
          "--mesh-res", "128"]),
        ("multiview", multiview.main, "reconstructed.obj",
         ["--fast", "--img", "128", "--views", "3", "--steps", "10", "--lr", "5e-2",
          "--w-photo", "0.1", "--mesh"]),
    )
    real = rc.latent_grad
    runs = []
    for name, fn, obj, argv_t in tasks:
        for seed in (None, None) + tuple(range(args.seeds)):
            gen = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)

            def moved(packed, us, gen=gen):
                out = []
                for u in us:
                    r = torch.randn(u.shape, generator=gen, device=u.device,
                                    dtype=torch.float64)
                    step = args.rel * u.double().norm() * r / r.norm()
                    out.append((u.double() + step).float())
                return real(packed, out)

            rc.latent_grad = real if gen is None else moved
            hist, err = [], None
            try:
                with tempfile.TemporaryDirectory() as tmp:
                    res = fn(argv_t + ["--out", tmp])
                    hist = [float(x) for x in res.loss_history.tolist()]
                    nv, nf = _obj_counts(os.path.join(tmp, obj))
            except Exception as e:  # an empty shape may fail the mesh's steps
                nv = nf = 0
                err = f"{type(e).__name__}: {e}"
            finally:
                rc.latent_grad = real
            runs.append(dict(task=name, seed=seed, rel=0.0 if seed is None else args.rel,
                             losses=hist, verts=nv, faces=nf, error=err))
            print(f"{name} seed {seed}: losses {[round(x, 6) for x in hist]}; "
                  f"mesh {nv} verts, {nf} faces{'; ' + err if err else ''}  [{smi}]",
                  flush=True)
    res = dict(card=smi, runs=runs)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
