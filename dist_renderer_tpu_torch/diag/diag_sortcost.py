"""The reordering primitives at the batched render's shapes: the
counterpart of scripts/diag_sortcost.py.

At F=8 frames of N=512^2 rays, keys in [0, 3) and ten float payloads
from numpy seeds (diag_glue's operands), each timed on its own:

  sort k+P    a stable key sort carrying P = 2, 4, 7, 10 payloads
              (diag_glue.sort_payloads: the sort, then one gather of the
              stacked payloads), at full width and, for P = 2, 4, 7, at
              half width
  take1       take_along_dim of one [F, N] payload by the order
  row take    a row gather of [F * N, 10] by a permutation
  row scatter a row scatter of [F * N, 10] by it (out of place)
  argsort     the stable sort's order alone

Check: every payload sort equals argsort + take_along_dim of each
payload, bit for bit.

    python -m dist_renderer_tpu_torch.diag.diag_sortcost
"""

from __future__ import annotations

import numpy as np
import torch

from dist_renderer_tpu_torch.diag import device, emit, parser, time_ms
from dist_renderer_tpu_torch.diag.diag_glue import operands, sort_payloads

F, N = 8, 512 * 512


def measure(dev, reps: int = 5, frames: int = F, rays: int = N) -> dict:
    x = operands(dev, frames, rays)
    key, pays = x["key"], x["pays"]
    order = torch.sort(key, dim=1, stable=True).indices
    ms = {}
    for half in (False, True):
        w = rays // 2 if half else rays
        k = key[:, :w].contiguous()
        for npay in ((2, 4, 7) if half else (2, 4, 7, 10)):
            ps = [p[:, :w].contiguous() for p in pays[:npay]]
            out, ms[f"sort_key_{npay}_payloads{'_half' if half else ''}"] = time_ms(
                lambda: sort_payloads(k, ps), reps)
            o_k = torch.sort(k, dim=1, stable=True).indices
            want = [torch.take_along_dim(p, o_k, 1) for p in ps]
            if not all(torch.equal(a, b) for a, b in zip(out[1:], want)):
                raise AssertionError(f"the sort with {npay} payloads differs from "
                                     f"argsort + gather")
    _, ms["take1"] = time_ms(lambda: torch.take_along_dim(pays[0], order, 1), reps)
    rows = torch.stack(pays, dim=-1).reshape(frames * rays, 10)
    rng = np.random.default_rng(1)
    ridx = torch.from_numpy(rng.permutation(frames * rays)).to(dev)
    _, ms["row_take"] = time_ms(lambda: rows.index_select(0, ridx), reps)
    _, ms["row_scatter"] = time_ms(lambda: rows.index_copy(0, ridx, rows), reps)
    _, ms["argsort"] = time_ms(lambda: torch.sort(key, dim=1, stable=True).indices, reps)
    return dict(frames=frames, rays=rays, ms=ms)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = device()
    emit("diag_sortcost", measure(dev, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
