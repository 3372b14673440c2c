"""The planning glue around the march kernels: the counterpart of
scripts/diag_glue.py.

At F=8 frames of N=262,144 rays (one 512^2 frame each), keys in [0, 3)
and values drawn from numpy seeds, each piece timed on its own:

  argsort    a stable sort of the keys per frame (torch.sort)
  csort      counting_sort_perm with 3 classes (the same permutation)
  cumsum     one cumsum of a class flag
  scatter    a permutation scatter of the ray ids
  take3      take_along_dim of [F, N, 3] by the sort's order
  take1      take_along_dim of [F, N]
  launch     one batched K1 launch (batched_trace_padded on the bench
             8x512 decoder) over the script's 4,096 blocks of 512 rays,
             with 0% and 6% of each frame's rays live

``--appendix`` (the script's GLUE_APPENDIX): a key sort carrying 10
payloads, the unsort of 6 payloads by a permutation, and the argsort
and a gather each read in full (their sums).

Checks: the counting sort is the stable argsort; the all-dead launch
returns no hit; the 6%-live launch equals the same launch through the
plain version with the in-order product, bit for bit, on its first
PLAIN_FRAMES frames.

    python -m dist_renderer_tpu_torch.diag.diag_glue [--appendix]
"""

from __future__ import annotations

import numpy as np
import torch

from dist_renderer_tpu_torch.diag import (
    PLAIN_FRAMES, TRACE_FIELDS, BenchCell, device, emit, hold_to_plain, in_order,
    parser, time_ms,
)

F, N = 8, 262144


def operands(dev, f: int = F, n: int = N) -> dict:
    """The script's operands from numpy seeds: keys [f, n] in [0, 3),
    x3 [f, n, 3], x1 [f, n], ten payloads [f, n], a permutation of n
    per frame (the same for every frame)."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a).to(dev)
    return dict(key=t(rng.integers(0, 3, (f, n)).astype(np.int32)),
                x3=t(rng.standard_normal((f, n, 3)).astype(np.float32)),
                x1=t(rng.standard_normal((f, n)).astype(np.float32)),
                pays=[t(rng.standard_normal((f, n)).astype(np.float32)) for _ in range(10)],
                perm=t(rng.permutation(n)).expand(f, n))


def sort_payloads(key: torch.Tensor, pays, stable: bool = True):
    """A key sort along the rays that carries payloads (lax.sort with one
    key and payload operands): (sorted keys, each payload in that order),
    one gather of the stacked payloads."""
    srt = torch.sort(key, dim=1, stable=stable)
    stacked = torch.stack(list(pays), dim=-1)
    moved = torch.gather(stacked, 1, srt.indices[..., None].expand_as(stacked))
    return (srt.values,) + tuple(moved.unbind(-1))


def glue_pieces(dev, x: dict, reps: int) -> dict:
    from dist_renderer_tpu_torch.ops.binning import counting_sort_perm

    key = x["key"]
    f, n = key.shape
    ms = {}
    order, ms["argsort"] = time_ms(lambda: torch.sort(key, dim=1, stable=True).indices, reps)
    (corder, _), ms["csort"] = time_ms(lambda: counting_sort_perm(key, 3), reps)
    if not torch.equal(corder, order):
        raise AssertionError("counting_sort_perm differs from the stable argsort")
    _, ms["cumsum"] = time_ms(lambda: torch.cumsum((key == 1).to(torch.int32), dim=1), reps)
    ids = torch.arange(n, dtype=torch.int32, device=dev).expand(f, n)
    _, ms["scatter"] = time_ms(lambda: torch.zeros((f, n), dtype=torch.int32, device=dev)
                               .scatter_(1, x["perm"], ids), reps)
    _, ms["take3"] = time_ms(lambda: torch.take_along_dim(x["x3"], order[..., None], 1), reps)
    _, ms["take1"] = time_ms(lambda: torch.take_along_dim(x["x1"], order, 1), reps)
    return ms


def appendix(dev, x: dict, reps: int) -> dict:
    """The script's sort_payload_bench: a key sort with 10 payloads, the
    unsort of 6 payloads by a permutation, argsort + sum, gather + sum."""
    key, pays = x["key"], x["pays"]
    ms = {}
    _, ms["sort_key_10_payloads"] = time_ms(lambda: sort_payloads(key, pays)[1:], reps)
    _, ms["unsort_6_payloads"] = time_ms(
        lambda: sort_payloads(x["perm"], pays[:6], stable=False)[1:], reps)
    _, ms["argsort_sum"] = time_ms(
        lambda: torch.sort(key, dim=1, stable=True).indices.sum(), reps)
    order = torch.sort(key, dim=1, stable=True).indices
    _, ms["gather_sum"] = time_ms(lambda: torch.take_along_dim(pays[0], order, 1).sum(), reps)
    return ms


def launches(dev, cell: BenchCell, reps: int, f: int = F, n: int = N) -> dict:
    """The batched K1 launch over f * n / 512 blocks of rays from
    (0, 0, -2.5) along +z, 0% and 6% of each frame live."""
    from dist_renderer_tpu_torch.config import MarchConfig
    from dist_renderer_tpu_torch.ops.kernels.batched_march import (
        batched_trace_padded, fold_bias_bank,
    )

    shared = cell.packed[0]
    with torch.no_grad():
        bank = fold_bias_bank(cell.params, cell.latent[None].expand(f, -1), cell.dcfg, shared)
    march = MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4)
    o = torch.tensor([0.0, 0.0, -2.5], device=dev).expand(f, n, 3)
    v = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(f, n, 3)
    out = dict(blocks=f * n // 512)
    for frac, name in ((0.0, "all_dead"), (0.06, "live_6pct")):
        active = (torch.arange(n, device=dev) < int(n * frac))[None].expand(f, n)

        def run(use_kernel=True, frames=f):
            with torch.no_grad():
                return batched_trace_padded(shared, bank, o[:frames], v[:frames],
                                            march, None, active[:frames],
                                            use_kernel=use_kernel)

        res, t = time_ms(run, reps)
        row = dict(ms=t, live=int(active.sum()), hits=int(res.hit.sum()))
        if frac == 0.0 and row["hits"]:
            raise AssertionError(f"the all-dead launch returned {row['hits']} hits")
        if frac > 0.0:
            with in_order():
                plain = run(use_kernel=False, frames=PLAIN_FRAMES)
            row["plain"] = hold_to_plain(f"K1 launch, {name}", res, plain, TRACE_FIELDS)
        out[name] = row
    return out


def measure(dev, cell: BenchCell, reps: int = 3, with_appendix: bool = False,
            frames: int = F, rays: int = N) -> dict:
    x = operands(dev, frames, rays)
    res = dict(frames=frames, rays=rays, pieces_ms=glue_pieces(dev, x, reps),
               launch=launches(dev, cell, reps, frames, rays))
    if with_appendix:
        res["appendix_ms"] = appendix(dev, x, reps)
    return res


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--appendix", action="store_true",
                    help="also the payload sorts (the script's GLUE_APPENDIX)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = device()
    cell = BenchCell(dev, 1)
    emit("diag_glue", measure(dev, cell, args.reps, args.appendix))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
