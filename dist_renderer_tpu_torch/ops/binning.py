"""Counting-sort permutations for small integer keys.

Counterpart of the JAX package's ``ops/binning.py``. Ordering a frame's
rays by class (rim -> interior -> skip) needs only a stable sort over a
few small integer keys; on the TPU a full argsort was a bitonic network,
and a counting sort (K masked cumsums and one scatter) replaced it. On
the card ``torch.sort(stable=True)`` gives the same permutation, and the
renderer's ``class_order`` keeps whichever the card runs faster
(chip_smoke.py phase 12 times both at the main path's shape).
"""

from __future__ import annotations

from typing import Tuple

import torch


def counting_sort_perm(key: torch.Tensor, num_classes: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable counting-sort permutations of integer keys [..., N] in
    [0, num_classes) (leading dims batch). Returns (order, inv), both
    [..., N] int64:
      order == torch.sort(key, stable=True).indices   (gather: x[order])
      inv[i] == the sorted position of element i      (unsort: sorted[inv] == x)."""
    dest = torch.zeros(key.shape, dtype=torch.int64, device=key.device)
    start = torch.zeros(key.shape[:-1] + (1,), dtype=torch.int64, device=key.device)
    for c in range(num_classes):
        m = key == c
        dest = torch.where(m, start + torch.cumsum(m, dim=-1) - 1, dest)
        start = start + m.sum(dim=-1, keepdim=True)
    ids = torch.arange(key.shape[-1], device=key.device).expand(key.shape)
    order = torch.empty_like(dest).scatter_(-1, dest, ids)
    return order, dest
