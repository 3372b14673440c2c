"""March result record and live-ray telemetry."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class TraceResult(NamedTuple):
    """Per-ray march outcome (all [N] unless noted)."""

    depth: torch.Tensor        # converged hit distance (valid where hit)
    hit: torch.Tensor          # bool: ray converged onto the surface
    min_sdf: torch.Tensor      # running min of sdf along the march
    depth_at_min: torch.Tensor  # distance at which min_sdf was observed
    last_sdf: torch.Tensor     # sdf at the final evaluated point
    steps_used: torch.Tensor   # scalar: most steps any ray took
    live_counts: torch.Tensor  # [max_steps] rays alive at each step
    unresolved: torch.Tensor   # bool: still live when the budget ended
    steps_per_ray: Optional[torch.Tensor] = None  # [N] int32 steps each ray took
    bracketed: Optional[torch.Tensor] = None      # [N] bool: owns a bracket


def live_counts_from_steps(steps_per_ray: torch.Tensor,
                           max_steps: int) -> torch.Tensor:
    """live_counts[k] = #rays active at the start of step k+1 =
    #{i: steps_i > k}."""
    s = torch.clamp(steps_per_ray.to(torch.int64), 0, max_steps)
    hist = torch.bincount(s.reshape(-1), minlength=max_steps + 1)
    c = torch.cumsum(hist, 0)
    return (c[-1] - c[:-1]).to(torch.int32)
