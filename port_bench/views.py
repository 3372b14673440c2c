"""The one traffic generator: cameras, rays and latents drawn from a
traffic file's parameters and the run's seed. The port receives only what
this makes.

A unit (a batch, a request, a fit job) holds ``latents_per_unit`` latents
and ``views_per_unit`` views; every latent is seen from every view.
View k of unit i is point i * views_per_unit + k of a Kronecker sequence
(additive recurrence) whose start the seed draws, so each run covers the
ranges evenly and two seeds cover them alike, in another order: the
seed changes which views come when, not how hard the whole window is.
Latents are the fixture latent + ``latent_sigma`` N(0, 1) per latent,
from a generator seeded with (seed, unit).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

# irrational steps of the three coordinates (azimuth, elevation, distance)
_STEPS = ((math.sqrt(5.0) - 1.0) / 2.0, math.sqrt(2.0) - 1.0, math.sqrt(3.0) - 1.0)


class View(NamedTuple):
    azimuth: float     # degrees
    elevation: float   # degrees above the xz plane (+y is up)
    distance: float


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for (seed, stream...); any whole seed, negative too."""
    return np.random.default_rng(np.random.SeedSequence(
        [seed % 2**64] + [s % 2**64 for s in stream]))


def _span(traffic: dict, key: str) -> Tuple[float, float]:
    lo_hi = traffic[key]
    return float(lo_hi[0]), float(lo_hi[1])


def unit_views(traffic: dict, seed: int, unit: int) -> List[View]:
    """The views of unit ``unit`` (warm-up units are negative)."""
    m = int(traffic["views_per_unit"])
    start = rng(seed, 1 << 40).random(3)
    out = []
    for k in range(m):
        j = unit * m + k
        frac = [(start[d] + j * _STEPS[d]) % 1.0 for d in range(3)]
        vals = [lo + (hi - lo) * u for (lo, hi), u in zip(
            (_span(traffic, "azimuth_deg"), _span(traffic, "elevation_deg"),
             _span(traffic, "distance")), frac)]
        out.append(View(*vals))
    return out


def unit_latents(traffic: dict, seed: int, unit: int, base: torch.Tensor) -> torch.Tensor:
    """[latents_per_unit, L] on base's device: base + sigma N(0, 1)."""
    n = int(traffic["latents_per_unit"])
    noise = rng(seed, 2, unit).standard_normal((n, base.shape[-1])).astype(np.float32)
    return base[None] + float(traffic["latent_sigma"]) * torch.from_numpy(noise).to(base.device)


def look_at(view: View, img: int, focal_scale: float, device) -> Tuple[torch.Tensor, ...]:
    """(K, R, T) of a pinhole camera at ``view`` looking at the origin
    (x_cam = R x_world + T; +z forward, +x right, +y down in the camera
    frame; world +y up), focal ``focal_scale`` * img, principal point at
    the image centre."""
    f32 = torch.float32
    az, el = math.radians(view.azimuth), math.radians(view.elevation)
    eye = torch.tensor([view.distance * math.cos(el) * math.sin(az),
                        view.distance * math.sin(el),
                        -view.distance * math.cos(el) * math.cos(az)], dtype=f32, device=device)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=f32, device=device)
    fwd = -eye / torch.linalg.norm(eye)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=0)
    T = -R @ eye
    fl = focal_scale * img
    c = (img - 1) / 2.0
    K = torch.tensor([[fl, 0.0, c], [0.0, fl, c], [0.0, 0.0, 1.0]], dtype=f32, device=device)
    return K, R, T


def rays(K: torch.Tensor, R: torch.Tensor, T: torch.Tensor, img: int):
    """(origin [1, 3], unit dirs [img * img, 3]) in world space, row-major
    pixels, a ray through each pixel's integer coordinates."""
    dev = K.device
    ys = torch.arange(img, dtype=torch.float32, device=dev)
    v, u = torch.meshgrid(ys, ys, indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], dim=-1).reshape(-1, 3)
    d = pix @ torch.linalg.inv(K).T @ R
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return (-R.T @ T)[None], d
