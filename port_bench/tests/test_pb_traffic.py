"""The traffic generator: the same seed gives the same inputs, another
seed other inputs, any whole seed works, and the views cover the ranges."""

import json
import os

import numpy as np
import pytest
import torch

from helpers import ROOT
from port_bench import views

TRAFFIC = os.path.join(ROOT, "port_bench", "traffic")
MIXES = sorted(f[:-5] for f in os.listdir(TRAFFIC) if f.endswith(".json"))
SEEDS = [0, 7, 2**31 + 11, 2**32 + 3, -5]


def _mix(name):
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        return json.load(f)


def _inputs(traffic, seed, unit):
    base = torch.zeros(8)
    return (views.unit_views(traffic, seed, unit),
            views.unit_latents(traffic, seed, unit, base).numpy())


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic_per_seed_and_different_across_seeds(mix, seed):
    t = _mix(mix)
    v1, l1 = _inputs(t, seed, 3)
    v2, l2 = _inputs(t, seed, 3)
    assert v1 == v2 and np.array_equal(l1, l2)
    v3, l3 = _inputs(t, seed + 1, 3)
    assert v1 != v3 and not np.array_equal(l1, l3)
    v4, l4 = _inputs(t, seed, 4)
    assert v1 != v4 and not np.array_equal(l1, l4)
    assert len(v1) == t["views_per_unit"] and l1.shape[0] == t["latents_per_unit"]


@pytest.mark.parametrize("mix", MIXES)
def test_views_cover_their_ranges_evenly(mix):
    t = _mix(mix)
    vs = [v for u in range(-2, 200 // t["views_per_unit"] + 2)
          for v in views.unit_views(t, 99, u)]
    for key, field in (("azimuth_deg", "azimuth"), ("elevation_deg", "elevation"),
                       ("distance", "distance")):
        lo, hi = t[key]
        x = np.array([getattr(v, field) for v in vs])
        assert lo <= x.min() and x.max() <= hi
        if hi > lo:
            # a Kronecker sequence: every tenth of the range holds 10% +- 3%
            hist = np.histogram((x - lo) / (hi - lo), bins=10, range=(0, 1))[0] / len(x)
            assert np.all(np.abs(hist - 0.1) < 0.03), hist


def test_cameras_and_rays():
    t = _mix("frame1")
    view = views.View(azimuth=0.0, elevation=0.0, distance=2.5)
    K, R, T = views.look_at(view, 32, 1.2, "cpu")
    o, d = views.rays(K, R, T, 32)
    assert torch.allclose(o[0], torch.tensor([0.0, 0.0, -2.5]), atol=1e-6)
    assert torch.allclose(d.norm(dim=-1), torch.ones(32 * 32), atol=1e-6)
    # the centre of the image looks at the origin
    centre = d.reshape(32, 32, 3)[15:17, 15:17].mean((0, 1))
    assert torch.allclose(centre / centre.norm(), torch.tensor([0.0, 0.0, 1.0]), atol=1e-3)
    # the port's camera and rays agree with the benchmark's on the same K, R, T
    from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays

    po, pd = pixel_rays(Camera(K=K, R=R, T=T), 32, 32)
    assert torch.allclose(po[:1], o, atol=1e-6) and torch.allclose(pd, d, atol=1e-6)
    up = views.look_at(views.View(0.0, 30.0, 2.5), 32, 1.2, "cpu")
    assert float((-up[1].T @ up[2])[1]) > 1.0   # elevation puts the eye above the xz plane
    assert t["img"] == 512
