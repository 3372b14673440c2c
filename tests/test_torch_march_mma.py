"""The host side of K1's and K1-multi's tensor-core tile march
(csrc/march_mma.cuh on csrc/point_mlp.cuh's body), on the CPU: the
march's shared-memory plan (mlp_eval.mma_smem_bytes with march=True), the
steps of its 64-ray tiles (batched_march.march_tile_steps), and the
per-ray independence its bits rest on: the plain version of K1 run on
64-ray slices, one of which straddles two frames, gives the whole run's
rows. The
kernels themselves run only on the card (tests/test_torch_cuda.py).

Decoders: the bench 8x512 (.bench_decoder.npz), its 4x256 proxy
(.bench_proxy.npz), the default 8x512 color decoder, and seeded 4x40,
4x48 and 4x528 decoders, as tests/test_torch_point_mma.py builds them.
"""

import os

import numpy as np
import pytest
import torch

from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.models.pretrain import load_params_npz
from dist_renderer_tpu_torch.models.proxy import load_proxy_npz
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
from dist_renderer_tpu_torch.ops.kernels import march_body, mlp_eval

from test_torch_cuda import _dot_k_order
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)
from test_torch_point_mma import DECODERS, _shared

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARCH = MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4)
# the march's rows' carries [12][64], geometry [8][64] and step values
# [64], fp32, and their ray or pixel indices [64], int32
MARCH_STATE_BYTES = 4 * 22 * 64


def _wide(width: int) -> bm.SharedDecoder:
    cfg = DecoderConfig(latent_size=8, hidden_dims=(width,) * 2, latent_in=())
    rng = np.random.default_rng(0)
    params = params_from_numpy({"layers": [
        {"w": rng.standard_normal((i, o)) * 0.01, "b": np.zeros(o)}
        for i, o in cfg.layer_dims]})
    return bm.pack_shared(params, cfg)


@pytest.mark.parametrize("which", DECODERS + ["4x528"])
def test_march_smem_plan_fits_an_h100_block(which):
    """The march's plan is K5's with the rows' march state added, and it
    fits the 232,448 bytes an H100 block may use for every decoder the
    repo marches (226,896 bytes at width 512) and up to width 528."""
    shared = _shared(which)
    need = mlp_eval.mma_smem_bytes(shared, march=True)
    assert need == mlp_eval.mma_smem_bytes(shared) + MARCH_STATE_BYTES
    assert need <= mlp_eval.SMEM_LIMIT == 232_448
    if which in ("bench", "color"):
        assert need == 226_896
    mlp_eval.check_mma_plan(shared, shared.tiles.device, march=True)


@pytest.mark.parametrize("width", [544, 600, 1024])
def test_march_smem_plan_refuses_a_decoder_it_cannot_hold(width):
    """A decoder too wide for the march's plan raises, naming its width
    and the march kernels, before any launch; at width 544 K5's plan,
    without the march state, still fits."""
    shared = _wide(width)
    assert mlp_eval.mma_smem_bytes(shared, march=True) > mlp_eval.SMEM_LIMIT
    with pytest.raises(ValueError, match=f"width {width} .* K1/K1-multi"):
        mlp_eval.check_mma_plan(shared, shared.tiles.device, march=True)
    if width == 544:
        mlp_eval.check_mma_plan(shared, shared.tiles.device)


def test_march_tile_steps_are_each_tiles_slowest_ray():
    """A tile steps while any of its rays is active: its steps are the most
    of its rays' step counts; a ragged tail pads with rays that never
    step, and lane-steps (64 a tile step) cover the active ray-steps."""
    rng = np.random.default_rng(5)
    for n in (1, 64, 100, 1000):
        steps = torch.as_tensor(rng.integers(0, 12, n), dtype=torch.int32)
        got = bm.march_tile_steps(steps)
        assert got.shape == ((n + 63) // 64,)
        for t in range(got.shape[0]):
            assert int(got[t]) == int(steps[64 * t:64 * t + 64].max())
        assert 64 * int(got.sum()) >= int(steps.sum())
    assert torch.equal(bm.march_tile_steps(torch.zeros((2, 96), dtype=torch.int32)),
                       torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("salvage", [True, False])
def test_plain_k1_on_tile_slices_equals_the_whole_run(salvage, monkeypatch):
    """K1's plain version, with the kernels' k-order sum, run on each
    64-ray slice of two frames of 90 rays (padded to 96, so the middle
    tile straddles the frames) gives the whole run's [8, N] rows: a ray's
    march depends on its own frame's biases and nothing else in its tile,
    which is what lets the tensor-core tile march equal the in-order
    witness's 32-ray tiles bit for bit."""
    monkeypatch.setattr(march_body, "dot_f32", _dot_k_order)
    params, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"))
    _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    rng = np.random.default_rng(2)
    lat = z0[None] + 0.001 * torch.as_tensor(rng.standard_normal((2, z0.shape[0])),
                                             dtype=torch.float32)
    shared = bm.pack_shared(params, pcfg)
    bank = bm.fold_bias_bank(params, lat, pcfg, shared)
    o, v = [], []
    for f in range(2):
        cam = Camera.looking_at((0.3 * f, 0.1, -2.5), focal=12.0, img_hw=(10, 10))
        of, vf = pixel_rays(cam, 10, 10)
        o.append(of[:90])
        v.append(vf[:90])
    o, v = torch.stack(o), torch.stack(v)
    seed = torch.where(torch.as_tensor(rng.random((2, 90)) < 0.3),
                       torch.as_tensor(rng.uniform(1.3, 1.8, (2, 90)), dtype=torch.float32),
                       torch.full((2, 90), float("nan")))
    active = torch.as_tensor(rng.random((2, 90)) < 0.9)
    o_p, v_p, s_p, a_p, frame, r_pad = bm.pad_frames(o, v, seed, active)
    assert r_pad == 96 and frame[64] != frame[127]
    rs = bm.ray_setup(o_p, v_p, MARCH, s_p, a_p)
    whole = bm.march_rows_plain(shared, bank, frame, o_p, v_p, rs, MARCH, salvage, False)
    assert whole[1].sum() > 20
    for i in range(0, o_p.shape[0], bm.MARCH_TILE):
        sl = slice(i, i + bm.MARCH_TILE)
        rows = bm.march_rows_plain(shared, bank, frame[sl], o_p[sl], v_p[sl],
                                   bm.RaySetup(*(x[sl] for x in rs)), MARCH, salvage,
                                   False)
        assert torch.equal(rows, whole[:, sl]), i
