"""The host side of K2's and K1-grid's tensor-core march (the queue and
the one-frame range forms of csrc/march_mma.cuh), on the CPU: the
march's shared-memory plan with its pixel region, the rule that makes a
tile pure (batched_march.tile_frames, which the kernel's block vote
mirrors), the arguments K1-grid's and K2's wrappers hand to the C entry
points, and the per-ray independence K2's bits rest on: the plain
version's generation schedule, run with each generation's survivors
marched in random 64-ray groups that mix frames, gives the whole run's
rows. The kernels themselves run only on the card
(tests/test_torch_cuda.py).

Decoders: tests/test_torch_point_mma.py's DECODERS.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from dist_renderer_tpu_torch.config import MarchConfig
from dist_renderer_tpu_torch.models.folded import fold_latent
from dist_renderer_tpu_torch.models.pretrain import load_params_npz
from dist_renderer_tpu_torch.models.proxy import load_proxy_npz
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
from dist_renderer_tpu_torch.ops.kernels import build, march_body, mlp_eval
from dist_renderer_tpu_torch.ops.kernels import fused_march as fm
from dist_renderer_tpu_torch.ops.kernels import queue_march as qm
from dist_renderer_tpu_torch.ops.kernels.march_body import (
    Carry, make_carry, march_loop, mlp_apply, rows_from_carry,
)

from test_torch_cuda import _dot_k_order
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)
from test_torch_point_mma import DECODERS, _shared

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARCH = MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4)
M, STAGES, STAGE_BYTES, QCAP = 64, 4, 16384, 2048


def _plan_by_region(w16: int) -> int:
    """csrc/point_mlp.cuh's smem_plan(w16, march=True), region by region."""
    act = -(-2 * M * w16 * 2 // 1024) * 1024   # two bf16 activation buffers, 1 KB aligned
    regions = [
        act,
        STAGES * STAGE_BYTES,                   # the weight ring
        4 * w16, 4 * w16, 4 * 3 * w16,          # biases, near-tie scales, x weights
        4 * 6 * M,                              # positions
        4 * M,                                  # frames
        4 * M,                                  # row norms
        4 * QCAP, 16,                           # near-tie queue and its count
        M * w16 // 8,                           # overflow bits
        8 * 2 * STAGES,                         # mbarriers
        4 * 12 * M, 4 * 8 * M, 4 * M,           # carries, geometry, step values
        4 * M,                                  # the rows' ray or pixel indices
    ]
    return sum(regions)


@pytest.mark.parametrize("which", DECODERS)
def test_queue_plan_fits_an_h100_block(which):
    """The march's plan, with the [64] int32 region of the rows' pixel
    indices the queue form reads, is the sum of its regions and fits the
    232,448 bytes an H100 block may use (226,896 at width 512)."""
    shared = _shared(which)
    t = shared.table
    w16 = max([16] + [-(-w // 16) * 16 for w in list(t[0::5]) + list(t[1::5])])
    need = mlp_eval.mma_smem_bytes(shared, march=True)
    assert need == _plan_by_region(w16) == mlp_eval.smem_plan_bytes(w16, True)
    assert need <= mlp_eval.SMEM_LIMIT == 232_448
    if which in ("bench", "color"):
        assert need == 226_896
    mlp_eval.check_mma_plan(shared, shared.tiles.device, march=True)


def _purity_by_loop(rows, rpf):
    """Each 64-row tile pure when every row's frame is row 0's, rows past
    the end counted as row 0."""
    out = []
    for i in range(0, len(rows), M):
        part = rows[i:i + M]
        out.append(all(p // rpf == part[0] // rpf for p in part))
    return out


def test_tile_purity_rule():
    """A tile is pure when every row's frame equals row 0's; rows past
    the end take row 0's frame, so a short last tile of one frame stays
    pure. Range tiles straddle frames where rays_per_frame is not a
    multiple of 64; queue tiles mix whatever frames the queue holds."""
    frames, pure = bm.tile_frames(torch.arange(4 * 96), 96)
    assert frames.shape == (6, 64)
    assert pure.tolist() == [True, False, True, True, False, True]
    # a short queue of one frame, padded past its end: pure
    frames, pure = bm.tile_frames(torch.tensor([200, 7, 150]), 96)
    assert pure.tolist() == [False]
    frames, pure = bm.tile_frames(torch.tensor([100, 101, 191]), 96)
    assert pure.tolist() == [True] and frames[0].tolist() == [1] * 64
    rng = np.random.default_rng(4)
    for n, rpf in ((1, 96), (63, 96), (65, 70), (300, 96), (1000, 262_144)):
        rows = rng.permutation(4 * rpf)[:n]
        _, pure = bm.tile_frames(torch.as_tensor(rows), rpf)
        assert pure.tolist() == _purity_by_loop(rows.tolist(), rpf), (n, rpf)


def _fits(arg, ctype) -> bool:
    """An argument ctypes passes as the C signature's type says."""
    if ctype is ctypes.c_void_p:
        return isinstance(arg, (ctypes.c_void_p, ctypes.Array))
    if ctype is ctypes.c_int:
        return isinstance(arg, int) and not isinstance(arg, bool)
    return isinstance(arg, float)


def _folded(which):
    if which == "bench":
        params, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
        from dist_renderer_tpu_torch.config import DecoderConfig
        cfg = DecoderConfig()
    else:
        params, cfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"))
        _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    return fm.pack_folded(fold_latent(params, z0, cfg), cfg)


@pytest.mark.parametrize("which", ["proxy", "bench"])
def test_k1_grid_args_carry_the_mma_layout_and_a_one_column_bank(which):
    """K1-grid's wrapper hands drt_sphere_trace_grid the rays, the shared
    weights with their MMA layout (tiles, rows, near-tie scales) and the
    folded biases as a one-column bank, in the C signature's order and
    types; every pointer is the tensor's own."""
    packed = _folded(which)
    sh = packed.shared
    assert packed.bias.shape == (sh.total, 1) and packed.bias.dtype == torch.float32
    assert sh.wscale.shape == (sh.total,) and sh.wscale.dtype == torch.float32
    streamed = sum(w.shape[0] * (-(-w.shape[1] // 16) * 16)
                   for w in sh.whT if w is not None)
    assert sh.tiles.dtype == sh.wrows.dtype == torch.bfloat16
    assert sh.tiles.numel() == sh.wrows.numel() == streamed
    n = 100
    rays, out = torch.zeros((16, n)), torch.empty((8, n))
    args = fm.grid_args(packed, rays, MARCH, True, out)
    sig = build.SIGNATURES["drt_sphere_trace_grid"]
    assert len(args) + 1 == len(sig)  # and the stream
    assert all(_fits(a, t) for a, t in zip(args, sig)), args
    ptr = lambda t: t.data_ptr()
    assert [args[i].value for i in (0, 2, 3, 4, 5, 8, 17)] == [
        ptr(rays), ptr(sh.flat), ptr(sh.tiles), ptr(sh.wrows), ptr(sh.wscale),
        ptr(packed.bias), ptr(out)]
    assert args[1] == n and args[7] == len(sh.offsets) and args[9] == 1
    assert list(args[6]) == list(sh.table)
    mlp_eval.check_mma_plan(sh, rays.device, march=True)


def test_k2_generation_args_follow_the_c_signature():
    """K2's generation arguments: K1-grid's decoder group with the bank's
    stride, the cap, the carries and the two queues with their counts."""
    shared = _shared("proxy")
    bank = torch.zeros((shared.total, 128))
    n = 96
    rays, state = torch.zeros((16, n)), torch.zeros((12, n))
    queues, counts = torch.zeros((2, n), dtype=torch.int32), torch.zeros(3, dtype=torch.int32)
    args = qm.generation_args(shared, bank, rays, 32, MARCH, 6, state, queues[0],
                              counts[0:1], queues[1], counts[1:2])
    sig = build.SIGNATURES["drt_queue_generation"]
    assert len(args) + 1 == len(sig)
    assert all(_fits(a, t) for a, t in zip(args, sig)), args
    assert args[1:3] == (n, 32) and args[10] == 128 and args[16:18] == (MARCH.max_steps, 6)
    assert [a.value for a in args[18:]] == [
        state.data_ptr(), queues[0].data_ptr(), counts[0:1].data_ptr(),
        queues[1].data_ptr(), counts[1:2].data_ptr()]


def _frames_scene(frames=4, rays=90, seed=2):
    """The bench proxy at jittered latents, `frames` views of `rays`
    rays each (padded to 96: 1.5 tiles a frame), seeded and inactive
    rays among them."""
    params, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"))
    _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    rng = np.random.default_rng(seed)
    lat = z0[None] + 0.001 * torch.as_tensor(
        rng.standard_normal((frames, z0.shape[0])), dtype=torch.float32)
    shared = bm.pack_shared(params, pcfg)
    bank = bm.fold_bias_bank(params, lat, pcfg, shared)
    o, v = [], []
    for f in range(frames):
        cam = Camera.looking_at((0.3 * f, 0.1, -2.5), focal=12.0, img_hw=(10, 10))
        of, vf = pixel_rays(cam, 10, 10)
        o.append(of[:rays])
        v.append(vf[:rays])
    o, v = torch.stack(o), torch.stack(v)
    seed_d = torch.where(
        torch.as_tensor(rng.random((frames, rays)) < 0.3),
        torch.as_tensor(rng.uniform(1.3, 1.8, (frames, rays)), dtype=torch.float32),
        torch.full((frames, rays), float("nan")))
    active = torch.as_tensor(rng.random((frames, rays)) < 0.9)
    return shared, bank, bm.pad_frames(o, v, seed_d, active)


@pytest.mark.parametrize("caps", [(1, 2, 6, 16), (2, 2, 2)])
def test_plain_generations_in_mixed_random_groups_equal_the_whole_run(caps, monkeypatch):
    """K2's plain version, with the kernels' k-order sum, run as its
    generation schedule but with each generation's survivors shuffled and
    marched in 64-ray groups (many impure: four frames of 96 rays) gives
    the whole run's [8, N] rows: a ray's march depends on its own carry
    and frame only, whatever rays share its tile, which is what lets the
    tensor-core queue march regroup rays after every generation."""
    monkeypatch.setattr(march_body, "dot_f32", _dot_k_order)
    shared, bank, (o_p, v_p, s_p, a_p, frame, r_pad) = _frames_scene()
    assert r_pad == 96
    rs = bm.ray_setup(o_p, v_p, MARCH, s_p, a_p)
    full = qm._caps(caps, MARCH)
    whole = qm._rows_plain(shared, bank, frame, o_p, v_p, rs, MARCH, full, False)
    assert whole[1].sum() > 50

    rng = np.random.default_rng(7)
    c = make_carry(rs.d0, rs.act0)
    impure, g = 0, 0
    while bool((c.act > 0.5).any()):
        queue = torch.nonzero(c.act > 0.5).squeeze(1)
        queue = queue[torch.as_tensor(rng.permutation(queue.numel()))]
        impure += int((~bm.tile_frames(queue, r_pad)[1]).sum())
        cap = full[min(g, len(full) - 1)]
        for i in range(0, queue.numel(), M):
            idx = queue[i:i + M]
            layers = bm.plain_layers(shared, bank, frame[idx], False)
            part = march_loop(lambda p: mlp_apply(layers, p, shared.final_tanh),
                              o_p[idx], v_p[idx], rs.near[idx], rs.far[idx], MARCH,
                              MARCH.max_steps, True, Carry(*(x[idx] for x in c)),
                              kmax=cap)
            c = Carry(*(x.index_copy(0, idx, y) for x, y in zip(c, part)))
        g += 1
    assert impure > 0 and g > 1
    assert torch.equal(rows_from_carry(c), whole)
