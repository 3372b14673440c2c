"""The host side of K5's and K6's tensor-core body (csrc/point_mlp.cuh), on
the CPU: the weight layout the kernels stream (batched_march.pack_mma_tiles)
and their shared-memory plan (mlp_eval.mma_smem_bytes). The kernels
themselves run only on the card (tests/test_torch_cuda.py).

Decoders: the bench 8x512 (.bench_decoder.npz), its 4x256 proxy
(.bench_proxy.npz), the default 8x512 color decoder, and seeded 4x40 and
4x48 decoders (in_p % 16 == 8 and 0: the layout pads K to 16).
"""

import os

import numpy as np
import pytest
import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.color_decoder import (
    init_color_params, make_color_config,
)
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.models.pretrain import load_params_npz
from dist_renderer_tpu_torch.models.proxy import load_proxy_npz
from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
from dist_renderer_tpu_torch.ops.kernels import mlp_eval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODERS = ["bench", "proxy", "color", "4x40", "4x48"]


def _shared(which: str) -> bm.SharedDecoder:
    if which == "bench":
        params, _ = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
        return bm.pack_shared(params, DecoderConfig())
    if which == "proxy":
        params, cfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"))
        return bm.pack_shared(params, cfg)
    if which == "color":
        cfg = make_color_config()
        return bm.pack_shared(init_color_params(torch.Generator().manual_seed(0), cfg,
                                                "cpu"), cfg)
    width = int(which.split("x")[1])
    cfg = DecoderConfig(latent_size=8, hidden_dims=(width,) * 4, latent_in=(2,))
    rng = np.random.default_rng(width)
    params = params_from_numpy({"layers": [
        {"w": rng.standard_normal((i, o)) * np.sqrt(2.0 / i),
         "b": 0.1 * rng.standard_normal(o)} for i, o in cfg.layer_dims]})
    return bm.pack_shared(params, cfg)


def _unpack_mma_tiles(tiles: torch.Tensor, whT):
    """pack_mma_tiles' inverse, shaped by the same layers: [out_p, in_p]
    bf16 per layer with a hidden product, None elsewhere."""
    out = [None] * len(whT)
    pos = 0
    for li, spans in bm.mma_tile_spans(whT):
        out_p, in_p = whT[li].shape
        wp = torch.zeros((out_p, (in_p + 15) // 16 * 16), dtype=torch.bfloat16,
                         device=tiles.device)
        for n0, nt, k0, kt in spans:
            tile = tiles[pos:pos + nt * kt].reshape(kt // 8, nt, 8).permute(1, 0, 2)
            wp[n0:n0 + nt, k0:k0 + kt] = tile.reshape(nt, kt)
            pos += nt * kt
        out[li] = wp[:, :in_p]
    if pos != tiles.numel():
        raise ValueError(f"tiles hold {tiles.numel()} values, the layers {pos}")
    return out


def _rows(shared):
    t = shared.table
    return [t[i:i + 5] for i in range(0, len(t), 5)]


@pytest.mark.parametrize("which", DECODERS)
def test_mma_tiles_unpack_to_the_flat_weights(which):
    """The streamed layout holds every hidden weight of shared.flat, once,
    in place: unpacked, each layer equals its [in_p][out_p] block of flat
    (and whT), and the stream is exactly as long as those blocks with K
    padded to 16 (the padding zero)."""
    shared = _shared(which)
    layers = _unpack_mma_tiles(shared.tiles, shared.whT)
    padded = 0
    for (out_p, in_p, wh_off, _, _), w, wT in zip(_rows(shared), layers, shared.whT):
        if wh_off < 0:
            assert w is None and wT is None
            continue
        block = shared.flat[wh_off:wh_off + in_p * out_p].reshape(in_p, out_p)
        assert torch.equal(w, block.T) and torch.equal(w, wT)
        padded += out_p * ((in_p + 15) // 16 * 16)
    assert shared.tiles.dtype == torch.bfloat16 and shared.tiles.numel() == padded
    assert int(torch.count_nonzero(shared.tiles)) == sum(
        int(torch.count_nonzero(w)) for w in layers if w is not None)


@pytest.mark.parametrize("which", DECODERS)
def test_mma_rows_and_scales_follow_the_hidden_weights(which):
    """wrows holds each hidden layer's weights row by row at the tiles'
    offsets, K padded to 16 with zeros (one output's weights one run for
    the in-order recompute); wscale holds each hidden output column's
    near-tie scale, NEAR_TIE * 2^-24 * its L2 norm, at the bias rows."""
    shared = _shared(which)
    pos = 0
    want = torch.zeros(shared.total)
    for (out_p, in_p, wh_off, _, b_off), w in zip(_rows(shared), shared.whT):
        if wh_off < 0:
            continue
        k16 = (in_p + 15) // 16 * 16
        rows = shared.wrows[pos:pos + out_p * k16].reshape(out_p, k16)
        assert torch.equal(rows[:, :in_p], w) and not rows[:, in_p:].any()
        want[b_off:b_off + out_p] = bm.NEAR_TIE * 2.0 ** -24 * w.float().norm(dim=1)
        pos += out_p * k16
    assert pos == shared.wrows.numel() == shared.tiles.numel()
    assert shared.wrows.dtype == torch.bfloat16 and shared.wscale.dtype == torch.float32
    torch.testing.assert_close(shared.wscale, want, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("which", DECODERS)
def test_mma_tiles_fit_the_ring(which):
    """Every tile fills at most one 16 KB ring stage in a multiple of 16
    bytes (a bulk copy's unit) and covers its layer's N-chunks (widths
    128, 64 or 8) and K (padded to 16) without overlap."""
    shared = _shared(which)
    spans = bm.mma_tile_spans(shared.whT)
    for li, tiles in spans:
        out_p, in_p = shared.whT[li].shape
        k16 = (in_p + 15) // 16 * 16
        cover = torch.zeros((out_p, k16), dtype=torch.int32)
        for n0, nt, k0, kt in tiles:
            nbytes = 2 * nt * kt
            assert nt in bm.MMA_NT and kt % 16 == 0
            assert nbytes <= bm.MMA_STAGE_BYTES and nbytes % 16 == 0
            cover[n0:n0 + nt, k0:k0 + kt] += 1
        assert bool((cover == 1).all())


@pytest.mark.parametrize("which", DECODERS)
def test_mma_smem_plan_fits_an_h100_block(which):
    """The shared-memory plan of each decoder fits the 232,448 bytes an
    H100 block may use: two [64, w16] bf16 activation buffers and the
    4 x 16 KB ring (221,264 bytes at width 512)."""
    shared = _shared(which)
    need = mlp_eval.mma_smem_bytes(shared)
    assert need <= mlp_eval.SMEM_LIMIT == 232_448
    w16 = max((w + 15) // 16 * 16 for row in _rows(shared) for w in row[:2])
    assert need >= 2 * 64 * w16 * 2 + 4 * bm.MMA_STAGE_BYTES
    if which in ("bench", "color"):
        assert need == 221_264
    mlp_eval.check_mma_plan(shared, shared.tiles.device)


@pytest.mark.parametrize("width", [600, 1024])
def test_mma_smem_plan_refuses_a_decoder_it_cannot_hold(width):
    """A decoder too wide for the plan raises, naming its width, before any
    launch."""
    cfg = DecoderConfig(latent_size=8, hidden_dims=(width,) * 2, latent_in=())
    rng = np.random.default_rng(0)
    params = params_from_numpy({"layers": [
        {"w": rng.standard_normal((i, o)) * 0.01, "b": np.zeros(o)}
        for i, o in cfg.layer_dims]})
    shared = bm.pack_shared(params, cfg)
    assert mlp_eval.mma_smem_bytes(shared) > mlp_eval.SMEM_LIMIT
    with pytest.raises(ValueError, match=f"width {width}"):
        mlp_eval.check_mma_plan(shared, shared.tiles.device)


@pytest.mark.parametrize("out_p,want", [
    (512, [(0, 128), (128, 128), (256, 128), (384, 128)]),
    (320, [(0, 128), (128, 128), (256, 64)]),
    (48, [(0, 8), (8, 8), (16, 8), (24, 8), (32, 8), (40, 8)]),
    (8, [(0, 8)]),
    (200, [(0, 128), (128, 64), (192, 8)]),
])
def test_mma_chunks_decompose_a_layer(out_p, want):
    """A layer's N-chunks: the widest of 128, 64, 8 that fits, in order
    (csrc/point_mlp.cuh's next_chunk)."""
    assert bm.mma_chunks(out_p) == want
