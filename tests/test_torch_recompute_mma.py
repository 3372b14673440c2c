"""The host side of K3's and K4's tensor-core body (csrc/recompute.cu), on
the CPU: the weight tiles both sweeps stream, the in-order rows and
near-tie scales (recompute.pack_precise), the shared-memory plan, the
N-chunks, K4's partial sums, and why the layer below a split layer is
summed in k order on CUDA cores. The kernels themselves run only on the
card (tests/test_torch_cuda.py).

Decoders: the bench 8x512 (.bench_decoder.npz), the 8x512 color decoder,
and the card tests' seeded ones (64x8 whose skip shrink pads 29 -> 32,
4x48 with xyz_in_all, 4x48 with use_tanh).
"""

import os

import numpy as np
import pytest
import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.color_decoder import init_color_params, make_color_config
from dist_renderer_tpu_torch.models.decoder import params_from_numpy, round_bf16
from dist_renderer_tpu_torch.models.pretrain import load_params_npz
from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
from dist_renderer_tpu_torch.ops.kernels import recompute as rc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDED = {
    "64x8": dict(latent_size=32, hidden_dims=(64,) * 8, latent_in=(4,)),
    "48x4_xyz": dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), xyz_in_all=True),
    "48x4_tanh": dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), use_tanh=True),
}
DECODERS = ["bench", "color", *SEEDED]


def _decoder(which: str):
    if which == "bench":
        params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
        return params, DecoderConfig(), z
    if which == "color":
        cfg = make_color_config()
        return init_color_params(torch.Generator().manual_seed(0), cfg, "cpu"), cfg, None
    cfg = DecoderConfig(**SEEDED[which])
    rng = np.random.default_rng(len(which))
    params = params_from_numpy({"layers": [
        {"w": rng.standard_normal((i, o)) * np.sqrt(2.0 / i),
         "b": 0.1 * rng.standard_normal(o)} for i, o in cfg.layer_dims]})
    z = torch.as_tensor(0.3 * rng.standard_normal(cfg.latent_size), dtype=torch.float32)
    return params, cfg, z


def _packed(which: str) -> rc.PackedPrecise:
    params, cfg, _ = _decoder(which)
    return rc.pack_precise(params, cfg)


def _unpack(tiles: torch.Tensor, mats):
    """pack_mma_tiles' inverse, shaped by the same [N, K] matrices (None
    skipped): the matrices, K padded to 16."""
    out, pos = [], 0
    for li, spans in bm.mma_tile_spans(mats):
        n, k = mats[li].shape
        wp = torch.zeros((n, (k + 15) // 16 * 16), dtype=torch.bfloat16)
        for n0, nt, k0, kt in spans:
            wp[n0:n0 + nt, k0:k0 + kt] = tiles[pos:pos + nt * kt].reshape(
                kt // 8, nt, 8).permute(1, 0, 2).reshape(nt, kt)
            pos += nt * kt
        out.append(wp)
    assert pos == tiles.numel(), (pos, tiles.numel())
    return out


def _flat_blocks(pk: rc.PackedPrecise, li: int):
    """Layer li's (W_hi [in_p, out_p], W_lo [in_p, out_p] or None, W_hi^T
    [out_p, in_p]) read from packed.flat at the table's offsets (fwd_hi,
    lo_rows: W_lo^T, rev)."""
    flat = pk.flat.to(torch.float32)
    out_p, in_p, split, fhi, flo, rev = pk.table[2 + 9 * li:8 + 9 * li]
    blk = lambda off, r, c: flat[off:off + r * c].reshape(r, c)
    return (blk(fhi, in_p, out_p), blk(flo, out_p, in_p).T if split else None,
            blk(rev, out_p, in_p))


@pytest.mark.parametrize("which", DECODERS)
def test_both_sweeps_tiles_unpack_to_the_flat_weights(which):
    """ftiles holds, in stream order, each tensor-core layer of the forward
    as [W_hi^T | W_lo^T | W_hi^T] (split layers) or W_hi^T, the blocks of
    packed.flat (rev, lo_rows) at a K of 16; rtiles the reverse's layers
    L-1 .. 1 as flat's fwd_hi [in_p, out_p]; padding zero."""
    pk = _packed(which)
    exact = rc.exact_layers(pk.meta)
    fwd = [i for i in range(1, len(pk.meta) - 1) if not exact[i]]
    got = _unpack(pk.ftiles, rc.fwd_mma_mats(pk.meta, pk.layers))
    assert len(got) == len(fwd)
    for li, mat in zip(fwd, got):
        m = pk.meta[li]
        fhi, flo, rev = _flat_blocks(pk, li)
        kh = (m.in_p + 15) // 16 * 16
        blocks = [rev, flo.T, rev] if m.split else [rev]
        assert mat.shape == (m.out_p, kh * len(blocks))
        for j, b in enumerate(blocks):
            assert torch.equal(mat[:, j * kh:j * kh + m.in_p].float(), b)
            assert not mat[:, j * kh + m.in_p:(j + 1) * kh].any()
    rev_layers = list(range(len(pk.meta) - 2, 0, -1))
    got = _unpack(pk.rtiles, rc.rev_mma_mats(pk.meta, pk.layers))
    assert len(got) == len(rev_layers)
    for li, mat in zip(rev_layers, got):
        m = pk.meta[li]
        fhi, _, _ = _flat_blocks(pk, li)
        assert torch.equal(mat[:, :m.out_p].float(), fhi)
        assert not mat[:, m.out_p:].any()


@pytest.mark.parametrize("which", DECODERS)
def test_in_order_rows_and_scales_follow_the_weights(which):
    """The split layers' in-order lo rows are W_lo^T [out_p][in_p] (the
    plain version's wh_lo); fscale is NEAR_TIE * 2^-24 times the L2 norm
    of each forward B column over its whole K (0 on the CUDA-core layers),
    rscale the same for the reverse's columns (rows of W_hi), at the rows
    of the layer below."""
    pk = _packed(which)
    exact = rc.exact_layers(pk.meta)
    unit = bm.NEAR_TIE * 2.0 ** -24
    offs = np.cumsum([0] + [m.out_p for m in pk.meta])
    for li, m in enumerate(pk.meta):
        fhi, flo, _ = _flat_blocks(pk, li) if m.has_wh else (None, None, None)
        if m.split and m.has_wh:
            assert torch.equal(flo, pk.layers[li]["wh_lo"])
        fs = pk.fscale[offs[li]:offs[li + 1]]
        if exact[li] or li == len(pk.meta) - 1:
            assert not fs.any()
        else:
            ss = (fhi ** 2).sum(0) * (2 if m.split else 1)
            if m.split:
                ss = ss + (flo ** 2).sum(0)
            torch.testing.assert_close(fs, unit * ss.sqrt(), rtol=1e-6, atol=0)
        if 0 < li < len(pk.meta) - 1:
            torch.testing.assert_close(pk.rscale[offs[li - 1]:offs[li]],
                                       unit * fhi.norm(dim=1), rtol=1e-6, atol=0)
    assert not pk.rscale[offs[-3]:].any()  # the last layer's reverse is on CUDA cores


def test_exact_layers_are_the_first_and_the_one_below_the_skip():
    """Layer 0 (x only) and layer 3, whose output the skip layer 4 splits,
    run on CUDA cores; every other hidden product of the bench decoder on
    the tensor cores."""
    pk = _packed("bench")
    assert rc.exact_layers(pk.meta) == (True, False, False, True) + (False,) * 5
    assert rc.exact_layers(_packed("48x4_xyz").meta) == (True, True, False, False, False)


def test_smem_plan_fits_8x512_and_refuses_wider():
    """The plan at 8x512: activations 131,072 bytes, a 3-stage ring 49,152,
    the gates 30,720 and the rest: 227,136, under the 232,448 an H100
    block may use; a 4-stage ring would not fit. A decoder of width 576
    is refused before launch."""
    pk = _packed("bench")
    assert rc.act_width(pk.meta) == 512
    assert rc.gate_words(pk.meta) * 4 == 7 * 64 * 512 // 8 + 64 * 256 // 8 == 30_720
    need = rc.precise_smem_bytes(pk)
    assert need == 227_136 and need <= rc.SMEM_LIMIT < need + rc.STAGE_BYTES
    rc.check_precise_plan(pk, torch.device("cpu"))
    params, cfg, _ = _decoder("color")
    assert rc.precise_smem_bytes(rc.pack_precise(params, cfg)) == need
    wide = DecoderConfig(latent_size=8, hidden_dims=(576,) * 3, latent_in=(2,))
    rng = np.random.default_rng(0)
    wp = params_from_numpy({"layers": [
        {"w": 0.01 * rng.standard_normal((i, o)), "b": np.zeros(o)}
        for i, o in wide.layer_dims]})
    with pytest.raises(ValueError, match="shared memory"):
        rc.check_precise_plan(rc.pack_precise(wp, wide), torch.device("cpu"))


def test_chunks_cover_the_skip_layer_with_hi_and_lo_in_one_buffer():
    """The skip layer of the bench decoder reads 256 inputs: its forward
    K is [hi | hi | lo] = 768 over 512 outputs in four 128-wide N-chunks;
    hi and lo fill the 512-wide activation buffer; the 256-wide layer
    below it chunks as 128 + 128 in the reverse of layer 4."""
    pk = _packed("bench")
    m4 = pk.meta[4]
    assert m4.split and m4.in_p == 256 and 2 * m4.in_p == rc.act_width(pk.meta)
    mats = rc.fwd_mma_mats(pk.meta, pk.layers)
    assert mats[4].shape == (512, 768)
    assert bm.mma_chunks(512) == [(0, 128), (128, 128), (256, 128), (384, 128)]
    assert bm.mma_chunks(pk.meta[3].out_p) == [(0, 128), (128, 128)]
    seeded = _packed("64x8")
    assert seeded.meta[3].out_p == 32 and seeded.meta[4].in_p == 32
    assert bm.mma_chunks(32) == [(0, 8), (8, 8), (16, 8), (24, 8)]
    assert rc.act_width(seeded.meta) == 64


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 3000, 65_536])
def test_k4_slots_and_u_rows_for_64_point_tiles(n):
    """K4 writes one partial per 32 points of each 64-point tile (at least
    one tile), over u_rows = the out_p of the layers the latent enters
    (layers 0 and 4 of the bench decoder: 1,024). The tensor cores take
    the forward's layers 1, 2 and 4-7 and the reverse's 7-1, K4's reverse
    without layers 5 and 1, which feed u."""
    tiles = max((n + 63) // 64, 1)
    assert rc.TILE == 64 and rc.k4_slots(n) == 2 * tiles
    pk = _packed("bench")
    assert sum(m.out_p for m in pk.meta if m.takes_z) == 1024
    fwd = 512 * 5 + 512
    rows = (n + 63) // 64 * 64
    assert rc.mma_values(pk, n) == rows * (fwd + 512 * 5 + 256 + 512)
    assert rc.mma_values(pk, n, k4=True) == rows * (fwd + 512 * 3 + 256 + 512)


def _k_order(a, w):
    """a [N, K] @ w [K, M] summed over k in order, one fp32 rounding a term
    (the kernels' and the in-order plain version's sum)."""
    out = torch.zeros(a.shape[0], w.shape[1])
    for k in range(a.shape[1]):
        out = out + a[:, k:k + 1] * w[k]
    return out


def _layer_below_skip(n=1024):
    """The bench decoder's layer 3 on n seeded points, in the plain
    version's order: (its bf16 input, its W_hi, its bias [1, 256], its
    product's k-order sum)."""
    params, cfg, z = _decoder("bench")
    pk = rc.pack_precise(params, cfg)
    b = rc.fold_bias_precise(params, z, cfg, pk)
    pts = torch.as_tensor(0.6 * np.random.default_rng(0).standard_normal((n, 3)),
                          dtype=torch.float32)
    x = round_bf16(pts)
    xl = round_bf16(pts - x)
    ops0 = pk.layers[0]
    h = torch.relu(((b[0][None] + _k_order(x, ops0["wx_hi"])) + _k_order(x, ops0["wx_lo"]))
                   + _k_order(xl, ops0["wx_hi"]))
    for i in (1, 2):
        h = torch.relu(b[i][None] + _k_order(round_bf16(h), pk.layers[i]["wh_hi"]))
    hin = round_bf16(h)
    w3 = pk.layers[3]["wh_hi"]
    return hin, w3, b[3][None], _k_order(hin, w3)


def _margin(hin, w3):
    return bm.NEAR_TIE * 2.0 ** -24 * w3.norm(dim=0)[None] * hin.norm(dim=1)[:, None]


def test_the_layer_below_the_skip_cannot_take_the_near_tie_margin():
    """Why the layer feeding a split layer runs in k order on CUDA cores:
    on the bench decoder, the near-tie margin (NEAR_TIE * 2^-24 |w| |h|)
    around layer 3's values holds a bf16 rounding boundary of relu(v) for
    under 1% of them, but a boundary of the split's low half,
    bf16(relu(v) - bf16(relu(v))), for over 10%: that layer would queue
    past QCAP in every tile."""
    hin, w3, bias, prod = _layer_below_skip()
    v, d = bias + prod, _margin(hin, w3)
    lo, hi = torch.relu(v - d), torch.relu(v + d)
    q_hi = round_bf16(lo) != round_bf16(hi)
    q_lo = q_hi | (round_bf16(lo - round_bf16(lo)) != round_bf16(hi - round_bf16(hi)))
    share_hi = q_hi[:, :253].double().mean().item()
    share_lo = q_lo[:, :253].double().mean().item()
    assert share_hi < 0.01 and share_lo > 0.10, (share_hi, share_lo)
    assert share_lo * 64 * 256 > rc.QCAP


def test_another_order_stays_within_the_near_tie_margin():
    """The margin against a summation order other than k's: layer 3's
    products summed in 16-wide blocks (each exact, then rounded and added,
    as the tensor cores add their k16 steps) lie within half the near-tie
    margin of the k-order sums."""
    hin, w3, _, prod = _layer_below_skip(512)
    blocked = torch.zeros_like(prod)
    for k0 in range(0, hin.shape[1], 16):
        blocked = blocked + (hin[:, k0:k0 + 16].double() @ w3[k0:k0 + 16].double()).float()
    ratio = ((prod - blocked).abs() / _margin(hin, w3))[:, :253].max().item()
    assert ratio <= 0.5, ratio
