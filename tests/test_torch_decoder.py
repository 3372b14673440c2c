"""Decoder, latent fold, bias bank and weight files: the PyTorch port
against the JAX package on the same weights (made from a numpy seed, or
the committed bench fixtures)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.models import decoder as jdec
from dist_renderer_tpu.models import folded as jfold
from dist_renderer_tpu.models import pretrain as jpre
from dist_renderer_tpu.models import proxy as jproxy
from dist_renderer_tpu.ops.pallas import batched_march as jbm
from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models import decoder as tdec
from dist_renderer_tpu_torch.models import folded as tfold
from dist_renderer_tpu_torch.models import pretrain as tpre
from dist_renderer_tpu_torch.models import proxy as tproxy
from dist_renderer_tpu_torch.ops.kernels import batched_march as tbm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, ".bench_decoder.npz")
PROXY = os.path.join(ROOT, ".bench_proxy.npz")

ARCHS = [
    dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,)),
    dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), xyz_in_all=True),
    dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), use_tanh=True),
    dict(latent_size=32, hidden_dims=(64,) * 4, latent_in=()),
]


def _weights(kw, seed=0, n=257):
    """numpy weights (He init), a latent batch and points from one seed."""
    rng = np.random.default_rng(seed)
    cfg = JDecoderConfig(**kw)
    params = {"layers": [
        {"w": (rng.standard_normal((i, o)) * np.sqrt(2.0 / i)).astype(np.float32),
         "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
        for i, o in cfg.layer_dims]}
    lat = (0.3 * rng.standard_normal((3, cfg.latent_size))).astype(np.float32)
    pts = (0.8 * rng.standard_normal((n, 3))).astype(np.float32)
    return params, lat, pts


def _jax_params(params):
    return {"layers": [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])}
                       for l in params["layers"]]}


@pytest.mark.parametrize("kw", ARCHS)
def test_decoder_apply_fp32_matches_jax(kw):
    params, lat, pts = _weights(kw)
    ref = jdec.decoder_apply(_jax_params(params), jnp.asarray(lat[0]),
                             jnp.asarray(pts), JDecoderConfig(**kw))
    out = tdec.decoder_apply(tdec.params_from_numpy(params),
                             torch.as_tensor(lat[0]), torch.as_tensor(pts),
                             DecoderConfig(**kw))
    # both fp32; only the BLAS summation order differs
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-6)


@pytest.mark.parametrize("kw", ARCHS)
def test_folded_apply_matches_jax(kw):
    params, lat, pts = _weights(kw, seed=1)
    jf = jfold.fold_latent(_jax_params(params), jnp.asarray(lat[1]),
                           JDecoderConfig(**kw))
    ref = jfold.folded_apply(jf, jnp.asarray(pts), JDecoderConfig(**kw))
    tp = tdec.params_from_numpy(params)
    tf = tfold.fold_latent(tp, torch.as_tensor(lat[1]), DecoderConfig(**kw))
    out = tfold.folded_apply(tf, torch.as_tensor(pts), DecoderConfig(**kw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-6)
    for a, b in zip(jf, tf):
        # the fold is an fp32 product in both packages
        np.testing.assert_allclose(b.b.numpy(), np.asarray(a.b), rtol=0, atol=1e-6)
    # and the folded decoder is the decoder
    full = tdec.decoder_apply(tp, torch.as_tensor(lat[1]), torch.as_tensor(pts),
                              DecoderConfig(**kw))
    np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=0, atol=2e-6)
    pf = tfold.make_point_fn(tp, torch.as_tensor(lat[1]), DecoderConfig(**kw))
    np.testing.assert_array_equal(pf(torch.as_tensor(pts)).numpy(), out.numpy())


@pytest.mark.parametrize("kw", ARCHS)
def test_pack_shared_and_bias_bank_match_jax(kw):
    params, lat, _ = _weights(kw, seed=2)
    js = jbm.pack_shared(_jax_params(params), JDecoderConfig(**kw))
    jbank = jbm.fold_bias_bank(_jax_params(params), jnp.asarray(lat),
                               JDecoderConfig(**kw), js)
    tp = tdec.params_from_numpy(params)
    ts = tbm.pack_shared(tp, DecoderConfig(**kw))
    tbank = tbm.fold_bias_bank(tp, torch.as_tensor(lat), DecoderConfig(**kw), ts)
    assert ts.offsets == js.offsets and ts.total == js.total
    assert ts.final_tanh == js.final_tanh
    for a, b in list(zip(js.whT, ts.whT)) + list(zip(js.wxT, ts.wxT)):
        assert (a is None) == (b is None)
        if a is not None:  # bf16 rounding of the same fp32 weights: exact
            np.testing.assert_array_equal(
                np.asarray(a.astype(jnp.float32)), b.to(torch.float32).numpy())
    assert tbank.shape == tuple(jbank.shape)
    np.testing.assert_allclose(tbank.numpy(), np.asarray(jbank), rtol=0, atol=1e-6)
    # the kernel layout carries the same weights, input-major
    off = 0
    for wh, wx in zip(ts.whT, ts.wxT):
        if wh is not None:
            blk = ts.flat[off:off + wh.numel()].reshape(wh.shape[1], wh.shape[0])
            assert torch.equal(blk, wh.T)
            off += wh.numel()
        if wx is not None:
            blk = ts.flat[off:off + 3 * wx.shape[0]].reshape(3, wx.shape[0])
            assert torch.equal(blk, wx[:, :3].T)
            off += 3 * wx.shape[0]
    assert off == ts.flat.numel()


def test_precise_sdf_siblings():
    kw = ARCHS[0]
    params, lat, pts = _weights(kw, seed=3)
    tp = tdec.params_from_numpy(params)
    f = tdec.make_precise_sdf(tp, DecoderConfig(**kw))
    z, p = torch.as_tensor(lat[0]), torch.as_tensor(pts)
    np.testing.assert_array_equal(
        f(z, p).numpy(), tdec.decoder_apply(tp, z, p, DecoderConfig(**kw)).numpy())
    s, dd, g = f.sdg_builder(128)(z, p, p / p.norm(dim=-1, keepdim=True))
    assert s.shape == (pts.shape[0],) and g.shape == (pts.shape[0], 3)
    with pytest.raises(ValueError):
        f.sdg_builder()(torch.as_tensor(lat), p, p)


def test_load_params_npz_bench_fixture():
    jp, jz = jpre.load_params_npz(BENCH)
    tp, tz = tpre.load_params_npz(BENCH)
    assert len(tp["layers"]) == len(jp["layers"]) == 9
    for a, b in zip(jp["layers"], tp["layers"]):
        np.testing.assert_array_equal(np.asarray(a["w"]), b["w"].numpy())
        np.testing.assert_array_equal(np.asarray(a["b"]), b["b"].numpy())
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())
    assert tp["layers"][3]["w"].shape == (512, 253)  # the skip shrink


def test_proxy_loaders_and_margins():
    jp, jc = jproxy.load_proxy_npz(PROXY)
    tp, tc = tproxy.load_proxy_npz(PROXY)
    assert tc == DecoderConfig(**{f: getattr(jc, f) for f in (
        "latent_size", "hidden_dims", "latent_in", "xyz_in_all", "use_tanh",
        "final_tanh", "clamp_dist", "dropout_prob")})
    assert tc.hidden_dims == (256,) * 4 and tc.latent_in == ()
    for a, b in zip(jp["layers"], tp["layers"]):
        np.testing.assert_array_equal(np.asarray(a["w"]), b["w"].numpy())
    jm, tm = jproxy.load_proxy_meta(PROXY), tproxy.load_proxy_meta(PROXY)
    assert jm == tm and tm is not None
    for eps in (2e-3, 5e-5, 1e-2):
        assert tproxy.proxy_march_margins(tm, eps) == \
            jproxy.proxy_march_margins(jm, eps)
    full = DecoderConfig()
    assert tproxy.default_proxy_cfg(full) == DecoderConfig(
        **vars(jproxy.default_proxy_cfg(JDecoderConfig())))
    assert tproxy.default_proxy_cfg(full, width=128, depth=3).hidden_dims == (128,) * 3


def test_proxy_meta_absent(tmp_path):
    path = str(tmp_path / "p.npz")
    np.savez(path, w0=np.zeros((3, 8), np.float32), b0=np.zeros(8, np.float32))
    assert tproxy.load_proxy_meta(path) is None
