"""The whole slice: the port's ``render()`` (coarse-to-fine proxy march,
verify march, fused precise recompute) against the JAX package's
``render()`` on the production path (use_pallas, the trace_frame
pipeline with its kernels in interpret mode), with proxy + verify.

Bar (tests/test_parity.py's): depth p95 <= 1e-3 on frontal common hits.
The two packages' marches stop within the convergence ball at slightly
different depths (their CPU BLAS libraries sum in different orders), and
one IFT step from there lands within ~1e-4 of the surface; grazing rays
are ill-conditioned for any sphere tracer and are excluded, as there.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import GradConfig as JGradConfig
from dist_renderer_tpu.config import MarchConfig as JMarchConfig
from dist_renderer_tpu.config import RenderConfig as JRenderConfig
from dist_renderer_tpu.models.analytic import sphere_sdf
from dist_renderer_tpu.models.decoder import make_precise_sdf as jmake_precise_sdf
from dist_renderer_tpu.models.pretrain import fit_decoder_to_sdf
from dist_renderer_tpu.models.pretrain import load_params_npz as jload_params
from dist_renderer_tpu.models.proxy import load_proxy_meta as jload_meta
from dist_renderer_tpu.models.proxy import load_proxy_npz as jload_proxy
from dist_renderer_tpu.ops.camera import Camera as JCamera
from dist_renderer_tpu.ops.renderer import make_march_factory as jmake_factory
from dist_renderer_tpu.ops.renderer import render as jrender
from dist_renderer_tpu_torch.config import (
    DecoderConfig, GradConfig, MarchConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf, params_from_numpy
from dist_renderer_tpu_torch.models.pretrain import load_params_npz
from dist_renderer_tpu_torch.models.proxy import (
    load_proxy_meta, load_proxy_npz, proxy_march_margins,
)
from dist_renderer_tpu_torch.ops.camera import Camera
from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f
from dist_renderer_tpu_torch.ops.renderer import (
    SDFRenderer, make_march_factory, render,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32


def _cfgs(mod_march, mod_grad, mod_render, **march_kw):
    """The bench configuration (bench.py), in either package's classes."""
    return mod_render(
        img_h=IMG, img_w=IMG,
        march=mod_march(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                        coarse_to_fine=True, c2f_strides=(16, 4),
                        c2f_coarse_steps=16, **march_kw),
        grad=mod_grad(mode="ift", compact_frac=4, recompute="pallas"),
        compute_dtype="bfloat16", use_pallas=True,
    )


def _both(params, dcfg_kw, latent, proxy, pcfg_kw, eye, march_kw):
    """Render one frame with each package; returns numpy maps."""
    jcfg = _cfgs(JMarchConfig, JGradConfig, JRenderConfig, **march_kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jpp = jax.tree_util.tree_map(jnp.asarray, proxy)
    jfac = jmake_factory(jp, JDecoderConfig(**dcfg_kw), jcfg, march_params=jpp,
                         march_dcfg=JDecoderConfig(**pcfg_kw))
    jcam = JCamera.looking_at(eye, focal=IMG * 1.2, img_hw=(IMG, IMG))
    jout = jrender(jmake_precise_sdf(jp, JDecoderConfig(**dcfg_kw)),
                   jnp.asarray(latent), jcam, jcfg, jfac)

    tcfg = _cfgs(MarchConfig, GradConfig, RenderConfig, **march_kw)
    tp, tpp = params_from_numpy(params), params_from_numpy(proxy)
    tfac = make_march_factory(tp, DecoderConfig(**dcfg_kw), tcfg,
                              march_params=tpp, march_dcfg=DecoderConfig(**pcfg_kw))
    tcam = Camera.looking_at(eye, focal=IMG * 1.2, img_hw=(IMG, IMG))
    tout = render(make_precise_sdf(tp, DecoderConfig(**dcfg_kw)),
                  torch.as_tensor(np.array(latent)), tcam, tcfg, tfac)
    return ({k: np.asarray(getattr(jout, k)) for k in ("depth", "mask", "normal", "min_sdf")},
            {k: getattr(tout, k).numpy() for k in ("depth", "mask", "normal", "min_sdf")},
            tout)


def _assert_parity(j, t):
    jh, th = j["mask"], t["mask"]
    assert jh.sum() > 0.05 * jh.size
    assert (jh == th).mean() >= 0.99
    both = jh & th
    derr = np.abs(t["depth"] - j["depth"])
    frontal = np.abs(j["normal"][..., 2]) > 0.2
    sel = both & frontal
    assert sel.sum() > 20
    assert np.percentile(derr[sel], 95) <= 1e-3, np.percentile(derr[sel], 95)
    cos = np.sum(t["normal"][both] * j["normal"][both], axis=-1)
    assert np.median(cos) > 0.9999
    # background and margins: misses render at the background depth; the
    # margins agree to the march tolerance on almost every ray
    assert np.all(t["depth"][~th] == 0.0)
    assert np.mean(np.abs(t["min_sdf"] - j["min_sdf"]) < 2e-3) >= 0.98


def test_slice_small_decoder_with_proxy():
    kw = dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,))
    params, z0 = fit_decoder_to_sdf(lambda p: sphere_sdf(0.5)(None, p),
                                    JDecoderConfig(**kw), steps=300, batch=2048)
    params = jax.tree_util.tree_map(np.asarray, params)
    # a stand-in proxy: the decoder with seeded weight noise (a small field
    # error the verify march must correct)
    rng = np.random.default_rng(5)
    proxy = {"layers": [
        {"w": l["w"] + 2e-3 * rng.standard_normal(l["w"].shape).astype(np.float32),
         "b": l["b"]} for l in params["layers"]]}
    j, t, tout = _both(params, kw, np.asarray(z0), proxy, kw, (0.0, 0.0, -2.0), {})
    _assert_parity(j, t)
    assert tout.trace.steps_per_ray.shape == (IMG * IMG,)


def test_slice_bench_fixture_full_width():
    """The production architecture: the 8x512 bench decoder marched
    through its distilled 4x256 proxy, with the proxy's own margins."""
    params, z0 = jload_params(os.path.join(ROOT, ".bench_decoder.npz"))
    proxy, pcfg = jload_proxy(os.path.join(ROOT, ".bench_proxy.npz"))
    bo, band = proxy_march_margins(
        load_proxy_meta(os.path.join(ROOT, ".bench_proxy.npz")), 2e-3)
    assert jload_meta(os.path.join(ROOT, ".bench_proxy.npz")) is not None
    pkw = dict(latent_size=pcfg.latent_size, hidden_dims=pcfg.hidden_dims,
               latent_in=pcfg.latent_in, use_tanh=pcfg.use_tanh,
               final_tanh=pcfg.final_tanh, xyz_in_all=pcfg.xyz_in_all)
    np_tree = lambda p: jax.tree_util.tree_map(np.asarray, p)
    j, t, _ = _both(np_tree(params), {}, np.asarray(z0), np_tree(proxy), pkw,
                    (0.0, 0.0, -2.5), dict(proxy_backoff=bo, proxy_band=band))
    _assert_parity(j, t)


def test_sdf_renderer_and_plain_switch_agree():
    """SDFRenderer(...).render(latent, R, T) is render() with a full-decoder
    march, on the weights' device, from numpy camera and latent inputs;
    use_pallas=False runs every kernel's plain version (the same
    arithmetic on a CPU tensor)."""
    proxy, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"))
    _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    cfg = _cfgs(MarchConfig, GradConfig, RenderConfig)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=IMG * 1.2, img_hw=(IMG, IMG))
    r = SDFRenderer(proxy, cam.K.numpy(), (IMG, IMG), decoder_cfg=pcfg, cfg=cfg)
    assert r.device == torch.device("cpu") and r.K.dtype == torch.float32
    a = r.render(z0.numpy(), cam.R.numpy(), cam.T.numpy())
    b = render(make_precise_sdf(proxy, pcfg), z0, cam, cfg,
               make_march_factory(proxy, pcfg, cfg))
    plain = dataclasses.replace(cfg, use_pallas=False)
    c = render(make_precise_sdf(proxy, pcfg), z0, cam, plain,
               make_march_factory(proxy, pcfg, plain))
    for x, y in [(a, b), (b, c)]:
        for k in ("depth", "mask", "normal", "min_sdf", "points"):
            assert torch.equal(getattr(x, k), getattr(y, k)), k
    assert a.mask.float().mean() > 0.05
    assert torch.isfinite(a.depth).all() and torch.isfinite(a.normal).all()
    assert r.render_depth(z0, cam.R, cam.T).shape == (IMG, IMG)


def test_unported_modes_raise():
    proxy, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"))
    z = torch.zeros(2, pcfg.latent_size)
    o = torch.zeros(2, 1, 3)
    v = torch.ones(2, 16, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_batched_c2f(proxy, pcfg, z, o, v, (4, 4), MarchConfig())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_batched_c2f(proxy, pcfg, z[:1], o[:1], v[:1], (4, 4), MarchConfig(),
                           verify_mode="cert")
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=20.0, img_hw=(8, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render(make_precise_sdf(proxy, pcfg), z[0], cam,
               RenderConfig(img_h=8, img_w=8))


def test_no_valid_stride_marches_every_ray():
    """Strides that do not divide the image leave no coarse level: one
    full-budget batched march (K1's plain version here) of every ray."""
    proxy, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"))
    _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    img = 18
    cfg = dataclasses.replace(_cfgs(MarchConfig, GradConfig, RenderConfig),
                              img_h=img, img_w=img)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img))
    out = render(make_precise_sdf(proxy, pcfg), z0, cam, cfg,
                 make_march_factory(proxy, pcfg, cfg))
    ref = render(make_precise_sdf(proxy, pcfg), z0, cam,
                 dataclasses.replace(cfg, march=dataclasses.replace(
                     cfg.march, c2f_strides=(2,))),
                 make_march_factory(proxy, pcfg, cfg))
    assert cfg.c2f_strides_valid() == () and out.mask.sum() > 30
    # another march schedule stops elsewhere inside the convergence ball
    # (eps 2e-3); one IFT step brings depths within ~1e-3 of each other
    assert (out.mask == ref.mask).float().mean() >= 0.98
    both = out.mask & ref.mask
    assert (out.depth - ref.depth).abs()[both].median() < 1e-3
