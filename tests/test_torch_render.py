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
from dist_renderer_tpu_torch.models import analytic
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
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

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


SMALL_KW = dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,))


@pytest.fixture(scope="module")
def small():
    """A 4x48 decoder fitted to a sphere, its latent, and a stand-in proxy:
    the decoder with seeded weight noise (a small field error the verify
    march must correct)."""
    params, z0 = fit_decoder_to_sdf(lambda p: sphere_sdf(0.5)(None, p),
                                    JDecoderConfig(**SMALL_KW), steps=300, batch=2048)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(5)
    proxy = {"layers": [
        {"w": l["w"] + 2e-3 * rng.standard_normal(l["w"].shape).astype(np.float32),
         "b": l["b"]} for l in params["layers"]]}
    return params, np.asarray(z0), proxy


def test_slice_small_decoder_with_proxy(small):
    params, z0, proxy = small
    j, t, tout = _both(params, SMALL_KW, z0, proxy, SMALL_KW, (0.0, 0.0, -2.0), {})
    _assert_parity(j, t)
    assert tout.trace.steps_per_ray.shape == (IMG * IMG,)


def test_fused_dd_matches_jax(small):
    """GradConfig(fused_dd=True) on the main path (the small decoder through
    its stand-in proxy): the composition takes the value and the IFT
    denominator from one with_dd pass (decoder_apply_with_dd, JAX's
    roundings in both packages; the K3 route is off), and the normals from
    the decoder's gradient at the final point. Maps under _assert_parity;
    latent and pose gradients of a depth-completion objective (10 depth L1
    + silhouette + 1e-4 prior, against the unjittered latent's render)
    under tests/test_torch_grad.py's whole-render bars, cos >= 0.999 and
    relative L2 <= 3e-2 (with_dd's backward takes bf16 products in both
    packages; with an fp32 backward the port read relative L2 5.2e-2)."""
    from dist_renderer_tpu.ops import camera as jcam
    from dist_renderer_tpu.utils import losses as JL
    from dist_renderer_tpu_torch.ops import camera as tcam
    from dist_renderer_tpu_torch.utils import losses as TL

    params, z0, proxy = small
    z = z0 + 0.05 * np.random.default_rng(7).standard_normal(z0.shape).astype(np.float32)
    fused = lambda c: dataclasses.replace(c, grad=dataclasses.replace(c.grad, fused_dd=True))
    jcfg = fused(_cfgs(JMarchConfig, JGradConfig, JRenderConfig))
    tcfg = fused(_cfgs(MarchConfig, GradConfig, RenderConfig))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jfac = jmake_factory(jp, JDecoderConfig(**SMALL_KW), jcfg,
                         march_params=jax.tree_util.tree_map(jnp.asarray, proxy),
                         march_dcfg=JDecoderConfig(**SMALL_KW))
    jsdf = jmake_precise_sdf(jp, JDecoderConfig(**SMALL_KW))
    cam = JCamera.looking_at((0.0, 0.0, -2.0), focal=IMG * 1.2, img_hw=(IMG, IMG))
    gt = jrender(jsdf, jnp.asarray(z0), cam, jcfg, jfac)
    obs_d, obs_m = np.asarray(gt.depth), np.asarray(gt.mask)
    pose = np.asarray(jcam.pose_from_camera(cam))

    def objective(lib, out, zz, to):
        return (10.0 * lib.depth_loss(out.depth, to(obs_d), to(obs_m), out.mask)
                + lib.silhouette_loss(out.min_sdf, to(obs_m)) + 1e-4 * lib.latent_reg(zz))

    def jloss(zz, pp):
        out = jrender(jsdf, zz, jcam.camera_from_pose(pp, cam.K), jcfg, jfac)
        return objective(JL, out, zz, jnp.asarray), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z), jnp.asarray(pose))
    tp = params_from_numpy(params)
    tfac = make_march_factory(tp, DecoderConfig(**SMALL_KW), tcfg,
                              march_params=params_from_numpy(proxy),
                              march_dcfg=DecoderConfig(**SMALL_KW))
    zt = torch.tensor(z, requires_grad=True)
    pt = torch.tensor(pose, requires_grad=True)
    tout = render(make_precise_sdf(tp, DecoderConfig(**SMALL_KW)), zt,
                  tcam.camera_from_pose(pt, torch.as_tensor(np.asarray(cam.K))), tcfg, tfac)
    tg = torch.autograd.grad(objective(TL, tout, zt, torch.as_tensor), (zt, pt))
    keys = ("depth", "mask", "normal", "min_sdf")
    _assert_parity({k: np.asarray(getattr(jout, k)) for k in keys},
                   {k: getattr(tout, k).detach().numpy() for k in keys})
    for a, b in zip((g.numpy() for g in tg), (np.asarray(g) for g in jg)):
        assert np.all(np.isfinite(a)) and np.linalg.norm(b) > 0
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert cos >= 0.999 and rel <= 3e-2, (cos, rel)


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
    use_kernel=False runs every kernel's plain version (the same
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
    c = render(make_precise_sdf(proxy, pcfg, use_kernel=False), z0, cam, cfg,
               make_march_factory(proxy, pcfg, cfg, use_kernel=False))
    for x, y in [(a, b), (b, c)]:
        for k in ("depth", "mask", "normal", "min_sdf", "points"):
            assert torch.equal(getattr(x, k), getattr(y, k)), k
    assert a.mask.float().mean() > 0.05
    assert torch.isfinite(a.depth).all() and torch.isfinite(a.normal).all()
    assert r.render_depth(z0, cam.R, cam.T).shape == (IMG, IMG)


def test_unported_modes_raise():
    """The polish demote's guard and the verify modes' guard (polish does
    not compose with cert or probe) raise ValueError. (Every mode of the
    JAX package is ported; fused_dd, the last one, is held to JAX in
    test_fused_dd_matches_jax.)"""
    proxy, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"))
    z = torch.zeros(2, pcfg.latent_size)
    o = torch.zeros(1, 1, 3)
    v = torch.ones(1, 16, 3)
    for mode in (dict(verify_mode="cert"), dict(verify_band="probe")):
        with pytest.raises(ValueError, match="composes only"):
            render_batched_c2f(proxy, pcfg, z[:1], o, v, (4, 4), MarchConfig(),
                               verify_hits="polish", **mode)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=20.0, img_hw=(8, 8))
    vh = MarchConfig(coarse_to_fine=True, proxy_verify_hits="polish")
    with pytest.raises(ValueError, match="polish_iters"):
        render(make_precise_sdf(proxy, pcfg), z[0], cam,
               RenderConfig(img_h=8, img_w=8, march=vh, use_pallas=True),
               make_march_factory(proxy, pcfg, RenderConfig(use_pallas=True),
                                  march_params=proxy, march_dcfg=pcfg))


def test_c2f_plan_skip_rays_take_the_coarse_margin():
    """render()'s c2f_plan path with the compose bucket (128^2 rays,
    compact_frac 4): skip-class rays never sample the SDF, and outside the
    bucket they keep the trace's margin. That must be the coarse level's
    margin, as merge_skip gives the batched path, not the tracer's
    stand-in for a never-sampled ray (the closest approach's distance to
    the bounding sphere, down to -0.68 here for rays through it; the JAX
    package's single-frame path keeps it, and silhouette fits from an
    empty shape then stall). On an analytic sphere of radius 0.3 every
    miss's margin is positive, and the misses' mean margin is the no-c2f
    render's within 0.01 (read: 0.4289 against 0.4310; -0.133 with the
    stand-in)."""
    img = 128
    sdf = lambda z, p: analytic.sphere_sdf(0.3)(None, p)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=1.25 * img, img_hw=(img, img))
    outs = [render(sdf, torch.zeros(1), cam, RenderConfig(
        img_h=img, img_w=img, march=MarchConfig(coarse_to_fine=c2f),
        grad=GradConfig(mode="ift", compact_frac=4))) for c2f in (True, False)]
    assert RenderConfig().grad.compact_min <= img * img
    miss = [~o.mask for o in outs]
    assert outs[0].mask.sum() > 500 and (outs[0].min_sdf[miss[0]] > 0).all()
    means = [o.min_sdf[m].mean().item() for o, m in zip(outs, miss)]
    assert abs(means[0] - means[1]) <= 0.01, means


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
