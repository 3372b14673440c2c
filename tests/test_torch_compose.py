"""Every single-frame render path of the port's ``render()`` besides
trace_frame (tests/test_torch_render.py holds that one), against the
JAX package's ``render()`` on the same weights, latent and camera:

  - the JAX default configuration (last-step composition, the masked
    tracer) and finite-difference normals;
  - tests/test_parity.py's fast configuration: c2f_plan + compaction +
    IFT with two polish iterations, on the XLA and the fused recompute;
  - use_pallas without the coarse-to-fine pipeline (K1-grid through the
    rounds driver; JAX's kernel in interpret mode) and c2f_plan with
    use_pallas and no classification (K1-grid on every level);

with tests/test_torch_render.py's bars. Then latent and pose gradients
against ``jax.grad``, tests/test_parity.py's and tests/test_gradients.py's
bars on the port itself, warm starts (tests/test_warm_start.py's bars,
and the port's warm render against JAX's from one warm state), and two
contracts of the port: use_pallas=False takes the JAX package's march
(the point function, c2f_plan), plain kernel versions being the separate
use_kernel; and render() takes a warm state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import GradConfig as JGradConfig
from dist_renderer_tpu.config import MarchConfig as JMarchConfig
from dist_renderer_tpu.config import RenderConfig as JRenderConfig
from dist_renderer_tpu.models.analytic import sphere_sdf, torus_sdf
from dist_renderer_tpu.models.decoder import decoder_apply as jdecoder_apply
from dist_renderer_tpu.models.decoder import make_precise_sdf as jmake_precise_sdf
from dist_renderer_tpu.models.pretrain import fit_decoder_to_sdf
from dist_renderer_tpu.ops.camera import Camera as JCamera
from dist_renderer_tpu.ops.pallas.batched_march import (
    render_batched_c2f as jrender_batched_c2f,
)
from dist_renderer_tpu.ops.renderer import make_march_factory as jmake_factory
from dist_renderer_tpu.ops.renderer import render as jrender
from dist_renderer_tpu_torch.config import (
    DecoderConfig, GradConfig, MarchConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.decoder import (
    decoder_apply, make_precise_sdf, params_from_numpy,
)
from dist_renderer_tpu_torch.models.folded import make_point_fn
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.kernels import fused_march as tfm
from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f
from dist_renderer_tpu_torch.ops.renderer import (
    SDFRenderer, make_march_factory, render, render_rays,
)
from test_torch_render import _assert_parity
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

IMG = 32
DEC_KW = dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,))
FAST = dict(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4)


@pytest.fixture(scope="module")
def decoder():
    """tests/test_parity.py's decoder: 4x48 fitted to a sphere."""
    params, z0 = fit_decoder_to_sdf(lambda p: sphere_sdf(0.5)(None, p),
                                    JDecoderConfig(**DEC_KW), steps=400, batch=2048)
    return jax.tree_util.tree_map(np.array, params), np.array(z0)


def _cfg(pkg, march=None, grad=None, **kw):
    """One RenderConfig in either package's classes."""
    M, G, R = pkg
    return R(img_h=IMG, img_w=IMG, march=M(**(march or {})), grad=G(**(grad or {})),
             **kw)


JAX = (JMarchConfig, JGradConfig, JRenderConfig)
PORT = (MarchConfig, GradConfig, RenderConfig)


def _interpret(factory):
    """JAX's march factory with PallasMarchFn.trace in interpret mode (its
    default, interpret=False, cannot run on the CPU)."""
    def wrapped(z):
        mf = factory(z)
        if hasattr(mf, "trace"):
            trace = mf.trace
            mf.trace = lambda o, v, m, i=None, a=None: trace(o, v, m, i, a,
                                                             interpret=True)
        return mf
    return wrapped


def _jax_sdf(jp, jd, production: bool):
    """The JAX package's sdf_fn: its production precise function (a bf16
    split value with a bf16 backward, and the fused recompute kernel), or
    the fp32 value the port holds to, with the same bf16 ``cheap``
    sibling as the port's."""
    if production:
        return jmake_precise_sdf(jp, jd)
    f = lambda z, p: jdecoder_apply(jp, z, p, jd)
    f.cheap = lambda z, p: jdecoder_apply(jp, z, p, jd, jnp.bfloat16)
    return f


def _uses_sdg(cfg):
    return (cfg.grad.mode == "ift" and cfg.grad.recompute == "pallas"
            and cfg.normal_eps == 0.0)


def _both(decoder, march=None, grad=None, **kw):
    """Render the decoder's latent with each package; numpy maps. The
    JAX side takes its production precise function where the fused
    recompute runs (the same rounding as the port's K3), else the fp32
    value."""
    params, z0 = decoder
    jcfg, tcfg = _cfg(JAX, march, grad, **kw), _cfg(PORT, march, grad, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jd, td = JDecoderConfig(**DEC_KW), DecoderConfig(**DEC_KW)
    jcam = JCamera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    jout = jrender(_jax_sdf(jp, jd, _uses_sdg(jcfg)), jnp.asarray(z0), jcam, jcfg,
                   _interpret(jmake_factory(jp, jd, jcfg)))
    tp = params_from_numpy(params)
    tcam = Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    tout = render(make_precise_sdf(tp, td), torch.tensor(z0), tcam, tcfg,
                  make_march_factory(tp, td, tcfg))
    keys = ("depth", "mask", "normal", "min_sdf", "points")
    return ({k: np.asarray(getattr(jout, k)) for k in keys},
            {k: getattr(tout, k).detach().numpy() for k in keys}, tout)


BRANCHES = {
    "default (last_step, masked tracer)": dict(march=dict(max_steps=50)),
    "finite-difference normals": dict(march=dict(max_steps=50), normal_eps=1e-3),
    "c2f_plan + compaction + IFT polish, xla": dict(
        march=dict(FAST, coarse_to_fine=True, use_compaction=True),
        grad=dict(mode="ift", polish_iters=2, recompute="xla"),
        compute_dtype="bfloat16"),
    "c2f_plan + compaction + IFT polish, pallas": dict(
        march=dict(FAST, coarse_to_fine=True, use_compaction=True),
        grad=dict(mode="ift", polish_iters=2, recompute="pallas"),
        compute_dtype="bfloat16"),
    "use_pallas without c2f (K1-grid rounds)": dict(
        march=FAST, grad=dict(mode="ift", compact_frac=4, compact_min=256),
        compute_dtype="bfloat16", use_pallas=True),
    "use_pallas, c2f_classify=False (K1-grid levels)": dict(
        march=dict(FAST, coarse_to_fine=True, c2f_classify=False),
        grad=dict(mode="ift"), compute_dtype="bfloat16", use_pallas=True),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_render_branch_matches_jax(decoder, branch):
    j, t, tout = _both(decoder, **BRANCHES[branch])
    _assert_parity(j, t)
    c2f = BRANCHES[branch]["march"].get("coarse_to_fine", False)
    assert (tout.trace is None) == c2f  # c2f_plan's output has no trace


def test_grazing_hits_no_more_than_jax(decoder):
    """The share of hits whose fp32 decoder value |f| lies above
    convergence_eps (grazing rays whose IFT step was clamped, or that the
    polish left off the surface): the port's no higher than the JAX
    package's plus one hit's worth, on the fused-recompute branch."""
    params, z0 = decoder
    branch = BRANCHES["c2f_plan + compaction + IFT polish, pallas"]
    j, t, _ = _both(decoder, **branch)
    tp, td = params_from_numpy(params), DecoderConfig(**DEC_KW)
    eps = branch["march"]["convergence_eps"]
    shares, hits = {}, {}
    for name, out in (("jax", j), ("port", t)):
        pts = torch.from_numpy(np.ascontiguousarray(out["points"][out["mask"]]))
        with torch.no_grad():
            f = decoder_apply(tp, torch.tensor(z0), pts, td)
        hits[name] = int(pts.shape[0])
        shares[name] = float((f.abs() > eps).float().mean())
    print(f"hits with |f| > {eps}: jax {shares['jax']:.6f} of {hits['jax']}, "
          f"port {shares['port']:.6f} of {hits['port']}")
    assert hits["port"] > 0
    assert shares["port"] <= shares["jax"] + 1.0 / hits["port"]


# ---- gradients against jax.grad -------------------------------------------

GRAD_CASES = {
    "last_step": dict(march=dict(max_steps=50)),
    "ift xla, compact bucket (lazy margins on the cheap decoder)": dict(
        march=FAST, grad=dict(mode="ift", recompute="xla", compact_frac=4,
                              compact_min=256), compute_dtype="bfloat16"),
}
# Bars on relative L2, per leaf (latent, R, T). Against the JAX package
# with the fp32 value the port holds to: last_step measured 7.8e-7, bar
# 1e-5; IFT measured 5.0e-4, bar 3e-3 (the IFT denominator is the bf16
# march function's derivative, which JAX takes in forward mode and the
# port in reverse mode, rounding to bf16 at other points). Against the
# JAX package's production precise function (a bf16 split value and a
# bf16 backward, TPU workarounds the port does not carry): the gap that
# leaves, measured 7.9e-3 (last_step) and 1.8e-2 (IFT, R); bar 3e-2.
GRAD_REL = {("last_step", False): 1e-5, ("ift", False): 3e-3,
            ("last_step", True): 3e-2, ("ift", True): 3e-2}


@pytest.mark.parametrize("production", [False, True])
@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_latent_and_pose_gradients_match_jax(decoder, case, production):
    params, z0 = decoder
    kw = GRAD_CASES[case]
    jcfg, tcfg = _cfg(JAX, **kw), _cfg(PORT, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jd, td = JDecoderConfig(**DEC_KW), DecoderConfig(**DEC_KW)
    jcam = JCamera.looking_at((0.1, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    cols = np.arange(IMG)[None, :] < IMG // 2

    def jloss(z, R, T):
        out = jrender(_jax_sdf(jp, jd, production), z, JCamera(jcam.K, R, T),
                      jcfg, jmake_factory(jp, jd, jcfg))
        sil = jnp.where(~out.mask, jnp.maximum(out.min_sdf, 0.0), 0.0)
        return jnp.sum(jnp.where(out.mask & cols, out.depth, 0.0)) + jnp.sum(sil)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(z0), jcam.R, jcam.T)
    tp = params_from_numpy(params)
    sdf, fac = make_precise_sdf(tp, td), make_march_factory(tp, td, tcfg)
    leaves = [torch.as_tensor(np.array(x)).requires_grad_()
              for x in (z0, jcam.R, jcam.T)]
    out = render(sdf, leaves[0], Camera(torch.as_tensor(np.array(jcam.K)),
                                        leaves[1], leaves[2]), tcfg, fac)
    loss = (torch.where(out.mask & torch.as_tensor(cols), out.depth, 0.0).sum()
            + torch.where(~out.mask, out.min_sdf.clamp(min=0.0), 0.0).sum())
    tg = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(("latent", "R", "T"), tg, jg):
        a, b = a.double().numpy().ravel(), np.asarray(b, np.float64).ravel()
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= GRAD_REL[(tcfg.grad.mode, production)], (name, rel)


# ---- tests/test_parity.py's bars on the port -------------------------------

def _exact(params, z0, img, eye, focal):
    """The exact reference: an fp32 decoder march, tight eps, last step."""
    cam = Camera.looking_at(eye, focal=focal, img_hw=(img, img))
    cfg = RenderConfig(img_h=img, img_w=img, march=MarchConfig(
        max_steps=80, convergence_eps=1e-6, depth_eps=1e-7))
    dcfg = params[1]
    return cam, render(lambda z, p: decoder_apply(params[0], z, p, dcfg), z0,
                       cam, cfg)


def _fast_cfg(img, rec):
    return RenderConfig(
        img_h=img, img_w=img,
        march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                          coarse_to_fine=True, use_compaction=True),
        grad=GradConfig(mode="ift", polish_iters=2, recompute=rec),
        compute_dtype="bfloat16")


def test_fast_path_depth_parity_1e3(decoder):
    tp, z0 = params_from_numpy(decoder[0]), torch.tensor(decoder[1])
    dcfg = DecoderConfig(**DEC_KW)
    cam, exact = _exact((tp, dcfg), z0, IMG, (0.0, 0.0, -2.0), 40.0)
    cfg = _fast_cfg(IMG, "xla")
    fast = render(lambda z, p: decoder_apply(tp, z, p, dcfg), z0, cam, cfg,
                  make_march_factory(tp, dcfg, cfg))
    both = exact.mask & fast.mask
    assert both.sum() > 0.8 * exact.mask.sum()
    derr = (fast.depth - exact.depth).abs()
    assert derr[both].median() < 2e-4
    sel = both & (exact.normal[..., 2].abs() > 0.2)
    assert np.percentile(derr[sel].numpy(), 95) < 1e-3
    cn = (fast.normal[both] * exact.normal[both]).sum(-1)
    assert (1.0 - cn).median() < 1e-4


def test_fast_path_depth_parity_pallas_recompute(decoder):
    """The fused recompute must not degrade the fast path beyond the
    production value's own precision. In the JAX package both recomputes
    carry its bf16-split value; the port's xla recompute is fp32, so the
    fused recompute (the JAX kernel's rounding) is held, quantile for
    quantile, to the JAX package's xla recompute against the same exact
    render."""
    tp, z0 = params_from_numpy(decoder[0]), torch.tensor(decoder[1])
    dcfg = DecoderConfig(**DEC_KW)
    cam, exact = _exact((tp, dcfg), z0, IMG, (0.0, 0.0, -2.0), 40.0)
    sdf = make_precise_sdf(tp, dcfg)
    fx, fp = [render(sdf, z0, cam, _fast_cfg(IMG, rec),
                     make_march_factory(tp, dcfg, _fast_cfg(IMG, rec)))
              for rec in ("xla", "pallas")]
    assert torch.equal(fx.mask, fp.mask)
    jp = jax.tree_util.tree_map(jnp.asarray, decoder[0])
    jd, jcfg = JDecoderConfig(**DEC_KW), _cfg(
        JAX, dict(FAST, coarse_to_fine=True, use_compaction=True),
        dict(mode="ift", polish_iters=2, recompute="xla"), compute_dtype="bfloat16")
    jx = jrender(jmake_precise_sdf(jp, jd), jnp.asarray(decoder[1]),
                 JCamera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG)),
                 jcfg, jmake_factory(jp, jd, jcfg))
    both = exact.mask & fx.mask & torch.as_tensor(np.array(jx.mask))
    assert both.sum() > 0.8 * exact.mask.sum()
    ex = np.abs(np.asarray(jx.depth) - exact.depth.numpy())[both.numpy()]
    ep = (fp.depth - exact.depth).abs()[both].numpy()
    assert np.median(ep) <= np.median(ex) * 1.2 + 5e-5
    assert np.percentile(ep, 95) <= np.percentile(ex, 95) * 1.2 + 1e-4
    cn = (fp.normal[both] * exact.normal[both]).sum(-1)
    assert (1.0 - cn).median() < 1e-4


def test_parity_production_arch_bench_decoder():
    """The absolute 1e-3 bar at 8x512 on the committed bench decoder."""
    import os

    from dist_renderer_tpu_torch.models.pretrain import load_params_npz

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params, z0 = load_params_npz(os.path.join(root, ".bench_decoder.npz"))
    dcfg, img = DecoderConfig(), 16
    cam, exact = _exact((params, dcfg), z0, img, (0.0, 0.0, -2.5), img * 1.2)
    sdf = make_precise_sdf(params, dcfg)
    for rec in ("xla", "pallas"):
        cfg = _fast_cfg(img, rec)
        fast = render(sdf, z0, cam, cfg, make_march_factory(params, dcfg, cfg))
        both = exact.mask & fast.mask
        assert both.sum() > 0.8 * exact.mask.sum(), rec
        derr = (fast.depth - exact.depth).abs()
        sel = both & (exact.normal[..., 2].abs() > 0.2)
        assert sel.sum() > 20, rec
        assert np.percentile(derr[sel].detach().numpy(), 95) < 1e-3, rec


# ---- tests/test_gradients.py's bars on the port -----------------------------

MARCH = MarchConfig(max_steps=64, convergence_eps=1e-6)


def _latent_sphere(z, p):
    """The sphere of radius z[0]: |p| - r."""
    return torch.linalg.norm(p, dim=-1) - z.reshape(-1)[0]


def _grad_of(fn, x0):
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    (g,) = torch.autograd.grad(fn(x), x)
    return float(g)


@pytest.mark.parametrize("mode", ["last_step", "ift"])
def test_depth_grad_wrt_latent_sphere(mode):
    cfg = RenderConfig(img_h=1, img_w=1, march=MARCH, grad=GradConfig(mode=mode))
    o, v = torch.tensor([[0.0, 0.0, -2.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    g = _grad_of(lambda r: render_rays(_latent_sphere, r[None], o, v, cfg).depth[0],
                 0.5)
    assert np.isfinite(g) and abs(g + 1.0) <= 1e-3


@pytest.mark.parametrize("mode", ["last_step", "ift"])
def test_depth_grad_wrt_origin(mode):
    cfg = RenderConfig(img_h=1, img_w=1, march=MARCH, grad=GradConfig(mode=mode))
    z = torch.tensor([0.5])

    def depth_of(oz):
        o = torch.stack([torch.zeros(()), torch.zeros(()), oz])[None]
        return render_rays(_latent_sphere, z, o, torch.tensor([[0.0, 0.0, 1.0]]),
                           cfg).depth[0]

    assert abs(_grad_of(depth_of, -2.0) + 1.0) <= 1e-3


def test_grad_matches_finite_difference_offaxis():
    cfg = RenderConfig(img_h=1, img_w=1, march=MARCH, grad=GradConfig(mode="ift"))
    o, v = torch.tensor([[0.3, 0.2, -2.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    depth_of = lambda r: render_rays(_latent_sphere, r.reshape(1), o, v, cfg).depth[0]
    g = _grad_of(depth_of, 0.6)
    eps = 1e-4
    with torch.no_grad():
        fd = (depth_of(torch.tensor(0.6 + eps)) - depth_of(torch.tensor(0.6 - eps))) / (2 * eps)
    assert abs(g - float(fd)) <= 2e-2 * abs(float(fd))


def test_min_sdf_grad_for_missing_ray():
    cfg = RenderConfig(img_h=1, img_w=1, march=MARCH)
    o, v = torch.tensor([[0.8, 0.0, -2.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    margin_of = lambda r: render_rays(_latent_sphere, r.reshape(1), o, v, cfg).min_sdf[0]
    assert float(margin_of(torch.tensor(0.5))) > 0
    assert abs(_grad_of(margin_of, 0.5) + 1.0) <= 1e-2


def test_grad_through_a_frame_is_finite():
    cfg = RenderConfig(img_h=4, img_w=4, march=MARCH)
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=5.0, img_hw=(4, 4))
    o, v = pixel_rays(cam, 4, 4)

    def loss(r):
        out = render_rays(_latent_sphere, r.reshape(1), o, v, cfg)
        return torch.where(out.mask, out.depth, 0.0).sum()

    assert np.isfinite(_grad_of(loss, 0.5))


# ---- warm starts ------------------------------------------------------------

WARM_MARCH = dict(max_steps=32, convergence_eps=2e-3, depth_eps=5e-4,
                  coarse_to_fine=True, c2f_strides=(4,), c2f_coarse_steps=12)
WARM_DEC = dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))


@pytest.fixture(scope="module")
def warm_scene():
    """tests/test_warm_start.py's scene: a 4x32 decoder fitted to a torus."""
    params, z0 = fit_decoder_to_sdf(lambda p: torus_sdf(0.55, 0.2)(None, p),
                                    JDecoderConfig(**WARM_DEC), steps=300,
                                    batch=1024)
    params = jax.tree_util.tree_map(np.array, params)
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=IMG * 1.2, img_hw=(IMG, IMG))
    o, v = pixel_rays(cam, IMG, IMG)
    return params, np.array(z0), o[None].contiguous(), v[None]


def _brender(params, z, ob, vb, warm=None):
    return render_batched_c2f(params_from_numpy(params), DecoderConfig(**WARM_DEC),
                              torch.tensor(z)[None], ob, vb, (IMG, IMG),
                              MarchConfig(**WARM_MARCH), strides=(4,),
                              coarse_steps=12, scheduler="queue", warm=warm)


def _jax_normal(seed, shape):
    """tests/test_warm_start.py's latent perturbations (jax.random)."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


def _warm_state(st):
    return (st.depth, st.hit | st.unresolved, st.depth_at_min, st.min_sdf)


def _rim_band(hit):
    img = hit.reshape(1, 1, IMG, IMG).float()
    dil = F.max_pool2d(img, 3, 1, 1) > 0.5
    ero = -F.max_pool2d(-img, 3, 1, 1) > 0.5
    return (dil & ~ero).reshape(-1)


def _polish(params, z, ob, vb, d):
    """Two Newton steps on the fp32 folded decoder (the compose polish)."""
    pf = make_point_fn(params_from_numpy(params), torch.as_tensor(z),
                       DecoderConfig(**WARM_DEC))
    for _ in range(2):
        p = (ob[0] + d[:, None] * vb[0]).requires_grad_()
        f = pf(p)
        (g,) = torch.autograd.grad(f.sum(), p)
        d = d - f.detach() / torch.clamp((g * vb[0]).sum(-1), max=-1e-2)
    return d


def test_warm_same_state_matches_cold(warm_scene):
    params, z0, ob, vb = warm_scene
    cold = _brender(params, z0, ob, vb)
    warm = _brender(params, z0, ob, vb, warm=_warm_state(cold))
    h_c, h_w = cold.hit[0], warm.hit[0]
    assert h_c.sum() > 200
    assert ((h_c != h_w) & ~_rim_band(h_c)).sum() == 0
    both = h_c & h_w
    derr = (_polish(params, z0, ob, vb, warm.depth[0])
            - _polish(params, z0, ob, vb, cold.depth[0])).abs()[both]
    assert np.percentile(derr.numpy(), 95) < 1e-3


def test_warm_small_drift_keeps_hits(warm_scene):
    params, z0, ob, vb = warm_scene
    prev = _brender(params, z0, ob, vb)
    z1 = z0 + 0.02 * _jax_normal(7, z0.shape)
    cold = _brender(params, z1, ob, vb)
    warm = _brender(params, z1, ob, vb, warm=_warm_state(prev))
    assert ((cold.hit[0] != warm.hit[0]) & ~_rim_band(cold.hit[0])).sum() == 0


def test_warm_fit_recovers_like_cold(warm_scene):
    """A latent fit driven by warm renders (refresh every 8) ends within
    10% of the cold fit's loss."""
    params, z0, ob, vb = warm_scene
    tp, dcfg = params_from_numpy(params), DecoderConfig(**WARM_DEC)
    target = _brender(params, z0, ob, vb)
    tgt_d, tgt_hit = target.depth, target.hit
    z_init = z0 + 0.15 * _jax_normal(5, z0.shape)

    def obj(z, st):
        anchor = torch.where(st.hit, st.depth, st.depth_at_min)
        p = (ob + anchor[..., None] * vb).reshape(-1, 3)
        s = decoder_apply(tp, z, p, dcfg).reshape(st.depth.shape)
        both = st.hit & tgt_hit
        ld = torch.where(both, (st.depth + s - tgt_d).abs(), 0.0).sum() / (both.sum() + 1.0)
        return ld + torch.where(tgt_hit & ~st.hit, s.abs(), 0.0).mean()

    def fit_loop(use_warm):
        z = torch.tensor(z_init, requires_grad=True)
        opt = torch.optim.Adam([z], lr=3e-2)
        warm = None
        for k in range(24):
            with torch.no_grad():
                st = _brender(params, z.detach().numpy(),
                              ob, vb, warm if (use_warm and k % 8) else None)
            opt.zero_grad()
            obj(z, st).backward()
            opt.step()
            warm = _warm_state(st)
        with torch.no_grad():
            return float(obj(z, _brender(params, z.numpy(), ob, vb)))

    cold, warm = fit_loop(False), fit_loop(True)
    assert warm <= cold * 1.1 + 1e-4, (warm, cold)


def test_warm_render_matches_jax_from_the_same_state(warm_scene):
    params, z0, ob, vb = warm_scene
    prev = _brender(params, z0, ob, vb)
    z1 = z0 + 0.02 * _jax_normal(7, z0.shape)
    w = _warm_state(prev)
    out = _brender(params, z1, ob, vb, warm=w)
    jw = tuple(jnp.asarray(x.numpy()) for x in w)
    ref = jax.jit(lambda l: jrender_batched_c2f(
        jax.tree_util.tree_map(jnp.asarray, params), JDecoderConfig(**WARM_DEC),
        l, jnp.asarray(ob.numpy()), jnp.asarray(vb.numpy()), (IMG, IMG),
        JMarchConfig(**WARM_MARCH), strides=(4,), coarse_steps=12,
        shared_origin=False, warm=jw, scheduler="queue",
        interpret=True))(jnp.asarray(z1)[None])
    jh, th = np.asarray(ref[1])[0], out.hit[0].numpy()
    assert jh.sum() > 200 and (jh == th).mean() >= 0.99
    both = jh & th
    derr = np.abs(np.asarray(ref[0])[0] - out.depth[0].numpy())[both]
    assert np.median(derr) < 1e-5 and np.mean(derr < 1e-3) >= 0.98


# ---- the repaired faults -----------------------------------------------------

def test_use_pallas_false_marches_the_jax_way(decoder):
    """use_pallas=False gives the folded point function (no trace_frame):
    render() then plans with c2f_plan on the plain tracers, whose output
    carries no trace, as in the JAX package. Plain kernel versions are
    the separate use_kernel choice."""
    tp, z0 = params_from_numpy(decoder[0]), torch.tensor(decoder[1])
    dcfg = DecoderConfig(**DEC_KW)
    cfg = RenderConfig(img_h=IMG, img_w=IMG, march=MarchConfig(
        **FAST, coarse_to_fine=True), grad=GradConfig(mode="ift"),
        compute_dtype="bfloat16")
    mf = make_march_factory(tp, dcfg, cfg)(z0)
    assert not hasattr(mf, "trace_frame") and not hasattr(mf, "trace")
    assert mf.proxy_march is False
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    out = render(make_precise_sdf(tp, dcfg), z0, cam, cfg,
                 make_march_factory(tp, dcfg, cfg))
    assert out.trace is None and out.mask.float().mean() > 0.05
    on = dataclasses.replace(cfg, use_pallas=True)
    mf = make_march_factory(tp, dcfg, on, use_kernel=False)(z0)
    assert isinstance(mf, tfm.FusedMarchFn) and hasattr(mf, "trace_frame")
    assert mf.use_kernel is False


def test_render_takes_a_warm_state(decoder):
    from dist_renderer_tpu_torch.ops.renderer import render_with_warm, warm_from_trace

    tp, z0 = params_from_numpy(decoder[0]), torch.tensor(decoder[1])
    dcfg = DecoderConfig(**DEC_KW)
    cfg = RenderConfig(march=MarchConfig(**FAST, coarse_to_fine=True,
                                         c2f_strides=(4,)),
                       grad=GradConfig(mode="ift"), compute_dtype="bfloat16",
                       use_pallas=True)
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    r = SDFRenderer(tp, cam.K, (IMG, IMG), decoder_cfg=dcfg, cfg=cfg)
    cold = r.render(z0, cam.R, cam.T)
    w = warm_from_trace(cold.trace)
    assert len(w) == 4 and all(x.shape == (IMG * IMG,) for x in w)
    warm = r.render(z0, cam.R, cam.T, warm=w)
    assert (warm.mask == cold.mask).float().mean() >= 0.99
    carry = (1, w)
    for k in range(1, 4):
        z = z0.clone().requires_grad_()
        out, carry = render_with_warm(r.sdf_fn, z, Camera(r.K, cam.R, cam.T),
                                      r.cfg, r.march_fn_factory, carry, 2)
        (g,) = torch.autograd.grad(out.depth.sum(), z)
        assert carry[0] == k + 1 and torch.isfinite(g).all() and g.abs().sum() > 0


def test_sdf_renderer_renders_with_the_jax_default_config(decoder):
    """SDFRenderer(params, K) with RenderConfig()'s defaults: last-step
    composition on the masked tracer, fp32."""
    tp, z0 = params_from_numpy(decoder[0]), torch.tensor(decoder[1])
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    r = SDFRenderer(tp, cam.K, (IMG, IMG), decoder_cfg=DecoderConfig(**DEC_KW))
    assert r.cfg.use_pallas is False and r.cfg.grad.mode == "last_step"
    out = r.render(z0, cam.R, cam.T)
    assert out.mask.float().mean() > 0.05 and torch.isfinite(out.depth).all()
    assert out.trace.steps_per_ray.shape == (IMG * IMG,)


# ---- an overflowed compose bucket: K3 on the hits, its value on the misses --

def _bucket_render(decoder, eye_z, frac, polish_iters, grad=False):
    """render() with the fused recompute on K1-grid's plain version, an
    n/4 compose bucket (compact_frac=frac, compact_min 256: 512 rays of
    IMG^2 = 1024): (output, the recorder's counts by counter name)."""
    from torch.profiler import profile

    from dist_renderer_tpu_torch.utils import profiling

    tp, z0 = params_from_numpy(decoder[0]), torch.tensor(decoder[1])
    dcfg = DecoderConfig(**DEC_KW)
    cfg = RenderConfig(img_h=IMG, img_w=IMG, march=MarchConfig(**FAST),
                       grad=GradConfig(mode="ift", compact_frac=frac, compact_min=256,
                                       polish_iters=polish_iters),
                       compute_dtype="bfloat16", use_pallas=True)
    cam = Camera.looking_at((0.0, 0.0, eye_z), focal=40.0, img_hw=(IMG, IMG))
    z = z0.clone().requires_grad_(grad)
    profiling.drain()
    with profile(), torch.set_grad_enabled(grad):
        out = render(make_precise_sdf(tp, dcfg), z, cam, cfg, make_march_factory(tp, dcfg, cfg))
    counts = {}
    for (name, _), v in profiling.drain().counts.items():
        counts[name] = counts.get(name, 0) + v
    return out, counts


def _same_maps(a, b):
    for k in ("depth", "mask", "normal", "min_sdf", "points"):
        x, y = getattr(a, k).detach(), getattr(b, k).detach()
        if x.is_floating_point():
            x, y = x.contiguous().view(torch.int32), y.contiguous().view(torch.int32)
        assert torch.equal(x, y), k


BUCKET, OVERFLOW_EYE, FIT_EYE = 512, -1.5, -2.0


@pytest.mark.parametrize("polish_iters", [1, 2])
def test_overflowed_bucket_splits_compose_with_the_full_width_bits(decoder, polish_iters):
    """Hits past the n/4 bucket and no gradient: K3 on the hits, K3's
    value mode on the misses; the maps equal the full-width branch's
    (compact_frac 0: K3 on every ray) bit for bit."""
    split, c = _bucket_render(decoder, OVERFLOW_EYE, 4, polish_iters)
    full, c0 = _bucket_render(decoder, OVERFLOW_EYE, 0, polish_iters)
    n, hits = IMG * IMG, int(split.mask.sum())
    assert BUCKET < hits < n
    assert c["k3_points"] == polish_iters * hits and c["k3_value_points"] == n - hits
    assert c0["k3_points"] == polish_iters * n and "k3_value_points" not in c0
    _same_maps(split, full)


@pytest.mark.parametrize("polish_iters", [1, 2])
def test_overflowed_bucket_with_a_gradient_keeps_the_full_width(decoder, polish_iters):
    """With a gradient wanted the split never engages: K3 on every ray
    (its K4 backward reads every margin), the full-width maps."""
    out, c = _bucket_render(decoder, OVERFLOW_EYE, 4, polish_iters, grad=True)
    full, _ = _bucket_render(decoder, OVERFLOW_EYE, 0, polish_iters)
    assert out.depth.requires_grad and int(out.mask.sum()) > BUCKET
    assert c["k3_points"] == polish_iters * IMG * IMG and "k3_value_points" not in c
    _same_maps(out, full)


@pytest.mark.parametrize("polish_iters", [1, 2])
def test_fitting_bucket_does_not_split(decoder, polish_iters):
    """Hits within the bucket: K3 on the bucket's rays alone, as before."""
    out, c = _bucket_render(decoder, FIT_EYE, 4, polish_iters)
    assert 0 < int(out.mask.sum()) <= BUCKET
    assert c["k3_points"] == polish_iters * BUCKET and "k3_value_points" not in c
