"""The proxy verify modes of the port's multi-frame render against the
JAX package's, on the CPU: ``render_batched_c2f`` on the rounds scheduler
with verify_hits "march", "polish" and "polish-all", and compose()'s
polish demote through ``render()``. The JAX side runs its kernels in
interpret mode. (Without a proxy: tests/test_torch_batched.py.)

Scene: tests/test_proxy.py's (a 4x48 decoder fitted to a sphere,
tests/test_torch_batched.py's ``sphere``, and its distilled 3x32 proxy,
here after 400 distillation steps where tests/test_proxy.py takes 1500):
two frames of 16x16 for the verify modes (JAX's interpret-mode compile of
the whole batched render sets the cost), one of 32x32 for the demote. Bars as in
tests/test_torch_batched.py: the two packages' CPU BLAS libraries sum in
different orders, so a ray near a stopping rule may stop one sample
apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import GradConfig as JGradConfig
from dist_renderer_tpu.config import MarchConfig as JMarchConfig
from dist_renderer_tpu.config import RenderConfig as JRenderConfig
from dist_renderer_tpu.models.proxy import default_proxy_cfg, distill_proxy
from dist_renderer_tpu.ops import camera as jcam
from dist_renderer_tpu.ops.pallas import batched_march as jbm
from dist_renderer_tpu.ops.renderer import make_march_factory as jmake_factory
from dist_renderer_tpu.ops.renderer import render as jrender
from dist_renderer_tpu_torch.config import (
    DecoderConfig, GradConfig, MarchConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.ops.camera import Camera
from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f
from dist_renderer_tpu_torch.ops.renderer import make_march_factory, render
from test_torch_batched import T, _assert_trace_parity, sphere  # noqa: F401
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

IMG = 32         # the demote's single frame
MODES_IMG = 16   # the verify modes' two frames
F = 2
MARCH_KW = dict(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4)


def _cfg_kw(cfg):
    return {k: getattr(cfg, k) for k in ("latent_size", "hidden_dims", "latent_in",
                                         "xyz_in_all", "use_tanh", "final_tanh")}


@pytest.fixture(scope="module")
def decoders(sphere):
    """The sphere decoder and its distilled proxy, as numpy."""
    params, z0, dkw = sphere
    dcfg = JDecoderConfig(**dkw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    proxy, pcfg = distill_proxy(jp, dcfg, jnp.asarray(z0)[None],
                                proxy_cfg=default_proxy_cfg(dcfg, width=32, depth=3),
                                steps=400, batch=2048, lr=2e-3)
    return params, z0, dkw, jax.tree_util.tree_map(np.array, proxy), _cfg_kw(pcfg)


def _frames(z0, img=MODES_IMG):
    rng = np.random.default_rng(4)
    lat = np.stack([z0, z0 + 0.02 * rng.standard_normal(z0.shape)]).astype(np.float32)
    cam = jcam.Camera.looking_at((0.0, 0.0, -2.0), focal=1.25 * img, img_hw=(img, img))
    o, v = (np.asarray(a) for a in jcam.pixel_rays(cam, img, img))
    n = img * img
    return lat, np.broadcast_to(o, (F, n, 3)).copy(), np.broadcast_to(v, (F, n, 3)).copy()


@pytest.mark.parametrize("mode", ["march", "polish", "polish-all"])
def test_render_batched_c2f_rounds_matches_jax(decoders, mode):
    params, z0, dkw, proxy, pkw = decoders
    lat, ob, vb = _frames(z0)
    flags = dict(strides=(4,), shared_origin=True, return_anchor=True,
                 return_steps=True, return_last=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jproxy = (jax.tree_util.tree_map(jnp.asarray, proxy), JDecoderConfig(**pkw))
    ref = jax.jit(lambda: jbm.render_batched_c2f(
        jp, JDecoderConfig(**dkw), jnp.asarray(lat), jnp.asarray(ob),
        jnp.asarray(vb), (MODES_IMG, MODES_IMG), JMarchConfig(**MARCH_KW),
        proxy=jproxy, verify_hits=mode,
        verify_round_caps=(2, 4, 12), interpret=True, **flags))()
    ref = [np.asarray(a) for a in ref]
    out = render_batched_c2f(
        params_from_numpy(params), DecoderConfig(**dkw), T(lat), T(ob), T(vb),
        (MODES_IMG, MODES_IMG), MarchConfig(**MARCH_KW),
        proxy=(params_from_numpy(proxy), DecoderConfig(**pkw)),
        verify_hits=mode, verify_round_caps=(2, 4, 12), **flags)
    _assert_trace_parity(ref[0], ref[1], ref[2], out.depth.numpy(), out.hit.numpy(),
                         out.min_sdf.numpy())
    assert np.mean(np.abs(ref[3] - out.depth_at_min.numpy()) < 1e-3) >= 0.98
    assert np.mean(ref[4] == out.steps.numpy()) >= 0.98
    assert np.mean(ref[6] == out.unresolved.numpy()) >= 0.99
    if mode == "polish-all":
        weak = out.weak.numpy()
        assert weak.any() and np.mean(ref[7] == weak) >= 0.99
        assert (out.hit.numpy() | ~weak).all()
    else:
        assert out.weak is None and len(ref) == 7


def test_polish_flip_rate_matches_jax(decoders):
    """The polish modes' hit flips against march-verify, on each side: both
    packages render F=2 frames of 32x32 with verify_hits (a) "march", (b)
    "polish" and (c) "polish-all" (the port's plain versions, JAX's kernels
    in interpret mode), finalize (b) and (c) as chip_smoke.py's phase 8
    does (finalize_hits_batched, polish_iters 2, compact_frac 4 and 3, the
    weak mask in (c)), and count the hits of (b) and (c) that differ from
    their own (a)'s. Bar: the port's count within max(2 rays, 0.5
    percentage points of (a)'s hits) of JAX's.

    Read on this scene (770 hits of (a) on both sides, equal traces): (b)
    port 101 flips (13.12%), JAX 100 (12.99%); (c) port 110 (14.29%), JAX
    109 (14.16%); the two finalizes differ on 1 ray in each. With an fp32
    value and tangent in the finalize the port read 93 and 99: the demote
    verdict follows the evaluation's roundings, so decoder_apply_with_dd
    keeps the JAX package's."""
    from dist_renderer_tpu.ops.renderer import finalize_hits_batched as jfinalize
    from dist_renderer_tpu_torch.ops.renderer import finalize_hits_batched

    params, z0, dkw, proxy, pkw = decoders
    lat, ob, vb = _frames(z0, IMG)
    flags = dict(strides=(4,), shared_origin=True, verify_round_caps=(2, 4, 12))
    fin = dict(convergence_eps=MARCH_KW["convergence_eps"], polish_iters=2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jproxy = (jax.tree_util.tree_map(jnp.asarray, proxy), JDecoderConfig(**pkw))
    tp = params_from_numpy(params)
    tproxy = (params_from_numpy(proxy), DecoderConfig(**pkw))
    hits = {}
    for mode in ("march", "polish", "polish-all"):
        ref = jax.jit(lambda: jbm.render_batched_c2f(
            jp, JDecoderConfig(**dkw), jnp.asarray(lat), jnp.asarray(ob),
            jnp.asarray(vb), (IMG, IMG), JMarchConfig(**MARCH_KW), proxy=jproxy,
            verify_hits=mode, interpret=True, **flags))()
        out = render_batched_c2f(tp, DecoderConfig(**dkw), T(lat), T(ob), T(vb),
                                 (IMG, IMG), MarchConfig(**MARCH_KW), proxy=tproxy,
                                 verify_hits=mode, **flags)
        assert np.mean(np.asarray(ref[1]) == out.hit.numpy()) >= 0.99
        if mode == "march":
            hits[mode] = (np.asarray(ref[1]), out.hit.numpy())
            continue
        kw = dict(fin, compact_frac=3 if mode == "polish-all" else 4)
        jh = np.asarray(jfinalize(
            jp, JDecoderConfig(**dkw), jnp.asarray(lat), jnp.asarray(ob),
            jnp.asarray(vb), ref[0], ref[1], ref[2],
            weak=ref[3] if mode == "polish-all" else None, **kw)[1])
        th = finalize_hits_batched(tp, DecoderConfig(**dkw), T(lat), T(ob), T(vb),
                                   out.depth, out.hit, out.min_sdf, weak=out.weak,
                                   **kw)[1].numpy()
        hits[mode] = (jh, th)
    ja, ta = hits["march"]
    assert ja.sum() > 500 and np.mean(ja == ta) >= 0.99
    for mode in ("polish", "polish-all"):
        jh, th = hits[mode]
        jax_flips, port = int((jh != ja).sum()), int((th != ta).sum())
        assert (abs(port - jax_flips) <= 2
                or abs(port / ta.sum() - jax_flips / ja.sum()) <= 0.005), (mode, port, jax_flips)


def _render_both(decoders, hits_mode, polish_iters=4):
    """One frame through each package's render() on the trace_frame path
    with the proxy march (compose() on the fp32 precise value; JAX's with
    its production recompute kernel in interpret mode)."""
    params, z0, dkw, proxy, pkw = decoders
    from dist_renderer_tpu.models.decoder import make_precise_sdf as jmake_precise_sdf
    from dist_renderer_tpu_torch.models.decoder import make_precise_sdf

    def cfg(M, G, R):
        return R(img_h=IMG, img_w=IMG,
                 march=M(**MARCH_KW, coarse_to_fine=True, proxy_verify_hits=hits_mode),
                 grad=G(mode="ift", polish_iters=polish_iters, recompute="pallas"),
                 compute_dtype="bfloat16", use_pallas=True)

    jcfg = cfg(JMarchConfig, JGradConfig, JRenderConfig)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jpp = jax.tree_util.tree_map(jnp.asarray, proxy)
    jout = jrender(jmake_precise_sdf(jp, JDecoderConfig(**dkw)), jnp.asarray(z0),
                   jcam.Camera.looking_at((0.0, 0.0, -2.0), focal=40.0,
                                          img_hw=(IMG, IMG)), jcfg,
                   jmake_factory(jp, JDecoderConfig(**dkw), jcfg, march_params=jpp,
                                 march_dcfg=JDecoderConfig(**pkw)))
    tcfg = cfg(MarchConfig, GradConfig, RenderConfig)
    tp, tpp = params_from_numpy(params), params_from_numpy(proxy)
    tout = render(make_precise_sdf(tp, DecoderConfig(**dkw)), T(z0),
                  Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG)),
                  tcfg, make_march_factory(tp, DecoderConfig(**dkw), tcfg,
                                           march_params=tpp,
                                           march_dcfg=DecoderConfig(**pkw)))
    keys = ("depth", "mask", "normal", "min_sdf")
    t = {k: getattr(tout, k).numpy() for k in keys}
    t["trace_hit"] = tout.trace.hit.reshape(IMG, IMG).numpy()
    return {k: np.asarray(getattr(jout, k)) for k in keys}, t


def test_polish_demote_render_matches_jax(decoders):
    """render(proxy_verify_hits="polish"): confident proxy hits skip the
    verify march and compose()'s Newton polish finalizes them (4
    iterations: tests/test_proxy.py's toy proxy). Against the JAX
    package's render: tests/test_torch_render.py's bars (hits agree on
    >= 99% of rays, depth p95 <= 1e-3 on frontal common hits); and the
    demote must have acted: some trace hits are not in the mask, and the
    JAX package's render demotes >= 90% of those rays too and keeps no
    more than 10% of the rays it demotes in the port's mask."""
    from test_torch_render import _assert_parity

    j, t = _render_both(decoders, "polish")
    _assert_parity(j, t)
    # the mask is the trace's hits less the demoted ones, which carry their
    # polished value as the margin: a positive dip
    assert (t["mask"] <= t["trace_hit"]).all()
    demoted = t["trace_hit"] & ~t["mask"]
    assert (t["min_sdf"][demoted] > -2e-3).all()
    assert demoted.any()
    assert np.mean(~j["mask"][demoted]) >= 0.9
    # JAX's demoted rays among the port's trace hits
    j_demoted = t["trace_hit"] & ~j["mask"]
    assert j_demoted.any() and np.mean(~t["mask"][j_demoted]) >= 0.9


@pytest.mark.parametrize("grad", [dict(mode="ift", polish_iters=1),
                                  dict(mode="last_step", polish_iters=2)])
def test_polish_demote_needs_newton_iterations(decoders, grad):
    """The demote's verdict comes from the Newton iterations: polish_iters
    < 2 runs none, and so does mode="last_step" (which the JAX package's
    guard lets through, ROADMAP C)."""
    params, z0, dkw, proxy, pkw = decoders
    cfg = RenderConfig(img_h=8, img_w=8, march=MarchConfig(
        **MARCH_KW, coarse_to_fine=True, proxy_verify_hits="polish"),
        grad=GradConfig(**grad), use_pallas=True)
    tp, tpp = params_from_numpy(params), params_from_numpy(proxy)
    from dist_renderer_tpu_torch.models.decoder import make_precise_sdf

    with pytest.raises(ValueError, match="polish_iters >= 2"):
        render(make_precise_sdf(tp, DecoderConfig(**dkw)), T(z0),
               Camera.looking_at((0.0, 0.0, -2.0), focal=10.0, img_hw=(8, 8)), cfg,
               make_march_factory(tp, DecoderConfig(**dkw), cfg, march_params=tpp,
                                  march_dcfg=DecoderConfig(**pkw)))
