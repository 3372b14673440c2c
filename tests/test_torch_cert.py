"""The proxy verify stage's certification path against the JAX package's, on
the CPU: the banked point eval (K6, ops/kernels/mlp_eval.py's plain
version against ``pallas_point_eval_banked`` in interpret mode),
``ops/cert.py``'s ``certify_hits_batched``, and ``render_batched_c2f``
with verify_mode="cert", verify_band="probe" and the hybrid; then the
port's own contracts from tests/test_proxy.py and one ``render()``
request through them.

Scene: tests/test_torch_polish.py's (a 4x48 decoder fitted to a sphere
of radius 0.5 and its distilled 3x32 proxy), two frames of 32x32.

Bars. K6 on active lanes: tests/test_torch_mlp_eval.py's K5 bars (the two
CPU BLAS libraries sum a row in their own orders, and a last-bit
difference can move an activation's bf16 rounding); lanes of a 32-point
tile with no active lane are exactly 3e38. CertResult: ``overflow`` is a
function of the masks and the stable sort alone, so it is equal;
``certified`` and ``promoted`` agree on >= 99.5% of candidates (a probe
value within a last-bit difference of zero may flip a sign test); the
float fields of rays both sides certify or probe meet the K5 bars. The
secant and the parabola are rational functions of the probe values with
denominators that stay away from zero on certified and probed rays, so
they carry the probes' differences at about the same size. Renders:
tests/test_torch_batched.py's ``_assert_trace_parity``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import MarchConfig as JMarchConfig
from dist_renderer_tpu.models.decoder import init_decoder_params
from dist_renderer_tpu.ops import camera as jcam
from dist_renderer_tpu.ops import cert as jcert
from dist_renderer_tpu.ops.pallas import batched_march as jbm
from dist_renderer_tpu.ops.pallas import mlp_eval as jmlp
from dist_renderer_tpu_torch.config import (
    DecoderConfig, GradConfig, MarchConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf, params_from_numpy
from dist_renderer_tpu_torch.ops import cert
from dist_renderer_tpu_torch.ops.camera import Camera
from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
from dist_renderer_tpu_torch.ops.kernels import mlp_eval
from dist_renderer_tpu_torch.ops.renderer import make_march_factory, render
from test_torch_batched import T, _assert_trace_parity, sphere  # noqa: F401
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)
from test_torch_mlp_eval import _assert_k5_bars
from test_torch_polish import MARCH_KW, _frames, decoders  # noqa: F401

IMG = 32
N = IMG * IMG
F = 2
POS_BIG = 3.0e38

# (i) K6: the two widths of tests/test_torch_batched.py's and
# tests/test_torch_polish.py's decoders, from numpy-free JAX keys
K6_ARCHS = [dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,)),
            dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,))]


def _k6_inputs(arch, frames=3, blocks=3, block=512, seed=0):
    """Weights of K6_ARCHS[arch] on both sides, latents, points and the
    active mask: frame 0 has a dead 512-block and dead 32-tiles inside a
    live block, frame 1 ragged live runs, frame 2 no active point."""
    kw = K6_ARCHS[arch]
    jp = init_decoder_params(jax.random.PRNGKey(arch), JDecoderConfig(**kw))
    rng = np.random.default_rng(seed + arch)
    lat = (0.3 * rng.standard_normal((frames, kw["latent_size"]))).astype(np.float32)
    n = frames * blocks * block
    pts = (0.8 * rng.standard_normal((n, 3))).astype(np.float32)
    act = np.zeros(n, bool)
    per = blocks * block
    act[0:40] = True                       # tiles 0-1 live
    act[100:101] = True                    # one lane of tile 3
    act[2 * block + 7:2 * block + 300] = True  # block 1 dead, block 2 partly
    act[per + 31:per + 33] = True          # two tiles, one lane each
    act[per + block:per + 2 * block:3] = True
    fob = np.repeat(np.arange(frames, dtype=np.int32), blocks)
    return jp, kw, lat, pts, act, fob


@pytest.mark.parametrize("precise_x", [True, False])
@pytest.mark.parametrize("arch", range(len(K6_ARCHS)))
def test_point_eval_banked_plain_matches_interpret(arch, precise_x):
    jp, kw, lat, pts, act, fob = _k6_inputs(arch)
    jcfg = JDecoderConfig(**kw)
    jshared = jbm.pack_shared(jp, jcfg)
    ref = np.asarray(jmlp.pallas_point_eval_banked(
        jshared, jbm.fold_bias_bank(jp, jnp.asarray(lat), jcfg, jshared),
        jnp.asarray(fob), jnp.asarray(pts), jnp.asarray(act), interpret=True,
        precise_x=precise_x))
    params, cfg = params_from_numpy(jax.tree_util.tree_map(np.array, jp)), DecoderConfig(**kw)
    shared = bm.pack_shared(params, cfg)
    bank = bm.fold_bias_bank(params, T(lat), cfg, shared)
    n0 = mlp_eval.point_eval_banked.launches
    out = mlp_eval.point_eval_banked(shared, bank, T(fob), T(pts), T(act),
                                     precise_x=precise_x).numpy()
    assert mlp_eval.point_eval_banked.launches == n0  # a CPU tensor launches nothing
    _assert_k5_bars(out[act], ref[act])
    live = np.repeat(act.reshape(-1, 32).any(axis=1), 32)
    assert (out[~live] == np.float32(POS_BIG)).all()
    assert (out[live] < 1e3).all() and live.sum() < len(live) // 2
    # the split changes the values: the low halves reach the x-products
    if precise_x:
        other = mlp_eval.point_eval_banked(shared, bank, T(fob), T(pts), T(act),
                                           precise_x=False).numpy()
        assert np.abs(other - out)[act].max() > 1e-5


def test_point_eval_banked_checks_its_shapes():
    jp, kw, lat, pts, act, fob = _k6_inputs(0, frames=1, blocks=1)
    params, cfg = params_from_numpy(jax.tree_util.tree_map(np.array, jp)), DecoderConfig(**kw)
    shared = bm.pack_shared(params, cfg)
    bank = bm.fold_bias_bank(params, T(lat), cfg, shared)
    with pytest.raises(ValueError, match="multiple of block"):
        mlp_eval.point_eval_banked(shared, bank, T(fob), T(pts[:500]), T(act[:500]))
    with pytest.raises(ValueError, match="frame_of_block"):
        mlp_eval.point_eval_banked(shared, bank, T(fob[:0]), T(pts), T(act))
    with pytest.raises(ValueError, match="columns"):
        mlp_eval.point_eval_banked(shared, bank, T(fob + bank.shape[1]), T(pts), T(act))


def _cert_scene(decoders, eye=-1.2):
    """tests/test_proxy.py's overflow scene: a close-up camera on the
    sphere decoder at two copies of its latent, the exact sphere's depths
    as seeds on the rays that meet it, both packages' packed decoders."""
    params, z0, dkw, _, _ = decoders
    cam = jcam.Camera.looking_at((0.0, 0.0, eye), focal=40.0, img_hw=(IMG, IMG))
    o, v = (np.asarray(a) for a in jcam.pixel_rays(cam, IMG, IMG))
    b_ = np.sum(o * v, axis=-1)
    c_ = np.sum(o * o, axis=-1) - 0.25
    disc = b_ * b_ - c_
    hit_geo = disc > 1e-4
    d_geo = (-b_ - np.sqrt(np.maximum(disc, 0.0))).astype(np.float32)
    lat = np.stack([z0, z0]).astype(np.float32)
    ob, vb = (np.broadcast_to(a[None], (F, N, 3)).copy() for a in (o, v))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jshared = jbm.pack_shared(jp, JDecoderConfig(**dkw))
    jbank = jbm.fold_bias_bank(jp, jnp.asarray(lat), JDecoderConfig(**dkw), jshared)
    tp = params_from_numpy(params)
    shared = bm.pack_shared(tp, DecoderConfig(**dkw))
    bank = bm.fold_bias_bank(tp, T(lat), DecoderConfig(**dkw), shared)
    return dict(ob=ob, vb=vb, hit_geo=hit_geo, d_geo=d_geo, jshared=jshared,
                jbank=jbank, shared=shared, bank=bank, o=o, v=v)


def _certify_both(s, seeded, depth, band=None, anchor=None, **kw):
    jargs = (s["jshared"], s["jbank"], jnp.asarray(s["ob"]), jnp.asarray(s["vb"]),
             jnp.asarray(depth), jnp.asarray(seeded), JMarchConfig(**MARCH_KW))
    ref = jax.jit(lambda: jcert.certify_hits_batched(
        *jargs, interpret=True,
        band=None if band is None else jnp.asarray(band),
        anchor=None if anchor is None else jnp.asarray(anchor), **kw))()
    out = cert.certify_hits_batched(
        s["shared"], s["bank"], T(s["ob"]), T(s["vb"]), T(depth), T(seeded),
        MarchConfig(**MARCH_KW), band=None if band is None else T(band),
        anchor=None if anchor is None else T(anchor), **kw)
    return ({k: np.asarray(getattr(ref, k)) for k in ref._fields},
            {k: getattr(out, k).numpy() for k in out._fields})


def _assert_cert_parity(j, t, cand):
    assert np.array_equal(j["overflow"], t["overflow"])
    for k in ("certified", "promoted"):
        assert np.mean((j[k] == t[k])[cand]) >= 0.995, k
    both = j["certified"] & t["certified"]
    assert both.sum() > 50
    for k in ("depth", "f_inside"):
        _assert_k5_bars(t[k][both], j[k][both])
    return both


def test_certify_hits_overflow_matches_jax(decoders):
    """tests/test_proxy.py's overflow accounting on a one-block bucket
    (block 128): the same overflow as JAX's, n_over = (n_hits - 128) * F,
    certified and overflow disjoint and within the seeded set, and
    certified depths on the full decoder's zero set."""
    s = _cert_scene(decoders)
    seeded = np.repeat(s["hit_geo"][None], F, 0)
    depth = np.repeat(s["d_geo"][None], F, 0)
    n_hits = int(s["hit_geo"].sum())
    assert n_hits > 128
    j, t = _certify_both(s, seeded, depth, delta=0.02, block=128,
                         bucket_frac=N // 128)
    both = _assert_cert_parity(j, t, seeded)
    assert int(t["overflow"].sum()) == (n_hits - 128) * F
    assert int(t["certified"].sum()) > 0.6 * 128 * F
    assert not (t["certified"] & t["overflow"]).any()
    assert ((t["certified"] | t["overflow"]) <= seeded).all()
    # the secant depth lands on the zero set of the full decoder
    params, z0, dkw, _, _ = decoders
    from dist_renderer_tpu_torch.models.decoder import decoder_apply

    c0 = t["certified"][0]
    pts = s["o"][c0] + t["depth"][0][c0, None] * s["v"][c0]
    f = decoder_apply(params_from_numpy(params), T(z0), T(pts), DecoderConfig(**dkw))
    assert np.percentile(np.abs(f.numpy()), 95) < 2e-3
    assert both.sum() >= 0.99 * t["certified"].sum()


def test_certify_hits_and_band_probes_match_jax(decoders):
    """Certification of seeds jittered off the sphere (some outside the
    +-delta window: demoted) and band probes of near-miss rays anchored at
    their closest approach, on a bucket that holds every candidate."""
    s = _cert_scene(decoders, eye=-2.0)
    rng = np.random.default_rng(7)
    o, v = s["o"], s["v"]
    b_ = np.sum(o * v, axis=-1)
    miss_by = np.sqrt(np.maximum(np.sum(o * o, -1) - b_ * b_, 0.0)) - 0.5
    seeded = np.repeat(s["hit_geo"][None], F, 0)
    depth = (np.repeat(s["d_geo"][None], F, 0)
             + 0.01 * rng.standard_normal((F, N))).astype(np.float32)
    band = np.repeat(((miss_by > -0.01) & (miss_by < 0.03) & ~s["hit_geo"])[None], F, 0)
    anchor = np.repeat((-b_)[None], F, 0).astype(np.float32)
    j, t = _certify_both(s, seeded, depth, band, anchor, delta=0.015,
                         promote_eps=0.005)
    cand = seeded | band
    assert not j["overflow"].any()
    _assert_cert_parity(j, t, cand)
    assert (~t["certified"] & seeded).any()  # demotions happen
    probed = j["promoted"] | np.isfinite(j["band_margin"])
    assert np.array_equal(probed, band)
    agree = band & (j["promoted"] == t["promoted"])
    assert t["promoted"].any() and (~t["promoted"] & band).any()
    for k in ("band_margin", "band_tmin"):
        _assert_k5_bars(t[k][agree], j[k][agree])


@pytest.mark.parametrize("mode", [("cert", "march"), ("cert", "probe"),
                                  ("march", "probe")])
def test_render_batched_c2f_cert_matches_jax(decoders, mode):
    """verify_mode="cert", verify_band="probe" and the hybrid (march +
    probe) through both packages' render_batched_c2f, F=2, 32x32."""
    params, z0, dkw, proxy, pkw = decoders
    lat, ob, vb = _frames(z0, IMG)
    vm, vband = mode
    flags = dict(strides=(4,), shared_origin=True, return_anchor=True,
                 return_steps=True, return_last=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jproxy = (jax.tree_util.tree_map(jnp.asarray, proxy), JDecoderConfig(**pkw))
    ref = jax.jit(lambda: jbm.render_batched_c2f(
        jp, JDecoderConfig(**dkw), jnp.asarray(lat), jnp.asarray(ob),
        jnp.asarray(vb), (IMG, IMG), JMarchConfig(**MARCH_KW), proxy=jproxy,
        verify_mode=vm, verify_band=vband, verify_round_caps=(2, 4, 12),
        interpret=True, **flags))()
    ref = [np.asarray(a) for a in ref]
    seen = []
    real = cert.certify_hits_batched
    try:
        cert.certify_hits_batched = lambda *a, **k: seen.append(real(*a, **k)) or seen[-1]
        out = _render_port(decoders, T(lat), T(ob), T(vb), verify_mode=vm,
                           verify_band=vband, **flags)
    finally:
        cert.certify_hits_batched = real
    assert len(seen) == 1
    if vm == "cert":
        assert seen[0].certified.sum() > 100
    if vband == "probe":
        assert torch.isfinite(seen[0].band_margin).sum() > 10
    _assert_trace_parity(ref[0], ref[1], ref[2], out.depth.numpy(), out.hit.numpy(),
                         out.min_sdf.numpy())
    assert np.mean(np.abs(ref[3] - out.depth_at_min.numpy()) < 1e-3) >= 0.98
    assert np.mean(ref[4] == out.steps.numpy()) >= 0.98
    fin = np.isfinite(ref[5])
    assert np.mean(np.abs(ref[5] - out.last_sdf.numpy())[fin] < 1e-3) >= 0.98
    assert np.mean(ref[6] == out.unresolved.numpy()) >= 0.99
    assert out.steps.dtype == torch.int32


def _render_port(decoders, lat, ob, vb, **kw):
    params, _, dkw, proxy, pkw = decoders
    kw = {"verify_round_caps": (2, 4, 12), **kw}
    return bm.render_batched_c2f(
        params_from_numpy(params), DecoderConfig(**dkw), lat, ob, vb, (IMG, IMG),
        MarchConfig(**MARCH_KW), proxy=(params_from_numpy(proxy), DecoderConfig(**pkw)),
        **kw)


@pytest.fixture(scope="module")
def port_modes(decoders):
    """The port's render_batched_c2f of tests/test_proxy.py's scene (the
    sphere's latent twice, the camera at z=-2, focal 40) in each verify
    treatment, with cert's results as they left certify_hits_batched."""
    _, z0, _, _, _ = decoders
    cam = jcam.Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    o, v = (np.asarray(a) for a in jcam.pixel_rays(cam, IMG, IMG))
    lat = T(np.stack([z0, z0]).astype(np.float32))
    ob, vb = (T(np.broadcast_to(a[None], (F, N, 3)).copy()) for a in (o, v))
    kw = dict(strides=(4,), shared_origin=True, return_anchor=True)
    seen, real = [], cert.certify_hits_batched
    cert.certify_hits_batched = lambda *a, **k: seen.append((a, k, real(*a, **k))) or seen[-1][2]
    try:
        out = {m: _render_port(decoders, lat, ob, vb, **mk, **kw) for m, mk in (
            ("march", {}), ("cert", dict(verify_mode="cert")),
            ("demote", dict(verify_mode="cert", proxy_backoff=2e-4)),
            ("hybrid", dict(verify_band="probe")))}
    finally:
        cert.certify_hits_batched = real
    return out, seen


def test_cert_and_hybrid_contracts(port_modes):
    """tests/test_proxy.py's contracts on the port: cert and march-verify
    hits agree on > 99% of rays; with proxy_backoff 2e-4 (far below the
    proxy's error) demotion fires and the hits still agree on > 98.5%; the
    hybrid's hit depths are march-verify's (the same seeded march: median
    < 1e-5, p99 < 5e-3)."""
    out, seen = port_modes
    m, c, d, h = (out[k] for k in ("march", "cert", "demote", "hybrid"))
    assert (m.hit == c.hit).float().mean() > 0.99
    a, k, res = seen[1]   # the demote run's certification
    seeded = a[5]
    demoted = seeded & ~res.certified & ~res.overflow
    assert int(demoted.sum()) > 0
    assert (d.hit == m.hit).float().mean() > 0.985
    assert (h.hit == m.hit).float().mean() > 0.985
    both = h.hit & m.hit
    dd = (h.depth - m.depth).abs()[both]
    assert dd.median() < 1e-5 and dd.quantile(0.99) < 5e-3
    # the hybrid certified nothing and probed band rays
    a, k, res = seen[2]
    assert not res.certified.any() and torch.isfinite(res.band_margin).sum() > 0


def test_render_with_cert_verify(decoders):
    """One render() request with proxy_verify_mode="cert", and one with the
    hybrid, through trace_frame and compose(): finite; the march-verify
    render's hits on >= 99% of rays; and no less accurate than it
    (tests/test_proxy.py's bars): the full decoder's |f| at the hit depths
    at the median within 1.3x + 1e-4 of march-verify's, at p95 within 1.3x
    + 2e-4. (A certified hit's depth, the secant point, and a march's stop
    lie anywhere in the convergence ball, eps 2e-3, so the two depths are
    not held to each other.)"""
    from dist_renderer_tpu_torch.models.decoder import decoder_apply
    from dist_renderer_tpu_torch.ops.camera import pixel_rays

    params, z0, dkw, proxy, pkw = decoders
    tp, tpp = params_from_numpy(params), params_from_numpy(proxy)
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    o, v = pixel_rays(cam, IMG, IMG)

    def run(**mk):
        cfg = RenderConfig(img_h=IMG, img_w=IMG,
                           march=MarchConfig(**MARCH_KW, coarse_to_fine=True, **mk),
                           grad=GradConfig(mode="ift"), use_pallas=True)
        out = render(make_precise_sdf(tp, DecoderConfig(**dkw)), T(z0), cam, cfg,
                     make_march_factory(tp, DecoderConfig(**dkw), cfg, march_params=tpp,
                                        march_dcfg=DecoderConfig(**pkw)))
        m = out.mask.reshape(-1)
        f = decoder_apply(tp, T(z0), o[m] + out.depth.reshape(-1)[m, None] * v[m],
                          DecoderConfig(**dkw)).abs()
        return out, f.median().item(), f.quantile(0.95).item()

    ref, med_m, p95_m = run()
    for mk in (dict(proxy_verify_mode="cert"), dict(proxy_verify_band="probe")):
        out, med, p95 = run(**mk)
        assert all(torch.isfinite(getattr(out, k)).all() for k in ("depth", "normal", "min_sdf"))
        assert out.mask.float().mean() > 0.05
        assert (out.mask == ref.mask).float().mean() >= 0.99
        assert med <= 1.3 * med_m + 1e-4 and p95 <= 1.3 * p95_m + 2e-4, (mk, med, p95)
