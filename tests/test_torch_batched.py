"""The multi-frame render path of the port against the JAX package's, on
the CPU: the rounds scheduler (``fine_march_rounds``),
``render_depth_batched`` (K1-multi's plain version),
``decoder_apply_with_dd``, ``finalize_hits_batched``, the rounds default
of ``render_batched_c2f`` and ``trace_frame``'s verify round caps. The
JAX side runs its kernels in interpret mode.

Scene: tests/test_round_budget.py's (a 4x32 decoder fitted to a torus,
two frames of 32x32, a deliberately tight 24-step budget). Against JAX
the bars are tests/test_torch_queue.py's: the two packages' CPU BLAS
libraries sum the products in different orders, so a ray near a stopping
rule may stop one sample apart (hits agree on >= 99% of rays, depth on
common hits within 1e-5 at the median and 1e-3 on >= 98%). On the port
itself, with the plain version's product summed in k order (the
kernels' order, ``k_order``), a row sum cannot depend on how many rays
share a launch, and the rounds' results are exact functions of each
ray's (seed, class, caps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import MarchConfig as JMarchConfig
from dist_renderer_tpu.models import decoder as jdecoder
from dist_renderer_tpu.models.analytic import sphere_sdf, torus_sdf
from dist_renderer_tpu.models.pretrain import fit_decoder_to_sdf
from dist_renderer_tpu.ops import camera as jcam
from dist_renderer_tpu.ops.pallas import batched_march as jbm
from dist_renderer_tpu.ops.renderer import finalize_hits_batched as jfinalize
from dist_renderer_tpu_torch.config import (
    DecoderConfig, GradConfig, MarchConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.decoder import (
    decoder_apply, decoder_apply_with_dd, params_from_numpy,
)
from dist_renderer_tpu_torch.ops import c2f as tc2f
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.kernels import batched_march as tbm
from dist_renderer_tpu_torch.ops.kernels import march_body
from dist_renderer_tpu_torch.ops.renderer import (
    finalize_hits_batched, make_march_factory,
)
from test_torch_cuda import _dot_k_order
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

IMG = 32
N = IMG * IMG
F = 2
DEC_KW = dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))
MARCH_KW = dict(max_steps=24, convergence_eps=2e-3, depth_eps=5e-4)


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """tests/test_round_budget.py's plan: a rough torus decoder, two
    jittered latents, the c2f classification of a 4-stride level."""
    params, z0 = fit_decoder_to_sdf(lambda p: torus_sdf(0.55, 0.2)(None, p),
                                    JDecoderConfig(**DEC_KW), steps=150, batch=512)
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(3)
    lat = (np.stack([np.asarray(z0)] * F)
           + 0.02 * rng.standard_normal((F, DEC_KW["latent_size"]))).astype(np.float32)
    cam = jcam.Camera.looking_at((0.0, 0.0, -2.0), focal=IMG * 1.2, img_hw=(IMG, IMG))
    o, v = jcam.pixel_rays(cam, IMG, IMG)
    ob = np.broadcast_to(np.asarray(o)[None], (F, N, 3)).copy()
    vb = np.broadcast_to(np.asarray(v)[None], (F, N, 3)).copy()
    tp, td = params_from_numpy(params), DecoderConfig(**DEC_KW)
    shared = tbm.pack_shared(tp, td)
    bank = tbm.fold_bias_bank(tp, T(lat), td, shared)
    coarse = MarchConfig(**{**MARCH_KW, "max_steps": 12})
    maps = tc2f.classify_pyramid(
        lambda ol, vl, seed, act, stride: tbm.batched_trace_padded(
            shared, bank, ol, vl, coarse, seed, act),
        T(ob).reshape(F, IMG, IMG, 3), T(vb).reshape(F, IMG, IMG, 3), (4,), 0.05)
    key, idep, _ = tc2f.plan_from_maps(maps)
    return dict(params=params, lat=lat, ob=ob, vb=vb, shared=shared, bank=bank,
                key=key, idep=idep, march=MarchConfig(**MARCH_KW))


def _rounds(s, o=None, v=None, key=None, idep=None, **kw):
    return tbm.fine_march_rounds(
        s["shared"], s["bank"], T(s["ob"]) if o is None else o,
        T(s["vb"]) if v is None else v, s["key"] if key is None else key,
        s["idep"] if idep is None else idep, s["march"], **kw)


def _assert_trace_parity(jd, jh, jmsdf, td, th, tmsdf, act=None):
    """tests/test_torch_queue.py's bars against the JAX package."""
    jd, jh, jmsdf = (np.asarray(a) for a in (jd, jh, jmsdf))
    assert (jh == th).mean() >= 0.99
    both = jh & th
    assert both.sum() > 50
    derr = np.abs(jd - td)[both]
    assert np.median(derr) < 1e-5 and np.mean(derr < 1e-3) >= 0.98
    sel = np.ones_like(jh) if act is None else act
    assert np.mean(np.abs(jmsdf - tmsdf)[sel] < 1e-3) >= 0.98


def test_fine_march_rounds_matches_jax(scene):
    s = scene
    jp = jax.tree_util.tree_map(jnp.asarray, s["params"])
    jd = JDecoderConfig(**DEC_KW)
    shared = jbm.pack_shared(jp, jd)
    bank = jbm.fold_bias_bank(jp, jnp.asarray(s["lat"]), jd, shared)
    ref = jax.jit(lambda: jbm.fine_march_rounds(
        shared, bank, jnp.asarray(s["ob"]), jnp.asarray(s["vb"]),
        jnp.asarray(s["key"].numpy()), jnp.asarray(s["idep"].numpy()),
        JMarchConfig(**MARCH_KW), block=512, round_caps=(4, 12), interpret=True,
        live_frac=3, return_anchor=True, return_steps=True, return_last=True))()
    out = _rounds(s, live_frac=3, return_anchor=True, return_steps=True,
                  return_last=True)
    # the scene overflows the prefix: every round guard is exercised
    assert int((s["key"] != 2).sum(dim=1).max()) > 512
    _assert_trace_parity(ref[0], ref[1], ref[2], out.depth.numpy(),
                         out.hit.numpy(), out.min_sdf.numpy())
    jdam, jstp, jlsdf, junres = (np.asarray(a) for a in ref[3:])
    assert np.mean(np.abs(jdam - out.depth_at_min.numpy()) < 1e-3) >= 0.98
    assert np.mean(jstp == out.steps.numpy()) >= 0.99
    fin = np.isfinite(jlsdf)
    assert np.array_equal(fin, np.isfinite(out.last_sdf.numpy()))
    assert np.mean(np.abs(jlsdf - out.last_sdf.numpy())[fin] < 1e-3) >= 0.98
    assert np.mean(junres == out.unresolved.numpy()) >= 0.99
    assert out.steps.dtype == torch.int32 and out.hit.dtype == torch.bool


LAYOUTS = ["bands", "live_frac", "difficulty_repack", "flags", "shared_origin"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rounds_results_are_layout_independent(scene, layout, monkeypatch):
    """tests/test_round_budget.py's invariant on the port: the same rays
    give the same bits whatever shares their launch (a band of the frame
    or all of it, live_frac 1 or 3, a difficulty re-pack or none, shared
    or per-ray origins), and the return flags only select outputs."""
    monkeypatch.setattr(march_body, "dot_f32", _dot_k_order)
    s = scene
    flags = dict(return_anchor=True, return_steps=True, return_last=True)
    full = _rounds(s, live_frac=3, **flags)
    fields = ("depth", "hit", "min_sdf", "depth_at_min", "steps", "last_sdf",
              "unresolved")
    same = lambda a, b, sl=slice(None): all(
        torch.equal(getattr(a, k)[:, sl], getattr(b, k)) for k in fields)
    if layout == "bands":
        rows = 8
        for b in range(IMG // rows):
            sl = slice(b * rows * IMG, (b + 1) * rows * IMG)
            band = _rounds(s, T(s["ob"][:, sl]), T(s["vb"][:, sl]), s["key"][:, sl],
                           s["idep"][:, sl], live_frac=2, **flags)
            assert same(full, band, sl), f"band {b}"
    elif layout == "live_frac":
        assert same(full, _rounds(s, live_frac=1, **flags))
    elif layout == "difficulty_repack":
        assert same(full, _rounds(s, live_frac=3, difficulty_repack=True, **flags))
    elif layout == "shared_origin":
        assert same(full, _rounds(s, T(s["ob"][:, :1]), live_frac=3, **flags))
    else:
        for kw in (dict(), dict(return_unres=True), dict(return_anchor=True),
                   dict(return_steps=True), dict(return_last=True)):
            out = _rounds(s, live_frac=3, **kw)
            for k in fields:
                got = getattr(out, k)
                wanted = (k in ("depth", "hit", "min_sdf")
                          or (k == "depth_at_min" and kw.get("return_anchor"))
                          or (k == "steps" and kw.get("return_steps"))
                          or (k == "last_sdf" and kw.get("return_last"))
                          or (k == "unresolved" and (kw.get("return_last")
                                                     or kw.get("return_unres"))))
                assert (got is not None) == bool(wanted), (kw, k)
                if got is not None:
                    assert torch.equal(got, getattr(full, k)), (kw, k)
    diag = {}
    _rounds(s, live_frac=3, diag=diag)
    assert sorted(diag) == ["fine_r0_block_residency", "fine_r1_block_residency",
                            "fine_r2_block_residency"]


def test_render_depth_batched_matches_jax(scene):
    s = scene
    jp = jax.tree_util.tree_map(jnp.asarray, s["params"])
    jd, jh = jax.jit(lambda: jbm.render_depth_batched(
        jp, JDecoderConfig(**DEC_KW), jnp.asarray(s["lat"]), jnp.asarray(s["ob"]),
        jnp.asarray(s["vb"]), JMarchConfig(**MARCH_KW), interpret=True))()
    tp = params_from_numpy(s["params"])
    n0 = tbm.sphere_trace_batched.launches
    d, h = tbm.render_depth_batched(tp, DecoderConfig(**DEC_KW), T(s["lat"]),
                                    T(s["ob"]), T(s["vb"]), s["march"])
    assert d.shape == h.shape == (F, N) and tbm.sphere_trace_batched.launches == n0
    jd, jh = np.asarray(jd), np.asarray(jh)
    assert (jh == h.numpy()).mean() >= 0.99 and jh.sum() > 100
    derr = np.abs(jd - d.numpy())[jh & h.numpy()]
    assert np.median(derr) < 1e-5 and np.mean(derr < 1e-3) >= 0.98
    # K1-multi's plain version is K1's: the same bits as a K1 march
    ref = tbm.batched_trace_padded(s["shared"], s["bank"], T(s["ob"]), T(s["vb"]),
                                   s["march"], None, torch.ones(F, N, dtype=torch.bool))
    assert torch.equal(d, ref.depth) and torch.equal(h, ref.hit)


DD_ARCHS = [
    dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,)),
    dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,), xyz_in_all=True),
    dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,), use_tanh=True),
]


@pytest.mark.parametrize("arch", range(len(DD_ARCHS)))
def test_decoder_apply_with_dd_matches_jax(arch):
    """Both packages take the same roundings (a bf16x3 split on the input
    layers, one bf16-rounded product on the hidden ones, a bf16-rounded
    tangent, fp32 sums), so the port equals JAX's decoder_apply_with_dd
    up to the order of its fp32 sums: measured on these random decoders,
    the value within 1.2e-7 on all but one point of the third (1.4e-4: a
    sum that rounds to the other bf16 neighbour), the derivative within
    relative L2 2.1e-5; bars 1e-6 on >= 99% of points, max 1e-3, and
    1e-4. The roundings' gap from the fp32 value and its jax.jvp stays
    what JAX's has: measured relative L2 4.8e-2 / 9.5e-2 / 5.8e-2 in dd
    and max 6.8e-3 / 1.1e-2 / 3.4e-3 in the value; bars 0.15 and 2e-2."""
    cfg = DD_ARCHS[arch]
    rng = np.random.default_rng(10 + arch)
    jcfg = JDecoderConfig(**cfg)
    params = {"layers": [
        {"w": (rng.standard_normal((i, o)) * np.sqrt(2.0 / i)).astype(np.float32),
         "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
        for i, o in jcfg.layer_dims]}
    z = (0.3 * rng.standard_normal(8)).astype(np.float32)
    pts = (0.6 * rng.standard_normal((400, 3))).astype(np.float32)
    v = rng.standard_normal((400, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    tp, tcfg = params_from_numpy(params), DecoderConfig(**cfg)
    s, dd = (a.numpy() for a in decoder_apply_with_dd(tp, T(z), T(pts), T(v), tcfg))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js16, jdd16 = (np.asarray(a) for a in jdecoder.decoder_apply_with_dd(
        jp, jnp.asarray(z), jnp.asarray(pts), jnp.asarray(v), jcfg))
    assert np.mean(np.abs(s - js16) <= 1e-6) >= 0.99 and np.abs(s - js16).max() <= 1e-3
    assert np.linalg.norm(dd - jdd16) <= 1e-4 * np.linalg.norm(jdd16)
    fv = lambda p: jdecoder.decoder_apply(jp, jnp.asarray(z), p, jcfg)
    js, jdd = (np.asarray(a) for a in jax.jvp(fv, (jnp.asarray(pts),), (jnp.asarray(v),)))
    assert np.linalg.norm(dd - jdd) <= 0.15 * np.linalg.norm(jdd)
    assert np.abs(s - js).max() <= 2e-2
    s32 = decoder_apply(tp, T(z), T(pts), tcfg).numpy()
    np.testing.assert_allclose(s32, js, atol=1e-6)


# ---- finalize_hits_batched --------------------------------------------------

@pytest.fixture(scope="module")
def sphere():
    """A 4x48 decoder fitted to a sphere of radius 0.5."""
    dcfg = dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,))
    params, z0 = fit_decoder_to_sdf(lambda p: sphere_sdf(0.5)(None, p),
                                    JDecoderConfig(**dcfg), steps=400, batch=2048)
    return jax.tree_util.tree_map(np.array, params), np.array(z0), dcfg


def _numpy_trace(seed=0):
    """A trace as render_batched_c2f(verify_hits="polish-all") would leave
    it, from numpy: frames of the sphere's rays with hit depths off the
    analytic surface by ~3e-3, false hits among near misses (seeded at
    the closest approach), weak candidates, and margins."""
    rng = np.random.default_rng(seed)
    cam = jcam.Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    o, v = (np.asarray(a) for a in jcam.pixel_rays(cam, IMG, IMG))
    b = np.sum(o * v, -1)
    c = np.sum(o * o, -1) - 0.25
    disc = b * b - c
    t_close = -b
    miss_by = np.sqrt(np.maximum(c - b * b + 0.25, 0.0)) - 0.5  # closest approach - r
    d, h, m, w = [], [], [], []
    for _ in range(F):
        true_hit = disc > 0
        depth = np.where(true_hit, -b - np.sqrt(np.maximum(disc, 0.0)), t_close)
        depth = depth + 3e-3 * rng.standard_normal(N)
        near = ~true_hit & (miss_by < 0.05)
        false_hit = near & (rng.random(N) < 0.3)
        weak = near & ~false_hit & (rng.random(N) < 0.3)
        hit = true_hit | false_hit | weak
        # false hits sit before their closest approach, where the field
        # still falls along the ray: the polish walks them and demotes
        depth = np.where(false_hit, depth - 0.1, depth)
        msdf = np.where(hit, 1e-3 * rng.standard_normal(N), miss_by + 0.01 * rng.random(N))
        d.append(depth), h.append(hit), m.append(msdf), w.append(weak)
    f32 = lambda x: np.stack(x).astype(np.float32)
    return (np.broadcast_to(o, (F, N, 3)).copy(), np.broadcast_to(v, (F, N, 3)).copy(),
            f32(d), np.stack(h), f32(m), np.stack(w))


def _finalize_both(sphere, trace, compact_frac):
    params, z0, dcfg = sphere
    o, v, d, h, m, w = trace
    lat = np.stack([z0, z0 + 0.01]).astype(np.float32)
    kw = dict(convergence_eps=2e-3, polish_iters=4, compact_frac=compact_frac)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jfinalize(jp, JDecoderConfig(**dcfg), jnp.asarray(lat), jnp.asarray(o),
                    jnp.asarray(v), jnp.asarray(d), jnp.asarray(h), jnp.asarray(m),
                    weak=jnp.asarray(w), **kw)
    out = finalize_hits_batched(params_from_numpy(params), DecoderConfig(**dcfg),
                                T(lat), T(o), T(v), T(d), T(h), T(m), weak=T(w), **kw)
    return [np.asarray(a) for a in ref], [a.numpy() for a in out]


@pytest.mark.parametrize("branch", ["bucketed", "full"])
def test_finalize_hits_batched_matches_jax(sphere, branch):
    """One numpy-fed trace through both packages' finalize, each with its
    own decoder_apply_with_dd (the same roundings). compact_frac 2 takes
    the hit-first bucket (every frame's hits fit N/2), N the full width.
    Compared on
    every ray, but where JAX's bucketed branch is at fault (ROADMAP C):
    the depth of rays that were not hits (it resets them to the
    background) and the margins of the misses that pad the bucket (it
    writes their polished value); the port keeps both from the trace.
    Depth and margin agree within 2e-5 on >= 99.5% of those rays and
    within 1e-3 on all: where the two BLAS orders round a sum to the other
    bf16 neighbour, a ray moves by ~1e-4 (read: 2 of 749 hits, 1.3e-4)."""
    trace = _numpy_trace()
    _, _, d_in, h_in, m_in, w_in = trace
    assert h_in.sum(axis=1).max() <= N // 2
    (jd, jh, jm), (td, th, tm) = _finalize_both(
        sphere, trace, 2 if branch == "bucketed" else N)
    demoted = h_in & ~th
    assert (h_in & ~w_in & ~th).any() and (w_in & ~th).any() and (w_in & th).any()
    assert np.mean(jh == th) >= 0.998
    same_d, same_m = np.ones_like(h_in), np.ones_like(h_in)
    if branch == "bucketed":
        same_d = h_in
        pad = np.zeros_like(h_in)
        for i in range(F):  # the bucket: hits first, then misses in pixel order
            pad[i, np.argsort(~h_in[i], kind="stable")[:N // 2]] = True
        same_m = h_in | ~pad
        assert not np.allclose(jd[~h_in], d_in[~h_in])   # JAX's fault shows
    for t, j, same in ((td, jd, same_d), (tm, jm, same_m)):
        gap = np.abs(t - j)[same & (jh == th)]
        assert np.mean(gap <= 2e-5) >= 0.995 and gap.max() <= 1e-3, np.sort(gap)[-5:]
    # the port's rays that are not hits keep the trace's depth and margin
    np.testing.assert_array_equal(td[~h_in], d_in[~h_in])
    np.testing.assert_array_equal(tm[~h_in], m_in[~h_in])
    assert np.all(td[demoted] == 10.0)


def test_finalize_bucketed_equals_full_width(sphere):
    """The port's bucket is only a width: it gives what the full width
    gives on every ray. The JAX package's bucketed branch does not (the
    transcription this test would catch)."""
    trace = _numpy_trace(seed=1)
    (jb, _, _), (tb, tbh, tbm_) = _finalize_both(sphere, trace, 2)
    (jf, _, _), (tf, tfh, tfm) = _finalize_both(sphere, trace, N)
    np.testing.assert_array_equal(tbh, tfh)
    np.testing.assert_allclose(tb, tf, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tbm_, tfm, atol=1e-6, rtol=0)
    h_in = trace[3]
    assert np.abs(jb - jf)[~h_in].max() > 0.1


# ---- the repaired defaults --------------------------------------------------

def _c2f(s, f, **kw):
    tp = params_from_numpy(s["params"])
    return tbm.render_batched_c2f(
        tp, DecoderConfig(**DEC_KW), T(s["lat"][:f]), T(s["ob"][:f, :1]),
        T(s["vb"][:f]), (IMG, IMG), s["march"], strides=(4,), coarse_steps=12,
        return_anchor=True, return_steps=True, return_last=True, **kw)


def test_render_batched_c2f_defaults_to_rounds_like_jax(scene):
    """A direct call at F=1 marches the rounds scheduler, as the JAX
    package's default does (the port defaulted to "auto", the queue at
    F=1); the two schedulers give different step counts here."""
    s = scene
    default = _c2f(s, 1)
    rounds, queue = _c2f(s, 1, scheduler="rounds"), _c2f(s, 1, scheduler="queue")
    for k in ("depth", "hit", "min_sdf", "depth_at_min", "steps", "last_sdf",
              "unresolved"):
        assert torch.equal(getattr(default, k), getattr(rounds, k)), k
    assert not torch.equal(default.steps, queue.steps)
    jp = jax.tree_util.tree_map(jnp.asarray, s["params"])
    ref = jax.jit(lambda: jbm.render_batched_c2f(
        jp, JDecoderConfig(**DEC_KW), jnp.asarray(s["lat"][:1]),
        jnp.asarray(s["ob"][:1]), jnp.asarray(s["vb"][:1]), (IMG, IMG),
        JMarchConfig(**MARCH_KW), strides=(4,), coarse_steps=12,
        shared_origin=True, return_steps=True, interpret=True))()
    _assert_trace_parity(ref[0], ref[1], ref[2], default.depth.numpy(),
                         default.hit.numpy(), default.min_sdf.numpy())
    assert np.mean(np.asarray(ref[3]) == default.steps.numpy()) >= 0.99


def test_trace_frame_passes_the_verify_round_caps(scene):
    """trace_frame hands MarchConfig.proxy_verify_caps to the verify
    stage's rounds, as the JAX package's does: other caps, other step
    counts, and the same trace as a direct call with those caps."""
    s = scene
    tp, td = params_from_numpy(s["params"]), DecoderConfig(**DEC_KW)
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=IMG * 1.2, img_hw=(IMG, IMG))
    o, v = pixel_rays(cam, IMG, IMG)
    steps = []
    for caps in ((2, 4, 12), (1, 1, 1)):
        march = MarchConfig(**MARCH_KW, coarse_to_fine=True, c2f_strides=(4,),
                            c2f_coarse_steps=12, scheduler="rounds",
                            proxy_verify_caps=caps)
        cfg = RenderConfig(img_h=IMG, img_w=IMG, march=march, use_pallas=True)
        z = T(s["lat"][0])
        # the decoder is its own proxy: the verify stage re-marches it
        tr = make_march_factory(tp, td, cfg, march_params=tp)(z).trace_frame(
            o, v, march, (IMG, IMG))
        ref = tbm.render_batched_c2f(
            tp, td, z[None], o[None, :1], v[None], (IMG, IMG), march,
            strides=(4,), coarse_steps=12, shared_origin=True, return_anchor=True,
            return_steps=True, return_last=True, scheduler="rounds",
            proxy=(tp, td), proxy_backoff=march.proxy_backoff,
            proxy_band=march.proxy_band, verify_round_caps=caps)
        assert torch.equal(tr.depth, ref.depth[0]) and torch.equal(tr.hit, ref.hit[0])
        assert torch.equal(tr.steps_per_ray, ref.steps[0])
        steps.append(tr.steps_per_ray)
    assert not torch.equal(*steps)


def test_verify_mode_and_hits_validation(scene):
    s = scene
    for kw, match in ((dict(verify_mode="certs"), "verify_mode"),
                      (dict(verify_band="probes"), "verify_band"),
                      (dict(verify_hits="polished"), "verify_hits"),
                      (dict(verify_hits="polish", verify_mode="cert"), "verify_hits"),
                      (dict(scheduler="fifo"), "scheduler")):
        with pytest.raises(ValueError, match=match):
            _c2f(s, 1, **kw)
