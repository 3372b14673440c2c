"""K1's plain version (the port's persistent march) against the JAX
package's ``pallas_sphere_trace_persistent`` in interpret mode, plus the
camera and telemetry helpers the march reads.

Scene: the tests/test_queue_march.py decoder (a 4x32 DeepSDF fitted to a
torus) with a coarse-to-fine plan (seeds and inactive rays) at 32x32, F=2.

Tolerance: the two packages multiply the same bf16-rounded operands in
fp32 but their CPU BLAS libraries sum in different orders, so SDF samples
differ in the last bits; a march that converges at |f| < eps (2e-3) can
then stop one secant step apart. Hit masks agree on >= 99% of rays, and
depths on common hits agree closely except at such stops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import MarchConfig as JMarchConfig
from dist_renderer_tpu.models.analytic import torus_sdf
from dist_renderer_tpu.models.pretrain import fit_decoder_to_sdf
from dist_renderer_tpu.ops import camera as jcam
from dist_renderer_tpu.ops import tracer as jtracer
from dist_renderer_tpu.ops.pallas import batched_march as jbm
from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.ops import c2f as tc2f
from dist_renderer_tpu_torch.ops import camera as tcam
from dist_renderer_tpu_torch.ops import tracer as ttracer
from dist_renderer_tpu_torch.ops.kernels import batched_march as tbm

IMG = 32
F = 2
MARCH_KW = dict(max_steps=32, convergence_eps=2e-3, depth_eps=5e-4)
DEC_KW = dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    dcfg = JDecoderConfig(**DEC_KW)
    params, z0 = fit_decoder_to_sdf(
        lambda p: torus_sdf(0.55, 0.2)(None, p), dcfg, steps=200, batch=512)
    rng = np.random.default_rng(3)
    lat = np.stack([np.asarray(z0)] * F) + 0.02 * rng.standard_normal(
        (F, dcfg.latent_size)).astype(np.float32)
    cam = jcam.Camera.looking_at((0.0, 0.0, -2.0), focal=IMG * 1.2,
                                 img_hw=(IMG, IMG))
    o, v = jcam.pixel_rays(cam, IMG, IMG)
    ob = jnp.broadcast_to(o[None], (F,) + o.shape)
    vb = jnp.broadcast_to(v[None], (F,) + v.shape)
    shared = jbm.pack_shared(params, dcfg)
    bank = jbm.fold_bias_bank(params, jnp.asarray(lat), dcfg, shared)
    tp = params_from_numpy(params)
    tshared = tbm.pack_shared(tp, DecoderConfig(**DEC_KW))
    tbank = tbm.fold_bias_bank(tp, T(lat), DecoderConfig(**DEC_KW), tshared)
    # the coarse-to-fine plan (seeds, inactive rays) from the port's plain
    # pyramid; both packages then march the same numpy inputs
    coarse = MarchConfig(**{**MARCH_KW, "max_steps": 12})
    maps = tc2f.classify_pyramid(
        lambda ol, vl, seed, act, stride: tbm.batched_trace_padded(
            tshared, tbank, ol, vl, coarse, seed, act),
        T(ob).reshape(F, IMG, IMG, 3), T(vb).reshape(F, IMG, IMG, 3), (4,), 0.05)
    key, idep, _ = tc2f.plan_from_maps(maps)
    key, idep = key.numpy(), idep.numpy()
    return dict(shared=shared, bank=bank, o=ob.reshape(-1, 3),
                v=vb.reshape(-1, 3), key=key.reshape(-1), idep=idep.reshape(-1),
                tshared=tshared, tbank=tbank)


CASES = {
    "seeded+inactive": dict(seeded=True, salvage=True),
    "seeded+inactive, no salvage": dict(seeded=True, salvage=False),
    "fresh, all active": dict(seeded=False, salvage=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k1_matches_pallas_persistent(scene, case):
    c = CASES[case]
    s = scene
    frame = jnp.repeat(jnp.arange(F, dtype=jnp.int32), IMG * IMG)
    init = jnp.asarray(s["idep"]) if c["seeded"] else None
    act = jnp.asarray(s["key"] != 2) if c["seeded"] else None
    ref = jax.jit(lambda: jbm.pallas_sphere_trace_persistent(
        s["shared"], s["bank"], frame, s["o"], s["v"], JMarchConfig(**MARCH_KW),
        init, act, block=512, interpret=True, salvage=c["salvage"]))()
    out = tbm.sphere_trace_persistent(
        s["tshared"], s["tbank"], T(frame), T(s["o"]), T(s["v"]),
        MarchConfig(**MARCH_KW), None if init is None else T(init),
        None if act is None else T(act), salvage=c["salvage"],
        rays_per_frame=IMG * IMG)

    jh, th = np.asarray(ref.hit), out.hit.numpy()
    assert jh.sum() > 300                       # the scene is visible
    assert (jh == th).mean() >= 0.99
    both = jh & th
    derr = np.abs(np.asarray(ref.depth) - out.depth.numpy())[both]
    assert np.median(derr) < 1e-5
    assert np.mean(derr < 1e-3) >= 0.98
    if act is not None:
        # inactive rays keep the init rows and the geometric margin
        dead = ~np.asarray(act)
        np.testing.assert_array_equal(out.steps_per_ray.numpy()[dead], 0)
        np.testing.assert_allclose(out.min_sdf.numpy()[dead],
                                   np.asarray(ref.min_sdf)[dead], atol=1e-6)
        np.testing.assert_allclose(out.depth.numpy()[dead],
                                   np.asarray(ref.depth)[dead], atol=1e-6)
    same = (jh == th) & (np.asarray(ref.unresolved) == out.unresolved.numpy())
    assert same.mean() >= 0.99
    steps_diff = np.abs(np.asarray(ref.steps_per_ray) - out.steps_per_ray.numpy())
    assert np.mean(steps_diff == 0) >= 0.95
    assert out.live_counts.shape == (MARCH_KW["max_steps"],)


def test_no_salvage_leaves_bracketed_rays_unresolved(scene):
    """salvage=False (a step-capped round): bracketed rays at the cap stay
    unresolved instead of taking the midpoint."""
    s = scene
    frame = torch.arange(F).repeat_interleave(IMG * IMG)
    n_salvaged = 0
    for cap in range(2, 9):
        # tight tolerances: a bracketed ray needs several secant steps
        m = MarchConfig(max_steps=cap, convergence_eps=1e-6, depth_eps=1e-7)
        a, b = [tbm.sphere_trace_persistent(
            s["tshared"], s["tbank"], frame, T(s["o"]), T(s["v"]), m,
            salvage=sv, rays_per_frame=IMG * IMG) for sv in (True, False)]
        salvaged = a.hit & ~b.hit
        n_salvaged += int(salvaged.sum())
        assert (b.unresolved[salvaged] & b.bracketed[salvaged]).all()
        assert not (b.hit & ~a.hit).any()
    assert n_salvaged > 0


def test_batched_trace_padded_pads_to_tile(scene):
    s = scene
    o = T(s["o"]).reshape(F, IMG * IMG, 3)[:, :1000]
    v = T(s["v"]).reshape(F, IMG * IMG, 3)[:, :1000]
    seed = T(s["idep"]).reshape(F, -1)[:, :1000]
    act = (T(s["key"]) != 2).reshape(F, -1)[:, :1000]
    res = tbm.batched_trace_padded(s["tshared"], s["tbank"], o, v,
                                   MarchConfig(**MARCH_KW), seed, act)
    assert res.depth.shape == (F, 1000)
    assert res.steps_per_ray.shape == (F * 1024,)  # padded to the 32-ray tile
    full = tbm.sphere_trace_persistent(
        s["tshared"], s["tbank"], torch.arange(F).repeat_interleave(1024),
        T(s["o"]), T(s["v"]), MarchConfig(**MARCH_KW), T(s["idep"]),
        T(s["key"] != 2), rays_per_frame=1024)
    # per-ray results do not depend on the batch around the ray, up to the
    # CPU BLAS summing rows of another batch size in another order
    hit_f = full.hit.reshape(F, -1)[:, :1000]
    assert (res.hit == hit_f).float().mean() >= 0.99
    both = res.hit & hit_f
    d_f = full.depth.reshape(F, -1)[:, :1000]
    assert ((res.depth - d_f).abs()[both] < 1e-3).float().mean() >= 0.99


def test_camera_matches_jax():
    for eye, focal, hw in [((0.0, 0.0, -2.5), 60.0, (24, 32)),
                           ((1.2, 0.7, -1.9), 40.0, (16, 16))]:
        jc = jcam.Camera.looking_at(eye, focal=focal, img_hw=hw)
        tc = tcam.Camera.looking_at(eye, focal=focal, img_hw=hw)
        for a, b in zip(jc, tc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
        np.testing.assert_allclose(tc.center.numpy(), np.asarray(jc.center),
                                   atol=1e-6)
        jo, jv = jcam.pixel_rays(jc, *hw)
        to, tv = tcam.pixel_rays(tc, *hw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
        for r, m in [(1.0, 0.0), (0.6, 0.05)]:
            jn, jf, jh = jcam.ray_sphere_entry(jo, jv, r, m)
            tn, tf, th = tcam.ray_sphere_entry(to, tv, r, m)
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
            np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)


def test_live_counts_from_steps_matches_jax():
    rng = np.random.default_rng(0)
    steps = rng.integers(0, 60, size=500).astype(np.int32)
    for max_steps in (50, 16):
        ref = jtracer.live_counts_from_steps(jnp.asarray(steps), max_steps)
        out = ttracer.live_counts_from_steps(torch.as_tensor(steps), max_steps)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
