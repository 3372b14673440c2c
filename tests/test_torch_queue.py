"""K2's plain version (the port's work-queue march) against the JAX
package's ``queue_march`` in interpret mode and, exactly, against K1's
plain version; and the coarse-to-fine planner that gives the queue its
keys and seeds.

Exactness: the plain versions march every step at one fixed ray width
with per-ray masks, so a ray's MLP row is summed the same way under any
generation schedule, and the queue (pause at each cap, resume from the
carry) must reproduce one uninterrupted march bit for bit. Against JAX
the tolerance is test_torch_march.py's: the CPU BLAS libraries of the two
packages sum in different orders.
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
from dist_renderer_tpu.ops import c2f as jc2f
from dist_renderer_tpu.ops import camera as jcam
from dist_renderer_tpu.ops.pallas import batched_march as jbm
from dist_renderer_tpu.ops.pallas.queue_march import queue_march as jqueue_march
from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.ops import c2f as tc2f
from dist_renderer_tpu_torch.ops.kernels import batched_march as tbm
from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march

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
    ob = np.broadcast_to(np.asarray(o)[None], (F, IMG * IMG, 3))
    vb = np.broadcast_to(np.asarray(v)[None], (F, IMG * IMG, 3))
    tp = params_from_numpy(params)
    tshared = tbm.pack_shared(tp, DecoderConfig(**DEC_KW))
    tbank = tbm.fold_bias_bank(tp, T(lat), DecoderConfig(**DEC_KW), tshared)
    coarse = MarchConfig(**{**MARCH_KW, "max_steps": 12})
    maps = tc2f.classify_pyramid(
        lambda ol, vl, seed, act, stride: tbm.batched_trace_padded(
            tshared, tbank, ol, vl, coarse, seed, act),
        T(ob).reshape(F, IMG, IMG, 3), T(vb).reshape(F, IMG, IMG, 3), (4,), 0.05)
    key, idep, _ = tc2f.plan_from_maps(maps)
    return dict(params=params, lat=lat, ob=ob, vb=vb, key=key, idep=idep,
                tshared=tshared, tbank=tbank, march=MarchConfig(**MARCH_KW))


def _k1(s):
    return tbm.batched_trace_padded(
        s["tshared"], s["tbank"], T(s["ob"]), T(s["vb"]), s["march"],
        s["idep"], s["key"] != 2)


@pytest.mark.parametrize("caps", [(1, 2, 6, 16), (6, 16), (64,), (2, 2, 2)])
def test_plain_queue_equals_plain_k1_exactly(scene, caps):
    s = scene
    q = queue_march(s["tshared"], s["tbank"], T(s["ob"]), T(s["vb"]), s["key"],
                    s["idep"], s["march"], gen_caps=caps)
    ref = _k1(s)
    assert int(ref.hit.sum()) > 300  # the scene is visible
    for a, b in [(q.depth, ref.depth), (q.hit, ref.hit),
                 (q.min_sdf, ref.min_sdf), (q.depth_at_min, ref.depth_at_min),
                 (q.last_sdf, ref.last_sdf), (q.unresolved, ref.unresolved)]:
        assert torch.equal(a, b)
    steps = ref.steps_per_ray.reshape(F, -1)[:, :IMG * IMG]
    assert torch.equal(q.steps, steps)


def test_queue_shared_origin_and_plain_alias(scene):
    """[F, 1, 3] shared origins broadcast to the same rays; the wrapper on
    a CPU tensor is the plain version."""
    s = scene
    full = queue_march(s["tshared"], s["tbank"], T(s["ob"]), T(s["vb"]),
                       s["key"], s["idep"], s["march"], use_kernel=False)
    shared = queue_march(s["tshared"], s["tbank"], T(s["ob"][:, :1]),
                         T(s["vb"]), s["key"], s["idep"], s["march"])
    for a, b in zip(full, shared):
        assert (a is None and b is None) or torch.equal(a, b)


def test_plain_queue_matches_jax_queue_march(scene):
    s = scene
    jp = jax.tree_util.tree_map(jnp.asarray, s["params"])
    dcfg = JDecoderConfig(**DEC_KW)
    shared = jbm.pack_shared(jp, dcfg)
    bank = jbm.fold_bias_bank(jp, jnp.asarray(s["lat"]), dcfg, shared)
    ref = jax.jit(lambda: jqueue_march(
        shared, bank, jnp.asarray(s["ob"]), jnp.asarray(s["vb"]),
        jnp.asarray(s["key"].numpy()), jnp.asarray(s["idep"].numpy()),
        JMarchConfig(**MARCH_KW), block=512, gen_caps=(6, 16),
        interpret=True))()
    out = queue_march(s["tshared"], s["tbank"], T(s["ob"]), T(s["vb"]), s["key"],
                      s["idep"], s["march"], gen_caps=(6, 16))
    jd, jh, jmsdf = (np.asarray(a) for a in ref[:3])
    th = out.hit.numpy()
    assert (jh == th).mean() >= 0.99
    both = jh & th
    derr = np.abs(jd - out.depth.numpy())[both]
    assert np.median(derr) < 1e-5 and np.mean(derr < 1e-3) >= 0.98
    act = s["key"].numpy() != 2
    merr = np.abs(jmsdf - out.min_sdf.numpy())
    assert np.mean(merr[act] < 1e-3) >= 0.98
    # never-marched rays carry the same geometric sphere margin
    np.testing.assert_allclose(out.min_sdf.numpy()[~act], jmsdf[~act], atol=1e-6)
    assert np.mean(np.asarray(ref[6]) == out.unresolved.numpy()) >= 0.99


# ---- the planner ----

def _fake_levels(seed):
    """Deterministic per-level trace fields from a numpy seed: a shape
    whose coarse hits cover a disc, with unresolved rays sprinkled in."""
    rng = np.random.default_rng(seed)

    def level(n_rays, stride):
        side = int(round(np.sqrt(n_rays)))
        yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        r = np.hypot(yy - side / 2, xx - side / 2) / side
        hit = (r < 0.3) & (rng.random((side, side)) > 0.05)
        unres = (~hit) & (rng.random((side, side)) < 0.05)
        depth = (1.5 + r + 0.01 * rng.standard_normal((side, side))).astype(np.float32)
        dam = (1.4 + r).astype(np.float32)
        msdf = np.where(hit, 0.0, r - 0.3).astype(np.float32)
        f = lambda a: np.broadcast_to(a.reshape(1, -1), (F, a.size)).copy()
        return dict(depth=f(depth), hit=f(hit), unresolved=f(unres),
                    depth_at_min=f(dam), min_sdf=f(msdf))

    return level


@pytest.mark.parametrize("strides", [(16, 4), (4,), (8, 2)])
def test_classify_pyramid_and_plan_match_jax(strides):
    hw = 32
    o = np.zeros((F, hw, hw, 3), np.float32)
    v = np.ones((F, hw, hw, 3), np.float32)
    lv = _fake_levels(0)
    cache = {}

    def fields(o_l, stride):
        if stride not in cache:
            cache[stride] = lv(o_l.shape[1], stride)
        return cache[stride]

    class NS:
        def __init__(self, d, wrap):
            for k_, a in d.items():
                setattr(self, k_, wrap(a))

    jm = jc2f.classify_pyramid(
        lambda ol, vl, seed, act, stride: NS(fields(ol, stride), jnp.asarray),
        jnp.asarray(o), jnp.asarray(v), strides, 0.05)
    tm = tc2f.classify_pyramid(
        lambda ol, vl, seed, act, stride: NS(fields(ol, stride), torch.as_tensor),
        torch.as_tensor(o), torch.as_tensor(v), strides, 0.05)
    for name, a, b in zip(jm._fields, jm, tm):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    for a, b in zip(jc2f.plan_from_maps(jm), tc2f.plan_from_maps(tm)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("op", ["min", "max", "or", "and"])
def test_window_reductions_and_border_neutrals_match_jax(op):
    rng = np.random.default_rng(1)
    if op in ("or", "and"):
        g = rng.random((2, 5, 7)) > (0.7 if op == "or" else 0.3)
        jop, neutral = ((jax.lax.bitwise_or, False) if op == "or"
                        else (jax.lax.bitwise_and, True))
    else:
        g = rng.standard_normal((2, 5, 7)).astype(np.float32)
        g[rng.random(g.shape) < 0.3] = np.inf if op == "min" else -np.inf
        jop, neutral = ((jax.lax.min, np.inf) if op == "min"
                        else (jax.lax.max, -np.inf))
    ref = jc2f.default_windows(jnp.asarray(g), jop, neutral)
    out = tc2f.default_windows(torch.as_tensor(g), op)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert tc2f.classify_pyramid(None, torch.zeros(1, 4, 4, 3),
                                 torch.zeros(1, 4, 4, 3), (), 0.05) is None
