"""The port's plain tracers (ops/tracer.py), K1-grid's plain version and
its rounds driver (ops/kernels/fused_march.py) and the class order of
c2f_plan, against the JAX package.

  - march_step: the same elementwise fp32 operations as the JAX step run
    op by op, so on the same sdf input every field is equal bit for bit
    (XLA's compiled step may contract a product and a sum into one FMA,
    which is why the reference step here runs eagerly);
  - sphere_trace / sphere_trace_compact on an analytic implicit function
    of products and sums, JAX's loop run op by op (jax.disable_jit):
    every field equal but the geometric margin of rays that miss the
    bounding sphere, a norm (within 1e-6);
  - on the three decoders of tests/test_torch_recompute.py (folded, fp32,
    plus a sphere so that rays hit), against JAX's compiled tracers: hit
    agreement >= 0.99 and common-hit depth p95 <= 1e-5;
  - K1-grid's plain version against ``pallas_sphere_trace(interpret=True)``
    and the rounds driver against ``pallas_sphere_trace_rounds``, with
    the cases and bars of tests/test_torch_march.py (the two packages'
    CPU BLAS libraries sum the bf16 products in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import MarchConfig as JMarchConfig
from dist_renderer_tpu.models.analytic import torus_sdf
from dist_renderer_tpu.models.folded import fold_latent as jfold
from dist_renderer_tpu.models.folded import make_point_fn as jpoint_fn
from dist_renderer_tpu.models.pretrain import fit_decoder_to_sdf
from dist_renderer_tpu.ops import tracer as jt
from dist_renderer_tpu.ops.binning import counting_sort_perm
from dist_renderer_tpu.ops.camera import Camera as JCamera
from dist_renderer_tpu.ops.camera import pixel_rays as jpixel_rays
from dist_renderer_tpu.ops.pallas import fused_march as jfm
from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.models.folded import fold_latent, make_point_fn
from dist_renderer_tpu_torch.ops import tracer as tt
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.kernels import fused_march as tfm
from dist_renderer_tpu_torch.ops.renderer import class_order
from test_torch_recompute import ARCHS
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

def T(a):
    return torch.as_tensor(np.array(a))


def _rays(img=24, eye=(0.3, 0.2, -2.0), focal=20.0):
    cam = Camera.looking_at(eye, focal=focal, img_hw=(img, img))
    o, v = pixel_rays(cam, img, img)
    return o.contiguous(), v


def _seeds(o, v, seed=0):
    """NaN or a seed 0.1-0.4 in front of the unit sphere's entry, and a
    random 85% of rays active."""
    rng = np.random.default_rng(seed)
    n = o.shape[0]
    t0 = -(o * v).sum(-1).numpy() - 0.6
    init = np.where(rng.uniform(size=n) < 0.5,
                    t0 + rng.uniform(0.1, 0.4, n), np.nan).astype(np.float32)
    act = rng.uniform(size=n) < 0.85
    return init, act


def _noisy_sphere_np(p):
    return (np.sqrt((p * p).sum(-1)) - np.float32(0.5)
            + np.float32(0.03) * np.sin(np.float32(9.0) * p[:, 0])).astype(np.float32)


def test_march_step_is_bit_equal_to_jax():
    """Both steps driven along one trajectory: each step's sdf comes from
    numpy at the JAX state's depths and is handed to both."""
    o, v = _rays()
    on, vn = o.numpy(), v.numpy()
    kw = dict(max_steps=40, convergence_eps=1e-5, depth_eps=1e-6)
    jm, tm = JMarchConfig(**kw), MarchConfig(**kw)
    init, act = _seeds(o, v)
    jn, jfar, ja, _, _, jd0 = jt._ray_init(jnp.asarray(on), jnp.asarray(vn), jm,
                                           jnp.asarray(init), jnp.asarray(act))
    tn, tfar, ta, _, _, td0 = tt._ray_init(o, v, tm, T(init), T(act))
    np.testing.assert_array_equal(td0.numpy(), np.asarray(jd0))
    np.testing.assert_array_equal(tfar.numpy(), np.asarray(jfar))
    js = jt._init_state(on.shape[0], jd0, ja)
    ts = tt._init_state(on.shape[0], td0, ta)
    for _ in range(kw["max_steps"]):
        f = _noisy_sphere_np(on + np.asarray(js.d)[:, None] * vn)
        js = jt.march_step(js, jnp.asarray(f), None, None, jn, jfar, jm)
        ts = tt.march_step(ts, T(f), o, v, tn, tfar, tm)
        for name, a, b in zip(js._fields, js, ts):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int(np.asarray(js.hit).sum()) > 50


def _exact_sdf(lib):
    """(x^2 + y^2 + z^2 - 0.25) + 0.3 x y: a sphere's implicit function,
    bent, in products and sums alone (exactly rounded in either
    package)."""
    return lambda p: ((p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2])
                      - 0.25 + 0.3 * p[:, 0] * p[:, 1])


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("seeded", [False, True])
def test_tracers_equal_jax_on_analytic_sdf(compact, seeded):
    o, v = _rays()
    kw = dict(max_steps=40, convergence_eps=1e-5, depth_eps=1e-6)
    init, act = _seeds(o, v, 1) if seeded else (None, None)
    jargs = (jnp.asarray(o.numpy()), jnp.asarray(v.numpy()), JMarchConfig(**kw),
             None if init is None else jnp.asarray(init))
    targs = (o, v, MarchConfig(**kw), None if init is None else T(init))
    extra = dict(bucket_frac=4, inner_steps=8) if compact else {}
    ja = None if act is None else jnp.asarray(act)
    ta = None if act is None else T(act)
    with jax.disable_jit():
        if compact:
            ref = jt.sphere_trace_compact(_exact_sdf(jnp), *jargs, init_active=ja, **extra)
        else:
            ref = jt.sphere_trace(_exact_sdf(jnp), *jargs, ja)
    if compact:
        out = tt.sphere_trace_compact(_exact_sdf(torch), *targs, init_active=ta, **extra)
    else:
        out = tt.sphere_trace(_exact_sdf(torch), *targs, ta)
    assert int(out.hit.sum()) > 50
    for name in ("hit", "depth", "depth_at_min", "last_sdf", "unresolved",
                 "steps_per_ray", "live_counts", "steps_used"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    # the geometric margin of rays missing the sphere: a norm, which the
    # two libraries round differently
    np.testing.assert_allclose(out.min_sdf.numpy(), np.asarray(ref.min_sdf),
                               atol=1e-6)


def _decoder_sdfs(kw, seed=0):
    """(JAX, port) point functions: a random-init decoder of the arch,
    folded at a random latent, scaled by 0.05 on a sphere of radius 0.5."""
    rng = np.random.default_rng(seed)
    cfg = JDecoderConfig(**kw)
    params = {"layers": [
        {"w": (rng.standard_normal((i, o)) * np.sqrt(2.0 / i)).astype(np.float32),
         "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
        for i, o in cfg.layer_dims]}
    z = (0.3 * rng.standard_normal(cfg.latent_size)).astype(np.float32)
    jp = jpoint_fn(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(z), cfg)
    tp = make_point_fn(params_from_numpy(params), T(z), DecoderConfig(**kw))
    jf = lambda p: 0.05 * jp(p) + jnp.linalg.norm(p, axis=-1) - 0.5
    tf = lambda p: 0.05 * tp(p) + torch.linalg.norm(p, dim=-1) - 0.5
    return jf, tf


@pytest.mark.parametrize("arch", range(len(ARCHS)))
def test_tracers_match_jax_on_decoders(arch):
    jf, tf = _decoder_sdfs(ARCHS[arch], arch)
    o, v = _rays(img=20)
    init, act = _seeds(o, v, arch)
    kw = dict(max_steps=40, convergence_eps=1e-5, depth_eps=1e-6)
    jo, jv = jnp.asarray(o.numpy()), jnp.asarray(v.numpy())
    for compact, seeded in [(False, False), (True, True)]:
        ji = (jnp.asarray(init), jnp.asarray(act)) if seeded else (None, None)
        ti = (T(init), T(act)) if seeded else (None, None)
        if compact:
            ref = jax.jit(lambda: jt.sphere_trace_compact(
                jf, jo, jv, JMarchConfig(**kw), ji[0], init_active=ji[1]))()
            out = tt.sphere_trace_compact(tf, o, v, MarchConfig(**kw), ti[0],
                                          init_active=ti[1])
        else:
            ref = jax.jit(lambda: jt.sphere_trace(jf, jo, jv, JMarchConfig(**kw)))()
            out = tt.sphere_trace(tf, o, v, MarchConfig(**kw))
        jh, th = np.asarray(ref.hit), out.hit.numpy()
        assert jh.sum() > 40
        assert (jh == th).mean() >= 0.99
        both = jh & th
        derr = np.abs(np.asarray(ref.depth) - out.depth.numpy())[both]
        assert np.percentile(derr, 95) <= 1e-5, np.percentile(derr, 95)


# ---- K1-grid and its rounds driver ---------------------------------------

IMG = 32
MARCH_KW = dict(max_steps=32, convergence_eps=2e-3, depth_eps=5e-4)
DEC_KW = dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))


@pytest.fixture(scope="module")
def scene():
    """tests/test_torch_march.py's scene at F=1: a 4x32 decoder fitted to
    a torus, 32x32 rays, a coarse-to-fine plan from the port's plain
    pyramid."""
    from dist_renderer_tpu_torch.ops import c2f as tc2f

    dcfg = JDecoderConfig(**DEC_KW)
    params, z0 = fit_decoder_to_sdf(
        lambda p: torus_sdf(0.55, 0.2)(None, p), dcfg, steps=200, batch=512)
    cam = JCamera.looking_at((0.0, 0.0, -2.0), focal=IMG * 1.2, img_hw=(IMG, IMG))
    o, v = jpixel_rays(cam, IMG, IMG)
    jpk = jfm.pack_folded(jfold(params, z0, dcfg), dcfg)
    tp = params_from_numpy(params)
    tcfg = DecoderConfig(**DEC_KW)
    tpk = tfm.pack_folded(fold_latent(tp, T(z0), tcfg), tcfg)
    coarse = MarchConfig(**{**MARCH_KW, "max_steps": 12})
    to, tv = T(o), T(v)

    def trace_level(ol, vl, seed, act, stride):
        r = tfm.sphere_trace_grid(tpk, ol[0], vl[0], coarse,
                                  None if seed is None else seed[0],
                                  init_active=act[0])
        return r._replace(**{k: getattr(r, k)[None] for k in (
            "depth", "hit", "unresolved", "depth_at_min", "min_sdf")})

    maps = tc2f.classify_pyramid(trace_level, to.reshape(1, IMG, IMG, 3),
                                 tv.reshape(1, IMG, IMG, 3), (4,), 0.05)
    key, idep, _ = tc2f.plan_from_maps(maps)
    return dict(jpk=jpk, tpk=tpk, o=o, v=v, to=to, tv=tv,
                key=key[0].numpy(), idep=idep[0].numpy())


CASES = {
    "seeded+inactive": dict(seeded=True, salvage=True),
    "seeded+inactive, no salvage": dict(seeded=True, salvage=False),
    "fresh, all active": dict(seeded=False, salvage=True),
}


def _assert_march_parity(ref, out, act=None):
    """tests/test_torch_march.py's bars."""
    jh, th = np.asarray(ref.hit), out.hit.numpy()
    assert jh.sum() > 150
    assert (jh == th).mean() >= 0.99
    both = jh & th
    derr = np.abs(np.asarray(ref.depth) - out.depth.numpy())[both]
    assert np.median(derr) < 1e-5
    assert np.mean(derr < 1e-3) >= 0.98
    if act is not None:
        dead = ~act
        np.testing.assert_array_equal(out.steps_per_ray.numpy()[dead], 0)
        for name in ("min_sdf", "depth", "depth_at_min"):
            np.testing.assert_allclose(getattr(out, name).numpy()[dead],
                                       np.asarray(getattr(ref, name))[dead],
                                       atol=1e-6, err_msg=name)
    same = (jh == th) & (np.asarray(ref.unresolved) == out.unresolved.numpy())
    assert same.mean() >= 0.99
    steps_diff = np.abs(np.asarray(ref.steps_per_ray) - out.steps_per_ray.numpy())
    assert np.mean(steps_diff == 0) >= 0.95


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k1_grid_matches_pallas_sphere_trace(scene, case):
    c, s = CASES[case], scene
    act = s["key"] != 2
    init = s["idep"] if c["seeded"] else None
    ja = jnp.asarray(act) if c["seeded"] else None
    ref = jax.jit(lambda: jfm.pallas_sphere_trace(
        s["jpk"], s["o"], s["v"], JMarchConfig(**MARCH_KW),
        None if init is None else jnp.asarray(init), block=512, interpret=True,
        init_active=ja, salvage=c["salvage"]))()
    out = tfm.sphere_trace_grid(
        s["tpk"], s["to"], s["tv"], MarchConfig(**MARCH_KW),
        None if init is None else T(init),
        init_active=T(act) if c["seeded"] else None, salvage=c["salvage"])
    _assert_march_parity(ref, out, act if c["seeded"] else None)
    assert (out.bracketed.numpy() == np.asarray(ref.bracketed)).mean() >= 0.99
    assert out.live_counts.shape == (MARCH_KW["max_steps"],)


@pytest.mark.parametrize("seeded", [True, False])
def test_rounds_match_pallas_rounds(scene, seeded):
    """Three rounds (caps 4, 12, then the rest of 40 steps) with the
    live-prefix buckets (block 128 so that the 1,024 rays get prefixes)."""
    s = scene
    m = dict(MARCH_KW, max_steps=40)
    act = s["key"] != 2
    kw_j = dict(init_active=jnp.asarray(act)) if seeded else {}
    kw_t = dict(init_active=T(act)) if seeded else {}
    init = s["idep"] if seeded else None
    ref = jax.jit(lambda: jfm.pallas_sphere_trace_rounds(
        s["jpk"], s["o"], s["v"], JMarchConfig(**m),
        None if init is None else jnp.asarray(init), block=128, interpret=True,
        round_caps=(4, 12), **kw_j))()
    out = tfm.sphere_trace_rounds(
        s["tpk"], s["to"], s["tv"], MarchConfig(**m),
        None if init is None else T(init), block=128, round_caps=(4, 12), **kw_t)
    _assert_march_parity(ref, out, act if seeded else None)


def test_rounds_skip_semantics_match_single_march(scene):
    """tests/test_batched_march.py's rounds case on the port: rays that
    never march (the c2f skip class) report their seed anchor and the
    geometric margin exactly as one K1-grid march does; marched rays hit
    alike, depths within the march tolerance."""
    s = scene
    n = s["to"].shape[0]
    active = torch.ones(n, dtype=torch.bool)
    active[:64] = False
    seed = torch.full((n,), float("nan"))
    seed[:64] = 1.7
    m = MarchConfig(max_steps=40, convergence_eps=2e-3, depth_eps=5e-4)
    ref = tfm.sphere_trace_grid(s["tpk"], s["to"], s["tv"], m, seed,
                                init_active=active)
    got = tfm.sphere_trace_rounds(s["tpk"], s["to"], s["tv"], m, seed, block=64,
                                  init_active=active)
    skip = ~active
    for name in ("depth", "depth_at_min", "min_sdf"):
        np.testing.assert_allclose(getattr(got, name)[skip].numpy(),
                                   getattr(ref, name)[skip].numpy(), atol=1e-6)
    both = ref.hit & got.hit
    assert both.sum() > 50
    np.testing.assert_allclose(got.depth[both].numpy(), ref.depth[both].numpy(),
                               atol=5e-3)


def test_fused_march_fn_dispatches_like_pallas_march_fn(scene):
    """FusedMarchFn.trace takes the rounds driver above 2 x max(caps)
    steps and one K1-grid march at or below; it is callable as its point
    function."""
    s = scene
    mf = tfm.FusedMarchFn(s["tpk"], lambda p: p[:, 0])
    n0 = tfm.sphere_trace_grid.launches
    short = mf.trace(s["to"], s["tv"], MarchConfig(**{**MARCH_KW, "max_steps": 24}))
    single = tfm.sphere_trace_grid(s["tpk"], s["to"], s["tv"],
                                   MarchConfig(**{**MARCH_KW, "max_steps": 24}))
    assert short.bracketed is not None and torch.equal(short.depth, single.depth)
    long = mf.trace(s["to"], s["tv"], MarchConfig(**{**MARCH_KW, "max_steps": 25}))
    assert long.bracketed is None  # the rounds driver's result
    assert tfm.sphere_trace_grid.launches == n0  # CPU tensors: no launch
    assert torch.equal(mf(s["to"][:4]), s["to"][:4, 0])


def test_class_order_is_the_counting_sort_permutation():
    rng = np.random.default_rng(0)
    for n in (1, 37, 4096):
        key = rng.integers(0, 3, size=n).astype(np.int32)
        jo, ji = counting_sort_perm(jnp.asarray(key), 3)
        to, ti = class_order(T(key))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
