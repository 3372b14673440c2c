"""Gradients of the port against the JAX package's, on the CPU: K4's plain
version against ``precise_bias_grads_call`` in interpret mode, the
differentiable sdg against ``jax.grad`` of JAX's ``make_precise_sdg``,
``render_rays`` on a fixed trace and the whole ``render()`` against
``jax.grad`` of JAX's, and the two margin gradients the port used to
drop. Inputs come from numpy seeds; each test states its tolerance.
"""

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
from dist_renderer_tpu.models.decoder import decoder_apply as jdecoder_apply
from dist_renderer_tpu.models.decoder import make_precise_sdf as jmake_precise_sdf
from dist_renderer_tpu.models.pretrain import fit_decoder_to_sdf
from dist_renderer_tpu.ops import camera as jcam
from dist_renderer_tpu.ops.pallas import recompute as jrec
from dist_renderer_tpu.ops.renderer import make_march_factory as jmake_factory
from dist_renderer_tpu.ops.renderer import render as jrender
from dist_renderer_tpu.ops.renderer import render_rays as jrender_rays
from dist_renderer_tpu.ops.tracer import TraceResult as JTraceResult
from dist_renderer_tpu.ops.tracer import sphere_trace as jsphere_trace
from dist_renderer_tpu.utils import losses as JL
from dist_renderer_tpu_torch.config import (
    DecoderConfig, GradConfig, MarchConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.decoder import (
    decoder_apply, make_precise_sdf, params_from_numpy,
)
from dist_renderer_tpu_torch.models.pretrain import load_params_npz
from dist_renderer_tpu_torch.ops import camera as tcam
from dist_renderer_tpu_torch.ops.kernels import recompute as trec
from dist_renderer_tpu_torch.ops.renderer import (
    SDFRenderer, make_march_factory, render, render_rays,
)
from dist_renderer_tpu_torch.ops.tracer import TraceResult
from dist_renderer_tpu_torch.utils import losses as L
from test_torch_recompute import ARCHS, _jax_params, _setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread: these tests run many small products (the
    in-order loop below: 512 per layer), and with the default intra-op
    threads, pytest workers sharing the cores slowed them up to 30-fold.
    Module-scoped, so a module's own module-scoped fixtures (set up before
    any function-scoped one) run on one thread too: tests/test_torch_cert.py's
    port_modes took 41-73 s of setup in 4-worker runs with the default
    threads, ~1 s on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_fold(params, latent, cfg, packed):
    """The JAX package's bias fold (bf16x3 split products, which drop the
    lo x lo term, ~2^-16 relative) in place of the port's fp32 fold."""
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().cpu().numpy()),
                                params)
    jc = JDecoderConfig(**{f: getattr(cfg, f) for f in (
        "latent_size", "hidden_dims", "latent_in", "use_tanh", "final_tanh",
        "xyz_in_all")})
    jb = jrec.fold_bias_precise(jp, jnp.asarray(latent.detach().cpu().numpy()),
                                jc, jrec.pack_precise(jp, jc))
    return tuple(torch.as_tensor(np.array(b)[:, 0]) for b in jb)


@pytest.fixture
def jax_fold(monkeypatch):
    """The port's sdg with the JAX package's bias fold: isolates the
    kernels and the composition. With its own fold the port's biases
    differ by ~1e-5 relative, which moves bf16 roundings of activations
    and gates; gradients then differ by 1e-4 to 1e-2 relative (measured
    on the CPU: 2.5e-4 to 6.8e-3 on the sdg, 13% on the fixed-trace
    depth objective, whose noisy L1 signs cancel most of the sum)."""
    monkeypatch.setattr(trec, "fold_bias_precise", _jax_fold)


def _dot_k_order(a, b):
    """a [N, K] @ b [K, M] summed over k in order from zero (each product
    of bf16-valued operands is exact in fp32)."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    a_t = a.T.contiguous()   # each k's column one contiguous run
    for k in range(a.shape[1]):
        out.addcmul_(a_t[k][:, None], b[k:k + 1])
    return out


@pytest.fixture
def jax_order(jax_fold, monkeypatch):
    """The JAX package's bias fold and its products' summation order: the
    JAX kernels in interpret mode sum each product over k in order, as
    the CUDA kernels do, and the port's plain versions then equal them on
    every point of the fixed traces below (s within 4e-9). With the CPU
    GEMM's blocked order instead, 6 of the far camera's 211 hit points
    move a bf16 rounding (s by up to 7.7e-5, dd by up to 2%); an fp64
    accumulated product moves 4 (measured on the CPU)."""
    monkeypatch.setattr(trec, "dot_f32", _dot_k_order)


def _rel(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cos(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)


# ---- K4: the plain version against the TPU kernel in interpret mode ----

K4_MODES = [dict(scalar_chain=True, want_gx=False),
            dict(scalar_chain=True, want_gx=True),
            dict(scalar_chain=False, want_gx=True)]


@pytest.mark.parametrize("mode", K4_MODES, ids=["scalar", "scalar-gx", "rows-gx"])
@pytest.mark.parametrize("kw", ARCHS)
def test_plain_k4_matches_pallas_bias_grads(kw, mode):
    """Bars: u relative L2 <= 1e-4 and gx p95 <= 1e-5. The same bf16
    operands on both sides, fp32 sums in another order (and u summed in
    fp64 here, in fp32 lanes there)."""
    params, latent, pts, _ = _setup(kw)
    rng = np.random.default_rng(11)
    n = pts.shape[0]
    ct = (rng.standard_normal(n) if mode["scalar_chain"]
          else rng.standard_normal((n, 3))).astype(np.float32)
    jp, jc = _jax_params(params), JDecoderConfig(**kw)
    jpk = jrec.pack_precise(jp, jc)
    jb = jrec.fold_bias_precise(jp, jnp.asarray(latent), jc, jpk)
    jres = jax.jit(lambda: jrec.precise_bias_grads_call(
        jpk, jb, jnp.asarray(pts), jnp.asarray(ct), block=128, interpret=True,
        **mode))()

    tpk = trec.pack_precise(params_from_numpy(params), DecoderConfig(**kw))
    tb = tuple(torch.as_tensor(np.array(b)[:, 0]) for b in jb)
    n0 = trec.precise_bias_grads_call.launches
    tres = trec.precise_bias_grads_call(tpk, tb, torch.as_tensor(pts),
                                        torch.as_tensor(ct), **mode)
    assert trec.precise_bias_grads_call.launches == n0  # CPU: plain, uncounted
    ju, tu = (jres[0], tres[0]) if mode["want_gx"] else (jres, tres)
    assert len(tu) == sum(m.takes_z for m in tpk.meta) == 2
    for a, b, m in zip(ju, tu, [m for m in tpk.meta if m.takes_z]):
        assert b.shape == (m.out_p,) and b.dtype == torch.float32
        assert _rel(b.numpy(), a) <= 1e-4
    if mode["want_gx"]:
        e = np.abs(tres[1].numpy() - np.asarray(jres[1])).max(axis=1)
        assert tres[1].shape == (n, 3) and np.quantile(e, 0.95) <= 1e-5


def test_k4_seeded_with_ones_gives_k3_gradient():
    """K4 with ct = 1 and want_gx walks K3's arithmetic: its gx is K3's g
    exactly, and u is the sum of K3's per-point deltas."""
    params, latent, pts, dirs = _setup(ARCHS[2], n=200)
    tp, tc = params_from_numpy(params), DecoderConfig(**ARCHS[2])
    pk = trec.pack_precise(tp, tc)
    b = trec.fold_bias_precise(tp, torch.as_tensor(latent), tc, pk)
    x = torch.as_tensor(pts)
    _, _, g = trec.precise_sdg_call(pk, b, x, torch.as_tensor(dirs))
    us, gx = trec.precise_bias_grads_call(pk, b, x, torch.ones(200), want_gx=True)
    assert torch.equal(gx, g)
    # per-point u of point 0 alone, twice, sums like two points
    u1 = trec.precise_bias_grads_call(pk, b, x[:1], torch.ones(1))
    u2 = trec.precise_bias_grads_call(pk, b, x[:1].repeat(2, 1), torch.ones(2))
    for a, c in zip(u1, u2):
        torch.testing.assert_close(2 * a, c, rtol=1e-6, atol=0)


# ---- the differentiable sdg ----

@pytest.mark.parametrize("kw", ARCHS)
def test_sdg_autograd_matches_jax_grad(kw, monkeypatch):
    """(gz, gp) of sum(w * s) against jax.grad of JAX's make_precise_sdg
    (interpret mode), with JAX's bias fold: relative L2 <= 1e-4 (measured
    <= 2e-7). With the port's own fold, against fp32 autodiff of
    decoder_apply: tests/test_recompute.py's bars, with JAX's kernel
    gradient as the yardstick."""
    params, latent, pts, dirs = _setup(kw, n=200)
    w = np.random.default_rng(7).standard_normal(200).astype(np.float32)
    jp, jc = _jax_params(params), JDecoderConfig(**kw)
    jsdg = jrec.make_precise_sdg(jp, jc, block=128, interpret=True)
    jgz, jgp = jax.jit(jax.grad(
        lambda z, p: jnp.sum(jnp.asarray(w) * jsdg(z, p, jnp.asarray(dirs))[0]),
        argnums=(0, 1)))(jnp.asarray(latent), jnp.asarray(pts))

    tp, tc = params_from_numpy(params), DecoderConfig(**kw)

    def grads():
        sdg = make_precise_sdf(tp, tc).sdg_builder()
        z = torch.tensor(latent, requires_grad=True)
        p = torch.tensor(pts, requires_grad=True)
        s, _, _ = sdg(z, p, torch.as_tensor(dirs))
        return torch.autograd.grad((torch.as_tensor(w) * s).sum(), (z, p))

    with monkeypatch.context() as m:
        m.setattr(trec, "fold_bias_precise", _jax_fold)
        gz, gp = grads()
    assert _rel(gz, jgz) <= 1e-4 and _rel(gp, jgp) <= 1e-4

    gz, gp = grads()
    z32 = torch.tensor(latent, requires_grad=True)
    p32 = torch.tensor(pts, requires_grad=True)
    rz, rp = torch.autograd.grad(
        (torch.as_tensor(w) * decoder_apply(tp, z32, p32, tc)).sum(), (z32, p32))
    jrz, jrp = jax.grad(lambda zz, pp: jnp.sum(
        jnp.asarray(w) * jdecoder_apply(jp, zz, pp, jc)), argnums=(0, 1))(
            jnp.asarray(latent), jnp.asarray(pts))
    assert _rel(gz, rz) <= _rel(jgz, jrz) * 1.5 + 1e-3
    assert _rel(gp, rp) <= _rel(jgp, jrp) * 1.5 + 1e-3
    assert _cos(gz, rz) > 0.97


def test_sdg_dd_and_g_carry_no_gradient():
    params, latent, pts, dirs = _setup(ARCHS[0], n=50)
    tp, tc = params_from_numpy(params), DecoderConfig(**ARCHS[0])
    sdg = make_precise_sdf(tp, tc).sdg_builder()
    z = torch.tensor(latent, requires_grad=True)
    p = torch.tensor(pts, requires_grad=True)
    s, dd, g = sdg(z, p, torch.as_tensor(dirs))
    assert s.requires_grad and not dd.requires_grad and not g.requires_grad
    # a loss on s and on (constant) dd/g: only s contributes
    gz, = torch.autograd.grad(s.sum() + (dd.sum() + g.sum()) * 0 + dd.sum(), (z,))
    gz_s, = torch.autograd.grad(sdg(z, p, torch.as_tensor(dirs))[0].sum(), (z,))
    assert torch.equal(gz, gz_s)
    # parameters are constants: no tensor of the decoder requires grad
    assert not any(l["w"].requires_grad for l in tp["layers"])
    # nothing requires grad: no graph
    with torch.no_grad():
        s2, _, _ = sdg(z, p, torch.as_tensor(dirs))
    assert s2.grad_fn is None


# ---- render_rays on a fixed trace (the bench fixture at 32x32) ----

def _bench():
    """(params as numpy, the bench latent, the latent a fit starts from:
    the bench latent + 0.01 N(0, 1) from a numpy seed)."""
    params, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    params_np = {"layers": [{k: v.numpy() for k, v in l.items()}
                            for l in params["layers"]]}
    z = z0.numpy() + 0.01 * np.random.default_rng(3).standard_normal(
        z0.shape[0]).astype(np.float32)
    return params_np, z0.numpy(), z.astype(np.float32)


_TRACES = {}


def _fixed_trace(params_np, z, eye, march):
    """JAX's plain masked sphere tracer on the fp32 decoder, as numpy.
    Rays that never enter the bounding sphere get the geometric margin
    the march kernels record (the plain tracer leaves +inf there). Traced
    once per (latent, eye, march) in this module (params_np is always the
    bench decoder): the tests read it and never write it."""
    key = (np.asarray(z, np.float32).tobytes(), tuple(eye), march)
    if key not in _TRACES:
        _TRACES[key] = _trace_with_jax(params_np, z, eye, march)
    return _TRACES[key]


def _trace_with_jax(params_np, z, eye, march):
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    jc = JDecoderConfig()
    cam = jcam.Camera.looking_at(eye, focal=IMG * 1.2, img_hw=(IMG, IMG))
    o, v = jcam.pixel_rays(cam, IMG, IMG)
    jm = JMarchConfig(max_steps=march.max_steps,
                      convergence_eps=march.convergence_eps,
                      depth_eps=march.depth_eps)
    tr = jax.jit(lambda: jsphere_trace(
        lambda p: jdecoder_apply(jp, jnp.asarray(z), p, jc), o, v, jm))()
    d = {k: np.asarray(getattr(tr, k)) for k in
         ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf", "unresolved")}
    o, v = np.asarray(o), np.asarray(v)
    _, _, enters = jcam.ray_sphere_entry(o, v, march.sphere_radius, 0.0)
    enters = np.asarray(enters)
    t_c = np.maximum(-np.sum(o * v, -1), 0.0)
    geo = np.linalg.norm(o + t_c[:, None] * v, axis=-1) - march.sphere_radius
    d["min_sdf"] = np.where(enters, d["min_sdf"], geo).astype(np.float32)
    d["enters"] = enters
    return d, np.asarray(cam.K), np.asarray(jcam.pose_from_camera(cam))


def _traces(d):
    n = d["depth"].shape[0]
    steps = np.zeros(n, np.int32)
    common = dict(steps_used=0, steps_per_ray=steps, bracketed=None)
    jt = JTraceResult(**{k: jnp.asarray(d[k]) for k in
                         ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf",
                          "unresolved")},
                      live_counts=jnp.zeros(1, jnp.int32),
                      **{k: (jnp.asarray(x) if x is not None else None)
                         for k, x in common.items()})
    tt = TraceResult(**{k: torch.as_tensor(d[k]) for k in
                        ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf",
                         "unresolved")},
                     live_counts=torch.zeros(1, dtype=torch.int32),
                     steps_used=torch.tensor(0), steps_per_ray=torch.as_tensor(steps))
    return jt, tt


def _observation(d):
    """tasks/depth_completion.py's observation from a ground-truth render
    (depth, hit): depth and silhouette where hit, in the left half of the
    columns. Returns flat (obs_depth, obs_valid, obs_mask, column mask)."""
    hit = d["hit"].reshape(IMG, IMG)
    cols = np.broadcast_to(np.arange(IMG) < IMG // 2, (IMG, IMG))
    valid = hit & cols
    obs_depth = np.where(valid, d["depth"].reshape(IMG, IMG), 0.0)
    return (obs_depth.astype(np.float32).ravel(), valid.ravel(), valid.ravel(),
            cols.ravel())


def _objective(lib, where, out, z, obs):
    """tasks/depth_completion.py's: 10 depth + 1 silhouette + 1e-4 reg."""
    obs_depth, obs_valid, obs_mask, col = obs
    ld = lib.depth_loss(out.depth, obs_depth, obs_valid, out.mask)
    ls = lib.silhouette_loss(where(col, out.min_sdf, 0.0 * out.min_sdf), obs_mask)
    return 10.0 * ld + ls + 1e-4 * lib.latent_reg(z)


def _grad_cfgs(march):
    grad = dict(mode="ift", compact_frac=4, compact_min=16, recompute="pallas")
    jcfg = JRenderConfig(img_h=IMG, img_w=IMG, use_pallas=True,
                         march=JMarchConfig(max_steps=march.max_steps,
                                            convergence_eps=march.convergence_eps,
                                            depth_eps=march.depth_eps),
                         grad=JGradConfig(**grad))
    tcfg = RenderConfig(img_h=IMG, img_w=IMG, use_pallas=True, march=march,
                        grad=GradConfig(**grad))
    return jcfg, tcfg


MARCH = MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4)


class _FixedTrace:
    """render_rays of the bench fixture at 32x32 on one fixed trace (from
    the jittered latent) in both packages, differentiable to the latent
    and an so3 pose vector."""

    def __init__(self, eye):
        params_np, _, z = _bench()
        self.d, K, pose = _fixed_trace(params_np, z, eye, MARCH)
        jt, tt = _traces(self.d)
        jcfg, tcfg = _grad_cfgs(MARCH)
        jsdf = jmake_precise_sdf(jax.tree_util.tree_map(jnp.asarray, params_np),
                                 JDecoderConfig())

        def jout(zz, pp):
            o, v = jcam.pixel_rays(jcam.camera_from_pose(pp, jnp.asarray(K)),
                                   IMG, IMG)
            return jrender_rays(jsdf, zz, o, v, jcfg, trace=jt)

        self.K = K
        self.jout, self.jz, self.jpose = jout, jnp.asarray(z), jnp.asarray(pose)
        sdf = make_precise_sdf(params_from_numpy(params_np), DecoderConfig())
        self.z = torch.tensor(z, requires_grad=True)
        self.pose = torch.tensor(pose, requires_grad=True)
        o, v = tcam.pixel_rays(tcam.camera_from_pose(self.pose, torch.as_tensor(K)),
                               IMG, IMG)
        self.out = render_rays(sdf, self.z, o, v, tcfg, trace=tt)

    def grads(self, loss_of):
        """((JAX gz, gpose), (port gz, gpose)) of loss_of(lib, where, out, z)."""
        jg = jax.jit(jax.grad(lambda zz, pp: loss_of(JL, jnp.where, self.jout(zz, pp), zz),
                              argnums=(0, 1)))(self.jz, self.jpose)
        tg = torch.autograd.grad(loss_of(L, torch.where, self.out, self.z),
                                 (self.z, self.pose), retain_graph=True)
        return tuple(map(np.asarray, jg)), tuple(t.numpy() for t in tg)

    def per_ray_depth_errors(self, rays):
        """Relative L2 error of each ray's depth gradient to (z, pose)."""
        jg = jax.jit(jax.grad(lambda zz, pp, w: jnp.sum(w * self.jout(zz, pp).depth),
                              argnums=(0, 1)))
        errs = []
        for i in rays:
            w = np.zeros(self.d["hit"].shape, np.float32)
            w[i] = 1.0
            j = jg(self.jz, self.jpose, jnp.asarray(w))
            t = torch.autograd.grad(self.out.depth[i], (self.z, self.pose),
                                    retain_graph=True)
            errs.append(max(_rel(a.numpy(), b) for a, b in zip(t, j)))
        return np.array(errs)


@pytest.mark.parametrize("eye,branch", [((0.0, 0.0, -2.5), "bucket"),
                                        ((0.0, 0.0, -1.6), "full width")])
def test_render_rays_gradients_match_jax_on_a_fixed_trace(eye, branch, jax_order):
    """The depth-completion objective against the bench latent's own
    trace, from a jittered latent's trace: latent and pose gradients, JAX's
    bias fold and in-order sums on both sides. At 1,024 rays the bucket is
    512: the far camera's ~210 hits fit it (the other misses take the lazy
    margin), the near camera's ~550 do not (the full-width composition).
    Bars: cos >= 0.9999 and relative L2 <= 1e-3 on each gradient; per
    sampled hit ray, the depth's gradient to (latent, pose) within
    relative L2 1e-4 (measured <= 4.2e-7).

    Two kinds of rays are left out of the objective:

      - rays whose forward value differs between the packages (the
        precise value s of a composed ray by > 1e-7, or a hit's depth by
        > 1e-6): at most 3% of the composed rays inside the bounding
        sphere (measured: 9 of the far camera's 428 and 14 of the near
        camera's 1,024; s moves by up to 2.1e-4). The JAX kernels in interpret mode sum their products in an
        order XLA picks per program: at the far camera JAX's jitted
        render_rays takes s = -1.1266e-3 on one ray where its own kernel
        alone takes -1.0253e-3 at the same point (the port: -1.0253e-3),
        so no fixed order matches it everywhere; a last-bit difference
        there moves a bf16 rounding of an activation;
      - rays whose rendered depth lies within 1e-3 of the observation in
        either package, where a last-bit difference flips the L1 sign.

    With both kept, the one far-camera ray, 1.3e-4 from its observed
    depth, flipped its L1 sign and moved the latent gradient by 2.3e-2
    relative; the near camera's moved it by 1.9e-3."""
    params_np, z0, _ = _bench()
    obs_depth, obs_valid, obs_mask, col = _observation(
        _fixed_trace(params_np, z0, eye, MARCH)[0])
    ft = _FixedTrace(eye)
    hit = ft.d["hit"]
    n_hit = int(hit.sum())
    assert (n_hit <= 512) == (branch == "bucket") and n_hit > 100

    composed = np.arange(hit.size)
    if branch == "bucket":
        composed = np.argsort(~hit, kind="stable")[:512]
    composed = composed[ft.d["enters"][composed]]
    jout = jax.jit(ft.jout)(ft.jz, ft.jpose)
    jd, jm = np.asarray(jout.depth), np.asarray(jout.min_sdf)
    td, tm = ft.out.depth.detach().numpy(), ft.out.min_sdf.detach().numpy()
    moved = hit & (np.abs(jd - td) > 1e-6)
    moved[composed] |= np.abs(jm - tm)[composed] > 1e-7
    assert moved.sum() <= 0.03 * composed.size, moved.sum()
    clear = (np.abs(jd - obs_depth) > 1e-3) & (np.abs(td - obs_depth) > 1e-3)
    keep = obs_valid & clear & ~moved
    assert (keep & hit).sum() >= 0.85 * (obs_valid & hit).sum()
    obs = (obs_depth, keep, obs_mask, col & ~moved)

    def loss_of(lib, where, out, zz):
        to = jnp.asarray if lib is JL else torch.as_tensor
        return _objective(lib, where, out, zz, tuple(map(to, obs)))

    (jgz, jgp), (gz, gp) = ft.grads(loss_of)
    for a, b in ((gz, jgz), (gp, jgp)):
        assert np.all(np.isfinite(a)) and np.linalg.norm(b) > 0
        assert _cos(a, b) >= 0.9999 and _rel(a, b) <= 1e-3, (_cos(a, b), _rel(a, b))
    rays = np.random.default_rng(0).choice(np.flatnonzero(hit & ~moved), size=6,
                                           replace=False)
    err = ft.per_ray_depth_errors(rays)
    assert err.max() <= 1e-4, err


def _one_margin_ray(kind):
    """A ray whose margin the parent's render_rays kept without gradient:
    a miss outside the compose bucket, or a ray that never enters the
    bounding sphere (at the far camera)."""
    params_np, _, z = _bench()
    d, _, _ = _fixed_trace(params_np, z, (0.0, 0.0, -2.5), MARCH)
    order = np.argsort(~d["hit"], kind="stable")
    outside = np.zeros(d["hit"].shape, bool)
    outside[order[512:]] = True
    if kind == "out-of-bucket miss":
        cand = np.flatnonzero(outside & d["enters"] & ~d["hit"])
    else:
        cand = np.flatnonzero(~d["enters"])
    assert cand.size > 0
    return int(cand[cand.size // 2])


@pytest.fixture(scope="module")
def far_trace():
    """The far camera's _FixedTrace with JAX's bias fold (the jax_fold
    fixture's), built once for the margin tests, which only read it (their
    backward passes keep its graph)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trec, "fold_bias_precise", _jax_fold)
        return _FixedTrace((0.0, 0.0, -2.5))


@pytest.mark.parametrize("kind", ["out-of-bucket miss", "non-entering ray"])
def test_margin_gradient_repairs(kind, jax_fold, far_trace):
    """A loss on one ray's margin gives the latent (and pose) gradient
    JAX gives, nonzero: the decoder's gradient at the ray's anchor (the
    lazy margin), or the margin's gradient kept under the geometric value
    on a ray outside the bounding sphere. Bars as the fixed-trace test."""
    i = _one_margin_ray(kind)
    ft = far_trace
    assert not ft.d["hit"][i]
    (jgz, jgp), (gz, gp) = ft.grads(lambda lib, where, out, z: out.min_sdf[i])
    for a, b in ((gz, jgz), (gp, jgp)):
        assert np.linalg.norm(a) > 1e-6
        assert _cos(a, b) >= 0.9999 and _rel(a, b) <= 1e-3, (_cos(a, b), _rel(a, b))


def test_non_entering_margin_value_is_geometric():
    """The value on a non-entering ray stays the geometric distance while
    its gradient is the decoder's."""
    params_np, _, z = _bench()
    d, K, pose = _fixed_trace(params_np, z, (0.0, 0.0, -2.5), MARCH)
    _, tt = _traces(d)
    _, tcfg = _grad_cfgs(MARCH)
    sdf = make_precise_sdf(params_from_numpy(params_np), DecoderConfig())
    o, v = tcam.pixel_rays(tcam.camera_from_pose(torch.as_tensor(pose),
                                                 torch.as_tensor(K)), IMG, IMG)
    zt = torch.tensor(z, requires_grad=True)
    out = render_rays(sdf, zt, o, v, tcfg, trace=tt)
    ne = ~torch.as_tensor(d["enters"])
    torch.testing.assert_close(out.min_sdf[ne], torch.as_tensor(d["min_sdf"])[ne],
                               rtol=0, atol=1e-6)
    with torch.no_grad():
        out2 = render_rays(sdf, zt.detach(), o, v, tcfg, trace=tt)
    assert out2.min_sdf.grad_fn is None and out2.depth.grad_fn is None
    torch.testing.assert_close(out2.depth, out.depth.detach(), rtol=0, atol=0)


# ---- the whole render() (small decoder, stand-in proxy) ----

def test_render_gradients_match_jax():
    """render() of tests/test_torch_render.py's small fitted decoder with
    its stand-in proxy, latent and so3-pose gradients of the
    depth-completion objective against jax.grad of JAX's render(). The
    two packages' marches stop at slightly different points inside the
    convergence ball (their CPU BLAS sum in other orders), so the bar is
    looser than on a fixed trace: cos >= 0.999, relative L2 <= 3e-2
    (measured here: cos > 0.9999, relative L2 < 1e-2)."""
    kw = dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,))
    params, z0 = fit_decoder_to_sdf(lambda p: sphere_sdf(0.5)(None, p),
                                    JDecoderConfig(**kw), steps=300, batch=2048)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(5)
    proxy = {"layers": [
        {"w": l["w"] + 2e-3 * rng.standard_normal(l["w"].shape).astype(np.float32),
         "b": l["b"]} for l in params["layers"]]}
    z = np.asarray(z0) + 0.05 * rng.standard_normal(8).astype(np.float32)
    march = dict(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                 coarse_to_fine=True, c2f_strides=(16, 4), c2f_coarse_steps=16)
    grad = dict(mode="ift", compact_frac=4, compact_min=16, recompute="pallas")
    jcfg = JRenderConfig(img_h=IMG, img_w=IMG, march=JMarchConfig(**march),
                         grad=JGradConfig(**grad), compute_dtype="bfloat16",
                         use_pallas=True)
    tcfg = RenderConfig(img_h=IMG, img_w=IMG, march=MarchConfig(**march),
                        grad=GradConfig(**grad), compute_dtype="bfloat16",
                        use_pallas=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jfac = jmake_factory(jp, JDecoderConfig(**kw), jcfg,
                         march_params=jax.tree_util.tree_map(jnp.asarray, proxy),
                         march_dcfg=JDecoderConfig(**kw))
    jsdf = jmake_precise_sdf(jp, JDecoderConfig(**kw))
    cam = jcam.Camera.looking_at((0.0, 0.0, -2.0), focal=IMG * 1.2, img_hw=(IMG, IMG))
    pose = np.asarray(jcam.pose_from_camera(cam))
    gt = jrender(jsdf, jnp.asarray(z0), cam, jcfg, jfac)
    d = {"depth": np.asarray(gt.depth).ravel(), "hit": np.asarray(gt.mask).ravel()}
    obs = _observation(d)

    def jloss(zz, pp):
        out = jrender(jsdf, zz, jcam.camera_from_pose(pp, cam.K), jcfg, jfac)
        flat = out._replace(depth=out.depth.ravel(), mask=out.mask.ravel(),
                            min_sdf=out.min_sdf.ravel())
        return _objective(JL, jnp.where, flat, zz, tuple(map(jnp.asarray, obs)))

    jgz, jgp = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(z), jnp.asarray(pose))

    tp = params_from_numpy(params)
    tfac = make_march_factory(tp, DecoderConfig(**kw), tcfg,
                              march_params=params_from_numpy(proxy),
                              march_dcfg=DecoderConfig(**kw))
    zt = torch.tensor(z, requires_grad=True)
    pt = torch.tensor(pose, requires_grad=True)
    out = render(make_precise_sdf(tp, DecoderConfig(**kw)), zt,
                 tcam.camera_from_pose(pt, torch.as_tensor(np.asarray(cam.K))),
                 tcfg, tfac)
    flat = out._replace(depth=out.depth.ravel(), mask=out.mask.ravel(),
                        min_sdf=out.min_sdf.ravel())
    gz, gp = torch.autograd.grad(
        _objective(L, torch.where, flat, zt, tuple(map(torch.as_tensor, obs))),
        (zt, pt))
    for a, b in ((gz.numpy(), jgz), (gp.numpy(), jgp)):
        assert np.all(np.isfinite(a)) and np.linalg.norm(b) > 0
        assert _cos(a, b) >= 0.999 and _rel(a, b) <= 3e-2, (_cos(a, b), _rel(a, b))


def test_sdf_renderer_passes_gradients_to_latent_and_pose():
    """SDFRenderer.render(latent, R, T) gives render()'s gradients to all
    three when they require grad, and builds no graph when none does."""
    kw = dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,))
    params, z0 = fit_decoder_to_sdf(lambda p: sphere_sdf(0.5)(None, p),
                                    JDecoderConfig(**kw), steps=150, batch=1024)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    dcfg = DecoderConfig(**kw)
    cfg = RenderConfig(img_h=IMG, img_w=IMG, use_pallas=True, compute_dtype="bfloat16",
                       march=MarchConfig(max_steps=50, convergence_eps=2e-3,
                                         depth_eps=5e-4, coarse_to_fine=True,
                                         c2f_strides=(16, 4), c2f_coarse_steps=16),
                       grad=GradConfig(mode="ift", compact_frac=4, compact_min=16))
    cam = tcam.Camera.looking_at((0.0, 0.0, -2.0), focal=IMG * 1.2, img_hw=(IMG, IMG))
    r = SDFRenderer(tp, cam.K, (IMG, IMG), decoder_cfg=dcfg, cfg=cfg)
    loss = lambda out: (L.masked_l1(out.depth, 1.5, out.mask)
                        + L.silhouette_loss(out.min_sdf, out.mask))
    leaves = [torch.tensor(np.asarray(z0), requires_grad=True),
              cam.R.clone().requires_grad_(), cam.T.clone().requires_grad_()]
    g_r = torch.autograd.grad(loss(r.render(*leaves)), leaves)
    leaves2 = [x.detach().clone().requires_grad_() for x in leaves]
    out = render(make_precise_sdf(tp, dcfg), leaves2[0],
                 tcam.Camera(K=cam.K, R=leaves2[1], T=leaves2[2]), r.cfg,
                 make_march_factory(tp, dcfg, r.cfg))
    g_f = torch.autograd.grad(loss(out), leaves2)
    for a, b in zip(g_r, g_f):
        assert torch.isfinite(a).all() and a.abs().sum() > 0
        assert torch.equal(a, b)
    plain = r.render(*(x.detach() for x in leaves))
    assert all(t.grad_fn is None for t in (plain.depth, plain.min_sdf, plain.points))
