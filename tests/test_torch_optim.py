"""The port's pose helpers, losses and fit harness against the JAX
package's, on the CPU, with inputs from numpy seeds; and a small
decoder's depth-completion fit through the port's render(). Each test
states its tolerance."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import OptimConfig as JOptimConfig
from dist_renderer_tpu.models.analytic import sphere_sdf
from dist_renderer_tpu.models.pretrain import fit_decoder_to_sdf
from dist_renderer_tpu.ops import camera as jcam
from dist_renderer_tpu.utils import losses as JL
from dist_renderer_tpu.utils.optim import fit as jfit
from dist_renderer_tpu_torch.config import (
    DecoderConfig, GradConfig, MarchConfig, OptimConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf, params_from_numpy
from dist_renderer_tpu_torch.ops import camera as tcam
from dist_renderer_tpu_torch.ops.renderer import make_march_factory, render
from dist_renderer_tpu_torch.utils import losses as L
from dist_renderer_tpu_torch.utils.optim import fit, make_optimizer

T = lambda x: torch.as_tensor(np.asarray(x))


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the fit test runs many small ops, which the
    default intra-op threads slowed 15-fold under pytest workers sharing
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _axis_angles():
    """Axis-angle vectors from a seed: generic, tiny (theta -> 0) and
    near pi (theta = pi - 1e-3, and pi - 1e-6)."""
    rng = np.random.default_rng(0)
    axes = rng.standard_normal((4, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ws = [0.7 * axes[0], 2.1 * axes[1], 1e-8 * axes[2], 1e-4 * axes[3],
          (math.pi - 1e-3) * axes[1], (math.pi - 1e-6) * axes[2]]
    return [w.astype(np.float32) for w in ws]


@pytest.mark.parametrize("i", range(6), ids=["generic", "large", "1e-8", "1e-4",
                                              "pi-1e-3", "pi-1e-6"])
def test_so3_exp_and_log_match_jax(i):
    """so3_exp and so3_log against JAX's to 1e-6, and the round trip
    so3_log(so3_exp(w)) = w to 1e-3 near pi (where theta = acos of a
    trace loses precision in fp32) and 1e-6 elsewhere."""
    w = _axis_angles()[i]
    R, jR = tcam.so3_exp(T(w)), jcam.so3_exp(jnp.asarray(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-6)
    back, jback = tcam.so3_log(R), jcam.so3_log(jR)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), atol=1e-6)
    tol = 1e-3 if i >= 4 else 1e-6
    np.testing.assert_allclose(back.numpy(), w, atol=tol)
    np.testing.assert_allclose(R.numpy() @ R.numpy().T, np.eye(3), atol=1e-6)


def test_so3_gradients_match_jax():
    """Autograd through so3_exp and so3_log against jax.grad, to 1e-5."""
    rng = np.random.default_rng(1)
    wgt = rng.standard_normal((3, 3)).astype(np.float32)
    for w in _axis_angles()[:2]:
        wt = T(w).requires_grad_()
        g, = torch.autograd.grad((tcam.so3_exp(wt) * T(wgt)).sum(), wt)
        jg = jax.grad(lambda v: jnp.sum(jcam.so3_exp(v) * wgt))(jnp.asarray(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
        R = tcam.so3_exp(T(w)).detach().requires_grad_()
        g, = torch.autograd.grad((tcam.so3_log(R) * T(wgt[0])).sum(), R)
        jg = jax.grad(lambda m: jnp.sum(jcam.so3_log(m) * wgt[0]))(
            jnp.asarray(R.detach().numpy()))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)


def test_rot6d_and_poses_match_jax():
    """rot6d_to_matrix, matrix_to_rot6d, camera_from_pose and
    pose_from_camera (both parameterizations) against JAX's to 1e-6, and
    their round trips."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(6).astype(np.float32)
    R = tcam.rot6d_to_matrix(T(x))
    np.testing.assert_allclose(R.numpy(), np.asarray(jcam.rot6d_to_matrix(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(tcam.rot6d_to_matrix(tcam.matrix_to_rot6d(R)).numpy(),
                               R.numpy(), atol=1e-6)
    cam = tcam.Camera.looking_at((0.4, -0.3, -2.2), focal=40.0, img_hw=(32, 32))
    jc = jcam.Camera.looking_at((0.4, -0.3, -2.2), focal=40.0, img_hw=(32, 32))
    for param in ("so3", "rot6d"):
        pose = tcam.pose_from_camera(cam, param)
        np.testing.assert_allclose(pose.numpy(), np.asarray(jcam.pose_from_camera(jc, param)),
                                   atol=1e-6)
        c2 = tcam.camera_from_pose(pose, cam.K, param)
        jc2 = jcam.camera_from_pose(jnp.asarray(pose.numpy()), jc.K, param)
        for a, b, ref in zip(c2, jc2, cam):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
            np.testing.assert_allclose(a.numpy(), ref.numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        tcam.camera_from_pose(pose, cam.K, "quaternion")


def test_project_matches_jax_and_inverts_pixel_rays():
    """project against JAX's to 1e-4 px (values up to ~40 px) and 1e-6 in
    z; points on the pixel rays project back to their pixels; the pose
    gradient of a projection equals jax.grad's to 1e-4 relative."""
    cam = tcam.Camera.looking_at((0.5, 0.2, -2.0), focal=40.0, img_hw=(24, 32))
    jc = jcam.Camera.looking_at((0.5, 0.2, -2.0), focal=40.0, img_hw=(24, 32))
    o, v = tcam.pixel_rays(cam, 24, 32)
    d = torch.as_tensor(np.random.default_rng(3).uniform(1.0, 3.0, (o.shape[0], 1)),
                        dtype=torch.float32)
    pts = o + d * v
    uv, z = tcam.project(cam, pts)
    juv, jz = jcam.project(jc, jnp.asarray(pts.numpy()))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6)
    ys, xs = np.mgrid[0:24, 0:32]
    np.testing.assert_allclose(uv.numpy(), np.stack([xs, ys], -1).reshape(-1, 2),
                               atol=2e-3)

    pose = tcam.pose_from_camera(cam).requires_grad_()
    g, = torch.autograd.grad(tcam.project(tcam.camera_from_pose(pose, cam.K), pts)[0].sum(),
                             pose)
    jg = jax.grad(lambda p: jnp.sum(jcam.project(jcam.camera_from_pose(p, jc.K),
                                                 jnp.asarray(pts.numpy()))[0]))(
        jnp.asarray(pose.detach().numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-3)


def _loss_inputs():
    rng = np.random.default_rng(4)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(pred=f32(16, 16), target=f32(16, 16), mask=rng.random((16, 16)) < 0.6,
                other=rng.random((16, 16)) < 0.5, min_sdf=0.1 * f32(16, 16),
                z=f32(64), img=rng.random((12, 14, 3)).astype(np.float32),
                uv=(rng.uniform(-2, 16, (50, 2))).astype(np.float32),
                normal=f32(40, 3), obs_normal=f32(40, 3), nmask=rng.random(40) < 0.7)


LOSSES = {
    "masked_l1": lambda lib, a: lib.masked_l1(a["pred"], a["target"], a["mask"]),
    "masked_l1 empty": lambda lib, a: lib.masked_l1(a["pred"], a["target"],
                                                   a["mask"] & ~a["mask"]),
    "masked_l2": lambda lib, a: lib.masked_l2(a["pred"], a["target"], a["mask"]),
    "depth_loss": lambda lib, a: lib.depth_loss(a["pred"], a["target"], a["mask"]),
    "depth_loss pred_mask": lambda lib, a: lib.depth_loss(a["pred"], a["target"],
                                                         a["mask"], a["other"]),
    "silhouette_loss": lambda lib, a: lib.silhouette_loss(a["min_sdf"], a["mask"]),
    "silhouette_loss margin": lambda lib, a: lib.silhouette_loss(a["min_sdf"], a["mask"],
                                                                 0.05),
    "latent_reg": lambda lib, a: lib.latent_reg(a["z"]),
    "bilinear_sample": lambda lib, a: lib.bilinear_sample(a["img"], a["uv"]).sum(),
    "normal_loss": lambda lib, a: lib.normal_loss(a["normal"], a["obs_normal"],
                                                  a["nmask"]),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_match_jax(name):
    """Each loss against JAX's to 1e-6 (relative), and its gradient to
    the first float input to 1e-6."""
    a = _loss_inputs()
    fn = LOSSES[name]
    j = fn(JL, {k: jnp.asarray(v) for k, v in a.items()})
    ta = {k: T(v) for k, v in a.items()}
    first = next(k for k in ("pred", "min_sdf", "z", "img", "normal") if k in _uses(name))
    ta[first].requires_grad_()
    t = fn(L, ta)
    np.testing.assert_allclose(t.item(), float(j), rtol=1e-6, atol=1e-7)
    g, = torch.autograd.grad(t, ta[first])
    jg = jax.grad(lambda x: fn(JL, {**{k: jnp.asarray(v) for k, v in a.items()},
                                    first: x}))(jnp.asarray(a[first]))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


def _uses(name):
    return {"silhouette_loss": ("min_sdf",), "silhouette_loss margin": ("min_sdf",),
            "latent_reg": ("z",), "bilinear_sample": ("img",),
            "normal_loss": ("normal",)}.get(name, ("pred",))


def test_photometric_loss_matches_jax():
    """Two views of a random textured plane's points: the loss and its
    gradient to the points against JAX's, relative 1e-5."""
    rng = np.random.default_rng(5)
    cam_i = tcam.Camera.looking_at((0.0, 0.0, -2.0), focal=20.0, img_hw=(16, 16))
    cam_j = tcam.Camera.looking_at((0.4, 0.1, -1.9), focal=20.0, img_hw=(16, 16))
    jci = jcam.Camera.looking_at((0.0, 0.0, -2.0), focal=20.0, img_hw=(16, 16))
    jcj = jcam.Camera.looking_at((0.4, 0.1, -1.9), focal=20.0, img_hw=(16, 16))
    pts = np.concatenate([rng.uniform(-0.5, 0.5, (60, 2)), rng.uniform(-0.1, 0.1, (60, 1))],
                         1).astype(np.float32)
    hit = rng.random(60) < 0.8
    img_i, img_j = (rng.random((16, 16, 3)).astype(np.float32) for _ in range(2))
    p = T(pts).requires_grad_()
    t = L.photometric_loss(p, T(hit), T(img_i), cam_i, T(img_j), cam_j)
    g, = torch.autograd.grad(t, p)
    jl = lambda x: JL.photometric_loss(x, jnp.asarray(hit), jnp.asarray(img_i), jci,
                                       jnp.asarray(img_j), jcj)
    np.testing.assert_allclose(t.item(), float(jl(jnp.asarray(pts))), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jl)(jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-5)
    assert t.item() > 0


def _quadratic_cfgs():
    kw = dict(lr=0.1, steps=25, lr_decay_steps=10, lr_decay_rate=0.5, checkpoint_every=0)
    return JOptimConfig(**kw), OptimConfig(**kw)


@pytest.mark.parametrize("kind", ["tensor", "tuple", "dict"])
def test_fit_matches_jax_on_a_quadratic(kind):
    """fit against the JAX package's fit on sum((v - c)^2) over 25 Adam
    steps with the learning rate halved at steps 10 and 20, for a tensor,
    a tuple and a dict of variables: equal loss histories and final
    variables to 1e-6 relative against JAX's fit run in fp64. Against
    JAX's fit in fp32 they differ by up to 1.5e-5 relative (bar 1e-4):
    optax takes Adam's bias correction 1 - 0.999^t in fp32, where 0.999
    is not exact (1.3e-5 relative at t = 1); torch.optim.Adam takes it in
    double precision and stays within 2e-7 of an fp64 Adam."""
    c = np.linspace(-1.0, 3.0, 4)
    jcfg, tcfg = _quadratic_cfgs()
    wrap = {"tensor": lambda a, b: a, "tuple": lambda a, b: (a, b),
            "dict": lambda a, b: {"a": a, "b": b}}[kind]
    parts = lambda v: ((v,) if kind == "tensor" else
                       tuple(v) if kind == "tuple" else (v["a"], v["b"]))

    def loss(lib, cc):
        def f(v):
            l = sum(lib.sum((x - cc[:x.shape[0]]) ** 2) for x in parts(v))
            return l, {"l": l}
        return f

    tr = fit(loss(torch, T(c.astype(np.float32))), wrap(torch.zeros(4), torch.zeros(2)),
             tcfg)
    with jax.enable_x64(True):
        z64 = lambda k: jnp.zeros(k, jnp.float64)
        j64 = jfit(loss(jnp, jnp.asarray(c)), wrap(z64(4), z64(2)), jcfg)
        h64 = np.asarray(j64.loss_history)
        v64 = [np.asarray(x) for x in parts(j64.variables)]
    j32 = jfit(loss(jnp, jnp.asarray(c, jnp.float32)), wrap(jnp.zeros(4), jnp.zeros(2)),
               jcfg)
    assert h64.dtype == np.float64 and tr.loss_history.dtype == torch.float32
    np.testing.assert_allclose(tr.loss_history.numpy(), h64, rtol=1e-6)
    for a, b in zip(parts(tr.variables), v64):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tr.loss_history.numpy(), np.asarray(j32.loss_history),
                               rtol=1e-4)
    assert type(tr.variables) is type(wrap(torch.zeros(1), None))
    assert tr.loss_history.shape == (25,)
    assert float(tr.metrics["l"]) < 0.25 * float(tr.loss_history[0])


def test_fit_schedule_carry_callback_and_checkpoint(tmp_path):
    """The staircase schedule (lr * rate ** floor(step / decay_steps)), a
    carry threaded through the loop, the callback's arguments, and the
    checkpoint option: a run stopped after 3 steps and resumed from its
    checkpoint equals an uninterrupted run bit for bit (variables, the
    resumed steps' losses), the lr schedule crossing a decay step inside
    the resumed part, and the carry restarting from carry_init."""
    _, cfg = _quadratic_cfgs()
    opt, sched = make_optimizer([torch.zeros(2, requires_grad=True)], cfg)
    lrs = []
    for _ in range(25):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [0.1 * 0.5 ** (k // 10) for k in range(25)], rtol=1e-12)

    seen, steps = [], []

    def loss_fn(v, carry):
        seen.append(carry)
        l = torch.sum(v ** 2)
        return l, {"carry": carry + 1, "l": l}

    r = fit(loss_fn, torch.ones(3), OptimConfig(lr=0.1, steps=4), carry_init=0,
            callback=lambda k, v, l: steps.append((k, v.requires_grad, l)))
    assert seen == [0, 1, 2, 3] and "carry" not in r.metrics
    assert [s[0] for s in steps] == [0, 1, 2, 3] and not any(s[1] for s in steps)
    assert steps[0][2] == pytest.approx(3.0)
    def wavy(v, carry):
        l = torch.sum((v - torch.arange(3.0)) ** 2) + torch.sum(torch.sin(3 * v))
        return l, {"carry": carry + 1}

    kw = dict(lr=0.1, lr_decay_steps=4, lr_decay_rate=0.5, checkpoint_every=3)
    whole = fit(wavy, torch.ones(3), OptimConfig(steps=6, **kw), carry_init=0)
    ckpt = str(tmp_path / "ckpt")
    first = fit(wavy, torch.ones(3), OptimConfig(steps=3, **kw), checkpoint_dir=ckpt,
                carry_init=0)
    seen.clear()
    rest = fit(lambda v, c: (seen.append(c), wavy(v, c))[1], torch.ones(3),
               OptimConfig(steps=6, **kw), checkpoint_dir=ckpt, carry_init=0)
    assert seen == [0, 1, 2]
    assert torch.equal(rest.variables, whole.variables)
    assert torch.equal(torch.cat([first.loss_history, rest.loss_history]),
                       whole.loss_history)
    assert sorted(os.listdir(ckpt)) == ["step_3.pt", "step_6.pt"]
    done = fit(wavy, torch.ones(3), OptimConfig(steps=6, **kw), checkpoint_dir=ckpt,
               carry_init=0)
    assert done.loss_history.shape == (0,) and torch.equal(done.variables, whole.variables)


def test_depth_completion_fit_lowers_its_objective():
    """tasks/depth_completion.py's objective (10 depth + 1 silhouette +
    1e-4 latent prior, the left half of the columns observed) through the
    port's render() of a small fitted decoder at 32x32, from a jittered
    latent (+ 0.5 N(0, 1) from a seed): 20 Adam steps of fit with the
    OptimConfig defaults (lr 1e-2) at least halve the objective (measured
    0.0713 -> 0.0180), and every loss is finite."""
    kw = dict(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,))
    params, z0 = fit_decoder_to_sdf(lambda p: sphere_sdf(0.5)(None, p),
                                    JDecoderConfig(**kw), steps=150, batch=1024)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    dcfg = DecoderConfig(**kw)
    img = 32
    cfg = RenderConfig(img_h=img, img_w=img, use_pallas=True, compute_dtype="bfloat16",
                       march=MarchConfig(max_steps=50, convergence_eps=2e-3,
                                         depth_eps=5e-4, coarse_to_fine=True,
                                         c2f_strides=(16, 4), c2f_coarse_steps=16),
                       grad=GradConfig(mode="ift", compact_frac=4, compact_min=16))
    sdf, fac = make_precise_sdf(tp, dcfg), make_march_factory(tp, dcfg, cfg)
    cam = tcam.Camera.looking_at((0.0, 0.0, -2.0), focal=img * 1.2, img_hw=(img, img))
    z_true = torch.as_tensor(np.asarray(z0))
    truth = render(sdf, z_true, cam, cfg, fac)
    cols = (torch.arange(img) < img // 2)[None, :]
    valid = truth.mask & cols
    obs = torch.where(valid, truth.depth, torch.zeros_like(truth.depth))

    def loss_fn(z):
        out = render(sdf, z, cam, cfg, fac)
        l = (10.0 * L.depth_loss(out.depth, obs, valid, out.mask)
             + L.silhouette_loss(torch.where(cols, out.min_sdf, 0.0 * out.min_sdf), valid)
             + 1e-4 * L.latent_reg(z))
        return l, {}

    z_start = z_true + 0.5 * torch.as_tensor(
        np.random.default_rng(6).standard_normal(8), dtype=torch.float32)
    res = fit(loss_fn, z_start, OptimConfig(steps=20))
    hist = res.loss_history.numpy()
    assert np.all(np.isfinite(hist))
    assert float(loss_fn(res.variables)[0]) < 0.5 * hist[0], hist
