"""The port's evaluation family against the JAX package on the CPU: the
SDF grid and marching tetrahedra (eval/mesh.py), mesh extraction through
K5's plain version, the chamfer distance and surface sampling
(eval/chamfer.py), the analytic SDFs (models/analytic.py) and the color
renderer (render_color_rays, SDFRendererColor). Inputs from numpy seeds;
grids of at most 32^3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import MarchConfig as JMarchConfig
from dist_renderer_tpu.config import RenderConfig as JRenderConfig
from dist_renderer_tpu.eval import chamfer as jchamfer
from dist_renderer_tpu.eval import mesh as jmesh
from dist_renderer_tpu.models import analytic as janalytic
from dist_renderer_tpu.models.color_decoder import color_apply as jcolor_apply
from dist_renderer_tpu.models.color_decoder import init_color_params as jinit_color
from dist_renderer_tpu.models.color_decoder import make_color_config as jcolor_config
from dist_renderer_tpu.ops.camera import Camera as JCamera
from dist_renderer_tpu.ops.camera import pixel_rays as jpixel_rays
from dist_renderer_tpu.ops.renderer import render_color_rays as jrender_color_rays
from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig, RenderConfig
from dist_renderer_tpu_torch.eval import chamfer, mesh
from dist_renderer_tpu_torch.models import analytic
from dist_renderer_tpu_torch.models.color_decoder import color_apply, make_color_config
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.kernels.mlp_eval import make_pallas_point_fn
from dist_renderer_tpu_torch.ops.kernels.recompute import make_color_vjp
from dist_renderer_tpu_torch.ops.renderer import (
    SDFRenderer, SDFRendererColor, render_color_rays,
)
from dist_renderer_tpu_torch.tasks.common import analytic_shape
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

CPU = torch.device("cpu")


def _torus_pair():
    return (lambda p: analytic.torus_sdf(0.55, 0.2)(None, p),
            lambda p: janalytic.torus_sdf(0.55, 0.2)(None, p))


def test_sdf_grid_matches_jax():
    """The grid made on the device, a slab per call, against the JAX
    package's one-dispatch grid on an analytic torus: atol 1e-6."""
    fn, jfn = _torus_pair()
    calls = []
    g = mesh.sdf_grid(lambda p: calls.append(p.shape) or fn(p), resolution=24,
                      device=CPU)
    ref = jmesh.sdf_grid(jfn, resolution=24, bound=1.0)
    assert g.shape == (24, 24, 24) and g.dtype == np.float32
    assert calls == [(24 * 24, 3)] * 24  # one x-slab of R^2 points per call
    np.testing.assert_allclose(g, ref, atol=1e-6)


def test_default_device_needs_a_card_or_the_cpu_named(monkeypatch):
    """Without a card the eval entry points raise unless the caller names
    the CPU (device="cpu"): nothing falls back to the CPU unasked."""
    fn, _ = _torus_pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device="):
        mesh.default_device()
    with pytest.raises(RuntimeError, match="device="):
        mesh.sdf_grid(fn, resolution=4)
    with pytest.raises(RuntimeError, match="device="):
        chamfer.sample_surface_points(fn, 16)
    assert mesh.sdf_grid(fn, resolution=4, device="cpu").shape == (4, 4, 4)


def test_analytic_renderer_needs_a_card_or_the_cpu_named(monkeypatch):
    """SDFRenderer with an analytic sdf_fn and no decoder weights takes the
    card as eval's entry points do: without one it raises unless the
    caller names the CPU (device="cpu"), and then renders there."""
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=20.0, img_hw=(8, 8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device="):
        SDFRenderer(None, cam.K, img_hw=(8, 8), sdf_fn=analytic.latent_sphere_sdf())
    r = SDFRenderer(None, cam.K, img_hw=(8, 8), sdf_fn=analytic.latent_sphere_sdf(),
                    cfg=RenderConfig(march=MarchConfig(max_steps=16)), device="cpu")
    assert r.device == CPU
    assert r.render_depth(torch.tensor([0.5]), cam.R, cam.T).device == CPU


def test_marching_tetrahedra_matches_jax():
    """The same numpy grid gives the same vertices and faces, in numpy and
    through the native kernels where they load (the same library)."""
    _, jfn = _torus_pair()
    grid = np.asarray(jmesh.sdf_grid(jfn, resolution=20))
    v, f = mesh.marching_tetrahedra(grid)
    jv, jf = jmesh.marching_tetrahedra(grid)
    assert len(v) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    v2, f2, route = mesh.assemble_mesh(grid)
    from dist_renderer_tpu.eval.native import marching_tetrahedra_native

    native = marching_tetrahedra_native(grid)
    if route == "native":
        np.testing.assert_array_equal(v2, native[0])
        np.testing.assert_array_equal(f2, native[1])
    else:
        assert native is None and route == "numpy"
        np.testing.assert_array_equal(v2, v)


def test_extract_mesh_through_k5_plain_version():
    """tests/test_mlp_eval.py's check on the port: a small decoder fitted
    to a sphere of radius 0.6 (the JAX package's fit, weights carried
    over), its mesh extracted through make_pallas_point_fn at 32^3:
    median vertex radius within 0.05 of 0.6."""
    from dist_renderer_tpu.models.pretrain import fit_decoder_to_sdf

    jcfg = JDecoderConfig(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))
    jp, z0 = fit_decoder_to_sdf(lambda p: janalytic.sphere_sdf(0.6)(None, p), jcfg,
                                steps=300, batch=1024)
    cfg = DecoderConfig(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))
    fn = make_pallas_point_fn(params_from_numpy(jp), torch.tensor(np.asarray(z0)), cfg)
    verts, faces = mesh.extract_mesh(fn, resolution=32, device=CPU)
    assert len(verts) > 100 and len(faces) > 100
    r = np.linalg.norm(verts, axis=-1)
    assert abs(np.median(r) - 0.6) < 0.05


def test_chamfer_distance_matches_jax():
    """Mean squared distances within 1e-6 relative (measured 1.9e-7: the
    two BLAS sum the 3-wide cross term differently, and the expansion
    |a|^2 - 2ab + |b|^2 cancels to ~3e-4 with ~3e-7 absolute error); the
    euclidean means within 1e-5 (measured 5.8e-6: the square root doubles
    the relative error of each small squared distance)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    b = (a[:1200] + 0.01 * rng.standard_normal((1200, 3))).astype(np.float32)
    for squared, rel in ((True, 1e-6), (False, 1e-5)):
        out = chamfer.chamfer_distance(torch.tensor(a), torch.tensor(b), squared)
        ref = jchamfer.chamfer_distance(jnp.asarray(a), jnp.asarray(b), squared)
        for o, r in zip(out, ref):
            assert abs(float(o) - float(r)) <= rel * abs(float(r)), (float(o), float(r))


def test_sample_surface_points_land_in_the_band():
    """Every returned point lies within keep_band of the zero set, on the
    device asked for; the draws follow the generator."""
    fn, _ = _torus_pair()
    gen = lambda: torch.Generator().manual_seed(5)
    p = chamfer.sample_surface_points(fn, 2000, gen(), keep_band=1e-3, device=CPU)
    assert p.shape == (2000, 3) and p.device == CPU
    assert bool((fn(p).abs() < 1e-3).all())
    assert torch.equal(p, chamfer.sample_surface_points(fn, 2000, gen(), device=CPU))
    # two spheres 0.1 apart: the chamfer of their surfaces is small, not 0
    c = chamfer.chamfer_vs_analytic(lambda q: analytic.sphere_sdf(0.5)(None, q),
                                    lambda q: analytic.sphere_sdf(0.6)(None, q),
                                    n=2000, device=CPU)
    assert 0.01 < c < 0.03  # 2 x 0.1^2 plus the samples' spacing


def test_analytic_sdfs_match_jax():
    pts = np.random.default_rng(1).uniform(-1, 1, (500, 3)).astype(np.float32)
    lat = np.array([0.45, 0.0], np.float32)
    pairs = [(analytic.sphere_sdf(0.5, (0.1, 0.0, -0.2)), janalytic.sphere_sdf(0.5, (0.1, 0.0, -0.2))),
             (analytic.box_sdf(), janalytic.box_sdf()),
             (analytic.torus_sdf(), janalytic.torus_sdf()),
             (analytic.latent_sphere_sdf(), janalytic.latent_sphere_sdf())]
    pairs += [(analytic_shape(k), None) for k in ("sphere", "torus", "union")]
    from dist_renderer_tpu.tasks.common import analytic_shape as janalytic_shape

    for (f, jf), key in zip(pairs, [None] * 4 + ["sphere", "torus", "union"]):
        jf = jf or janalytic_shape(key)
        out = f(torch.tensor(lat), torch.tensor(pts)).numpy()
        ref = np.asarray(jf(jnp.asarray(lat), jnp.asarray(pts)))
        np.testing.assert_allclose(out, ref, atol=1e-6)
    o = np.tile(np.array([[0.0, 0.0, -2.0]], np.float32), (50, 1))
    v = np.random.default_rng(2).normal([0, 0, 1], 0.2, (50, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    d = analytic.analytic_sphere_depth(torch.tensor(o), torch.tensor(v), 0.5).numpy()
    np.testing.assert_allclose(d, np.asarray(janalytic.analytic_sphere_depth(
        jnp.asarray(o), jnp.asarray(v), 0.5)), atol=1e-6)
    assert (d > 0).any() and (d == -1.0).any()


def _color_scene():
    kw = dict(latent_size=4, hidden_dims=(16,) * 3, latent_in=())
    jp = jinit_color(jax.random.PRNGKey(0), jcolor_config(**kw))
    jcam = JCamera.looking_at((0.0, 0.0, -2.0), focal=20.0, img_hw=(16, 16))
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=20.0, img_hw=(16, 16))
    return jp, make_color_config(**kw), jcam, cam


def test_render_color_rays_matches_jax():
    """The textured render on a 16x16 sphere against the JAX package's
    (tests/test_train_color.py's scene): misses exactly 0, RGB in [0, 1]
    and spatially varying, depth p95 <= 1e-3 on common hits; then the
    SDFRendererColor wrapper's image."""
    jp, ccfg, jcam, cam = _color_scene()
    params = params_from_numpy(jp)
    color_fn = lambda zc, p: color_apply(params, zc, p, ccfg)
    cfg = RenderConfig(img_h=16, img_w=16, march=MarchConfig(max_steps=40))
    o, v = pixel_rays(cam, 16, 16)
    out, rgb = render_color_rays(analytic.latent_sphere_sdf(), color_fn,
                                 torch.tensor([0.5]), torch.zeros(4), o, v, cfg)
    jo, jv = jpixel_rays(jcam, 16, 16)
    jout, jrgb = jrender_color_rays(
        janalytic.latent_sphere_sdf(), lambda zc, p: jcolor_apply(jp, zc, p, jcolor_config(
            latent_size=4, hidden_dims=(16,) * 3, latent_in=())),
        jnp.array([0.5]), jnp.zeros(4), jo, jv,
        JRenderConfig(img_h=16, img_w=16, march=JMarchConfig(max_steps=40)))
    m, jm = out.mask.numpy(), np.asarray(jout.mask)
    rgb = rgb.numpy()
    assert rgb.shape == (256, 3)
    assert (rgb[~m] == 0).all()
    assert rgb[m].min() >= 0.0 and rgb[m].max() <= 1.0 and rgb[m].std() > 0
    assert (m == jm).mean() >= 0.99 and m.sum() > 50
    both = m & jm
    derr = np.abs(out.depth.numpy() - np.asarray(jout.depth))[both]
    assert np.quantile(derr, 0.95) <= 1e-3
    cerr = np.abs(rgb - np.asarray(jrgb))[both]
    assert np.quantile(cerr, 0.95) <= 1e-3

    r = SDFRenderer(None, cam.K, img_hw=(16, 16), sdf_fn=analytic.latent_sphere_sdf(),
                    cfg=cfg, device="cpu")
    out2, img = SDFRendererColor(r, color_fn).render_color(
        torch.tensor([0.5]), torch.zeros(4), cam.R, cam.T)
    assert img.shape == (16, 16, 3)
    np.testing.assert_array_equal(img.reshape(-1, 3).numpy(), rgb)


def test_color_vjp_gradient_reaches_the_geometry():
    """A photometric-style loss on SDFRendererColor with the differentiable
    color head (K5 forward, K4 backward) reaches the shape latent through
    the surface points: finite, nonzero, and the gradient of the fp32
    color decoder's autograd (test_train_color.py's check, JAX's sign)."""
    jp, ccfg, jcam, cam = _color_scene()
    params = params_from_numpy(jp)
    cfg = RenderConfig(img_h=16, img_w=16, march=MarchConfig(max_steps=40))
    r = SDFRenderer(None, cam.K, img_hw=(16, 16), sdf_fn=analytic.latent_sphere_sdf(),
                    cfg=cfg, device="cpu")

    def grad_r(color_fn):
        z = torch.tensor([0.5], requires_grad=True)
        zc = torch.zeros(4, requires_grad=True)
        _, img = SDFRendererColor(r, color_fn).render_color(z, zc, cam.R, cam.T)
        return torch.autograd.grad(img.sum(), (z, zc))

    gz, gc = grad_r(make_color_vjp(params, ccfg))
    gz_ref, gc_ref = grad_r(lambda zc, p: color_apply(params, zc, p, ccfg))
    assert torch.isfinite(gz).all() and float(gz.abs().sum()) > 0
    # bf16 forward against fp32 autograd: the bf16 chain's tolerance
    assert abs(float(gz[0] - gz_ref[0])) <= 0.1 * abs(float(gz_ref[0]))
    assert float(torch.nn.functional.cosine_similarity(gc, gc_ref, dim=0)) > 0.99
