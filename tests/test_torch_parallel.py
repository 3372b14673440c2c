"""The port's parallel/ on 8 gloo ranks on the CPU against the JAX
package's parallel/ on tests/conftest.py's fake 8-device mesh (Pallas in
interpret mode; the port's plain versions): the cases of
tests/test_parallel.py and tests/test_parallel_batched.py.

One module-scoped group of 8 spawned ranks (file rendezvous) runs every
port case; the JAX side runs here. Bars: JAX's own. The frame and view
renders within 1e-5, masks equal; the batched sharded render under
test_parallel_batched.py's cross-layout contract against the port's
single-device render (as JAX's sharded render against JAX's), and under
tests/test_torch_batched.py's bars between the packages against JAX's
sharded render; the fit step
halves its loss and follows JAX's first 3 steps within 1e-4 (optax's
fp32 Adam bias correction and torch's differ at ~1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import LossConfig as JLossConfig
from dist_renderer_tpu.config import MarchConfig as JMarchConfig
from dist_renderer_tpu.config import RenderConfig as JRenderConfig
from dist_renderer_tpu.models.analytic import latent_sphere_sdf as jlatent_sphere_sdf
from dist_renderer_tpu.models.analytic import torus_sdf as jtorus_sdf
from dist_renderer_tpu.models.folded import fold_latent as jfold_latent
from dist_renderer_tpu.models.pretrain import fit_decoder_to_sdf as jfit_decoder
from dist_renderer_tpu.ops.camera import Camera as JCamera
from dist_renderer_tpu.ops.camera import pixel_rays as jpixel_rays
from dist_renderer_tpu.ops.pallas.fused_march import pack_folded as jpack_folded
from dist_renderer_tpu.ops.renderer import render as jrender
from dist_renderer_tpu.parallel import sharding as jsh
from dist_renderer_tpu.parallel.mesh import make_mesh as jmake_mesh
from dist_renderer_tpu_torch.config import (
    DecoderConfig, LossConfig, MarchConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.analytic import latent_sphere_sdf
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.models.folded import fold_latent, make_point_fn
from dist_renderer_tpu_torch.ops.camera import Camera
from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f
from dist_renderer_tpu_torch.ops.kernels.fused_march import pack_folded
from dist_renderer_tpu_torch.parallel import sharding
from dist_renderer_tpu_torch.parallel.dryrun import fit_steps, run_calls
from dist_renderer_tpu_torch.parallel.mesh import check_backend, make_mesh, run_ranks
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

FRAME_MARCH = dict(max_steps=48, convergence_eps=1e-5)
BATCH_MARCH = dict(max_steps=40, convergence_eps=2e-3, depth_eps=5e-4)
DEC_KW = dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))
BATCHED = [((4,), "rounds"), ((8, 2), "rounds"), ((4,), "queue"), ((8, 2), "queue")]
TRUE_R = np.array([[0.4], [0.5], [0.6], [0.45]], np.float32)
FIT_STEPS = 25


def _frame(img, focal):
    kw = dict(focal=focal, img_hw=(img, img))
    return (JCamera.looking_at((0.0, 0.0, -2.0), **kw),
            Camera.looking_at((0.0, 0.0, -2.0), **kw))


def _view_rays(img=16):
    rays = [jpixel_rays(JCamera.looking_at((2.0 * np.cos(a), 0.5, 2.0 * np.sin(a)),
                                           focal=20.0, img_hw=(img, img)), img, img)
            for a in np.linspace(0, 2 * np.pi, 8, endpoint=False)]
    return (np.stack([np.asarray(r[0]) for r in rays]),
            np.stack([np.asarray(r[1]) for r in rays]))


def _batched_rays(img, n_frames):
    cam = JCamera.looking_at((0.0, 0.0, -2.0), focal=img * 1.2, img_hw=(img, img))
    o, v = (np.asarray(a) for a in jpixel_rays(cam, img, img))
    return (np.broadcast_to(o[None], (n_frames,) + o.shape).copy(),
            np.broadcast_to(v[None], (n_frames,) + v.shape).copy())


@functools.lru_cache(maxsize=None)
def _fit_obs(img=16):
    """tests/test_parallel.py's batch: 4 spheres' JAX renders (made once;
    the callers only read it)."""
    jcam, _ = _frame(img, 40.0)
    jcfg = JRenderConfig(img_h=img, img_w=img, march=JMarchConfig(**FRAME_MARCH))
    f = jlatent_sphere_sdf()
    depths, masks = jax.jit(jax.vmap(lambda r: (lambda o: (
        o.depth.reshape(-1), o.mask.reshape(-1)))(jrender(f, r, jcam, jcfg))))(
        jnp.asarray(TRUE_R))
    o, v = (np.asarray(a) for a in jpixel_rays(jcam, img, img))
    n = o.shape[0]
    return dict(origins=np.broadcast_to(o[None], (4, n, 3)).copy(),
                dirs=np.broadcast_to(v[None], (4, n, 3)).copy(),
                obs_depth=np.asarray(depths), obs_mask=np.asarray(masks))


@pytest.fixture(scope="module")
def torus():
    """A rough 4x32 torus decoder (JAX's fit), its latent, and 4 jittered
    latents."""
    params, z0 = jfit_decoder(lambda p: jtorus_sdf(0.55, 0.2)(None, p),
                              JDecoderConfig(**DEC_KW), steps=150, batch=512)
    params = jax.tree_util.tree_map(np.array, params)
    z0 = np.array(z0)
    lat = z0[None] + 0.02 * np.random.default_rng(3).standard_normal(
        (4, z0.shape[0])).astype(np.float32)
    return params, z0, lat


@pytest.fixture(scope="module")
def ranks(torus):
    """Every port case, on one group of 8 gloo ranks; rank 0's outputs."""
    params, z0, lat = torus
    t = torch.as_tensor
    sphere = latent_sphere_sdf()
    z = torch.tensor([0.5])
    calls = {}
    for img, focal in ((32, 40.0), (18, 24.0)):
        calls[f"frame{img}"] = (
            sharding.render_frame_sharded, ("rays",), (8,),
            dict(sdf_fn=sphere, latent=z, camera=_frame(img, focal)[1],
                 cfg=RenderConfig(img_h=img, img_w=img, march=MarchConfig(**FRAME_MARCH))))
    vo, vv = _view_rays()
    calls["views"] = (sharding.render_views_sharded, ("latents",), (8,),
                      dict(sdf_fn=sphere, latent=z, origins=t(vo), dirs=t(vv),
                           cfg=RenderConfig(img_h=16, img_w=16,
                                            march=MarchConfig(**FRAME_MARCH))))
    tparams, dcfg = params_from_numpy(params), DecoderConfig(**DEC_KW)
    o1, v1 = _batched_rays(32, 1)
    calls["trace"] = (sharding.trace_sharded_pallas, ("rays",), (8,),
                      dict(packed=pack_folded(fold_latent(tparams, t(z0), dcfg), dcfg),
                           origins=t(o1[0]), dirs=t(v1[0]),
                           march=MarchConfig(**BATCH_MARCH), block=128))
    ob, vb = _batched_rays(32, 4)
    for strides, sched in BATCHED:
        calls[f"batched{strides}{sched}"] = (
            sharding.render_batched_c2f_sharded, ("latents", "rays"), (2, 4),
            dict(params=tparams, dcfg=dcfg, latents=t(lat), origins=t(ob), dirs=t(vb),
                 img_hw=(32, 32), march=MarchConfig(**BATCH_MARCH), strides=strides,
                 coarse_steps=16, scheduler=sched))
    obs = {k: t(a.copy()) for k, a in _fit_obs().items()}
    calls["fit"] = (fit_steps, ("latents", "rays"), (2, 4),
                    dict(sdf_fn=sphere, cfg=RenderConfig(img_h=16, img_w=16,
                                                         march=MarchConfig(**FRAME_MARCH)),
                         loss_cfg=LossConfig(), latents=torch.full((4, 1), 0.3),
                         steps=FIT_STEPS, **obs))
    res = run_ranks(run_calls, 8, list(calls.values()), "cpu", backend="gloo",
                    device="cpu")
    return {name: r["out"] for name, r in zip(calls, res)}


@pytest.mark.parametrize("img,focal", [(32, 40.0), (18, 24.0)])
def test_sharded_frame_render_matches_jax(ranks, img, focal):
    """render_frame_sharded on 8 ray shards, 32x32 and 18x18 (324 rays,
    padded to 328 and trimmed), against JAX's on its fake mesh."""
    jcam, _ = _frame(img, focal)
    cfg = JRenderConfig(img_h=img, img_w=img, march=JMarchConfig(**FRAME_MARCH))
    # jitted: eager shard_map runs primitive by primitive (~20x slower)
    ref = jax.jit(lambda: jsh.render_frame_sharded(
        jlatent_sphere_sdf(), jnp.array([0.5]), jcam, cfg, jmake_mesh(("rays",))))()
    out = ranks[f"frame{img}"]
    assert out.depth.shape == (img, img) and out.normal.shape == (img, img, 3)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert out.mask.sum() > 20
    for k in ("depth", "min_sdf", "normal", "points"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_view_sharded_render_matches_jax(ranks):
    """render_views_sharded: 8 views over the 8-shard latents axis."""
    vo, vv = _view_rays()
    cfg = JRenderConfig(img_h=16, img_w=16, march=JMarchConfig(**FRAME_MARCH))
    ref = jax.jit(lambda: jsh.render_views_sharded(
        jlatent_sphere_sdf(), jnp.array([0.5]), jnp.asarray(vo), jnp.asarray(vv), cfg,
        jmake_mesh(("latents",))))()
    out = ranks["views"]
    assert out.depth.shape == (8, 256)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    for k in ("depth", "min_sdf"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=0, atol=1e-5, err_msg=k)


def _newton_polish(point_fn, o, v, d, iters=2):
    """fp32 Newton refinement of depths: d <- d - f(p) / <grad f, v>
    (tests/test_parallel_batched.py's, on the port's point function)."""
    o, v, d = (torch.as_tensor(np.asarray(a)) for a in (o, v, d))
    for _ in range(iters):
        p = (o + d[:, None] * v).requires_grad_(True)
        f = point_fn(p)
        (g,) = torch.autograd.grad(f.sum(), p)
        d = d - f.detach() / torch.clamp((g * v).sum(-1), max=-1e-2)
    return d.numpy()


def test_sharded_trace_matches_jax(ranks, torus):
    """trace_sharded_pallas: the port's K1-grid plain version on 8 ray
    shards against JAX's kernel in interpret mode (block 128), under
    test_parallel_batched.py's bar: on rays both hit, p95 |depth diff|
    <= 1e-3 after an fp32 Newton polish; hit disagreement only within 1 px
    of JAX's silhouette, at most half the rim."""
    params, z0, _ = torus
    o, v = _batched_rays(32, 1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    dcfg = JDecoderConfig(**DEC_KW)
    packed = jpack_folded(jfold_latent(jp, jnp.asarray(z0), dcfg), dcfg)
    jd, jhit, _ = jax.jit(lambda o, v: jsh.trace_sharded_pallas(
        packed, o, v, JMarchConfig(**BATCH_MARCH), jmake_mesh(("rays",)), block=128,
        interpret=True))(jnp.asarray(o[0]), jnp.asarray(v[0]))
    d, hit, msdf = ranks["trace"]
    assert d.shape == (1024,) and torch.isfinite(msdf).all()
    jhit, hit = np.asarray(jhit), hit.numpy()
    both = jhit & hit
    assert both.sum() > 100
    pf = make_point_fn(params_from_numpy(params), torch.as_tensor(z0),
                       DecoderConfig(**DEC_KW))
    err = np.abs(_newton_polish(pf, o[0], v[0], d.numpy())
                 - _newton_polish(pf, o[0], v[0], np.asarray(jd)))[both]
    assert np.percentile(err, 95) <= 1e-3, np.percentile(err, 95)
    img = torch.as_tensor(jhit.reshape(1, 32, 32), dtype=torch.float32)
    dil = torch.nn.functional.max_pool2d(img, 3, 1, 1)[0] > 0.5
    ero = -torch.nn.functional.max_pool2d(-img, 3, 1, 1)[0] > 0.5
    rim = (dil & ~ero).numpy()
    disagree = (jhit != hit).reshape(32, 32)
    assert (disagree & ~rim).sum() == 0
    assert disagree.sum() <= 0.5 * rim.sum()


def _layout_contract(d, hit, msdf, d_ref, hit_ref, msdf_ref, depth_eps):
    """tests/test_parallel_batched.py's cross-layout contract."""
    np.testing.assert_array_equal(hit, hit_ref)
    dd = np.abs(d - d_ref)[hit_ref]
    assert (dd > 1e-6).mean() <= 0.005 and dd.max() <= 4 * depth_eps
    md = np.abs(msdf - msdf_ref)
    assert (md > 1e-6).mean() <= 0.005 and md.max() <= 1e-3


def _package_parity(d, hit, msdf, jd, jhit, jmsdf):
    """tests/test_torch_batched.py's bars between the two packages' renders
    (their CPU products sum in different orders)."""
    assert (hit == jhit).mean() >= 0.99
    both = hit & jhit
    derr = np.abs(d - jd)[both]
    assert np.median(derr) < 1e-5 and np.mean(derr < 1e-3) >= 0.98
    assert np.mean(np.abs(msdf - jmsdf) < 1e-3) >= 0.98


@pytest.mark.parametrize("strides,scheduler", BATCHED)
def test_sharded_batched_matches_single_device_and_jax(ranks, torus, strides, scheduler):
    """render_batched_c2f_sharded on a (2, 4) frames x ray-bands mesh (the
    halo rows make the plan the single-device plan), under the cross-layout
    contract against the port's single-device render_batched_c2f, as
    tests/test_parallel_batched.py holds JAX's sharded render to its own.
    Across the packages the two sharded renders differ as the two
    single-device renders do (the CPU products' summation orders: 0.9-1.5%
    of hits by more than 1e-6, up to 8.8e-3, more than the cross-layout
    contract allows), so they are held to tests/test_torch_batched.py's
    bars between the packages."""
    params, _, lat = torus
    ob, vb = _batched_rays(32, 4)
    d, hit, msdf = (a.numpy() for a in ranks[f"batched{strides}{scheduler}"])
    ref = render_batched_c2f(params_from_numpy(params), DecoderConfig(**DEC_KW),
                             torch.as_tensor(lat), torch.as_tensor(ob),
                             torch.as_tensor(vb), (32, 32), MarchConfig(**BATCH_MARCH),
                             strides=strides, coarse_steps=16, scheduler=scheduler)
    hit_ref = ref.hit.numpy()
    assert hit_ref.sum() > 100
    eps = BATCH_MARCH["depth_eps"]
    _layout_contract(d, hit, msdf, ref.depth.numpy(), hit_ref, ref.min_sdf.numpy(), eps)

    jargs = (jax.tree_util.tree_map(jnp.asarray, params), JDecoderConfig(**DEC_KW))
    jin = (jnp.asarray(lat), jnp.asarray(ob), jnp.asarray(vb))
    kw = dict(strides=strides, coarse_steps=16, interpret=True, scheduler=scheduler)
    jsh_out = jax.jit(lambda l, o, v: jsh.render_batched_c2f_sharded(
        *jargs, l, o, v, (32, 32), JMarchConfig(**BATCH_MARCH),
        jmake_mesh(("latents", "rays"), (2, 4)), **kw))(*jin)
    _package_parity(d, hit, msdf, *(np.asarray(a) for a in jsh_out))


def test_sharded_fit_step_reduces_loss_and_follows_jax(ranks):
    """tests/test_parallel.py's fit on a (2, 4) mesh: 4 spheres from radius
    0.3, 25 steps: the loss halves and the radii halve their error; the
    latents after each of the first 3 steps within 1e-4 of JAX's."""
    out = ranks["fit"]
    losses, lats = out["losses"].numpy(), out["latents"].numpy()
    assert lats.shape == (FIT_STEPS, 4, 1)
    assert losses[-1] < 0.5 * losses[0]
    assert np.abs(lats[-1] - TRUE_R).mean() < 0.5 * np.abs(0.3 - TRUE_R).mean()

    obs = _fit_obs()
    cfg = JRenderConfig(img_h=16, img_w=16, march=JMarchConfig(**FRAME_MARCH))
    step, tx = jsh.make_sharded_fit_step(jlatent_sphere_sdf(), cfg, JLossConfig(),
                                         jmake_mesh(("latents", "rays"), (2, 4)))
    z = jnp.full((4, 1), 0.3)
    state = tx.init(z)
    for i in range(3):
        z, state, loss = step(z, state, *(jnp.asarray(obs[k]) for k in
                                          ("origins", "dirs", "obs_depth", "obs_mask")))
        np.testing.assert_allclose(lats[i], np.asarray(z), rtol=0, atol=1e-4)
        np.testing.assert_allclose(losses[i], float(loss), rtol=1e-4)


def test_make_mesh_shapes_and_backends(tmp_path):
    """make_mesh needs a group and a shape of the world's size; NCCL with
    more ranks than cards, or on the CPU, raises rather than switching to
    gloo."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(("rays",), device_type="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        assert make_mesh(device_type="cpu").shape == (1, 1)
        with pytest.raises(ValueError, match=r"mesh shape \(2, 4\) != 1 ranks"):
            make_mesh(("latents", "rays"), (2, 4), device_type="cpu")
        with pytest.raises(ValueError, match="does not name"):
            make_mesh(("latents", "rays"), (1,), device_type="cpu")
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="two ranks on one card"):
        check_backend(2, "nccl", "cuda", n_cards=1)
    with pytest.raises(ValueError, match="CUDA cards only"):
        check_backend(2, "nccl", "cpu", n_cards=0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        check_backend(2, "gloo", "cuda", n_cards=0)
    check_backend(4, "gloo", "cuda", n_cards=1)
    check_backend(2, "nccl", "cuda", n_cards=2)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    """The port's dryrun_multichip(4): one fit step through the fused
    recompute (K3, K4's plain versions) on a (2, 2) mesh, and the flagship
    sharded render held to the single-device plan; its two lines."""
    from dist_renderer_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("dryrun_multichip(4): mesh={'latents': 2, 'rays': 2} loss=")
    assert "plan-exact vs single-device" in lines[-1] and lines[-1].endswith("OK")
    assert np.isfinite(res["loss"]) and res["hits"] > 0


def test_batched_render_on_two_ranks_equals_one_process():
    """tasks/batched_render under a 2-rank group: each rank renders half of
    the latents; the reduced counts equal one process's."""
    from dist_renderer_tpu_torch.tasks import batched_render

    argv = ["--cpu", "--img", "16", "--march-steps", "24", "--latents", "2",
            "--views", "2"]
    one = batched_render.main(argv)
    two = run_ranks(batched_render.main, 2, argv, backend="gloo", device="cpu")
    assert two["devices"] == 2 and one["devices"] == 1
    for k in ("total_rays", "hit_frac", "mean_hit_depth"):
        assert two[k] == one[k], k
    assert one["hit_frac"] > 0
