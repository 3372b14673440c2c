"""ops/polish.py's polish_depth_batched (K3's plain version) against the
JAX package's (its kernel in interpret mode): F=2 frames of 32x32 of a
fitted torus decoder, their batched march depths, 2 safeguarded Newton
iterations on a hit-first bucket, with the full decoder's residual.

On JAX's K3 values the port's polish gives JAX's depth and residual
(within 1e-5); on its own K3 it is held to K3's cross-package bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.models.analytic import torus_sdf
from dist_renderer_tpu.models.pretrain import fit_decoder_to_sdf
from dist_renderer_tpu.ops.camera import Camera as JCamera
from dist_renderer_tpu.ops.camera import pixel_rays as jpixel_rays
from dist_renderer_tpu.ops.polish import polish_depth_batched as jpolish
from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig
from dist_renderer_tpu_torch.models.decoder import decoder_apply, params_from_numpy
from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f
from dist_renderer_tpu_torch.ops.kernels.recompute import precise_sdg_call
from dist_renderer_tpu_torch.ops.polish import polish_depth_batched
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

DEC_KW = dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))
IMG, F = 32, 2


@pytest.fixture(scope="module")
def scene():
    """The torus decoder, 2 jittered latents and their march at a loose
    eps (so the polish has work): rays, depth, hit."""
    params, z0 = fit_decoder_to_sdf(lambda p: torus_sdf(0.55, 0.2)(None, p),
                                    JDecoderConfig(**DEC_KW), steps=150, batch=512)
    params = jax.tree_util.tree_map(np.array, params)
    lat = np.array(z0)[None] + 0.02 * np.random.default_rng(4).standard_normal(
        (F, DEC_KW["latent_size"])).astype(np.float32)
    cam = JCamera.looking_at((0.0, 0.0, -2.0), focal=IMG * 1.2, img_hw=(IMG, IMG))
    o, v = (np.asarray(a) for a in jpixel_rays(cam, IMG, IMG))
    ob = np.broadcast_to(o[None], (F,) + o.shape).copy()
    vb = np.broadcast_to(v[None], (F,) + v.shape).copy()
    st = render_batched_c2f(params_from_numpy(params), DecoderConfig(**DEC_KW),
                            torch.as_tensor(lat), torch.as_tensor(ob), torch.as_tensor(vb),
                            (IMG, IMG), MarchConfig(max_steps=40, convergence_eps=1e-2,
                                                    depth_eps=5e-3), strides=(4,))
    return params, lat, ob, vb, st.depth.numpy(), st.hit.numpy()


def _both(scene, **kw):
    """(JAX's polish in interpret mode, the port's) -> numpy (depth, res)."""
    params, lat, ob, vb, depth, hit = scene
    j = jpolish(jax.tree_util.tree_map(jnp.asarray, params), JDecoderConfig(**DEC_KW),
                jnp.asarray(lat), jnp.asarray(ob), jnp.asarray(vb), jnp.asarray(depth),
                jnp.asarray(hit), iters=2, interpret=True, return_residual=True)
    t = polish_depth_batched(
        params_from_numpy(params), DecoderConfig(**DEC_KW), torch.as_tensor(lat),
        torch.as_tensor(ob), torch.as_tensor(vb), torch.as_tensor(depth),
        torch.as_tensor(hit), iters=2, return_residual=True, **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def test_polish_batched_equals_jax_on_jax_k3(scene, monkeypatch):
    """The polish's own logic (bucket, safeguards, accepts, scatters):
    with JAX's K3 values in place of the port's, depth and residual equal
    JAX's (bars: 1e-5; read: equal)."""
    import dist_renderer_tpu_torch.ops.kernels.recompute as trec
    from dist_renderer_tpu.ops.pallas.recompute import make_precise_sdg as jmake_sdg

    params, _, _, _, depth, hit = scene
    jsdg = jmake_sdg(jax.tree_util.tree_map(jnp.asarray, params), JDecoderConfig(**DEC_KW),
                     interpret=True)

    def jax_k3(*args, **kw):
        def sdg(z, p, v):
            return tuple(torch.as_tensor(np.asarray(a)) for a in
                         jsdg(*(jnp.asarray(x.numpy()) for x in (z, p, v))))
        return sdg

    monkeypatch.setattr(trec, "make_precise_sdg", jax_k3)
    (jd, jres), (d, res) = _both(scene)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5)
    fin = np.isfinite(jres)
    np.testing.assert_array_equal(np.isfinite(res), fin)
    assert fin.sum() == hit.sum() > 100
    np.testing.assert_allclose(res[fin], jres[fin], rtol=0, atol=1e-5)


def test_polish_batched_matches_jax(scene):
    """On the port's plain K3. K3's value differs from JAX's by a bf16
    step of an activation on a few points (tests/test_torch_recompute.py's
    bars: 95% within 1e-6, max 1e-3), which can flip one accept decision:
    bars at K3's quantile, >= 95% of hits within 1e-5 in depth and in
    residual, depth at most iters * max_step off, residual at most 1e-3
    (read: 98.4% and 96.2% within 1e-5, max 2.5e-3 and 9.6e-4). The
    polish moves most hits and shrinks the median residual below the
    march's |f|."""
    params, lat, ob, vb, depth, hit = scene
    n0 = precise_sdg_call.launches
    (jd, jres), (d, res) = _both(scene)
    assert precise_sdg_call.launches == n0  # the plain version on the CPU
    dd = np.abs(d - jd)[hit]
    assert np.mean(dd <= 1e-5) >= 0.95 and dd.max() <= 2 * 0.05
    fin = np.isfinite(jres)
    np.testing.assert_array_equal(np.isfinite(res), fin)
    rr = np.abs(res - jres)[fin]
    assert np.mean(rr <= 1e-5) >= 0.95 and rr.max() <= 1e-3
    np.testing.assert_array_equal(d[~hit], depth[~hit])
    assert (np.abs(d - depth)[hit] > 1e-6).mean() > 0.5
    # the march's |f| at its own depths, against the polished residual
    p = torch.as_tensor(ob + depth[..., None] * vb)
    f0 = torch.stack([decoder_apply(params_from_numpy(params), torch.as_tensor(lat[i]), p[i],
                                    DecoderConfig(**DEC_KW)) for i in range(F)]).abs().numpy()
    assert np.median(res[fin]) < np.median(f0[hit])


def test_polish_batched_without_residual_and_bucket(scene):
    """return_residual=False gives the same depth; hits beyond a small
    bucket keep their march depth (bucket_frac 16 -> 64 of 1,024 rays)."""
    params, lat, ob, vb, depth, hit = scene
    args = (params_from_numpy(params), DecoderConfig(**DEC_KW), torch.as_tensor(lat),
            torch.as_tensor(ob), torch.as_tensor(vb), torch.as_tensor(depth),
            torch.as_tensor(hit))
    d_res, _ = polish_depth_batched(*args, return_residual=True)
    assert torch.equal(polish_depth_batched(*args), d_res)
    small = polish_depth_batched(*args, bucket_frac=16, block=64).numpy()
    order = np.argsort(~hit, axis=1, kind="stable")
    for i in range(F):
        beyond = order[i, 64:]
        np.testing.assert_array_equal(small[i, beyond], depth[i, beyond])
        np.testing.assert_array_equal(small[i, order[i, :64]], d_res.numpy()[i, order[i, :64]])
