"""K3's plain version (the port's fused precise recompute) against the JAX
package's ``precise_sdg_call`` in interpret mode, on the three
architectures of tests/test_recompute.py, with weights, latents, points
and directions made from a numpy seed.

Tolerances. Both packages multiply the same bf16 operands (hi/lo splits
on input layers, single bf16 on hidden layers) and accumulate in fp32,
so only the CPU BLAS summation order differs; a ~1e-7 relative change
can still move one bf16 rounding of an activation by a bf16 step or flip
a ReLU gate that sits at zero on a random-init net. Hence a tight
quantile bar plus a loose maximum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.ops.pallas import recompute as jrec
from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import decoder_apply, params_from_numpy
from dist_renderer_tpu_torch.ops.kernels import recompute as trec

ARCHS = [
    dict(latent_size=32, hidden_dims=(64,) * 8, latent_in=(4,)),
    dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), xyz_in_all=True),
    dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), use_tanh=True),
]


def _setup(kw, n=300, seed=0):
    rng = np.random.default_rng(seed)
    cfg = JDecoderConfig(**kw)
    params = {"layers": [
        {"w": (rng.standard_normal((i, o)) * np.sqrt(2.0 / i)).astype(np.float32),
         "b": np.zeros(o, np.float32)}
        for i, o in cfg.layer_dims]}
    latent = (0.3 * rng.standard_normal(cfg.latent_size)).astype(np.float32)
    pts = (0.8 * rng.standard_normal((n, 3))).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return params, latent, pts, dirs


def _jax_params(params):
    return {"layers": [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])}
                       for l in params["layers"]]}


@pytest.mark.parametrize("kw", ARCHS)
def test_plain_k3_matches_pallas_precise_sdg(kw):
    params, latent, pts, dirs = _setup(kw)
    jp, jc = _jax_params(params), JDecoderConfig(**kw)
    jpk = jrec.pack_precise(jp, jc)
    jb = jrec.fold_bias_precise(jp, jnp.asarray(latent), jc, jpk)
    js, jdd, jg = jax.jit(lambda: jrec.precise_sdg_call(
        jpk, jb, jnp.asarray(pts), jnp.asarray(dirs), block=128,
        interpret=True))()

    tp, tc = params_from_numpy(params), DecoderConfig(**kw)
    tpk = trec.pack_precise(tp, tc)
    assert [tuple(m) for m in tpk.meta] == [tuple(m) for m in jpk.meta]
    # the same biases on both sides isolate the kernel arithmetic
    tb = tuple(torch.as_tensor(np.array(b)[:, 0]) for b in jb)
    s, dd, g = trec.precise_sdg_call(tpk, tb, torch.as_tensor(pts),
                                     torch.as_tensor(dirs))
    es = np.abs(s.numpy() - np.asarray(js))
    assert np.quantile(es, 0.95) < 1e-6 and es.max() < 1e-3
    gn = np.linalg.norm(np.asarray(jg), axis=-1)
    eg = np.linalg.norm(g.numpy() - np.asarray(jg), axis=-1) / np.maximum(gn, 1e-3)
    assert np.quantile(eg, 0.95) < 1e-5 and np.median(eg) < 1e-6
    edd = np.abs(dd.numpy() - np.asarray(jdd)) / np.maximum(np.abs(np.asarray(jdd)), 1e-2)
    assert np.quantile(edd, 0.95) < 1e-4

    # the port's own fp32 fold against the JAX package's bf16x3 split
    # fold: the split drops the lo x lo term (~2^-16 relative)
    tb2 = trec.fold_bias_precise(tp, torch.as_tensor(latent), tc, tpk)
    for a, b in zip(jb, tb2):
        np.testing.assert_allclose(b.numpy(), np.asarray(a)[:, 0], rtol=0,
                                   atol=1e-4)
    s2, _, _ = trec.precise_sdg_plain(tpk, tb2, torch.as_tensor(pts),
                                      torch.as_tensor(dirs))
    ref32 = decoder_apply(tp, torch.as_tensor(latent), torch.as_tensor(pts), tc)
    err = np.abs(s2.numpy() - ref32.numpy())
    # vs the fp32 decoder: single-bf16 hidden layers bound the value error
    assert np.quantile(err, 0.99) < 8e-3 and err.max() < 5e-2


def test_pack_precise_kernel_layout():
    """The CUDA buffer holds every operand the plain version multiplies:
    hi input-major, lo and hi output-major, x rows hi/lo."""
    kw = ARCHS[0]
    params, *_ = _setup(kw, n=4)
    pk = trec.pack_precise(params_from_numpy(params), DecoderConfig(**kw))
    tab = pk.table
    assert tab[:2] == (0, 1)
    flat = pk.flat.to(torch.float32)
    for li, (m, ops) in enumerate(zip(pk.meta, pk.layers)):
        out_p, in_p, split, fhi, flo, rev, xhi, xlo, boff = tab[2 + 9 * li:11 + 9 * li]
        assert (out_p, in_p, bool(split)) == (m.out_p, m.in_p, m.split)
        if m.has_wh:
            blk = lambda off, r, c: flat[off:off + r * c].reshape(r, c)
            assert torch.equal(blk(fhi, in_p, out_p), ops["wh_hi"])
            assert torch.equal(blk(rev, out_p, in_p), ops["wh_hi"].T)
            if m.split:
                assert torch.equal(blk(flo, out_p, in_p), ops["wh_lo"].T)
        if m.has_wx:
            assert torch.equal(flat[xhi:xhi + 3 * out_p].reshape(3, out_p), ops["wx_hi"])
            assert torch.equal(flat[xlo:xlo + 3 * out_p].reshape(3, out_p), ops["wx_lo"])
    # layer 3 of the 8x512 decoder shrinks to 253 outputs: padding is zero
    full = DecoderConfig(latent_size=8, hidden_dims=(24,) * 8, latent_in=(4,))
    rng = np.random.default_rng(0)
    p = {"layers": [{"w": rng.standard_normal((i, o)).astype(np.float32),
                     "b": np.zeros(o, np.float32)} for i, o in full.layer_dims]}
    pk = trec.pack_precise(params_from_numpy(p), full)
    assert full.layer_dims[3] == (24, 13) and pk.meta[3].out_p == 16
    assert pk.meta[4].in_p == 16
    assert torch.all(pk.layers[4]["wh_hi"][13:] == 0)


def test_padding_and_ragged_batch():
    kw = ARCHS[0]
    params, latent, pts, dirs = _setup(kw, n=130)
    tp, tc = params_from_numpy(params), DecoderConfig(**kw)
    f = trec.pack_precise(tp, tc)
    b = trec.fold_bias_precise(tp, torch.as_tensor(latent), tc, f)
    s, dd, g = trec.precise_sdg_call(f, b, torch.as_tensor(pts), torch.as_tensor(dirs))
    assert s.shape == (130,) and dd.shape == (130,) and g.shape == (130, 3)
    s1, dd1, g1 = trec.precise_sdg_call(f, b, torch.as_tensor(pts[:7]),
                                        torch.as_tensor(dirs[:7]))
    np.testing.assert_allclose(s1.numpy(), s.numpy()[:7], atol=1e-6)
    np.testing.assert_allclose(g1.numpy(), g.numpy()[:7], atol=1e-5)


@pytest.mark.parametrize("kw", ARCHS)
def test_value_plain_is_the_s_of_precise_sdg_plain(kw):
    """K3's value mode's plain version is precise_sdg_plain's s bit for
    bit, on random points, for each architecture."""
    params, latent, pts, dirs = _setup(kw, n=257, seed=5)
    tp, tc = params_from_numpy(params), DecoderConfig(**kw)
    pk = trec.pack_precise(tp, tc)
    b = trec.fold_bias_precise(tp, torch.as_tensor(latent), tc, pk)
    s, _, _ = trec.precise_sdg_plain(pk, b, torch.as_tensor(pts), torch.as_tensor(dirs))
    v = trec.precise_value_plain(pk, b, torch.as_tensor(pts))
    assert v.shape == (257,) and v.dtype == torch.float32
    assert torch.equal(v.view(torch.int32), s.view(torch.int32))


def test_value_call_on_the_cpu_is_its_plain_version_and_counts_its_rows():
    """On a CPU tensor precise_value_call runs its plain version (no
    launch), and k3_value_points counts its rows under a profiler; the
    sdg's .value folds the latent as the sdg does and carries no
    gradient."""
    from torch.profiler import profile

    from dist_renderer_tpu_torch.utils import profiling

    kw = ARCHS[1]
    params, latent, pts, dirs = _setup(kw, n=130, seed=6)
    tp, tc = params_from_numpy(params), DecoderConfig(**kw)
    pk = trec.pack_precise(tp, tc)
    z = torch.as_tensor(latent)
    b = trec.fold_bias_precise(tp, z, tc, pk)
    p = torch.as_tensor(pts)
    n0 = trec.precise_value_call.launches
    profiling.drain()
    with profile():
        v = trec.precise_value_call(pk, b, p)
        v0 = trec.precise_value_call(pk, b, p[:0])
    counts = profiling.drain().counts
    assert trec.precise_value_call.launches == n0
    assert counts == {("k3_value_points", ""): 130}
    assert torch.equal(v, trec.precise_value_plain(pk, b, p)) and v0.shape == (0,)
    sdg = trec.make_precise_sdg(tp, tc, packed=pk)
    zg = z.clone().requires_grad_()
    sv = sdg.value(zg, p)
    assert not sv.requires_grad
    assert torch.equal(sv, sdg(zg, p, torch.as_tensor(dirs))[0].detach())
    with pytest.raises(ValueError):
        sdg.value(z[None], p)
