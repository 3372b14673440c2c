"""The stage-split and fidelity diagnostics (dist_renderer_tpu_torch/diag/:
diag_f1_stages to diag_finalize_compile) on the CPU, and the public
parameters they need against the JAX package's.

- Each module runs on a CUDA card only: without one it raises
  SystemExit (tests/test_torch_cuda.py runs each on the card).
- ``render_rays(init_active=)``, ``decoder_apply(precision=)``,
  ``color_apply(compute_dtype=)`` and ``init_color_params(dtype=)``
  against the JAX package's on the same inputs. Scene:
  tests/test_torch_polish.py's 4x48 decoder fitted to a sphere, one
  frame of 32x32; bars tests/test_torch_render.py's and
  tests/test_torch_decoder.py's.
- The modules' offline statistics (polish flips and their confinement,
  the frontal quantiles, band promoted / demoted, the value paths'
  error quantiles, the hit-first orderings) against the scripts'
  formulas, restated in numpy on seeded data.
- retrain_proxy's choice of output file.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.models import color_decoder as jcol
from dist_renderer_tpu.models import decoder as jdec
from dist_renderer_tpu.ops import camera as jcam
from dist_renderer_tpu.ops.renderer import render_rays as jrender_rays
from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models import color_decoder as tcol
from dist_renderer_tpu_torch.models import decoder as tdec
from dist_renderer_tpu_torch.ops.renderer import render_rays
from test_torch_batched import T, sphere  # noqa: F401
from test_torch_compose import JAX, PORT, _cfg, _jax_sdf
from test_torch_decoder import ARCHS, _jax_params, _weights
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)
from test_torch_polish import decoders  # noqa: F401
from test_torch_render import _assert_parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32
STAGE_MODULES = ("diag_f1_stages", "diag_compose", "diag_glue", "diag_sortcost",
                 "diag_fused_dd", "diag_recompute", "diag_precision", "diag_polish_parity",
                 "diag_band_fidelity", "debug_band_probe", "diag_warm", "retrain_proxy",
                 "diag_finalize_compile")


@pytest.mark.parametrize("name", STAGE_MODULES)
def test_stage_module_needs_a_card(name, monkeypatch):
    """Each module runs on one CUDA card: without one it raises
    SystemExit before it loads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"dist_renderer_tpu_torch.diag.{name}")
    with pytest.raises(SystemExit, match="CUDA card"):
        mod.main([])


# ---- the repaired parameters against JAX ------------------------------------

def _rays():
    cam = jcam.Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    return tuple(np.asarray(a) for a in jcam.pixel_rays(cam, IMG, IMG))


def test_render_rays_init_active_matches_jax(decoders):
    """render_rays with an init_active mask (a third of the rays off, the
    c2f skip class) on tests/test_torch_compose.py's default branch (the
    masked tracer, last-step composition, the fp32 value on both sides):
    no inactive ray hits in either package, the mask takes away hits the
    render without it has, and the maps agree under
    tests/test_torch_render.py's bars."""
    params, z0, dkw, _, _ = decoders
    o, v = _rays()
    active = np.random.default_rng(2).random(IMG * IMG) > 0.33
    march = dict(max_steps=50)
    jcfg, tcfg = _cfg(JAX, march), _cfg(PORT, march)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jout = jrender_rays(_jax_sdf(jp, JDecoderConfig(**dkw), False), jnp.asarray(z0),
                        jnp.asarray(o), jnp.asarray(v), jcfg,
                        init_active=jnp.asarray(active))
    tsdf = tdec.make_precise_sdf(tdec.params_from_numpy(params), DecoderConfig(**dkw))
    tout = render_rays(tsdf, T(z0), T(o), T(v), tcfg, init_active=T(active))
    full = render_rays(tsdf, T(z0), T(o), T(v), tcfg)
    maps = lambda out: {k: np.asarray(getattr(out, k)).reshape(
        (IMG, IMG, 3) if k == "normal" else (IMG, IMG)) for k in
        ("depth", "mask", "normal", "min_sdf")}
    j, t = maps(jout), maps(tout)
    assert not j["mask"].reshape(-1)[~active].any()
    assert not t["mask"].reshape(-1)[~active].any()
    assert full.mask.numpy()[~active].sum() > 50
    _assert_parity(j, t)


class _SplitXSDF(tdec.PreciseSDF):
    """The port's precise function with the JAX package's production
    value, ``precision="split_x"`` (its ``make_precise_sdf``'s); K3,
    ``sdg_builder``, already rounds as split_x."""

    def __call__(self, latent, points):
        return tdec.decoder_apply(self.params, latent, points, self.cfg,
                                  precision="split_x")


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_render_rays_init_active_matches_jax_on_the_ift_branch(decoders, route):
    """render_rays with the init_active mask on the IFT branch without
    c2f (the tracer marches the value itself), each route with one value
    on both sides: "xla", the fp32 value and its autograd gradient in
    both packages; "pallas", each package's production precise function
    (JAX's make_precise_sdf, split_x with its recompute kernel; the
    port's split_x value with K3). Under tests/test_torch_render.py's
    bars (frontal p95 1.6e-6 and 6.7e-4 here). The port's fp32 value
    against JAX's fp32 lambda on the pallas route differs by a p95 of
    4.4e-3 for that reason alone: the port's K3 rounds as split_x, while
    JAX's lambda has no kernel and composes the fp32 value."""
    params, z0, dkw, _, _ = decoders
    o, v = _rays()
    active = np.random.default_rng(2).random(IMG * IMG) > 0.33
    march, grad = dict(max_steps=50), dict(mode="ift", recompute=route)
    jcfg, tcfg = _cfg(JAX, march, grad), _cfg(PORT, march, grad)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp, tdc = tdec.params_from_numpy(params), DecoderConfig(**dkw)
    production = route == "pallas"
    jout = jrender_rays(_jax_sdf(jp, JDecoderConfig(**dkw), production), jnp.asarray(z0),
                        jnp.asarray(o), jnp.asarray(v), jcfg,
                        init_active=jnp.asarray(active))
    tsdf = _SplitXSDF(tp, tdc) if production else tdec.make_precise_sdf(tp, tdc)
    tout = render_rays(tsdf, T(z0), T(o), T(v), tcfg, init_active=T(active))
    maps = lambda out: {k: np.asarray(getattr(out, k)).reshape(
        (IMG, IMG, 3) if k == "normal" else (IMG, IMG)) for k in
        ("depth", "mask", "normal", "min_sdf")}
    j, t = maps(jout), maps(tout)
    assert not j["mask"].reshape(-1)[~active].any()
    assert not t["mask"].reshape(-1)[~active].any()
    _assert_parity(j, t)


@pytest.mark.parametrize("kw", ARCHS)
@pytest.mark.parametrize("precision", ["split", "split_x"])
def test_decoder_apply_precision_matches_jax(kw, precision):
    """decoder_apply(precision=) against the JAX package's: both split
    the operands at bf16 and sum exact products in fp32, so only the
    CPU BLAS's order of the sums differs. "split" sits ~1e-5 from the
    fp32 value and is held within 1e-5 of JAX's, its mean difference a
    quarter of its mean distance from fp32; "split_x" (bf16 hidden
    layers) within 1e-5 of JAX's and ~3e-3 from fp32."""
    params, lat, pts = _weights(kw, seed=4)
    ref = np.asarray(jdec.decoder_apply(_jax_params(params), jnp.asarray(lat[0]),
                                        jnp.asarray(pts), JDecoderConfig(**kw),
                                        precision=precision))
    tp = tdec.params_from_numpy(params)
    args = (tp, torch.as_tensor(lat[0]), torch.as_tensor(pts), DecoderConfig(**kw))
    out = tdec.decoder_apply(*args, precision=precision).numpy()
    f32 = tdec.decoder_apply(*args).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if precision == "split":
        assert np.abs(out - ref).mean() <= 0.25 * np.abs(ref - f32).mean()
    else:
        assert np.abs(out - f32).max() > 1e-3


@pytest.mark.parametrize("kw", ARCHS[:2])
def test_split_x_is_the_with_dd_value(kw):
    """The split_x value is decoder_apply_with_dd's value bit for bit, as
    the JAX package's tests/test_decoder.py has it; an unknown precision
    raises."""
    params, lat, pts = _weights(kw, seed=5)
    tp = tdec.params_from_numpy(params)
    z, p = torch.as_tensor(lat[0]), torch.as_tensor(pts)
    s, _ = tdec.decoder_apply_with_dd(tp, z, p, p / p.norm(dim=-1, keepdim=True),
                                      DecoderConfig(**kw))
    assert torch.equal(tdec.decoder_apply(tp, z, p, DecoderConfig(**kw),
                                          precision="split_x"), s)
    with pytest.raises(ValueError):
        tdec.decoder_apply(tp, z, p, DecoderConfig(**kw), precision="highest")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_color_apply_and_init_dtype_match_jax(dtype):
    """color_apply(compute_dtype=) on JAX's weights, and on weights made
    by init_color_params(dtype=) in each package (bf16 weights, bf16
    compute), against the JAX package's color_apply: bf16 operands, fp32
    sums, CPU BLAS orders (tests/test_torch_decoder.py's 2e-6)."""
    kw = dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    z = rng.standard_normal(8).astype(np.float32)
    pts = rng.standard_normal((257, 3)).astype(np.float32)
    jcfg, tcfg = jcol.make_color_config(**kw), tcol.make_color_config(**kw)
    jp = jcol.init_color_params(jax.random.PRNGKey(7), jcfg, jd)
    tp = tcol.init_color_params(torch.Generator().manual_seed(7), tcfg, "cpu", td)
    assert all(l[k].dtype == td for l in tp["layers"] for k in ("w", "b"))
    assert [tuple(l["w"].shape) for l in tp["layers"]] == \
        [tuple(l["w"].shape) for l in jp["layers"]]
    # JAX's weights carried across in their dtype
    tj = {"layers": [{k: torch.tensor(np.asarray(l[k].astype(jnp.float32))).to(td)
                      for k in ("w", "b")} for l in jp["layers"]]}
    ref = np.asarray(jcol.color_apply(jp, jnp.asarray(z), jnp.asarray(pts), jcfg, jd))
    out = tcol.color_apply(tj, torch.tensor(z), torch.tensor(pts), tcfg, td)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-6)


# ---- the modules' offline statistics against the scripts' formulas ------------

def _maps(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    rh = rng.random(n) < 0.3
    ph = rh.copy()
    flip = rng.choice(n, 40, replace=False)
    ph[flip] = ~ph[flip]
    rd = np.where(rh, 1.5 + 0.2 * rng.random(n), 0.0).astype(np.float32)
    pd = np.where(ph, rd + 1e-3 * rng.standard_normal(n), 0.0).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ms = np.where(rh, 0.0, 0.02 * rng.standard_normal(n)).astype(np.float32)
    return rh, ph, rd, pd, ms, nrm


def test_polish_parity_statistics_are_the_scripts():
    """diag_polish_parity.parity_stats against scripts/diag_polish_parity.py's
    numpy: flips, confinement, the common and frontal quantiles."""
    from dist_renderer_tpu_torch.diag.diag_polish_parity import parity_stats

    rh, ph, rd, pd, ms, nrm = _maps()
    band = 0.012
    got = parity_stats(rh, ph, rd, pd, ms, nrm, band)
    flips = rh != ph
    ms_ref = np.abs(ms)[flips]
    common = rh & ph
    dd = np.abs(pd - rd)[common]
    frontal = (np.abs(nrm[..., 2]) > 0.2) & common
    df = np.abs(pd - rd)[frontal]
    assert got["flips"] == flips.sum() and got["flip_frac"] == pytest.approx(flips.mean())
    assert got["hits_march"] == rh.sum() and got["hits_polish"] == ph.sum()
    assert got["flip_min_sdf_max"] == pytest.approx(ms_ref.max())
    assert got["confined"] == (ms_ref.max() < 2 * band)
    for k, x in (("common", dd), ("frontal", df)):
        assert got[k]["p50"] == pytest.approx(np.median(x))
        assert got[k]["p95"] == pytest.approx(np.percentile(x, 95))
        assert got[k]["max"] == pytest.approx(x.max())
    assert got["gate_p95_met"] == (np.percentile(df, 95) < 1e-3)


def test_band_fidelity_statistics_are_the_scripts():
    """diag_band_fidelity.band_stats against scripts/diag_band_fidelity.py's
    numpy on [F, N] fields, and the promoted / demoted counts."""
    from dist_renderer_tpu_torch.diag.diag_band_fidelity import band_stats

    rh, ph, rd, pd, ms, _ = _maps(1)
    ms_p = ms + 1e-3 * np.random.default_rng(2).standard_normal(ms.shape).astype(np.float32)
    f = lambda a: a.reshape(2, -1)
    band = 0.02
    got = band_stats(f(rh), f(ph), f(ms), f(ms_p), f(rd), f(pd), band)
    sel = ~rh & ~ph & (ms < band)
    dd = np.abs(ms_p[sel] - ms[sel])
    de = np.abs(pd - rd)[rh & ph]
    assert got["hit_agree"] == pytest.approx((rh == ph).mean())
    assert got["flips"] == (rh != ph).sum() == got["promoted"] + got["demoted"]
    assert got["promoted"] == (ph & ~rh).sum() and got["demoted"] == (rh & ~ph).sum()
    assert got["band_rays"] == sel.sum()
    for k, x in (("band_margin", dd), ("hit_depth", de)):
        assert got[k]["p50"] == pytest.approx(np.median(x))
        assert got[k]["p95"] == pytest.approx(np.percentile(x, 95))
        assert got[k]["max"] == pytest.approx(x.max())


def test_precision_statistics_are_the_scripts():
    """diag_precision.error_stats against scripts/diag_precision.py's
    numpy (all points p50 / p95 / max; near-surface, |f_ref| < 0.05),
    and its points: uniform in [-0.9, 0.9]^3 from the seed."""
    from dist_renderer_tpu_torch.diag.diag_precision import error_stats, points

    rng = np.random.default_rng(3)
    f_ref = 0.3 * rng.standard_normal(5000).astype(np.float32)
    f_v = f_ref + 1e-4 * rng.standard_normal(5000).astype(np.float32)
    got = error_stats(f_v, f_ref)
    err = np.abs(f_v - f_ref)
    near = np.abs(f_ref) < 0.05
    assert got["all"]["p50"] == pytest.approx(np.percentile(err, 50))
    assert got["all"]["p95"] == pytest.approx(np.percentile(err, 95))
    assert got["all"]["max"] == pytest.approx(err.max())
    assert got["near"]["n"] == near.sum()
    assert got["near"]["p95"] == pytest.approx(np.percentile(err[near], 95))
    assert got["near"]["max"] == pytest.approx(err[near].max())
    p = points(1000, 0)
    assert p.shape == (1000, 3) and p.dtype == np.float32
    assert p.min() >= -0.9 and p.max() <= 0.9 and np.array_equal(p, points(1000, 0))


def test_finalize_parity_statistics_are_the_scripts():
    """diag_finalize_compile.parity against the script's polish-all
    parity numbers."""
    from dist_renderer_tpu_torch.diag.diag_finalize_compile import parity

    rh, ph, rd, pd, ms, _ = _maps(4)
    got = parity(T(rh), T(ph), T(rd), T(pd), T(ms))
    flips = rh != ph
    dd = np.abs(rd.astype(np.float64) - pd)[rh & ph]
    assert got["flips"] == flips.sum() and got["flip_frac"] == pytest.approx(flips.mean())
    assert got["flip_min_sdf_max"] == pytest.approx(np.abs(ms)[flips].max())
    assert got["common"]["p50"] == pytest.approx(np.median(dd))
    assert got["common"]["p95"] == pytest.approx(np.percentile(dd, 95))


@pytest.mark.parametrize("frac", [0.1, 0.3, 0.6])
def test_hit_first_orderings_are_the_stable_sort(frac):
    """diag_compose's four hit-first orderings (the stable sort, the
    2-class counting sort, the packed single-array sort, the static-size
    nonzero) against numpy's stable argsort of the miss flag, [:bucket];
    nonzero fills past the hits with n."""
    from dist_renderer_tpu_torch.diag.diag_compose import check_orders, hit_first

    n = 4096
    hit = np.random.default_rng(int(frac * 10)).random(n) < frac
    bucket = n // 4
    want = np.argsort(~hit, kind="stable")[:bucket]
    orders = {k: fn() for k, fn in hit_first(T(hit), bucket).items()}
    m = min(hit.sum(), bucket)
    for k, got in orders.items():
        got = got.numpy()
        if k == "nonzero":
            np.testing.assert_array_equal(got[:m], want[:m])
            assert (got[m:] == n).all()
        else:
            np.testing.assert_array_equal(got, want)
    assert not any(check_orders(orders, T(hit), bucket).values())


def test_payload_sort_is_argsort_then_gather():
    """diag_glue.sort_payloads (one gather of the stacked payloads) is a
    stable argsort of the keys and a take of each payload (numpy)."""
    from dist_renderer_tpu_torch.diag.diag_glue import operands, sort_payloads

    x = operands("cpu", 2, 3000)
    out = sort_payloads(x["key"], x["pays"][:4])
    key = x["key"].numpy()
    order = np.argsort(key, axis=1, kind="stable")
    np.testing.assert_array_equal(out[0].numpy(), np.take_along_axis(key, order, 1))
    for got, p in zip(out[1:], x["pays"][:4]):
        np.testing.assert_array_equal(got.numpy(), np.take_along_axis(p.numpy(), order, 1))


# ---- retrain_proxy's output files -------------------------------------------

def test_retrain_proxy_names_the_committed_proxy_only_with_promote(tmp_path):
    """The new proxy goes to .bench_proxy_v2.npz (or --out); the
    committed .bench_proxy.npz is written only with --promote, and then
    only when the new error report improves on the old one's max and
    p99; an --out naming it is refused. .gitignore lists the new
    file."""
    from dist_renderer_tpu_torch.diag.retrain_proxy import output_files

    root = str(tmp_path)
    bench = os.path.join(root, ".bench_proxy.npz")
    old = dict(p99=5e-3, max=8e-3)
    better, worse = dict(p99=4e-3, max=6e-3), dict(p99=4e-3, max=9e-3)
    for out in (None, os.path.join(root, "other.npz")):
        for new in (None, better, worse):
            for o in (None, old):
                files = output_files(root, out, False, o, new)
                assert bench not in files and len(files) == 1
        assert output_files(root, out)[0] == (out or os.path.join(root,
                                                                  ".bench_proxy_v2.npz"))
        assert output_files(root, out, True, old, better)[1:] == [bench]
        assert output_files(root, out, True, old, worse)[1:] == []
        assert output_files(root, out, True, None, worse)[1:] == [bench]
    for promote in (False, True):
        with pytest.raises(SystemExit, match="promote"):
            output_files(root, bench, promote, old, better)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".bench_proxy_v2.npz" in f.read().split()
