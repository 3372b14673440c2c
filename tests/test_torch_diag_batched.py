"""The batched render's straggler telemetry (``with_diag``) and its
unverified proxy trace (``proxy_verify=False``) against the JAX
package's, on the CPU, and the scheduling diagnostics' offline parts.

Scene: tests/test_torch_polish.py's (a 4x48 decoder fitted to a sphere
and its distilled 3x32 proxy), two frames of 32x32; the cert contracts
on tests/test_proxy.py's camera. The JAX side runs its kernels in
interpret mode. Bars are tests/test_torch_batched.py's: the two
packages' CPU BLAS libraries sum in different orders, so a ray near a
stopping rule may stop one sample apart (per-ray step counts and keys
agree on >= 99% of rays, planning widths and seeds within 1e-3 on >= 98%
of the entries finite on both sides, the cert counts within 1%).
Residencies are not compared with JAX's: the port's is per 64-row tile
of the card's march, JAX's per 512-lane TPU block.
"""

import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.config import MarchConfig as JMarchConfig
from dist_renderer_tpu.ops import camera as jcam
from dist_renderer_tpu.ops.pallas import batched_march as jbm
from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
from test_torch_batched import T, _assert_trace_parity, sphere  # noqa: F401
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)
from test_torch_polish import MARCH_KW, _frames, decoders  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32
N = IMG * IMG
F = 2
FLAGS = dict(strides=(4,), shared_origin=True, return_anchor=True,
             return_steps=True, return_last=True)
OUT_FIELDS = ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf", "steps",
              "unresolved", "weak")
# with_diag against without, port only: every verify treatment and both
# schedulers
MODES = {
    "rounds": {}, "queue": dict(scheduler="queue"),
    "cert": dict(verify_mode="cert"), "hybrid": dict(verify_band="probe"),
    "polish-all": dict(verify_hits="polish-all"),
}
DIAG_MODULES = ("diag_perf", "diag_proxy", "diag_proxy_ab", "diag_kernel",
                "diag_proxy_cost", "diag_binning", "diag_round_caps",
                "diag_verify_caps", "diag_queue", "diag_caps_ab", "diag_repack_scale",
                "sweep_batched")


def _port(decoders, lat, ob, vb, **kw):
    params, _, dkw, proxy, pkw = decoders
    kw = {"verify_round_caps": (2, 4, 12), **FLAGS, **kw}
    return bm.render_batched_c2f(
        params_from_numpy(params), DecoderConfig(**dkw), lat, ob, vb, (IMG, IMG),
        MarchConfig(**MARCH_KW), proxy=(params_from_numpy(proxy), DecoderConfig(**pkw)),
        **kw)


def _jax(decoders, lat, ob, vb, **kw):
    params, _, dkw, proxy, pkw = decoders
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jproxy = (jax.tree_util.tree_map(jnp.asarray, proxy), JDecoderConfig(**pkw))
    kw = {"verify_round_caps": (2, 4, 12), **FLAGS, **kw}
    return jax.jit(lambda: jbm.render_batched_c2f(
        jp, JDecoderConfig(**dkw), jnp.asarray(lat), jnp.asarray(ob), jnp.asarray(vb),
        (IMG, IMG), JMarchConfig(**MARCH_KW), proxy=jproxy, interpret=True, **kw))()


def _proxy_scene(z0):
    """tests/test_proxy.py's cert scene: the sphere's latent twice, the
    camera at z=-2, focal 40."""
    cam = jcam.Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(IMG, IMG))
    o, v = (np.asarray(a) for a in jcam.pixel_rays(cam, IMG, IMG))
    lat = np.stack([z0, z0]).astype(np.float32)
    return lat, *(np.broadcast_to(a[None], (F, N, 3)).copy() for a in (o, v))


def _close_on_finite(j, t, share=0.98, bar=1e-3):
    fj, ft = np.isfinite(j), np.isfinite(t)
    assert np.mean(fj == ft) >= 0.99
    both = fj & ft
    assert both.any()
    assert np.mean(np.abs(j[both] - t[both]) <= bar) >= share


@pytest.mark.parametrize("mode", ["march", "cert-probe"])
def test_render_batched_c2f_diag_matches_jax(decoders, mode):
    """with_diag=True through both packages: the coarse levels' per-ray
    steps, the plan (key, width, seed), the verify key and, under cert
    with probed band rays, the four cert counts, on tests/test_proxy.py's
    camera with a proxy_backoff of 2e-4 (so demotions occur) and a band
    of 0.05 (so band rays are probed)."""
    _, z0, _, _, _ = decoders
    lat, ob, vb = _proxy_scene(z0)
    kw = (dict(verify_mode="cert", verify_band="probe", proxy_backoff=2e-4,
               proxy_band=0.05) if mode == "cert-probe" else {})
    ref = _jax(decoders, lat, ob, vb, with_diag=True, **kw)
    jdiag = {k: np.asarray(v) for k, v in ref[-1].items()}
    out, diag = _port(decoders, T(lat), T(ob), T(vb), with_diag=True, **kw)
    _assert_trace_parity(ref[0], ref[1], ref[2], out.depth.numpy(), out.hit.numpy(),
                         out.min_sdf.numpy())
    want = {"coarse4_block_residency", "coarse4_ray_steps", "plan_key", "plan_width",
            "plan_seed", "fine_r0_block_residency", "fine_r1_block_residency",
            "fine_r2_block_residency", "verify_fine_r0_block_residency",
            "verify_fine_r1_block_residency", "verify_fine_r2_block_residency",
            "verify_fine_r3_block_residency", "verify_key"}
    if mode == "cert-probe":
        want |= {"cert_frac", "cert_demoted", "cert_promoted", "cert_band_probed"}
    assert set(diag) == set(jdiag) == want
    tdiag = {k: v.numpy() for k, v in diag.items()}
    steps = tdiag["coarse4_ray_steps"]
    assert steps.shape == jdiag["coarse4_ray_steps"].shape == (F, N // 16)
    assert steps.sum() > 0 and np.mean(steps == jdiag["coarse4_ray_steps"]) >= 0.99
    for k in ("plan_key", "verify_key"):
        assert tdiag[k].shape == (F, N) and np.mean(tdiag[k] == jdiag[k]) >= 0.99, k
    assert (tdiag["verify_key"] == 1).any() and (tdiag["verify_key"] == 0).any()
    for k in ("plan_width", "plan_seed"):
        _close_on_finite(jdiag[k], tdiag[k])
    if mode == "cert-probe":
        for k in ("cert_demoted", "cert_promoted", "cert_band_probed"):
            j, t = float(jdiag[k]), float(tdiag[k])
            assert abs(t - j) <= 0.01 * j + 1e-9, (k, t, j)
        assert tdiag["cert_demoted"] > 0 and tdiag["cert_band_probed"] > 0
        assert abs(float(tdiag["cert_frac"]) - float(jdiag["cert_frac"])) <= 0.01
        assert 0.0 < float(tdiag["cert_frac"]) < 1.0


def test_unverified_proxy_trace_matches_jax(decoders):
    """proxy_verify=False: the proxy stage's trace, to the bars of the
    verified render, and no verify stage in the port's telemetry."""
    _, z0, _, _, _ = decoders
    lat, ob, vb = _frames(z0, IMG)
    ref = [np.asarray(a) for a in _jax(decoders, lat, ob, vb, proxy_verify=False)]
    out, diag = _port(decoders, T(lat), T(ob), T(vb), proxy_verify=False, with_diag=True)
    _assert_trace_parity(ref[0], ref[1], ref[2], out.depth.numpy(), out.hit.numpy(),
                         out.min_sdf.numpy())
    assert np.mean(np.abs(ref[3] - out.depth_at_min.numpy()) < 1e-3) >= 0.98
    assert np.mean(ref[4] == out.steps.numpy()) >= 0.98
    assert np.mean(ref[6] == out.unresolved.numpy()) >= 0.99
    assert not any(k.startswith("verify") for k in diag)
    # the verified render re-marches: more steps on the same rays
    verified = _port(decoders, T(lat), T(ob), T(vb))
    assert verified.steps.sum() > out.steps.sum()


@pytest.mark.parametrize("mode", list(MODES))
def test_with_diag_changes_no_bit(decoders, mode):
    """Telemetry leaves the render as it is: every output field equal with
    and without with_diag, on the plain versions (the CPU GEMM, whose sums
    may depend on a launch's width: the telemetry keeps the widths)."""
    _, z0, _, _, _ = decoders
    lat, ob, vb = (T(a) for a in _frames(z0, IMG))
    plain = _port(decoders, lat, ob, vb, **MODES[mode])
    out, diag = _port(decoders, lat, ob, vb, with_diag=True, **MODES[mode])
    for k in OUT_FIELDS:
        a, b = getattr(plain, k), getattr(out, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert torch.equal(a.isnan(), b.isnan()) and torch.equal(
                a.nan_to_num(0.0), b.nan_to_num(0.0)), k
    rounds = [k for k in diag if k.startswith("fine_r")]
    assert (rounds == []) == (mode == "queue")
    assert "verify_key" in diag and ("cert_frac" in diag) == (mode in ("cert", "hybrid"))


def test_residency_is_the_march_tiles_steps(decoders, monkeypatch):
    """Each *_block_residency is march_tile_steps of that launch's steps in
    its row order (the K1 launches in call order: the coarse level, the
    proxy stage's rounds, the verify stage's rounds), and each coarse
    level's ray steps are its launch's, unpadded."""
    _, z0, _, _, _ = decoders
    lat, ob, vb = (T(a) for a in _frames(z0, IMG))
    seen = []
    real = bm.batched_trace_padded

    def spy(*a, **k):
        res = real(*a, **k)
        seen.append(res.steps_per_ray.clone())
        return res

    monkeypatch.setattr(bm, "batched_trace_padded", spy)
    _, diag = _port(decoders, lat, ob, vb, with_diag=True)
    res_keys = [k for k in diag if k.endswith("_block_residency")]
    assert res_keys[0] == "coarse4_block_residency"
    assert res_keys[1:4] == [f"fine_r{i}_block_residency" for i in range(3)]
    assert res_keys[4:] == [f"verify_fine_r{i}_block_residency" for i in range(4)]
    assert len(seen) == len(res_keys)
    for k, steps in zip(res_keys, seen):
        assert torch.equal(diag[k], bm.march_tile_steps(steps)), k
        assert diag[k].numel() == -(-steps.numel() // bm.MARCH_TILE)
        # a tile pays the most of its rays' steps: lane-steps >= ray-steps
        assert int(diag[k].sum()) * bm.MARCH_TILE >= int(steps.sum())
    r_pad = seen[0].numel() // F
    assert torch.equal(diag["coarse4_ray_steps"],
                       seen[0].reshape(F, r_pad)[:, :diag["coarse4_ray_steps"].shape[1]])


def test_cert_counts_fire_as_in_the_jax_tests(decoders):
    """The port's counterparts of tests/test_proxy.py's asserts: with a
    proxy_backoff of 2e-4, far below the proxy's error, cert demotes hits
    (cert_demoted > 0); with band probing and a band of 0.05, band rays
    are probed (cert_band_probed > 0). The counts are device tensors."""
    _, z0, _, _, _ = decoders
    lat, ob, vb = (T(a) for a in _proxy_scene(z0))
    kw = dict(strides=(4,), shared_origin=True, verify_round_caps=None)
    _, d1 = _port(decoders, lat, ob, vb, verify_mode="cert", proxy_backoff=2e-4,
                  with_diag=True, **kw)
    assert isinstance(d1["cert_demoted"], torch.Tensor)
    assert int(d1["cert_demoted"]) > 0
    _, d2 = _port(decoders, lat, ob, vb, verify_mode="cert", verify_band="probe",
                  proxy_band=0.05, with_diag=True, **kw)
    assert int(d2["cert_band_probed"]) > 0


def test_binning_residency_matches_the_jax_script():
    """diag_binning's offline residency simulation against
    scripts/diag_binning.py's residency_ms with its block set to the
    card's 64-row tile, on the same numpy steps and keys; and its
    strategies' sort keys against the script's."""
    spec = importlib.util.spec_from_file_location(
        "jax_diag_binning", os.path.join(ROOT, "scripts", "diag_binning.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.BLOCK = bm.MARCH_TILE
    from dist_renderer_tpu_torch.diag import diag_binning

    rng = np.random.default_rng(5)
    steps = rng.integers(0, 50, (3, 1000)) * (rng.random((3, 1000)) < 0.4)
    key = rng.integers(0, 3, (3, 1000))
    width = np.where(rng.random((3, 1000)) < 0.1, np.inf, rng.exponential(0.05, (3, 1000)))
    for k in (key, -steps, key * 100 + steps % 7):
        tot, ms = diag_binning.residency_ms(steps, k, us_per_tile_step=2.5)
        j_tot, j_ms = script.residency_ms(steps, k, us_per_block_step=2.5)
        assert tot == j_tot and ms == pytest.approx(j_ms)
    keys = diag_binning.strategies(steps, key, width)
    assert list(keys) == ["current (class)", "oracle (true steps)", "class+width(4q)",
                          "class+width(8q)", "width only"]
    np.testing.assert_array_equal(keys["class+width(4q)"], key * 100 + np.digitize(
        np.nan_to_num(width, posinf=9.0), [0.01, 0.03, 0.1]))
    sim = diag_binning.simulate(steps, key, width, us_per_tile_step=2.5)
    assert sim["strategies"]["oracle (true steps)"]["residency"] <= \
        sim["strategies"]["current (class)"]["residency"]
    for cap in (8, 12, 16):
        a, _ = script.residency_ms(np.minimum(steps, cap), key, 2.5)
        rem = np.maximum(steps - cap, 0)
        b, _ = script.residency_ms(rem, -rem, 2.5)
        assert sim["two_round"][str(cap)]["residency"] == a + b


@pytest.mark.parametrize("name", DIAG_MODULES)
def test_diag_module_needs_a_card(name, monkeypatch):
    """Each scheduling diagnostic runs on one CUDA card: without one it
    raises SystemExit before it loads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"dist_renderer_tpu_torch.diag.{name}")
    with pytest.raises(SystemExit, match="CUDA card"):
        mod.main([])


def test_diag_modules_import_no_jax():
    """The scheduling diagnostics import nothing of JAX or the JAX package
    (a fresh interpreter: this test process imports both)."""
    import subprocess
    import sys

    mods = [f"dist_renderer_tpu_torch.diag.{m}" for m in DIAG_MODULES]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dist_renderer_tpu', 'optax', 'orbax'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
