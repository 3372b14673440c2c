"""The CUDA kernels against their plain versions, on the card.

The tests marked ``gpu`` need a CUDA card and skip without one. They
import nothing of JAX, so they run where JAX is absent; tests/conftest.py
imports JAX, so run them with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Scenes come from the committed bench fixtures (the 4x256 proxy is a
fitted SDF too) and numpy seeds. The unmarked tests check, on the CPU,
the wrapper rules that hold without a card.

The kernels are held to their plain versions bit for bit, with the plain
versions' product (``decoder.dot_f32``) swapped for a sum over k in
order (the ``k_order`` fixture). Every operand of those products is
bf16-valued, so each term is exact in fp32 and the in-order sum is the
kernels' fmaf chain term for term. The card's GEMM, which the plain
versions use otherwise, picks its summation order by shape; a last-bit
difference can then move a bf16 rounding of an activation (2^-8
relative) or a march's stopping sample, so against it only agreement
fractions hold (chip_smoke.py's bars at the main path's shapes).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dist_renderer_tpu_torch.config import (
    DecoderConfig, GradConfig, MarchConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf, params_from_numpy
from dist_renderer_tpu_torch.models.pretrain import load_params_npz
from dist_renderer_tpu_torch.models.proxy import load_proxy_npz
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
from dist_renderer_tpu_torch.ops.kernels import build, march_body
from dist_renderer_tpu_torch.ops.kernels import recompute as rc
from dist_renderer_tpu_torch.ops.kernels.queue_march import queue_march
from dist_renderer_tpu_torch.ops.renderer import (
    SDFRenderer, make_march_factory, render,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARCH = MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4)
TRACE_FIELDS = ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf",
                "unresolved", "steps_per_ray", "bracketed")


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _dot_k_order(a, b):
    """a [N, K] @ b [K, M] summed over k in order, one fp32 rounding per
    term (each product of bf16-valued operands is exact)."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[1]):
        out = out + a[:, k:k + 1] * b[k]
    return out


@pytest.fixture
def k_order(monkeypatch):
    """The plain versions with the kernels' summation order."""
    monkeypatch.setattr(march_body, "dot_f32", _dot_k_order)
    monkeypatch.setattr(rc, "dot_f32", _dot_k_order)


def _scene(dev, img=32, frames=2, seed=0):
    """Bench proxy + jittered latents, rays of `frames` views with a
    seeded subset of seeds and inactive rays."""
    params, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    rng = np.random.default_rng(seed)
    lat = z0[None] + 0.001 * torch.as_tensor(
        rng.standard_normal((frames, z0.shape[0])), dtype=torch.float32, device=dev)
    o, v = [], []
    for f in range(frames):
        cam = Camera.looking_at((0.3 * f, 0.0, -2.5), focal=img * 1.2,
                                img_hw=(img, img), device=dev)
        of, vf = pixel_rays(cam, img, img)
        o.append(of)
        v.append(vf)
    o, v = torch.stack(o), torch.stack(v)
    n = img * img
    key = torch.as_tensor(rng.integers(0, 3, size=(frames, n)), dtype=torch.int32,
                          device=dev)
    seed_d = torch.where(
        key == 1, torch.as_tensor(rng.uniform(1.3, 1.8, (frames, n)),
                                  dtype=torch.float32, device=dev),
        torch.full((frames, n), float("nan"), device=dev))
    shared = bm.pack_shared(params, pcfg)
    bank = bm.fold_bias_bank(params, lat, pcfg, shared)
    return shared, bank, o, v, key, seed_d


@pytest.mark.gpu
@pytest.mark.parametrize("salvage", [True, False])
def test_cuda_k1_matches_plain(salvage, k_order):
    dev = _device()
    shared, bank, o, v, key, seed_d = _scene(dev)
    run = lambda k: bm.batched_trace_padded(shared, bank, o, v, MARCH, seed_d,
                                            key != 2, salvage=salvage,
                                            use_kernel=k)
    n0 = bm.sphere_trace_persistent.launches
    out = run(True)
    assert bm.sphere_trace_persistent.launches == n0 + 1
    ref = run(False)
    assert bm.sphere_trace_persistent.launches == n0 + 1
    torch.cuda.synchronize()
    assert out.hit.sum() > 100
    for name in TRACE_FIELDS:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("caps", [(1, 2, 6, 16), (2, 2, 2), (64,)])
def test_cuda_k2_equals_k1_exactly(caps, k_order):
    dev = _device()
    shared, bank, o, v, key, seed_d = _scene(dev, seed=1)
    n0 = queue_march.launches
    q = queue_march(shared, bank, o, v, key, seed_d, MARCH, gen_caps=caps)
    assert queue_march.launches == n0 + len(caps) + 2  # seed + generations
    ref = bm.batched_trace_padded(shared, bank, o, v, MARCH, seed_d, key != 2)
    plain = queue_march(shared, bank, o, v, key, seed_d, MARCH, gen_caps=caps,
                        use_kernel=False)
    torch.cuda.synchronize()
    for a, b in [(q.depth, ref.depth), (q.hit, ref.hit), (q.min_sdf, ref.min_sdf),
                 (q.depth_at_min, ref.depth_at_min), (q.last_sdf, ref.last_sdf),
                 (q.unresolved, ref.unresolved)]:
        assert torch.equal(a, b)
    r_pad = ref.steps_per_ray.shape[0] // o.shape[0]
    assert torch.equal(q.steps, ref.steps_per_ray.reshape(o.shape[0], r_pad)[:, :o.shape[1]])
    for a, b in zip(q, plain):
        assert torch.equal(a, b)


K3_ARCHS = [
    dict(latent_size=32, hidden_dims=(64,) * 8, latent_in=(4,)),
    dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), xyz_in_all=True),
    dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), use_tanh=True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", range(len(K3_ARCHS) + 1))
def test_cuda_k3_matches_plain(arch, k_order):
    dev = _device()
    rng = np.random.default_rng(arch)
    if arch == len(K3_ARCHS):  # the 8x512 bench decoder
        params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
        cfg = DecoderConfig()
    else:
        cfg = DecoderConfig(**K3_ARCHS[arch])
        params = params_from_numpy({"layers": [
            {"w": rng.standard_normal((i, o)) * np.sqrt(2.0 / i),
             "b": 0.1 * rng.standard_normal(o)} for i, o in cfg.layer_dims]}, dev)
        z = torch.as_tensor(0.3 * rng.standard_normal(cfg.latent_size),
                            dtype=torch.float32, device=dev)
    n = 3000  # not a multiple of the tile
    pts = torch.as_tensor(0.6 * rng.standard_normal((n, 3)), dtype=torch.float32,
                          device=dev)
    dirs = torch.nn.functional.normalize(
        torch.as_tensor(rng.standard_normal((n, 3)), dtype=torch.float32,
                        device=dev), dim=-1)
    pk = rc.pack_precise(params, cfg)
    b = rc.fold_bias_precise(params, z, cfg, pk)
    n0 = rc.precise_sdg_call.launches
    out = rc.precise_sdg_call(pk, b, pts, dirs)
    assert rc.precise_sdg_call.launches == n0 + 1
    ref = rc.precise_sdg_call(pk, b, pts, dirs, use_kernel=False)
    assert rc.precise_sdg_call.launches == n0 + 1
    torch.cuda.synchronize()
    for name, a, r in zip(("s", "dd", "g"), out, ref):
        assert torch.equal(a, r), name
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[2]).all()


@pytest.mark.gpu
def test_cuda_render_matches_plain_render():
    dev = _device()
    params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    proxy, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    img = 64
    cfg = RenderConfig(
        img_h=img, img_w=img,
        march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                          coarse_to_fine=True, c2f_strides=(16, 4),
                          c2f_coarse_steps=16),
        grad=GradConfig(mode="ift", compact_frac=4, compact_min=1024),
        compute_dtype="bfloat16", use_pallas=True)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2,
                            img_hw=(img, img), device=dev)
    sdf = make_precise_sdf(params, DecoderConfig())
    outs = []
    for use in (True, False):
        c = dataclasses.replace(cfg, use_pallas=use)
        fac = make_march_factory(params, DecoderConfig(), c, march_params=proxy,
                                 march_dcfg=pcfg)
        outs.append(render(sdf, z, cam, c, fac))
    a, b = outs
    assert (a.mask == b.mask).float().mean() >= 0.99
    both = a.mask & b.mask
    assert ((a.depth - b.depth).abs()[both] <= 1e-3).float().mean() >= 0.99
    assert torch.isfinite(a.depth).all() and torch.isfinite(a.normal).all()


@pytest.mark.gpu
def test_cuda_sdf_renderer_on_the_card(k_order):
    """SDFRenderer on the weights' device, fed numpy intrinsics, pose and
    latent, renders through K1, K2 and K3, and equals the same render on
    the plain versions bit for bit."""
    dev = _device()
    proxy, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    _, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    img = 32
    cfg = RenderConfig(
        img_h=img, img_w=img,
        march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                          coarse_to_fine=True, c2f_strides=(16, 4),
                          c2f_coarse_steps=16),
        grad=GradConfig(mode="ift", compact_frac=4, compact_min=256),
        compute_dtype="bfloat16", use_pallas=True)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img))
    K, R, T = (x.numpy() for x in cam)
    counters = (bm.sphere_trace_persistent, queue_march, rc.precise_sdg_call)
    n0 = [fn.launches for fn in counters]
    outs = []
    for use in (True, False):
        r = SDFRenderer(proxy, K, (img, img), decoder_cfg=pcfg,
                        cfg=dataclasses.replace(cfg, use_pallas=use))
        assert r.device == proxy["layers"][0]["w"].device
        outs.append(r.render(z.numpy(), R, T))
        if use:
            assert all(fn.launches > c for fn, c in zip(counters, n0))
            n0 = [fn.launches for fn in counters]
    assert [fn.launches for fn in counters] == n0
    a, b = outs
    assert a.depth.is_cuda and a.mask.float().mean() > 0.05
    for k in ("depth", "mask", "normal", "min_sdf", "points"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_inputs():
    dev = _device()
    shared, bank, o, v, key, seed_d = _scene(dev)
    rs = bm.ray_setup(o[0], v[0], MARCH)
    with pytest.raises(ValueError):  # bank on the wrong device
        bm.march_rows_cuda(shared, bank.cpu(), 1024, o[0], v[0], rs, MARCH, True)
    params, _ = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    pk = rc.pack_precise(params, DecoderConfig())
    p = torch.zeros(16, 3, device=dev)
    with pytest.raises(ValueError):  # non-contiguous points
        rc.precise_sdg_call(pk, [torch.zeros(m.out_p, device=dev) for m in pk.meta],
                            torch.zeros(3, 16, device=dev).T, p)


def test_cpu_tensors_take_the_plain_versions_uncounted():
    """On a CPU tensor every wrapper runs its plain version and counts no
    launch (launches count CUDA kernel launches only)."""
    dev = torch.device("cpu")
    shared, bank, o, v, key, seed_d = _scene(dev, img=16, frames=1)
    counts = (bm.sphere_trace_persistent.launches, queue_march.launches,
              rc.precise_sdg_call.launches)
    a = bm.batched_trace_padded(shared, bank, o, v, MARCH, seed_d, key != 2)
    b = bm.batched_trace_padded(shared, bank, o, v, MARCH, seed_d, key != 2,
                                use_kernel=False)
    assert torch.equal(a.depth, b.depth) and torch.equal(a.hit, b.hit)
    queue_march(shared, bank, o, v, key, seed_d, MARCH)
    params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    sdg = make_precise_sdf(params, DecoderConfig()).sdg_builder()
    sdg(z, o[0, :8], v[0, :8])
    assert counts == (bm.sphere_trace_persistent.launches, queue_march.launches,
                      rc.precise_sdg_call.launches)


def test_kernel_build_is_keyed_by_source_hash():
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    names = {os.path.basename(p) for p in build._sources()}
    assert {"march_body.cuh", "batched_march.cu", "queue_march.cu",
            "recompute.cu"} <= names
    assert "-use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
