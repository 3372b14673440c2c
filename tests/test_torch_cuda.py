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
fractions hold (chip_smoke.py's bars at the main path's shapes). K5 and
K6 sum on the tensor cores (csrc/point_mlp.cuh): they are held to K5's
bars and to their own bits under any grouping of their points.
"""

import os

import numpy as np
import pytest
import torch

from dist_renderer_tpu_torch.config import (
    DecoderConfig, GradConfig, MarchConfig, RenderConfig,
)
from dist_renderer_tpu_torch.models.decoder import make_precise_sdf, params_from_numpy
from dist_renderer_tpu_torch.models.folded import fold_latent
from dist_renderer_tpu_torch.models.pretrain import load_params_npz
from dist_renderer_tpu_torch.models.proxy import load_proxy_npz
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
from dist_renderer_tpu_torch.ops.kernels import build, march_body
from dist_renderer_tpu_torch.ops.kernels import fused_march as fm
from dist_renderer_tpu_torch.ops.kernels import queue_march as qm
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


def _same(a, b) -> bool:
    """Equal bits, NaN where NaN (never-marched rays keep a NaN seed)."""
    if a.is_floating_point():
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(0.0), b.nan_to_num(0.0))
    return torch.equal(a, b)


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
@pytest.mark.parametrize("which", ["proxy", "bench"])
def test_cuda_k1_grouping_is_bit_exact(which):
    """A ray's bits do not depend on the tile, block or launch that
    marches it: K1 on the rays shuffled within each frame, on ragged
    prefixes (tiles cut short, frames straddled, persistent grids of 1 and
    2 blocks and of one block per SM) and K1-multi (a block per tile)
    equal K1 on them in order, whose blocks stride over 287 tiles."""
    dev = _device()
    shared, bank, o, v, key, seed_d = _scene(dev, img=96, seed=6)
    if which == "bench":
        params, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
        shared = bm.pack_shared(params, DecoderConfig())
        bank = bm.fold_bias_bank(params, torch.stack([z0, z0 + 0.001]), DecoderConfig(),
                                 shared)
    # 9170 rays a frame pad to 9184: 143.5 tiles, so a tile straddles frames
    o, v, key, seed_d = o[:, :9170], v[:, :9170], key[:, :9170], seed_d[:, :9170]
    f = key.shape[0]
    o_p, v_p, s_p, a_p, _, r_pad = bm.pad_frames(o, v, seed_d, key != 2)
    assert r_pad % bm.MARCH_TILE
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert f * r_pad > 2 * sms * bm.MARCH_TILE  # every block takes two tiles or more
    rs = bm.ray_setup(o_p, v_p, MARCH, s_p, a_p)
    rows = lambda idx, persistent=True: bm.march_rows_cuda(
        shared, bank, r_pad, o_p[idx], v_p[idx],
        bm.RaySetup(*(x[idx] for x in rs)), MARCH, True, persistent=persistent)
    every = torch.arange(f * r_pad, device=dev)
    ref = rows(every)
    gen = torch.Generator(device="cpu").manual_seed(3)
    perm = torch.cat([i * r_pad + torch.randperm(r_pad, generator=gen)
                      for i in range(f)]).to(dev)
    shuffled = rows(perm)
    per_tile = rows(every, persistent=False)
    torch.cuda.synchronize()
    assert ref[1].sum() > 100
    assert torch.equal(shuffled, ref[:, perm]) and torch.equal(per_tile, ref)
    for n in (1, 63, 65, r_pad + 40, f * r_pad - 1):
        part = rows(every[:n])
        torch.cuda.synchronize()
        assert torch.equal(part, ref[:, :n]), n


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
        assert (a is None and b is None) or torch.equal(a, b)


def _k2_fields_equal(q, ref, f, r):
    """K2's StageResult equals a padded trace (K1's, the witness's) on
    every field, bit for bit."""
    for a, b in [(q.depth, ref.depth), (q.hit, ref.hit), (q.min_sdf, ref.min_sdf),
                 (q.depth_at_min, ref.depth_at_min), (q.last_sdf, ref.last_sdf),
                 (q.unresolved, ref.unresolved)]:
        assert torch.equal(a, b)
    r_pad = ref.steps_per_ray.shape[0] // f
    assert torch.equal(q.steps, ref.steps_per_ray.reshape(f, r_pad)[:, :r])


class _Queues:
    """queue_march.generation_watch: keeps each generation's queue and, with
    shuffle_at, permutes that generation's queue (seeded) before it runs."""

    def __init__(self, shuffle_at=None):
        self.queues, self.shuffle_at = [], shuffle_at

    def __call__(self, state, queue, count):
        c = int(count.item())
        if len(self.queues) == self.shuffle_at:
            gen = torch.Generator(device="cpu").manual_seed(11)
            queue[:c] = queue[:c][torch.randperm(c, generator=gen).to(queue.device)]
        self.queues.append(queue[:c].clone())


@pytest.mark.gpu
def test_cuda_k2_impure_queue_tiles_equal_k1_and_plain(k_order, monkeypatch):
    """K2 at F=4 with 900 rays a frame (padded to 928, not a multiple of
    the 64-row tile): its queue tiles hold rays of two frames or more
    (impure: a bias per row), and every field equals K1's and the
    in-order plain version's bit for bit."""
    dev = _device()
    shared, bank, o, v, key, seed_d = _scene(dev, img=30, frames=4, seed=5)
    watch = _Queues()
    monkeypatch.setattr(qm, "generation_watch", watch)
    q = queue_march(shared, bank, o, v, key, seed_d, MARCH, gen_caps=(1, 2, 6, 16))
    monkeypatch.setattr(qm, "generation_watch", None)
    ref = bm.batched_trace_padded(shared, bank, o, v, MARCH, seed_d, key != 2)
    plain = queue_march(shared, bank, o, v, key, seed_d, MARCH, gen_caps=(1, 2, 6, 16),
                        use_kernel=False)
    torch.cuda.synchronize()
    r_pad = ref.steps_per_ray.shape[0] // 4
    assert r_pad == 928
    impure = sum(int((~bm.tile_frames(qu, r_pad)[1]).sum()) for qu in watch.queues[:-1])
    assert impure > 0 and q.hit.sum() > 100
    _k2_fields_equal(q, ref, 4, o.shape[1])
    for a, b in zip(q, plain):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["proxy", "bench"])
def test_cuda_k2_shuffled_queue_keeps_every_bit(which, monkeypatch):
    """K2 with generation 1's queue permuted on the card before it runs
    (the order the atomics leave is open) gives the same bits as K2
    unshuffled and as K1: a ray's march does not depend on its tile."""
    dev = _device()
    shared, bank, o, v, key, seed_d = _scene(dev, img=48, frames=2, seed=3)
    if which == "bench":
        params, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
        shared = bm.pack_shared(params, DecoderConfig())
        bank = bm.fold_bias_bank(params, torch.stack([z0, z0 + 0.001]), DecoderConfig(),
                                 shared)
    run = lambda: queue_march(shared, bank, o, v, key, seed_d, MARCH, gen_caps=(1, 2, 6, 16))
    a = run()
    watch = _Queues(shuffle_at=1)
    monkeypatch.setattr(qm, "generation_watch", watch)
    b = run()
    monkeypatch.setattr(qm, "generation_watch", None)
    ref = bm.batched_trace_padded(shared, bank, o, v, MARCH, seed_d, key != 2)
    torch.cuda.synchronize()
    assert watch.queues[1].numel() > 100
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)
    _k2_fields_equal(b, ref, 2, o.shape[1])


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["proxy", "bench"])
def test_cuda_k1_grid_and_k2_equal_the_in_order_march(which):
    """K1-grid (one frame, seeded and inactive rays, salvage on and off)
    and K2 (two frames) on the tensor cores equal the in-order witness
    (csrc/march_in_order.cu: the decoder on CUDA cores, every sum in k
    order) bit for bit: the near-tie margin missed no tie on these rays."""
    from dist_renderer_tpu_torch.ops.kernels.march_in_order import trace_in_order

    dev = _device()
    packed, shared, bank, o, v, key, seed_d = _grid_scene(dev, which)
    for salvage in (True, False):
        a = fm.sphere_trace_grid(packed, o, v, MARCH, seed_d, init_active=key != 2,
                                 salvage=salvage)
        w = trace_in_order(shared, bank, o[None], v[None], MARCH, seed_d[None],
                           (key != 2)[None], salvage)
        torch.cuda.synchronize()
        assert a.hit.sum() > 100
        for name in TRACE_FIELDS:
            x, y = getattr(a, name), getattr(w, name)
            assert torch.equal(x, y[:x.shape[0]] if name == "steps_per_ray" else y[0]), name
    shared2, bank2, o2, v2, key2, seed2 = _scene(dev, img=48, frames=2, seed=3)
    if which == "bench":
        params, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
        shared2 = shared
        bank2 = bm.fold_bias_bank(params, torch.stack([z0, z0 + 0.001]), DecoderConfig(),
                                  shared)
    q = queue_march(shared2, bank2, o2, v2, key2, seed2, MARCH)
    w = trace_in_order(shared2, bank2, o2, v2, MARCH, seed2, key2 != 2)
    torch.cuda.synchronize()
    assert q.hit.sum() > 100
    _k2_fields_equal(q, w, 2, o2.shape[1])


K3_ARCHS = [
    dict(latent_size=32, hidden_dims=(64,) * 8, latent_in=(4,)),
    dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), xyz_in_all=True),
    dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), use_tanh=True),
]


# point counts: not a multiple of the 64-point tile, under one tile, and
# one past a multiple of it
K34_SIZES = [3000, 40, 64 * 5 + 1]


@pytest.mark.gpu
@pytest.mark.parametrize("n", K34_SIZES)
@pytest.mark.parametrize("arch", range(len(K3_ARCHS) + 1))
def test_cuda_k3_matches_plain(arch, n, k_order):
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
@pytest.mark.parametrize("n", K34_SIZES)
@pytest.mark.parametrize("arch", range(len(K3_ARCHS) + 1))
def test_cuda_k3_value_is_k3s_s(arch, n, k_order):
    """K3's value mode: K3's s and its in-order plain version's, bit for
    bit; one launch counted, none for the plain version; no point, no
    launch's work."""
    dev = _device()
    _, _, _, pk, b, pts, _ = _k4_inputs(arch, dev, n)
    dirs = torch.nn.functional.normalize(torch.ones_like(pts), dim=-1)
    n0 = rc.precise_value_call.launches
    s = rc.precise_value_call(pk, b, pts)
    assert rc.precise_value_call.launches == n0 + 1
    ref = rc.precise_value_call(pk, b, pts, use_kernel=False)
    assert rc.precise_value_call.launches == n0 + 1
    s_k3 = rc.precise_sdg_call(pk, b, pts, dirs)[0]
    none = rc.precise_value_call(pk, b, pts[:0])
    torch.cuda.synchronize()
    assert s.shape == (n,) and torch.isfinite(s).all()
    assert torch.equal(s, ref) and torch.equal(s, s_k3)
    assert none.shape == (0,)


def _k4_inputs(arch, dev, n=3000):
    """A decoder of K3's card test (arch == len(K3_ARCHS): the 8x512
    bench decoder), its packed weights and folded biases, and seeded
    points and cotangents (one column and three)."""
    rng = np.random.default_rng(100 + arch)
    if arch == len(K3_ARCHS):
        params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
        cfg = DecoderConfig()
    else:
        cfg = DecoderConfig(**K3_ARCHS[arch])
        params = params_from_numpy({"layers": [
            {"w": rng.standard_normal((i, o)) * np.sqrt(2.0 / i),
             "b": 0.1 * rng.standard_normal(o)} for i, o in cfg.layer_dims]}, dev)
        z = torch.as_tensor(0.3 * rng.standard_normal(cfg.latent_size),
                            dtype=torch.float32, device=dev)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    pts = t(0.6 * rng.standard_normal((n, 3)))
    cts = {1: t(rng.standard_normal(n)), 3: t(rng.standard_normal((n, 3)))}
    pk = rc.pack_precise(params, cfg)
    return params, cfg, z, pk, rc.fold_bias_precise(params, z, cfg, pk), pts, cts


K4_MODES = [dict(scalar_chain=True, want_gx=False), dict(scalar_chain=True, want_gx=True),
            dict(scalar_chain=False, want_gx=True)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", K34_SIZES)
@pytest.mark.parametrize("mode", range(len(K4_MODES)))
@pytest.mark.parametrize("arch", range(len(K3_ARCHS) + 1))
def test_cuda_k4_matches_plain(arch, mode, n, k_order):
    """K4 against its in-order plain version: gx bit for bit; u (a sum
    over the points, in fp64 in either, in another order) within
    relative L2 1e-6; two launches give the same bits."""
    dev = _device()
    kw = K4_MODES[mode]
    _, _, _, pk, b, pts, cts = _k4_inputs(arch, dev, n)
    ct = cts[1 if kw["scalar_chain"] else 3]
    n0 = rc.precise_bias_grads_call.launches
    out = rc.precise_bias_grads_call(pk, b, pts, ct, **kw)
    again = rc.precise_bias_grads_call(pk, b, pts, ct, **kw)
    assert rc.precise_bias_grads_call.launches == n0 + 2
    ref = rc.precise_bias_grads_call(pk, b, pts, ct, use_kernel=False, **kw)
    assert rc.precise_bias_grads_call.launches == n0 + 2
    torch.cuda.synchronize()
    us, us2, ur = ((o[0], o[1]) if kw["want_gx"] else (o, None)
                   for o in (out, again, ref))
    assert len(us[0]) == sum(m.takes_z for m in pk.meta) == 2
    for a, a2, r in zip(us[0], us2[0], ur[0]):
        assert torch.equal(a, a2)
        assert a.dtype == torch.float32 and a.shape == r.shape
        rel = ((a.double() - r.double()).norm() / r.double().norm()).item()
        assert rel <= 1e-6, rel
    if kw["want_gx"]:
        assert torch.equal(us[1], ur[1]) and torch.equal(us[1], us2[1])
        assert torch.isfinite(us[1]).all()


def _u_in_slot_order(delta: torch.Tensor) -> torch.Tensor:
    """K4's sum of delta [N, R] over the points, emulated: per 32 points a
    warp's shuffle-down tree in fp64 (x[i] + x[i + 16], then + the
    partner 8, 4, 2, 1 on), then the slots added in order, 64 a pass
    (recompute.SUM_CHUNK), rounded once to fp32."""
    n, rows = delta.shape
    slots = rc.k4_slots(n)
    x = torch.zeros((slots * 32, rows), dtype=torch.float64, device=delta.device)
    x[:n] = delta.double()
    s = x.reshape(slots, 32, rows)
    s = s[:, :16] + s[:, 16:]
    for off in (8, 4, 2, 1):
        s = s[:, :off] + s[:, off:2 * off]
    parts = s[:, 0]
    while True:
        chunks = [parts[c:c + rc.SUM_CHUNK] for c in range(0, parts.shape[0], rc.SUM_CHUNK)]
        sums = []
        for ch in chunks:
            acc = torch.zeros(rows, dtype=torch.float64, device=delta.device)
            for q in range(ch.shape[0]):
                acc = acc + ch[q]
            sums.append(acc)
        parts = torch.stack(sums)
        if len(chunks) == 1:
            return parts[0].float()


def _u_deltas(pk, b, pts, ct):
    """The plain version's fp32 delta of each layer the latent enters, in
    ascending order, from the scalar chain's seed ct (its reverse sweep,
    keeping what u sums)."""
    from dist_renderer_tpu_torch.models.decoder import round_bf16

    pre, gates = rc._forward_plain(pk, b, pts)
    _, delta = rc._seed_last(pk, pre, ct)
    deltas = []
    for i in range(len(pk.meta) - 1, -1, -1):
        m, ops = pk.meta[i], pk.layers[i]
        if m.takes_z:
            deltas.append(delta)
        if not m.has_wh:
            break
        delta = rc.dot_f32(round_bf16(delta), ops["wh_hi"].T) * gates[i - 1].float()
    return deltas[::-1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [0, len(K3_ARCHS)])
def test_cuda_k4_u_is_the_in_order_deltas_summed_in_slot_order(arch, k_order):
    """K4's u, bit for bit: the in-order plain version's fp32 delta of each
    layer the latent enters, summed per 32 points by the shuffle-down tree
    and the slots in order (the sum of K4 on CUDA cores, so the tasks' fits
    keep their trajectories), for 3,000 and 40 points."""
    dev = _device()
    for n in (3000, 40):
        _, _, _, pk, b, pts, cts = _k4_inputs(arch, dev, n)
        us = rc.precise_bias_grads_call(pk, b, pts, cts[1])
        deltas = _u_deltas(pk, b, pts, cts[1])
        torch.cuda.synchronize()
        assert len(us) == len(deltas) == 2
        for u, d in zip(us, deltas):
            assert torch.equal(u, _u_in_slot_order(d)), n


@pytest.mark.gpu
def test_cuda_k3_k4_latent_in_the_last_layers_match_plain(k_order):
    """A 4x48 decoder whose latent also enters the last two layers: the
    layer below a split layer is itself split (three in-order passes on
    CUDA cores), the last layer's value reads hi and lo, and K4 sums u of
    the last layer and of the one below it from CUDA-core values. K3's s,
    dd, g and K4's gx equal the in-order plain version's in every mode, u
    within relative L2 1e-6 and in K4's slot order bit for bit."""
    dev = _device()
    cfg = DecoderConfig(latent_size=16, hidden_dims=(48,) * 4, latent_in=(3, 4))
    rng = np.random.default_rng(5)
    params = params_from_numpy({"layers": [
        {"w": rng.standard_normal((i, o)) * np.sqrt(2.0 / i),
         "b": 0.1 * rng.standard_normal(o)} for i, o in cfg.layer_dims]}, dev)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    z = t(0.3 * rng.standard_normal(16))
    n = 700
    pts = t(0.6 * rng.standard_normal((n, 3)))
    dirs = torch.nn.functional.normalize(t(rng.standard_normal((n, 3))), dim=-1)
    cts = {1: t(rng.standard_normal(n)), 3: t(rng.standard_normal((n, 3)))}
    pk = rc.pack_precise(params, cfg)
    b = rc.fold_bias_precise(params, z, cfg, pk)
    assert rc.exact_layers(pk.meta) == (True, False, True, True, False)
    out = rc.precise_sdg_call(pk, b, pts, dirs)
    ref = rc.precise_sdg_call(pk, b, pts, dirs, use_kernel=False)
    for name, a, r in zip(("s", "dd", "g"), out, ref):
        assert torch.equal(a, r), name
    for kw in K4_MODES:
        ct = cts[1 if kw["scalar_chain"] else 3]
        (uk, gk), (ur, gr) = (rc.precise_bias_grads_call(pk, b, pts, ct, use_kernel=k,
                                                         **dict(kw, want_gx=True))
                              for k in (True, False))
        assert torch.equal(gk, gr), kw
        assert len(uk) == 3
        for a, r in zip(uk, ur):
            rel = ((a.double() - r.double()).norm() / r.double().norm()).item()
            assert rel <= 1e-6, (kw, rel)
    # the scalar chain's u in K4's slot order, from the in-order deltas
    us = rc.precise_bias_grads_call(pk, b, pts, cts[1])
    deltas = _u_deltas(pk, b, pts, cts[1])
    torch.cuda.synchronize()
    for u, d in zip(us, deltas):
        assert torch.equal(u, _u_in_slot_order(d))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", range(len(K4_MODES)))
def test_cuda_k4_of_no_points_is_zero(mode):
    """K4 over no points: u is zero, gx empty, and no kernel of the sweep
    runs."""
    dev = _device()
    kw = K4_MODES[mode]
    _, _, _, pk, b, pts, cts = _k4_inputs(1, dev, n=8)
    ct = cts[1 if kw["scalar_chain"] else 3][:0]
    out = rc.precise_bias_grads_call(pk, b, pts[:0].contiguous(), ct.contiguous(), **kw)
    torch.cuda.synchronize()
    us = out[0] if kw["want_gx"] else out
    assert all(torch.equal(u, torch.zeros_like(u)) for u in us)
    if kw["want_gx"]:
        assert out[1].shape == (0, 3)


def _tie_decoder(dev, seed=7):
    """A 4x48 decoder whose tensor-core values sit on near ties: layer 1's
    outputs come in equal pairs and layer 2's input rows in opposite
    pairs, so half of layer 2's preactivations (zero bias) cancel to 0
    forward, and the reverse of layer 1 cancels to 0 wherever delta
    flows: 64 rows x 24 or more values a tile, past the near-tie queue."""
    cfg = DecoderConfig(latent_size=8, hidden_dims=(48,) * 4, latent_in=())
    rng = np.random.default_rng(seed)
    layers = [{"w": rng.standard_normal((i, o)) * np.sqrt(2.0 / i),
               "b": 0.1 * rng.standard_normal(o)} for i, o in cfg.layer_dims]
    w1, b1 = layers[1]["w"], layers[1]["b"]
    w1[:, 1::2], b1[1::2] = w1[:, 0::2], b1[0::2]
    w2, b2 = layers[2]["w"], layers[2]["b"]
    w2[1::2] = -w2[0::2]
    b2[:24], b2[24:] = 0.0, 0.5
    params = params_from_numpy({"layers": layers}, dev)
    z = torch.as_tensor(0.3 * rng.standard_normal(8), dtype=torch.float32, device=dev)
    return params, cfg, z


@pytest.mark.gpu
def test_cuda_k3_k4_near_tie_overflow_matches_plain(k_order):
    """Past the near-tie queue (QCAP values a layer) the overflow bits
    carry the rest: on _tie_decoder K3's s, dd, g and K4's gx equal the
    in-order plain version's, and both kernels' counters show values past
    the queue. u: layer 0's delta cancels to 0 in the plain version; K4
    computes that delta in o order from the settled bf16(delta_1) (the
    overflow's bits among them) and sums it in its slot order, so u is
    that sum of the in-order deltas bit for bit, and 0."""
    dev = _device()
    params, cfg, z = _tie_decoder(dev)
    rng = np.random.default_rng(3)
    n = 300
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    pts, ct = t(0.6 * rng.standard_normal((n, 3))), t(rng.standard_normal(n))
    dirs = torch.nn.functional.normalize(t(rng.standard_normal((n, 3))), dim=-1)
    pk = rc.pack_precise(params, cfg)
    b = rc.fold_bias_precise(params, z, cfg, pk)
    out = rc.precise_sdg_call(pk, b, pts, dirs)
    ref = rc.precise_sdg_call(pk, b, pts, dirs, use_kernel=False)
    (uk, gk), (ur, gr) = (rc.precise_bias_grads_call(pk, b, pts, ct, use_kernel=k, want_gx=True)
                          for k in (True, False))
    torch.cuda.synchronize()
    for name, a, r in zip(("s", "dd", "g"), out, ref):
        assert torch.equal(a, r), name
    assert torch.equal(gk, gr)
    assert len(uk) == 1 and torch.equal(ur[0], torch.zeros_like(ur[0]))
    (d0,) = _u_deltas(pk, b, pts, ct)
    assert torch.equal(uk[0], _u_in_slot_order(d0)) and torch.equal(uk[0], ur[0])
    for fn in (rc.precise_sdg_call, rc.precise_bias_grads_call):
        queued, past = fn.ties.tolist()
        assert past > 0 and queued > past, (fn.__name__, queued, past)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [1, len(K3_ARCHS)])
def test_cuda_precise_sdg_autograd_matches_plain(arch, k_order):
    """make_precise_sdg on the card (K3 forward, K4 backward) against its
    plain version: s and the points' gradient bit for bit, the latent's
    within relative L2 1e-6."""
    dev = _device()
    params, cfg, z, _, _, pts, cts = _k4_inputs(arch, dev, n=1000)
    dirs = torch.nn.functional.normalize(pts.flip(1), dim=-1)
    counters = (rc.precise_sdg_call, rc.precise_bias_grads_call)
    res = []
    for use in (True, False):
        n0 = [fn.launches for fn in counters]
        sdg = rc.make_precise_sdg(params, cfg, use_kernel=use)
        zz, pp = z.clone().requires_grad_(), pts.clone().requires_grad_()
        s, dd, g = sdg(zz, pp, dirs)
        res.append((s, *torch.autograd.grad((cts[1] * s).sum(), (zz, pp))))
        assert [fn.launches - c for fn, c in zip(counters, n0)] == ([1, 1] if use else [0, 0])
    (s_k, gz_k, gp_k), (s_p, gz_p, gp_p) = res
    assert torch.equal(s_k, s_p) and torch.equal(gp_k, gp_p)
    rel = ((gz_k.double() - gz_p.double()).norm() / gz_p.double().norm()).item()
    assert rel <= 1e-6 and torch.isfinite(gz_k).all(), rel


@pytest.mark.gpu
def test_cuda_sdf_renderer_gradients_match_plain(k_order):
    """SDFRenderer on the card: the gradients of a depth + silhouette loss
    to (latent, R, T) through K1-K4 (the silhouette reaches the lazy
    margin's backward) against the same render and backward on the plain
    versions. With the in-order products the forward is equal bit for
    bit, so only K4's fp64 sums, in another order, differ: relative L2
    <= 1e-5 on each gradient."""
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
    grads = []
    for use in (True, False):
        n0 = rc.precise_bias_grads_call.launches
        r = SDFRenderer(proxy, cam.K, (img, img), decoder_cfg=pcfg, cfg=cfg,
                        use_kernel=use)
        leaves = [t.to(dev).requires_grad_() for t in (z.clone(), cam.R.clone(),
                                                       cam.T.clone())]
        out = r.render(*leaves)
        obs = out.mask.detach() & (torch.arange(img, device=dev) < img // 2)[None, :]
        loss = (10.0 * (out.depth - 1.5).abs()[obs].mean()
                + torch.clamp(out.min_sdf, min=0.0)[~out.mask].mean())
        grads.append(torch.autograd.grad(loss, leaves))
        # the bucket's K4 and the lazy margin's
        assert rc.precise_bias_grads_call.launches - n0 == (2 if use else 0)
    for a, b in zip(*grads):
        assert a.is_cuda and torch.isfinite(a).all() and a.abs().sum() > 0
        rel = ((a.double() - b.double()).norm() / b.double().norm()).item()
        assert rel <= 1e-5, rel


@pytest.mark.gpu
@pytest.mark.parametrize("polish_iters", [1, 2])
def test_cuda_compose_split_is_the_full_width(polish_iters):
    """A request whose hits overflow the n/4 compose bucket, with no
    gradient wanted: K3 on the hits and K3's value mode on the misses
    give the full-width branch's (compact_frac 0: K3 on every ray) depth,
    mask, normal, margins and points bit for bit."""
    dev = _device()
    params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    proxy, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    img = 64
    cam = Camera.looking_at((0.0, 0.0, -1.3), focal=img * 1.2, img_hw=(img, img),
                            device=dev)
    outs = []
    for frac in (4, 0):
        cfg = RenderConfig(
            img_h=img, img_w=img,
            march=MarchConfig(max_steps=50, convergence_eps=2e-3, depth_eps=5e-4,
                              coarse_to_fine=True, c2f_strides=(16, 4),
                              c2f_coarse_steps=16),
            grad=GradConfig(mode="ift", compact_frac=frac, compact_min=1024,
                            polish_iters=polish_iters),
            compute_dtype="bfloat16", use_pallas=True)
        fac = make_march_factory(params, DecoderConfig(), cfg, march_params=proxy,
                                 march_dcfg=pcfg)
        n0 = rc.precise_value_call.launches
        with torch.no_grad():
            outs.append(render(make_precise_sdf(params, DecoderConfig()), z, cam, cfg, fac))
        assert rc.precise_value_call.launches - n0 == (1 if frac else 0)
    a, b = outs
    assert a.mask.sum() > img * img // 4
    for k in ("depth", "mask", "normal", "min_sdf", "points"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


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
    outs = []
    for use in (True, False):
        sdf = make_precise_sdf(params, DecoderConfig(), use_kernel=use)
        fac = make_march_factory(params, DecoderConfig(), cfg, march_params=proxy,
                                 march_dcfg=pcfg, use_kernel=use)
        outs.append(render(sdf, z, cam, cfg, fac))
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
        r = SDFRenderer(proxy, K, (img, img), decoder_cfg=pcfg, cfg=cfg,
                        use_kernel=use)
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


@pytest.mark.gpu
def test_cuda_k4_rejects_bad_inputs():
    """A CUDA tensor launches K4 or raises: weights on another device,
    non-contiguous points and too many seed rows are refused."""
    dev = _device()
    params, cfg, _, pk, b, pts, cts = _k4_inputs(1, dev, n=64)
    with pytest.raises(ValueError):
        rc.precise_bias_grads_call(rc.pack_precise(
            {"layers": [{k: v.cpu() for k, v in l.items()} for l in params["layers"]]},
            cfg), b, pts, cts[1])
    with pytest.raises(ValueError):
        rc.precise_bias_grads_call(pk, b, pts.T.contiguous().T, cts[1])
    with pytest.raises(ValueError):
        rc.precise_bias_grads_call(pk, b, pts, torch.zeros(64, 9, device=dev),
                                   scalar_chain=False)


def test_cpu_tensors_take_the_k4_plain_version_uncounted():
    """On CPU tensors K4's wrapper and the sdg's backward run the plain
    version and count no launch."""
    _, _, _, pk, b, pts, cts = _k4_inputs(1, torch.device("cpu"), n=100)
    n0 = rc.precise_bias_grads_call.launches
    us, gx = rc.precise_bias_grads_call(pk, b, pts, cts[3], scalar_chain=False,
                                        want_gx=True)
    ref = rc.precise_bias_grads_plain(pk, b, pts, cts[3], scalar_chain=False,
                                      want_gx=True)
    assert all(torch.equal(a, r) for a, r in zip(us, ref[0]))
    assert torch.equal(gx, ref[1])
    params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    sdg = make_precise_sdf(params, DecoderConfig()).sdg_builder()
    zz = z.clone().requires_grad_()
    sdg(zz, pts[:8], pts[:8])[0].sum().backward()
    assert zz.grad is not None and rc.precise_bias_grads_call.launches == n0


def _grid_scene(dev, which, img=48):
    """One frame of _scene's rays, the latent folded into K1-grid's
    layout and K1's one-frame bank of the same decoder ("proxy": the bench
    proxy, "bench": the 8x512 bench decoder)."""
    shared, bank, o, v, key, seed_d = _scene(dev, img=img, frames=1, seed=2)
    params, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    if which == "bench":
        params, pcfg = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"),
                                       dev)[0], DecoderConfig()
        shared = bm.pack_shared(params, pcfg)
        bank = bm.fold_bias_bank(params, z0[None], pcfg, shared)
    else:
        bank = bm.fold_bias_bank(params, z0[None], pcfg, shared)
    packed = fm.pack_folded(fold_latent(params, z0, pcfg), pcfg, shared)
    return packed, shared, bank, o[0], v[0], key[0], seed_d[0]


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["proxy", "bench"])
@pytest.mark.parametrize("seeded", [True, False])
@pytest.mark.parametrize("salvage", [True, False])
def test_cuda_k1_grid_matches_plain(salvage, seeded, which, k_order):
    """K1-grid against its in-order plain version bit for bit; a CPU-side
    rule: the plain run counts no launch."""
    dev = _device()
    packed, _, _, o, v, key, seed_d = _grid_scene(dev, which)
    kw = dict(init_depth=seed_d, init_active=key != 2) if seeded else {}
    n0 = fm.sphere_trace_grid.launches
    out = fm.sphere_trace_grid(packed, o, v, MARCH, salvage=salvage, **kw)
    assert fm.sphere_trace_grid.launches == n0 + 1
    ref = fm.sphere_trace_grid(packed, o, v, MARCH, salvage=salvage,
                               use_kernel=False, **kw)
    assert fm.sphere_trace_grid.launches == n0 + 1
    torch.cuda.synchronize()
    assert out.hit.sum() > 100
    for name in TRACE_FIELDS:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["proxy", "bench"])
def test_cuda_k1_grid_equals_k1(which):
    """K1-grid and K1 at F=1 share the step body: the same bits on the
    same rays (seeded, inactive and salvage-off rays included)."""
    dev = _device()
    packed, shared, bank, o, v, key, seed_d = _grid_scene(dev, which)
    frame = torch.zeros(o.shape[0], dtype=torch.int64, device=dev)
    for salvage in (True, False):
        a = fm.sphere_trace_grid(packed, o, v, MARCH, seed_d, init_active=key != 2,
                                 salvage=salvage)
        b = bm.sphere_trace_persistent(shared, bank, frame, o, v, MARCH, seed_d,
                                       key != 2, salvage=salvage)
        torch.cuda.synchronize()
        for name in TRACE_FIELDS:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("seeded", [True, False])
def test_cuda_rounds_match_plain(seeded, k_order):
    """sphere_trace_rounds on the card (every round on K1-grid) equals
    its run on the in-order plain version."""
    dev = _device()
    packed, _, _, o, v, key, seed_d = _grid_scene(dev, "proxy", img=64)
    kw = dict(init_depth=seed_d, init_active=key != 2) if seeded else {}
    n0 = fm.sphere_trace_grid.launches
    out = fm.sphere_trace_rounds(packed, o, v, MARCH, **kw)
    assert fm.sphere_trace_grid.launches == n0 + 3
    ref = fm.sphere_trace_rounds(packed, o, v, MARCH, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert out.hit.sum() > 100
    for name in ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf",
                 "unresolved", "steps_per_ray"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


@pytest.mark.gpu
def test_cuda_analytic_renderer_takes_the_card():
    """SDFRenderer with an analytic sdf_fn, no weights and no device
    renders on the current card, as eval's entry points do."""
    from dist_renderer_tpu_torch.models.analytic import latent_sphere_sdf

    _device()
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=20.0, img_hw=(16, 16))
    r = SDFRenderer(None, cam.K, img_hw=(16, 16), sdf_fn=latent_sphere_sdf(),
                    cfg=RenderConfig(march=MarchConfig(max_steps=32)))
    assert r.device.type == "cuda"
    depth = r.render_depth(np.array([0.5], np.float32), cam.R, cam.T)
    assert depth.device.type == "cuda" and torch.isfinite(depth).any()


@pytest.mark.gpu
def test_cuda_sdf_renderer_grid_path_matches_plain(k_order):
    """SDFRenderer with use_pallas and no coarse-to-fine traces through
    the rounds driver on K1-grid; its render and the (latent, R, T)
    gradients of a depth + silhouette loss equal the plain versions'
    (K4's fp64 sums in another order: relative L2 <= 1e-5)."""
    dev = _device()
    proxy, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    _, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    img = 32
    cfg = RenderConfig(
        img_h=img, img_w=img, march=MARCH,
        grad=GradConfig(mode="ift", compact_frac=4, compact_min=256),
        compute_dtype="bfloat16", use_pallas=True)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img))
    outs, grads = [], []
    for use in (True, False):
        n0 = fm.sphere_trace_grid.launches
        r = SDFRenderer(proxy, cam.K, (img, img), decoder_cfg=pcfg, cfg=cfg,
                        use_kernel=use)
        leaves = [t.to(dev).requires_grad_() for t in (z.clone(), cam.R.clone(),
                                                       cam.T.clone())]
        out = r.render(*leaves)
        assert (fm.sphere_trace_grid.launches > n0) == use
        obs = out.mask.detach() & (torch.arange(img, device=dev) < img // 2)[None, :]
        loss = (10.0 * (out.depth - 1.5).abs()[obs].mean()
                + torch.clamp(out.min_sdf, min=0.0)[~out.mask].mean())
        grads.append(torch.autograd.grad(loss, leaves))
        outs.append(out)
    for k in ("depth", "mask", "normal", "min_sdf", "points"):
        assert torch.equal(getattr(outs[0], k).detach(), getattr(outs[1], k).detach()), k
    assert outs[0].mask.float().mean() > 0.05
    for a, b in zip(*grads):
        assert a.is_cuda and torch.isfinite(a).all() and a.abs().sum() > 0
        rel = ((a.double() - b.double()).norm() / b.double().norm()).item()
        assert rel <= 1e-5, rel


def test_cpu_tensors_take_the_k1_grid_plain_version_uncounted():
    """On CPU tensors K1-grid and its rounds driver run the plain version
    and count no launch."""
    packed, _, _, o, v, key, seed_d = _grid_scene(torch.device("cpu"), "proxy",
                                                  img=16)
    n0 = fm.sphere_trace_grid.launches
    a = fm.sphere_trace_grid(packed, o, v, MARCH, seed_d, init_active=key != 2)
    b = fm.sphere_trace_grid(packed, o, v, MARCH, seed_d, init_active=key != 2,
                             use_kernel=False)
    fm.sphere_trace_rounds(packed, o, v, MARCH)
    assert fm.sphere_trace_grid.launches == n0
    for name in TRACE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("salvage", [True, False])
def test_cuda_k1_multi_matches_plain(salvage, k_order):
    """K1-multi against its in-order plain version (K1's) bit for bit,
    over two frames of seeded and inactive rays."""
    dev = _device()
    shared, bank, o, v, key, seed_d = _scene(dev)
    run = lambda k: bm.batched_trace_padded(shared, bank, o, v, MARCH, seed_d,
                                            key != 2, salvage=salvage,
                                            use_kernel=k, persistent=False)
    n0, n1 = bm.sphere_trace_batched.launches, bm.sphere_trace_persistent.launches
    out = run(True)
    ref = run(False)
    assert bm.sphere_trace_batched.launches == n0 + 1
    assert bm.sphere_trace_persistent.launches == n1
    torch.cuda.synchronize()
    assert out.hit.sum() > 100
    for name in TRACE_FIELDS:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["proxy", "bench"])
def test_cuda_k1_multi_equals_k1(which):
    """K1-multi and K1 inline one tile march: the same bits on the same
    rays of several frames, and render_depth_batched is K1-multi's march
    of every ray from its sphere entry."""
    dev = _device()
    shared, bank, o, v, key, seed_d = _scene(dev, frames=3, seed=4)
    params, dcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    if which == "bench":
        params, _ = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
        dcfg = DecoderConfig()
        shared = bm.pack_shared(params, dcfg)
    _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    lat = torch.stack([z0, z0 + 0.001, z0 - 0.001])
    bank = bm.fold_bias_bank(params, lat, dcfg, shared)
    for salvage in (True, False):
        a, b = (bm.batched_trace_padded(shared, bank, o, v, MARCH, seed_d, key != 2,
                                        salvage=salvage, persistent=p)
                for p in (False, True))
        torch.cuda.synchronize()
        for name in TRACE_FIELDS:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    n0 = bm.sphere_trace_batched.launches
    d, h = bm.render_depth_batched(params, dcfg, lat, o, v, MARCH)
    assert bm.sphere_trace_batched.launches == n0 + 1
    ref = bm.batched_trace_padded(shared, bank, o, v, MARCH, None,
                                  torch.ones_like(key, dtype=torch.bool))
    assert torch.equal(d, ref.depth) and torch.equal(h, ref.hit) and h.sum() > 100


@pytest.mark.gpu
@pytest.mark.parametrize("persistent", [True, False])
def test_cuda_fine_march_rounds_matches_plain(persistent, k_order):
    """The rounds scheduler with every round on K1 (or K1-multi) equals its
    run on the in-order plain version, every output field."""
    dev = _device()
    shared, bank, o, v, key, seed_d = _scene(dev, img=64, seed=5)
    kw = dict(live_frac=3, return_anchor=True, return_steps=True,
              return_last=True, difficulty_repack=True)
    counter = bm.sphere_trace_persistent if persistent else bm.sphere_trace_batched
    n0 = counter.launches
    out = bm.fine_march_rounds(shared, bank, o[:, :1], v, key, seed_d, MARCH,
                               persistent=persistent, **kw)
    assert counter.launches == n0 + 3
    ref = bm.fine_march_rounds(shared, bank, o[:, :1], v, key, seed_d, MARCH,
                               use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert out.hit.sum() > 100
    for name in ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf", "steps",
                 "unresolved"):
        assert _same(getattr(out, name), getattr(ref, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("verify_hits", ["march", "polish", "polish-all"])
def test_cuda_batched_render_matches_plain(verify_hits, k_order):
    """render_batched_c2f on the rounds scheduler with the proxy (the bench
    decoder verified through its proxy), two frames: the kernels' trace
    equals the in-order plain versions' bit for bit, weak mask included;
    finalize_hits_batched then runs on the card."""
    from dist_renderer_tpu_torch.ops.renderer import finalize_hits_batched

    dev = _device()
    params, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    proxy = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    img = 32
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img),
                            device=dev)
    o, v = pixel_rays(cam, img, img)
    lat = torch.stack([z0, z0 + 0.001])
    outs = [bm.render_batched_c2f(
        params, DecoderConfig(), lat, o[None, :1].expand(2, 1, 3),
        v[None].expand(2, -1, -1), (img, img), MARCH, proxy=proxy,
        shared_origin=True, verify_hits=verify_hits, verify_round_caps=(2, 4, 12),
        return_anchor=True, return_steps=True, return_last=True, use_kernel=k)
        for k in (True, False)]
    torch.cuda.synchronize()
    for name in ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf", "steps",
                 "unresolved", "weak"):
        a, b = getattr(outs[0], name), getattr(outs[1], name)
        assert (a is None and b is None) or _same(a, b), name
    a = outs[0]
    d, h, m = finalize_hits_batched(params, DecoderConfig(), lat, o[None, :1],
                                    v[None].expand(2, -1, -1), a.depth, a.hit,
                                    a.min_sdf, convergence_eps=MARCH.convergence_eps,
                                    weak=a.weak)
    assert d.is_cuda and h.sum() > 100 and (h <= a.hit).all()
    assert torch.isfinite(d).all() and torch.isfinite(m[h]).all()


@pytest.mark.gpu
def test_cuda_decoder_apply_with_dd_matches_cpu():
    """The finalize's evaluation takes the JAX package's roundings on both
    devices: bf16 GEMMs with an fp32 output on the card, the bf16-rounded
    operands' fp32 product on the CPU; only the order of the sums differs,
    and a sum that lands on the other side of a bf16 rounding moves one
    activation by 2^-8, which later layers carry. The bench decoder at
    4096 seeded points (0.6 x a normal draw), read on an H100: |value gap|
    p50 1.5e-8 (the fp32 decoder's gap from the CPU's: 7.4e-5), p99 9.5e-5
    (3.6e-4), max 3.2e-4, within 1e-5 on 94.6% of points; the derivative's
    relative L2 2.7e-3 (the fp32 jvp's: 2.0e-2). Bars: the median at most
    a hundredth of fp32's, >= 90% within 1e-5, max 1e-3, and the
    derivative at most a quarter of fp32's."""
    from dist_renderer_tpu_torch.models.decoder import decoder_apply, decoder_apply_with_dd

    dev = _device()
    params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    gen = torch.Generator(device="cpu").manual_seed(7)
    pts = 0.6 * torch.randn((4096, 3), generator=gen)
    v = torch.nn.functional.normalize(torch.randn((4096, 3), generator=gen), dim=-1)
    s, dd = decoder_apply_with_dd(params, z, pts.to(dev), v.to(dev), DecoderConfig())
    params_c = {"layers": [{kk: t.cpu() for kk, t in l.items()} for l in params["layers"]]}
    zc = z.cpu()
    sc, ddc = decoder_apply_with_dd(params_c, zc, pts, v, DecoderConfig())
    s32, dd32 = torch.func.jvp(lambda p: decoder_apply(params_c, zc, p, DecoderConfig()),
                               (pts,), (v,))
    q = lambda x: torch.quantile(x, torch.tensor([0.5, 0.99])).tolist()
    gap = (s.cpu() - sc).abs()
    card, fp32 = q(gap), q((s32 - sc).abs())
    rel = lambda x: (torch.linalg.norm(x - ddc) / torch.linalg.norm(ddc)).item()
    d_card, d_fp32 = rel(dd.cpu()), rel(dd32)
    print(f"value gap p50/p99: card {card}, fp32 {fp32}; dd relative L2: card "
          f"{d_card:.3e}, fp32 {d_fp32:.3e}")
    assert s.is_cuda and dd.is_cuda and card[0] <= 0.01 * fp32[0]
    assert (gap <= 1e-5).float().mean() >= 0.9 and gap.max() <= 1e-3
    assert d_card <= 0.25 * d_fp32


@pytest.mark.gpu
def test_cuda_split_x_is_the_with_dd_value():
    """decoder_apply(precision="split_x") on the card takes the finalize's
    products (bf16 GEMMs with an fp32 output), so its value is
    decoder_apply_with_dd's bit for bit, as on the CPU; "split" (every
    layer split) lies closer to the fp32 value than "split_x" does. The
    bench decoder at 4096 seeded points."""
    from dist_renderer_tpu_torch.models.decoder import (
        decoder_apply, decoder_apply_with_dd, set_fp32_matmul,
    )

    set_fp32_matmul()
    dev = _device()
    params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    gen = torch.Generator(device="cpu").manual_seed(8)
    pts = (0.6 * torch.randn((4096, 3), generator=gen)).to(dev)
    v = torch.nn.functional.normalize(torch.randn((4096, 3), generator=gen), dim=-1).to(dev)
    s, _ = decoder_apply_with_dd(params, z, pts, v, DecoderConfig())
    sx = decoder_apply(params, z, pts, DecoderConfig(), precision="split_x")
    assert sx.is_cuda and torch.equal(sx, s)
    f32 = decoder_apply(params, z, pts, DecoderConfig())
    split = decoder_apply(params, z, pts, DecoderConfig(), precision="split")
    assert (split - f32).abs().mean() < (sx - f32).abs().mean()


DOT_SHAPES = [(1000, 515, 70), (4096, 3, 512), (65, 512, 1), (1, 17, 64), (0, 8, 8)]


def _dot_operands(n, k, m, dev, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn((n, k), generator=gen).to(dev)
    b = torch.randn((m, k), generator=gen).to(dev).t()   # not contiguous
    return a, b


@pytest.mark.gpu
@pytest.mark.parametrize("shape", range(len(DOT_SHAPES)))
def test_cuda_dot_in_order_equals_the_loop(shape):
    """decoder.dot_f32_in_order's kernel gives the loop over k's bits, on
    fp32 values that are not bf16-valued too (one rounding per product
    and per add, in k order)."""
    from dist_renderer_tpu_torch.models.decoder import dot_f32_in_order

    dev = _device()
    a, b = _dot_operands(*DOT_SHAPES[shape], dev, shape)
    out = dot_f32_in_order(a, b)
    torch.cuda.synchronize()
    assert out.shape == (a.shape[0], b.shape[1]) and out.is_cuda
    assert torch.equal(out, _dot_k_order(a, b))


@pytest.mark.gpu
def test_cuda_batched_render_matches_in_order_plain(monkeypatch):
    """chip_smoke.py's witness at a small size: render_batched_c2f (march
    verify, the bench decoder through its proxy) equals its plain versions
    bit for bit with decoder.dot_f32_in_order in dot_f32's place."""
    from dist_renderer_tpu_torch.models.decoder import dot_f32_in_order

    dev = _device()
    params, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    proxy = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    img = 48
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img),
                            device=dev)
    o, v = pixel_rays(cam, img, img)
    lat = torch.stack([z0, z0 + 0.001, z0 - 0.001])
    kw = dict(proxy=proxy, shared_origin=True, verify_round_caps=(2, 4, 12),
              return_anchor=True)
    run = lambda k: bm.render_batched_c2f(
        params, DecoderConfig(), lat, o[None, :1].expand(3, 1, 3),
        v[None].expand(3, -1, -1), (img, img), MARCH, use_kernel=k, **kw)
    out = run(True)
    monkeypatch.setattr(march_body, "dot_f32", dot_f32_in_order)
    ref = run(False)
    torch.cuda.synchronize()
    assert out.hit.sum() > 500
    for name in ("depth", "hit", "min_sdf", "depth_at_min"):
        assert _same(getattr(out, name), getattr(ref, name)), name


def test_cpu_dot_in_order_is_the_loop():
    """On CPU tensors decoder.dot_f32_in_order is the loop over k: the
    test's own loop's bits, within fp32 rounding of the GEMM."""
    from dist_renderer_tpu_torch.models.decoder import dot_f32_in_order

    for i, shape in enumerate(DOT_SHAPES):
        a, b = _dot_operands(*shape, torch.device("cpu"), i)
        out = dot_f32_in_order(a, b)
        assert torch.equal(out, _dot_k_order(a, b))
        torch.testing.assert_close(out, a @ b, rtol=1e-5, atol=1e-4)


def test_cpu_tensors_take_the_k1_multi_plain_version_uncounted():
    """On CPU tensors K1-multi's wrapper and render_depth_batched run the
    plain version (K1's) and count no launch."""
    dev = torch.device("cpu")
    shared, bank, o, v, key, seed_d = _scene(dev, img=16)
    n0 = (bm.sphere_trace_batched.launches, bm.sphere_trace_persistent.launches)
    a = bm.batched_trace_padded(shared, bank, o, v, MARCH, seed_d, key != 2,
                                persistent=False)
    b = bm.batched_trace_padded(shared, bank, o, v, MARCH, seed_d, key != 2)
    params, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"))
    _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
    bm.render_depth_batched(params, pcfg, torch.stack([z0, z0]), o, v, MARCH)
    assert n0 == (bm.sphere_trace_batched.launches, bm.sphere_trace_persistent.launches)
    for name in TRACE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_kernel_build_is_keyed_by_source_hash():
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    names = {os.path.basename(p) for p in build._sources()}
    assert {"march_body.cuh", "batched_march.cu", "queue_march.cu",
            "recompute.cu", "fused_march.cu", "march_in_order.cu",
            "dot_in_order.cu", "point_eval.cu", "point_mlp.cuh",
            "march_mma.cuh"} <= names
    assert "-use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def _k5_case(out_rows, dev, seed=0):
    """The bench 8x512 decoder at its latent (1 row), or the default 8x512
    color decoder from a seeded torch.Generator at a seeded texture
    latent (3 rows): (params, cfg, latent, packed K5 layout)."""
    from dist_renderer_tpu_torch.models.color_decoder import (
        init_color_params, make_color_config,
    )

    if out_rows == 1:
        params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
        cfg = DecoderConfig()
    else:
        cfg = make_color_config()
        gen = torch.Generator().manual_seed(seed)
        params = init_color_params(gen, cfg, dev)
        z = (0.3 * torch.randn(cfg.latent_size, generator=gen)).to(dev)
    return params, cfg, z, fm.pack_folded(fold_latent(params, z, cfg), cfg)


def _points(n, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-1.0, 1.0, (n, 3)), dtype=torch.float32,
                           device=dev)


# K5 and K6 sum the hidden products on the tensor cores, in another order
# than the plain versions' k order, and sum again in k order every value
# within an empirical margin of a bf16 rounding boundary, and the last
# layer (csrc/point_mlp.cuh). Against the plain versions with the k-ordered
# product (the k_order fixture) they are held bit for bit, which a tie the
# margin missed would break, and to chip_smoke.py's bars (K5_WITHIN,
# K5_MAX), which hold even then. Against themselves bit for bit: a point's
# value does not depend on the other points of its launch.
K5_WITHIN, K5_MAX = 0.99, 5e-3


def _k5_bars(out, ref):
    err = (out - ref).abs().reshape(out.shape[0], -1).amax(dim=1)
    return (err <= 1e-5).float().mean().item(), err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 33, 100_000])
@pytest.mark.parametrize("out_rows", [1, 3])
def test_cuda_k5_matches_in_order_plain(out_rows, n, k_order):
    """K5 against its plain version with the in-order product, bit for bit
    and within K5's bars, on ragged and whole tiles; a second launch gives
    the same bits."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    dev = _device()
    _, _, _, packed = _k5_case(out_rows, dev)
    pts = _points(n, dev, n)
    n0 = mlp_eval.point_eval.launches
    out = mlp_eval.point_eval(packed, pts, out_rows=out_rows)
    again = mlp_eval.point_eval(packed, pts, out_rows=out_rows)
    assert mlp_eval.point_eval.launches == n0 + 2
    ref = mlp_eval.point_eval(packed, pts, out_rows=out_rows, use_kernel=False)
    assert mlp_eval.point_eval.launches == n0 + 2
    torch.cuda.synchronize()
    assert out.shape == ((n,) if out_rows == 1 else (n, out_rows))
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)
    within, worst = _k5_bars(out, ref)
    assert within >= K5_WITHIN and worst <= K5_MAX, (within, worst)
    assert torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("out_rows", [1, 3])
def test_cuda_k5_grouping_is_bit_exact(out_rows):
    """K5 gives a point the same bits however a caller groups the points:
    shuffled, split over two launches, and as a ragged prefix (1, 31, 33,
    100,000 points)."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    dev = _device()
    _, _, _, packed = _k5_case(out_rows, dev)
    pts = _points(100_000, dev, 5)
    run = lambda x: mlp_eval.point_eval(packed, x.contiguous(), out_rows=out_rows)
    out = run(pts)
    perm = torch.as_tensor(np.random.default_rng(6).permutation(pts.shape[0]), device=dev)
    assert torch.equal(run(pts[perm]), out[perm])
    assert torch.equal(torch.cat([run(pts[:37_011]), run(pts[37_011:])]), out)
    for n in (1, 31, 33, 100_000):
        assert torch.equal(run(pts[:n]), out[:n]), n


# The color head's RGB against the plain versions': sigmoid(logits), whose
# slope is at most 1/4, so K5's bar on the logits, K5_MAX, bounds RGB by
# K5_MAX / 4.
RGB_MAX = K5_MAX / 4


@pytest.mark.gpu
def test_cuda_color_vjp_matches_plain(k_order):
    """make_color_vjp on the card (K5 forward, K4 backward with 3 seed
    rows) against its plain versions: RGB bit for bit (and within
    RGB_MAX), the points' gradient bit for bit, the texture latent's (a sum
    over points in fp64, in another order) within relative L2 1e-6."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    dev = _device()
    params, cfg, z, _ = _k5_case(3, dev, seed=1)
    pts = _points(5000, dev, 7) * 0.6
    w = _points(5000, dev, 8)

    def run(k):
        zz, pp = z.clone().requires_grad_(True), pts.clone().requires_grad_(True)
        rgb = rc.make_color_vjp(params, cfg, use_kernel=k)(zz, pp)
        return (rgb,) + torch.autograd.grad((w * rgb).sum(), (zz, pp))

    n0 = (mlp_eval.point_eval.launches, rc.precise_bias_grads_call.launches)
    rgb, gz, gp = run(True)
    assert (mlp_eval.point_eval.launches, rc.precise_bias_grads_call.launches) == (
        n0[0] + 1, n0[1] + 1)
    rgb_p, gz_p, gp_p = run(False)
    torch.cuda.synchronize()
    assert (rgb - rgb_p).abs().max().item() <= RGB_MAX
    assert torch.equal(rgb, rgb_p) and torch.equal(gp, gp_p)
    rel = ((gz.double() - gz_p.double()).norm() / gz_p.double().norm()).item()
    assert rel <= 1e-6, rel
    assert torch.isfinite(gz).all() and gz.norm() > 0


@pytest.mark.gpu
def test_cuda_color_render_matches_plain(k_order):
    """SDFRendererColor on the K1-grid path (K1-grid, K3, K5; backward K4)
    against the plain versions: RGB bit for bit (and within RGB_MAX); the
    gradients to the
    shape and texture latents within relative L2 1e-5."""
    dev = _device()
    params, z = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    cparams, ccfg, zt, _ = _k5_case(3, dev, seed=2)
    img = 48
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img),
                            device=dev)
    cfg = RenderConfig(march=MARCH, grad=GradConfig(mode="ift", compact_frac=4),
                       compute_dtype="bfloat16", use_pallas=True)
    from dist_renderer_tpu_torch.ops.renderer import SDFRendererColor

    def run(k):
        r = SDFRenderer(params, cam.K, (img, img), cfg=cfg, use_kernel=k)
        rcol = SDFRendererColor(r, rc.make_color_vjp(cparams, ccfg, use_kernel=k))
        leaves = [z.clone().requires_grad_(True), zt.clone().requires_grad_(True)]
        out, rgb = rcol.render_color(leaves[0], leaves[1], cam.R, cam.T)
        return (out, rgb) + torch.autograd.grad(rgb.abs().mean(), leaves)

    out, rgb, g_z, g_t = run(True)
    out_p, rgb_p, g_zp, g_tp = run(False)
    torch.cuda.synchronize()
    assert out.mask.sum() > 200 and torch.equal(out.mask, out_p.mask)
    assert (rgb - rgb_p).abs().max().item() <= RGB_MAX
    assert torch.equal(rgb, rgb_p)
    for a, b in ((g_z, g_zp), (g_t, g_tp)):
        rel = ((a.double() - b.double()).norm() / b.double().norm()).item()
        assert rel <= 1e-5, rel


def test_cpu_tensors_take_the_k5_plain_version_uncounted():
    """On CPU tensors K5's wrapper, the point and color functions and the
    color head's backward run the plain versions and count no launch."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    dev = torch.device("cpu")
    params, cfg, z, packed = _k5_case(3, dev)
    pts = _points(100, dev, 0)
    n0 = (mlp_eval.point_eval.launches, rc.precise_bias_grads_call.launches)
    out = mlp_eval.point_eval(packed, pts, out_rows=3)
    assert torch.equal(out, mlp_eval.point_eval_plain(packed, pts, 3))
    fn = mlp_eval.make_pallas_color_fn(params, z, cfg)
    assert torch.equal(fn(pts), torch.sigmoid(out))
    zz = z.clone().requires_grad_(True)
    rc.make_color_vjp(params, cfg)(zz, pts).sum().backward()
    assert zz.grad is not None and torch.isfinite(zz.grad).all()
    assert n0 == (mlp_eval.point_eval.launches, rc.precise_bias_grads_call.launches)


def _k6_case(dev, block, frames=3, seed=0):
    """The bench 8x512 decoder's shared weights and a bias bank of jittered
    bench latents, with probe-like points: per frame a hit-first run of
    active lanes (ragged: 700, 33 and 0 of each frame's points), one
    active lane deep in the dead suffix of frame 0. A frame holds 2048
    points, or 2000 with 80-point blocks (frames then meet inside a
    32-point tile)."""
    params, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    rng = np.random.default_rng(seed)
    lat = z0[None] + 0.001 * torch.as_tensor(
        rng.standard_normal((frames, z0.shape[0])), dtype=torch.float32, device=dev)
    shared = bm.pack_shared(params, DecoderConfig())
    bank = bm.fold_bias_bank(params, lat, DecoderConfig(), shared)
    per = 2048 if block % 32 == 0 else 25 * block
    n = frames * per
    pts = torch.as_tensor(rng.uniform(-0.8, 0.8, (n, 3)), dtype=torch.float32,
                          device=dev)
    act = torch.zeros(n, dtype=torch.bool, device=dev)
    for f, live in enumerate((700, 33, 0)[:frames]):
        act[f * per:f * per + live] = True
    act[per - 100] = True
    fob = torch.arange(frames, dtype=torch.int32, device=dev).repeat_interleave(per // block)
    return shared, bank, fob, pts, act


@pytest.mark.gpu
@pytest.mark.parametrize("block", [512, 80])
@pytest.mark.parametrize("precise_x", [True, False])
def test_cuda_k6_matches_in_order_plain(precise_x, block, k_order):
    """K6 against its plain version with the in-order product, bit for bit
    and on active lanes within K5's bars (dead tiles 3e38 on both); with
    80-point blocks two frames share a 32-point tile. A second launch gives
    the same bits."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    dev = _device()
    shared, bank, fob, pts, act = _k6_case(dev, block)
    run = lambda k: mlp_eval.point_eval_banked(shared, bank, fob, pts, act, block=block,
                                               precise_x=precise_x, use_kernel=k)
    n0 = mlp_eval.point_eval_banked.launches
    out, again = run(True), run(True)
    assert mlp_eval.point_eval_banked.launches == n0 + 2
    ref = run(False)
    assert mlp_eval.point_eval_banked.launches == n0 + 2
    torch.cuda.synchronize()
    live = mlp_eval._live_tiles(act)
    assert (out[~live] == 3.0e38).all() and (ref[~live] == 3.0e38).all()
    assert (out[live].abs() < 10).all()
    assert torch.equal(out, again)
    within, worst = _k5_bars(out[act], ref[act])
    assert within >= K5_WITHIN and worst <= K5_MAX, (within, worst)
    assert torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [512, 80])
def test_cuda_k6_grouping_is_bit_exact(block):
    """K6 gives a point the same bits however its blocks are grouped: the
    blocks shuffled (each keeping its frame and its points) and split
    over two launches. A 32-point tile's liveness follows its neighbours
    (80-point blocks move tile edges), so lanes live in both groupings are
    compared, and every lane of a dead tile is 3e38."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    dev = _device()
    shared, bank, fob, pts, act = _k6_case(dev, block)
    run = lambda f, p, a: mlp_eval.point_eval_banked(shared, bank, f, p.contiguous(),
                                                     a.contiguous(), block=block)
    out = run(fob, pts, act)
    live = mlp_eval._live_tiles(act)

    def same(lanes, got, now):
        both = now & live[lanes]
        return (both.sum() > 700 and torch.equal(got[both], out[lanes][both])
                and bool((got[~now] == 3.0e38).all()))

    nb = fob.shape[0]
    perm = torch.as_tensor(np.random.default_rng(3).permutation(nb), device=dev)
    lanes = (perm[:, None] * block + torch.arange(block, device=dev)).reshape(-1)
    assert same(lanes, run(fob[perm], pts[lanes], act[lanes]),
                mlp_eval._live_tiles(act[lanes]))
    cut = (nb // 3) * block  # each launch's tiles start at its first lane
    both = torch.cat([run(fob[:nb // 3], pts[:cut], act[:cut]),
                      run(fob[nb // 3:], pts[cut:], act[cut:])])
    now = torch.cat([mlp_eval._live_tiles(act[:cut]), mlp_eval._live_tiles(act[cut:])])
    assert same(torch.arange(pts.shape[0], device=dev), both, now)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [("cert", "march"), ("cert", "probe"), ("march", "probe")])
def test_cuda_cert_render_matches_plain(mode, k_order):
    """render_batched_c2f with verify_mode="cert", verify_band="probe" and
    the hybrid (the bench decoder verified through its proxy), two frames,
    against the plain versions with the march kernels' k order: every
    field bit for bit, and so within chip_smoke.py's shares for (d) (hits
    agreeing on >= 0.9999 of the rays; depth 0.98, min_sdf 0.998,
    depth_at_min 0.995 of common hits within 1e-5); and K6 launched."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    dev = _device()
    params, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    proxy = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    img = 48
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img),
                            device=dev)
    o, v = pixel_rays(cam, img, img)
    lat = torch.stack([z0, z0 + 0.001])
    n0 = mlp_eval.point_eval_banked.launches
    outs = [bm.render_batched_c2f(
        params, DecoderConfig(), lat, o[None, :1].expand(2, 1, 3),
        v[None].expand(2, -1, -1), (img, img), MARCH, proxy=proxy,
        shared_origin=True, verify_mode=mode[0], verify_band=mode[1],
        verify_round_caps=(2, 4, 12), return_anchor=True, return_steps=True,
        return_last=True, use_kernel=k)
        for k in (True, False)]
    torch.cuda.synchronize()
    assert mlp_eval.point_eval_banked.launches >= n0 + 2  # probes + refinement
    k, p = outs
    assert k.hit.sum() > 500
    assert (k.hit == p.hit).float().mean().item() >= 0.9999
    both = k.hit & p.hit
    for name, share in (("depth", 0.98), ("min_sdf", 0.998), ("depth_at_min", 0.995)):
        a, b = getattr(k, name), getattr(p, name)
        near = ((a - b).abs() <= 1e-5)[both].float().mean().item()
        assert near >= share, (name, near)
    for name in ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf", "steps",
                 "unresolved"):
        assert _same(getattr(k, name), getattr(p, name)), name


def test_cpu_tensors_take_the_k6_plain_version_uncounted():
    """On CPU tensors K6's wrapper runs the plain version and counts no
    launch."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    shared, bank, fob, pts, act = _k6_case(torch.device("cpu"), 512, frames=2)
    n0 = mlp_eval.point_eval_banked.launches
    out = mlp_eval.point_eval_banked(shared, bank, fob, pts, act)
    assert torch.equal(out, mlp_eval.point_eval_banked_plain(shared, bank, fob, pts, act))
    assert mlp_eval.point_eval_banked.launches == n0


# ptxas's registers per thread for the in-order witness
# (csrc/march_in_order.cu), as this tree's build reported them (NVIDIA
# H100 80GB HBM3, CUDA 12.8): its mlp_tile, the CUDA-core body the routed
# march kernels left for point_mlp.cuh, must keep its code as it was.
WITNESS_REGISTERS = {
    "march_in_order_kernel": 176,
}
# every tensor-core kernel's spill stores stay a few words (ptxas -v)
MMA_SPILL_BYTES = 64


def ptxas_registers(log: str) -> dict:
    """{mangled kernel name: registers} from nvcc -Xptxas -v output."""
    import re

    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            regs[name] = int(m.group(1))
            name = None
    return regs


def ptxas_spills(log: str) -> dict:
    """{mangled kernel name: spill store bytes} from nvcc -Xptxas -v output."""
    import re

    spills, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name is not None:
            spills[name] = int(m.group(1))
    return spills


MARCH_KERNELS = ("march_mma_kernel", "sphere_trace_grid_kernel", "queue_generation_kernel")


@pytest.mark.gpu
def test_cuda_march_registers_unchanged():
    _device()
    log = build.load().build_log
    regs, spills = ptxas_registers(log), ptxas_spills(log)
    for key, want in WITNESS_REGISTERS.items():
        got = [r for name, r in regs.items() if key in name]
        assert got == [want], (key, got)
    assert any("point_mlp_kernel" in name for name in regs)
    # K1, K1-multi, K1-grid and K2's generations: march_mma.cuh's tile march
    march = {n: r for n, r in regs.items() if any(k in n for k in MARCH_KERNELS)}
    assert len(march) == 4, sorted(regs)
    # K5, K6 and the march kernels share point_mlp.cuh's wgmma loop and
    # producer with K3 and K4: their registers stay the parent's 168, and
    # the march kernels spill a few words at most
    mma = {n: r for n, r in regs.items() if "point_mlp_kernel" in n or n in march}
    assert set(mma.values()) == {168}, mma
    assert all(spills[n] <= MMA_SPILL_BYTES for n in march), {n: spills[n] for n in march}
    assert sum("precise_kernel" in name for name in regs) == 2


# K3's and K4's ptxas report, as their one body (recompute.cu's
# precise_block) compiled before it gained the value mode
PRECISE_REGISTERS = {"precise_kernelILb1E": (168, 60), "precise_kernelILb0E": (168, 24)}


@pytest.mark.gpu
def test_cuda_precise_registers_unchanged():
    """K3 and K4 keep their registers and spill stores; K3's value mode
    (precise_value_kernel) is built, within the tensor-core kernels'
    registers and spills."""
    _device()
    log = build.load().build_log
    regs, spills = ptxas_registers(log), ptxas_spills(log)
    for key, want in PRECISE_REGISTERS.items():
        got = [(r, spills[n]) for n, r in regs.items() if key in n]
        assert got == [want], (key, got)
    value = [n for n in regs if "precise_value_kernel" in n]
    assert len(value) == 1
    assert regs[value[0]] <= 168 and spills[value[0]] <= MMA_SPILL_BYTES


@pytest.mark.gpu
def test_cuda_precise_smem_plan_matches_the_host():
    """K3's and K4's shared-memory plan (drt_precise_smem, recompute.cu's
    smem_plan) and the wrappers' own sum (precise_smem_bytes) agree on the
    card tests' decoders, the bench 8x512 (227,136 bytes, under the
    232,448 a block may use) and the 8x512 color decoder."""
    import ctypes

    from dist_renderer_tpu_torch.models.color_decoder import (
        init_color_params, make_color_config,
    )

    _device()
    lib = build.load()
    packs = [_k4_inputs(arch, torch.device("cpu"), n=4)[3] for arch in range(len(K3_ARCHS) + 1)]
    ccfg = make_color_config()
    packs.append(rc.pack_precise(init_color_params(torch.Generator().manual_seed(0), ccfg,
                                                   "cpu"), ccfg))
    for pk in packs:
        tab = (ctypes.c_int * len(pk.table))(*pk.table)
        assert lib.drt_precise_smem(tab, len(pk.meta)) == rc.precise_smem_bytes(pk)
    assert rc.precise_smem_bytes(packs[len(K3_ARCHS)]) == 227_136


@pytest.mark.gpu
def test_cuda_point_mlp_smem_plan_matches_the_host():
    """The kernels' shared-memory plans (drt_point_mlp_smem for K5 and K6,
    drt_march_mma_smem for K1 and K1-multi, point_mlp.cuh's smem_plan) and
    the wrappers' own sum (mlp_eval.smem_plan_bytes) agree at every
    activation width from 16 to 1024."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval

    _device()
    lib = build.load()
    for w16 in range(16, 1025, 16):
        assert lib.drt_point_mlp_smem(w16) == mlp_eval.smem_plan_bytes(w16), w16
        assert lib.drt_march_mma_smem(w16) == mlp_eval.smem_plan_bytes(w16, True), w16


def sass_functions(sass: str) -> dict:
    """{mangled function name: its SASS text} from cuobjdump --dump-sass."""
    import re

    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


@pytest.mark.gpu
def test_cuda_point_evals_run_on_tensor_cores():
    """Every K5 and K6 kernel of the built library, every march kernel
    (K1's, K1-multi's, K1-grid's and K2's generations), and K3's and
    K4's (precise_kernel) and K3's value mode's (precise_value_kernel),
    issues warpgroup MMAs (HGMMA in its SASS); the in-order witness
    issues none."""
    import shutil
    import subprocess

    _device()
    lib = build.load()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", lib.path], capture_output=True, text=True,
                          check=True).stdout
    funcs = sass_functions(sass)
    point = {k: v for k, v in funcs.items() if "point_mlp_kernel" in k}
    march = {k: v for k, v in funcs.items() if any(m in k for m in MARCH_KERNELS)}
    precise = {k: v for k, v in funcs.items() if "precise_kernel" in k
               or "precise_value_kernel" in k}
    assert len(point) >= 4 and len(march) == 4 and len(precise) == 3, sorted(funcs)
    assert any("sphere_trace_grid" in k for k in march)
    assert any("queue_generation" in k for k in march)
    for name, text in {**point, **march, **precise}.items():
        assert "HGMMA" in text, name
    witness = [k for k in funcs if "march_in_order_kernel" in k]
    assert len(witness) == 1 and "HGMMA" not in funcs[witness[0]]


def test_sass_functions_splits_a_dump():
    dump = ("\tcode for sm_90a\n\t\tFunction : _ZN3drt2pm16point_mlp_kernelE\n"
            "        /*0000*/ HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;\n"
            "\t\tFunction : _ZN3drt19sphere_trace_kernelEv\n        /*0000*/ FFMA R1, R2, R3, R4 ;\n")
    funcs = sass_functions(dump)
    assert set(funcs) == {"_ZN3drt2pm16point_mlp_kernelE", "_ZN3drt19sphere_trace_kernelEv"}
    assert "HGMMA" in funcs["_ZN3drt2pm16point_mlp_kernelE"]
    assert "HGMMA" not in funcs["_ZN3drt19sphere_trace_kernelEv"]


def test_ptxas_registers_parses_the_build_log():
    log = ("ptxas info    : Compiling entry function '_ZN3drt19sphere_trace_kernelEv' "
           "for 'sm_90a'\nptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 184 registers, used 1 barriers, 640 bytes smem\n")
    assert ptxas_registers(log) == {"_ZN3drt19sphere_trace_kernelEv": 184}


def test_ptxas_spills_parses_the_build_log():
    log = ("ptxas info    : Compiling entry function '_ZN3drt23queue_generation_kernelE' "
           "for 'sm_90a'\nptxas info    : Function properties for x\n"
           "16 bytes stack frame, 28 bytes spill stores, 28 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n"
           "ptxas info    : Compiling entry function '_ZN3drt17queue_seed_kernelE' "
           "for 'sm_90a'\n0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n")
    assert ptxas_spills(log) == {"_ZN3drt23queue_generation_kernelE": 28,
                                 "_ZN3drt17queue_seed_kernelE": 0}


# ---- the TPU probe scripts' kernels (csrc/probe_launch.cu, probe_blocks.cu,
# mlp_chain.cu): each against its plain version ----

PROBE_MODULES = ("diag_launch_cost", "diag_launch2", "diag_launch3", "diag_launch4")


@pytest.mark.gpu
@pytest.mark.parametrize("module", PROBE_MODULES)
def test_cuda_probe_kernels_match_plain_at_the_scripts_shapes(module):
    """Each diag module's check: P1-P22 at the TPU scripts' inputs (and
    seeded ones), equal to the plain versions where the math is exact and
    within the module's bars where sums run in another order."""
    import importlib

    dev = _device()
    rows = importlib.import_module(f"dist_renderer_tpu_torch.diag.{module}").check(dev)
    assert rows and all(r["ms"] > 0 for r in rows)


@pytest.mark.gpu
@pytest.mark.parametrize("int_pos", [False, True])
def test_cuda_compaction_drops_what_names_no_slot(int_pos):
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.uniform(-4, 4, (24, 512)).astype(np.float32)).to(dev)
    surv = torch.from_numpy((rng.random((1, 512)) < 0.6).astype(np.float32)).to(dev)
    pos = rng.permutation(np.arange(-40, 1100))[:512].astype(np.float32)
    pos[:7] += 0.25  # non-integral: no slot in fp32, truncated with int_pos
    pos = torch.from_numpy(pos[None]).to(dev)
    assert torch.equal(pk.compact(d, pos, surv, int_pos=int_pos),
                       pk.compact_plain(d, pos, surv, int_pos=int_pos))


@pytest.mark.gpu
def test_cuda_building_blocks_on_seeded_inputs():
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    g = torch.Generator().manual_seed(6)
    x = (torch.rand((3, 1000), generator=g) * 200 - 100).to(dev)
    assert torch.equal(pk.scan(x), pk.scan_plain(x))          # the TPU kernel's adds
    b = torch.randint(0, 2, (5, 512), generator=g).to(torch.bfloat16).to(dev)
    assert torch.equal(pk.scan(b), torch.cumsum(b.float(), 1))  # 0/1: exact
    for shift in (-512, 0, 1, 513, 1023):
        xr = x[:, :1000].contiguous()
        assert torch.equal(pk.roll_lanes(xr, shift), pk.roll_lanes_plain(xr, shift))
    xm = (torch.rand((24, 512), generator=g) * 2 - 1).to(dev)
    w = (torch.rand((512, 256), generator=g) * 2 - 1).to(torch.bfloat16).to(dev)
    # 24 rows: a full and a ragged 16-row tile
    diff = (pk.small_mm(xm, w) - pk.small_mm_plain(xm, w)).abs().max().item()
    assert diff <= 1e-3
    m = (torch.rand((300, 512), generator=g) * 2 - 1).to(dev)
    assert (pk.f32dot(xm, m) - pk.f32dot_plain(xm, m)).abs().max().item() <= 1e-4
    rays = torch.rand((16, 4096), generator=g).to(dev)
    for trips in (0, 2):
        t = torch.tensor([trips], dtype=torch.int32, device=dev)
        dflt = torch.rand((8, 4096), generator=g).to(dev)
        assert torch.equal(pk.dma_loop(t, rays, dflt.clone()),
                           pk.dma_loop_plain(t, rays, dflt.clone()))


def _compaction_case(rows, lanes, slots, seed):
    """d [rows, lanes] fp32 (a -0.0 among it), pos and surv [1, lanes]:
    distinct integral positions from below 0 to past the slots, 70%
    survivors, and lanes that name no slot of every kind: non-survivors
    (0, exactly 0.5, NaN), NaN and infinite positions, positions past
    int32's range, and positions p + 0.25 (p >= 0: no slot in fp32, slot
    p truncated)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-4, 4, (rows, lanes)).astype(np.float32)
    d.flat[rng.integers(d.size)] = -0.0
    surv = (rng.random(lanes) < 0.7).astype(np.float32)
    pos = rng.permutation(np.arange(-lanes, slots + lanes))[:lanes].astype(np.float32)
    kinds = [("surv", 0.5), ("surv", np.nan), ("pos", np.nan), ("pos", np.inf),
             ("pos", -np.inf), ("pos", 2.0 ** 31), ("pos", -(2.0 ** 31) - 256.0),
             ("pos", 3.0e9), ("frac", 0.25)]
    for (kind, v), j in zip(kinds, rng.permutation(lanes)):
        if kind == "surv":
            surv[j] = v
        elif kind == "pos":
            surv[j], pos[j] = 1.0, v
        elif pos[j] >= 0:
            surv[j], pos[j] = 1.0, pos[j] + v
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return as_t(d), as_t(pos[None]), as_t(surv[None])


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [1, 256, 1024, 4096])
@pytest.mark.parametrize("lanes", [1, 33, 512, 1000])
@pytest.mark.parametrize("rows", [1, 3, 24, 64])
def test_cuda_compact_equals_plain_at_any_shape(rows, lanes, slots):
    """compact's blocks (a row and 1,024 slots each, rounds of 512 lanes,
    16-byte stores where slots % 4 == 0) give compact_plain's bits, -0.0
    included, with fp32 and int positions, every kind of dropped lane
    among the survivors."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    d, pos, surv = _compaction_case(rows, lanes, slots, rows * 7919 + lanes * 31 + slots)
    for int_pos in (False, True):
        want = pk.compact_plain(d, pos, surv, slots, int_pos)
        got = pk.compact(d.to(dev), pos.to(dev), surv.to(dev), slots, int_pos)
        assert torch.equal(_bits(got.cpu()), _bits(want)), (int_pos, rows, lanes, slots)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(24, 512, 1024), (64, 1000, 4096), (3, 33, 257)])
def test_cuda_compact_writes_every_slot(shape):
    """The output's block, filled with NaN and freed just before the call,
    comes back from the allocator as the output; no NaN is left in it, so
    the kernel wrote every slot (d holds no NaN)."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    rows, lanes, slots = shape
    d, pos, surv = (t.to(dev) for t in _compaction_case(rows, lanes, slots, 11))
    for int_pos in (False, True):
        nan = torch.full((rows, slots), float("nan"), device=dev)
        at = nan.data_ptr()
        del nan
        got = pk.compact(d, pos, surv, slots, int_pos)
        assert got.data_ptr() == at
        assert not torch.isnan(got).any()
        assert torch.equal(_bits(got), _bits(pk.compact_plain(d, pos, surv, slots, int_pos)))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 2, 31, 32, 33, 511, 512, 1000, 1024])
@pytest.mark.parametrize("rows", [1, 4, 65])
def test_cuda_scan_equals_plain(rows, lanes):
    """scan's warp per row gives scan_plain's bits on seeded fp32 (-0.0
    leading a row, which the first step's +0.0 turns into 0.0), also from
    a misaligned row (4-byte loads), and torch.cumsum's on bf16 0/1."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    rng = np.random.default_rng(rows * 1031 + lanes)
    x = torch.from_numpy(rng.uniform(-100, 100, (rows, lanes)).astype(np.float32))
    x[0, 0] = -0.0
    want = _bits(pk.scan_plain(x))
    assert torch.equal(_bits(pk.scan(x.to(dev)).cpu()), want)
    assert torch.equal(_bits(pk.scan(_misaligned(x.to(dev))).cpu()), want)
    b = torch.from_numpy(rng.integers(0, 2, (rows, lanes)).astype(np.float32)).to(torch.bfloat16)
    want_b = torch.cumsum(b.float(), 1)
    assert torch.equal(pk.scan(b.to(dev)).cpu(), want_b)
    assert torch.equal(pk.scan(_misaligned(b.to(dev))).cpu(), want_b)


@pytest.mark.gpu
def test_cuda_compact_and_scan_sass():
    """In the built library's SASS, compact's kernel stores by STG.E.128
    and scan's kernels (fp32 and bf16 at L = 512) hold no barrier."""
    import shutil
    import subprocess

    from dist_renderer_tpu_torch.diag import block_designs

    _device()
    lib = build.load()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", lib.path], capture_output=True, text=True,
                          check=True).stdout
    block_designs.check_sass(block_designs.sass_ops(sass))


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous tensor starting 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 24, 32])
@pytest.mark.parametrize("k", [1, 100, 512])
def test_cuda_f32dot_edges_of_its_tiling(rows, k):
    """f32dot at the edges of its tiling (a block per 8 columns, 128-deep
    copy groups, 16-byte or 4-byte copies): within diag_launch2's bar of
    the plain version on seeded input, bit for bit on a one-hot m (each
    output one exact product), and the same bits from two launches and
    through the 4-byte copies of a misaligned x."""
    from dist_renderer_tpu_torch.diag.diag_launch2 import DOT_BAR
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    rng = np.random.default_rng(100 * rows + k)
    x = torch.from_numpy(rng.uniform(-1, 1, (rows, k)).astype(np.float32)).to(dev)
    for s in (8, 300, 1024, 1030):
        m = torch.from_numpy(rng.uniform(-1, 1, (s, k)).astype(np.float32)).to(dev)
        got = pk.f32dot(x, m)
        assert got.shape == (rows, s)
        assert (got - pk.f32dot_plain(x, m)).abs().max().item() <= DOT_BAR
        assert torch.equal(pk.f32dot(x, m), got)
        assert torch.equal(pk.f32dot(_misaligned(x), m), got)
        pick = torch.from_numpy(rng.integers(0, k, s)).to(dev)
        hot = torch.nn.functional.one_hot(pick, k).to(torch.float32)
        assert torch.equal(pk.f32dot(x, hot), pk.f32dot_plain(x, hot))
        assert torch.equal(pk.f32dot(x, hot), x[:, pick])


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 24, 40])
@pytest.mark.parametrize("k", [16, 528])
def test_cuda_small_mm_edges_of_its_tiling(m, k):
    """small_mm at the edges of its tiling (16 columns a block, the last
    one half empty at N = 264; rows in chunks of 32, padded to 8; K in
    chunks of 512 split over 8 warps) and its loop at 0, 1 and 3 trips:
    within diag_launch4's bar of the plain version on seeded input, bit
    for bit on ones (every sum exact), and the same bits from every launch,
    looped or not."""
    from dist_renderer_tpu_torch.diag.diag_launch4 import MM_BAR
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    rng = np.random.default_rng(1000 * m + k)
    x = torch.from_numpy(rng.uniform(-1, 1, (m, k)).astype(np.float32)).to(dev)
    for n in (8, 264, 512):
        w = torch.from_numpy(rng.uniform(-1, 1, (k, n)).astype(np.float32))
        w = w.to(torch.bfloat16).to(dev)
        ones_x = torch.ones((m, k), dtype=torch.float32, device=dev)
        ones_w = torch.ones((k, n), dtype=torch.bfloat16, device=dev)
        got = pk.small_mm(x, w)
        assert got.shape == (m, n)
        assert (got - pk.small_mm_plain(x, w)).abs().max().item() <= MM_BAR
        assert torch.equal(pk.small_mm(ones_x, ones_w), pk.small_mm_plain(ones_x, ones_w))
        assert torch.equal(pk.small_mm(x, w), got)
        for trips in (0, 1, 3):
            want = torch.zeros_like(got) if trips == 0 else got
            assert torch.equal(pk.small_mm(x, w, True, trips), want)
            assert torch.equal(pk.small_mm(ones_x, ones_w, True, trips),
                               pk.small_mm_plain(ones_x, ones_w, True, trips))


@pytest.mark.gpu
@pytest.mark.parametrize("width", [128, 256, 384, 512])
@pytest.mark.parametrize("cols,layers", [(192, 3), (64, 3), (320, 3), (192, 1)])
def test_cuda_mlp_chains_match_plain(width, cols, layers):
    """Both chains at every width the kernel takes, on column counts that
    leave a block's tail masked (64, 192, 320: 1, 3 and 5 warpgroups' 64
    columns, a block spanning 128), and with one layer (the last layer is
    the first): int8 bit for bit, bf16 within 2e-3, at 0, 1 and 3 steps."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_chain as mc

    dev = _device()
    rng = np.random.default_rng(width + cols + layers)
    x = torch.from_numpy(rng.standard_normal((width, cols)).astype(np.float32)).to(dev)
    wi = torch.from_numpy(rng.integers(-127, 128, (layers, width, width))
                          .astype(np.int8)).to(dev)
    wb = torch.from_numpy((0.05 * rng.standard_normal((layers, width, width)))
                          .astype(np.float32)).to(torch.bfloat16).to(dev)
    before = (mc.chain_bf16.launches, mc.chain_int8.launches)
    for steps in (0, 1, 3):
        assert torch.equal(mc.chain_int8(x, wi, steps), mc.chain_int8_plain(x, wi, steps))
        diff = (mc.chain_bf16(x, wb, steps) - mc.chain_bf16_plain(x, wb, steps)).abs()
        assert diff.max().item() <= 2e-3
    assert (mc.chain_bf16.launches, mc.chain_int8.launches) == (before[0] + 3, before[1] + 3)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(0,), (1,), (3,), (8, 512), (3, 5), (1027,),
                                   ((1 << 22) + 3,), "misaligned"])
def test_cuda_copy_and_add_one_edges_of_their_grid(shape):
    """copy and add_one at the edges of their grid (no launch at n = 0, a
    tail of n % 4 values, one block, many blocks, past a block's worth,
    and a view starting 4 bytes past a 16-byte boundary, which takes the
    4-byte body): equal to their plain versions bit for bit, one launch
    each where there is anything to move."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    rng = np.random.default_rng(18)
    dims = (8, 512) if shape == "misaligned" else shape
    x = torch.from_numpy(rng.uniform(-1, 1, dims).astype(np.float32)).to(dev)
    if shape == "misaligned":
        x = _misaligned(x)
    before = (pk.copy.launches, pk.add_one.launches)
    got = pk.copy(x)
    assert got.shape == x.shape and torch.equal(got, pk.copy_plain(x))
    assert torch.equal(pk.add_one(x), pk.add_one_plain(x))
    torch.cuda.synchronize()
    step = int(x.numel() > 0)
    assert (pk.copy.launches, pk.add_one.launches) == (before[0] + step, before[1] + step)


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_copy_and_add_one_keep_special_values(aligned):
    """copy moves bits (-0.0, infinities, a denormal and two NaNs with
    different payloads come back as they were); add_one is x + 1.0 in
    fp32, NaN where x is NaN. Both bodies: 16-byte and 4-byte."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    bits = np.array([0x80000000, 0x7F800000, 0xFF800000, 0x00000001, 0x7FC00001,
                     0xFFA00123, 0x3F800000, 0x807FFFFF, 0x00000000], dtype=np.uint32)
    x = torch.from_numpy(np.tile(bits, 115)[:1027].view(np.int32)).to(dev)
    x = x.view(torch.float32)
    if not aligned:
        x = _misaligned(x)
    assert torch.equal(pk.copy(x).view(torch.int32), x.view(torch.int32))
    got, want = pk.add_one(x), x + 1.0
    nan = torch.isnan(x)
    assert torch.equal(torch.isnan(got), nan) and nan.sum().item() == 2 * 114
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.gpu
def test_cuda_copy_and_add_one_take_a_64_bit_count():
    """Past 2^31 values (8.6 GB) copy and add_one reach the last one: the
    count is 64-bit in the C entries and the kernels' indexing."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    n = (1 << 31) + 5
    x = torch.rand(n, device=dev)
    x[-7:] = torch.arange(7, dtype=torch.float32, device=dev) - 3.0
    got = pk.copy(x)
    assert torch.equal(got, x)
    del got
    got = pk.add_one(x)
    assert torch.equal(got[-7:], x[-7:] + 1.0)
    assert torch.equal(got, x + 1.0)
    del got, x
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("trips", [-3, 0, 1, 8, 1000, 1 << 20, (1 << 24) + 5])
def test_cuda_vec_while_counts_its_trips(trips):
    """vec_while's carry is the trip count (none below 1, held at 2^24,
    where c + 1 rounds to c), bit for bit with the plain version, one
    launch a call."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    t = torch.tensor([trips], dtype=torch.int32, device=dev)
    before = pk.vec_while.launches
    got = pk.vec_while(t)
    assert got.shape == (8, 512) and torch.equal(got, pk.vec_while_plain(t))
    assert pk.vec_while.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1,), (3, 5), (7,), (4095,), (64, 64)])
def test_cuda_vec_while_carry_shapes(shape):
    """vec_while on carries that fill its block's 4,096 values or not,
    with and without an n % 4 tail of 4-byte stores."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    t = torch.tensor([5], dtype=torch.int32, device=dev)
    got = pk.vec_while(t, shape)
    assert got.shape == shape and torch.equal(got, pk.vec_while_plain(t, shape))


@pytest.mark.gpu
@pytest.mark.parametrize("ld", [512, 262_144])
@pytest.mark.parametrize("trips", [0, 1, 2, 64])
def test_cuda_dma_loop_matches_plain(trips, ld):
    """dma_loop writes rays[0:8, 0:512] + 1 into its output's first 512
    columns after a trip or more and nothing at 0 trips, in place; the
    columns from 512 on stay as they were. Bit for bit with the plain
    version, one launch a call."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    g = torch.Generator().manual_seed(trips + ld)
    rays = (torch.rand((16, ld), generator=g) * 2 - 1).to(dev)
    dflt = torch.rand((8, ld), generator=g).to(dev)
    t = torch.tensor([trips], dtype=torch.int32, device=dev)
    out = dflt.clone()
    before = pk.dma_loop.launches
    assert pk.dma_loop(t, rays, out) is out
    assert pk.dma_loop.launches == before + 1
    assert torch.equal(out, pk.dma_loop_plain(t, rays, dflt.clone()))
    assert torch.equal(out[:, 512:], dflt[:, 512:])
    assert torch.equal(out[:, :512], rays[:8, :512] + 1.0 if trips else dflt[:, :512])


@pytest.mark.gpu
def test_cuda_probe_loops_read_their_count_when_replayed():
    """vec_while and dma_loop read their trip count on the device at run
    time: one captured CUDA graph of each, replayed after the count is
    rewritten in place, follows the new count."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk
    from dist_renderer_tpu_torch.utils.profiling import capture

    dev = _device()
    g = torch.Generator().manual_seed(17)
    rays = (torch.rand((16, 4096), generator=g) * 2 - 1).to(dev)
    dflt = torch.rand((8, 4096), generator=g).to(dev)
    out = dflt.clone()
    trips = torch.zeros(1, dtype=torch.int32, device=dev)
    carries = []
    graph = capture(lambda: (carries.append(pk.vec_while(trips)),
                             pk.dma_loop(trips, rays, out)), 1)
    for n in (3, 0, 70, 1, 0):
        trips.fill_(n)
        out.copy_(dflt)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(carries[-1], torch.full((8, 512), float(n), device=dev))
        assert torch.equal(out, pk.dma_loop_plain(trips, rays, dflt.clone()))


@pytest.mark.gpu
def test_cuda_dma_loop_and_vec_while_reject_what_they_cannot_take():
    """The C entries refuse a row stride the bulk copies cannot take
    (below 512 or not a multiple of 4 floats) and a carry past the
    block's 4,096 values; the wrapper raises, nothing launches."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    t = torch.ones(1, dtype=torch.int32, device=dev)
    for ld in (256, 514):
        with pytest.raises(RuntimeError):
            pk.dma_loop(t, torch.zeros((16, ld), device=dev), torch.zeros((8, ld), device=dev))
    with pytest.raises(RuntimeError):
        pk.vec_while(t, (4097,))
    with pytest.raises(ValueError):
        pk.vec_while(t.to(torch.int64))


LOOP_TRIPS = (0, 1, 64, 512, 16384)


def _loop_probes():
    """P3-P6 and P11-P14: id -> (kernel call, plain call, whether the
    kernel writes its output), each a function of diag.Operands; P3 and
    P4 with the bench decoder's march plan as their scratch."""
    from dist_renderer_tpu_torch.diag import diag_launch3, diag_launch_cost
    from dist_renderer_tpu_torch.ops.kernels import probes as pk
    from dist_renderer_tpu_torch.ops.kernels.mlp_eval import smem_plan_bytes

    calls = {**diag_launch_cost.probe_calls(smem_plan_bytes(512, march=True)),
             **diag_launch3.ladder()}
    calls["P6"] = (lambda o: pk.scalar_while(o.n_live, zeros=True),
                   lambda o: pk.scalar_while_plain(o.n_live, zeros=True), True)
    return {pid: calls[pid] for pid in ("P3", "P4", "P5", "P6", "P11", "P12", "P13", "P14")}


@pytest.mark.gpu
@pytest.mark.parametrize("trips", LOOP_TRIPS)
@pytest.mark.parametrize("pid", ["P3", "P4", "P5", "P6", "P11", "P12", "P13", "P14"])
def test_cuda_loop_probes_match_plain(pid, trips):
    """The loop probes on seeded operands at n_live 0 to 16,384: the
    output equal to the plain version's (zeros, or the aliased defaults
    untouched), every operand equal to its clone taken before the launch
    (diag.check_probe), one launch a call."""
    from dist_renderer_tpu_torch.diag import Operands, check_probe
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    run, plain, written = _loop_probes()[pid]
    kern = pk.index_loop if pid in ("P4", "P14") else pk.scalar_while
    o = Operands(dev, total=40, seed=int(pid[1:]), n_live=trips)
    before = kern.launches
    assert check_probe(f"{pid} x{trips}", run, plain, o, written) == 0.0
    torch.cuda.synchronize()
    assert kern.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_bars", [0, 3])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("case", ["odd length", "misaligned", "aligned"])
def test_cuda_index_loop_stages_any_list(case, mode, n_bars):
    """index_loop on lists its int4 staging cannot take (511 entries; 512
    starting 4 bytes past a 16-byte boundary: the 4-byte loads) and one it
    can, with the least shared memory (the shared scalar ts right after
    the list's last entry), at n_live 0 to 16,384: defaults untouched and
    every operand as it was."""
    from dist_renderer_tpu_torch.diag import Operands, check_probe
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    rng = np.random.default_rng(19 + mode + n_bars)
    n = 511 if case == "odd length" else 512
    live = torch.from_numpy(rng.integers(1, 512, n).astype(np.int32)).to(dev)
    if case == "misaligned":
        live = _misaligned(live)
    run = lambda o: pk.index_loop(o.live, o.n_live, o.x16, o.x8, mode=mode, n_bars=n_bars)
    plain = lambda o: pk.index_loop_plain(o.live, o.n_live, o.x16, o.x8, mode=mode)
    for trips in LOOP_TRIPS:
        o = Operands(dev, seed=trips, n_live=trips)
        o.live = live
        assert check_probe(f"{case} mode {mode} x{trips}", run, plain, o) == 0.0


@pytest.mark.gpu
def test_cuda_graph_replay_of_loop_probes_equals_eager():
    """One CUDA graph of the loop probes (P3-P6, P11-P14), replayed after
    their count is rewritten in place (the loops read it on the device at
    every replay): the outputs equal the plain versions' and eager's, and
    no operand changes."""
    from dist_renderer_tpu_torch.diag import Operands
    from dist_renderer_tpu_torch.utils.profiling import capture

    dev = _device()
    probes = _loop_probes()
    o = Operands(dev, total=40, seed=5, n_live=0)
    keep = o.clone()
    outs = []
    graph = capture(lambda: outs.append([run(o) for run, _, _ in probes.values()]), 1)
    for n in (3, 0, 512, 1, 16384):
        o.n_live.fill_(n)
        keep.n_live.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        eager = [run(o) for run, _, _ in probes.values()]
        for (pid, (_, plain, written)), got, want in zip(probes.items(), outs[-1], eager):
            if written:
                assert torch.equal(got, plain(keep)), (pid, n)
                assert torch.equal(got, want), (pid, n)
            else:
                assert got.shape == want.shape, (pid, n)
        for name, t in vars(o).items():
            assert torch.equal(t, getattr(keep, name)), (name, n)


@pytest.mark.gpu
def test_cuda_loop_probes_are_not_folded():
    """The loops run their trips (a loop that read its bound once could
    fold into k = max(n, 0)): in a CUDA graph, scalar_while (P6) and
    index_loop mode 1 (P14, the scripts' 512-entry list) at 16,384 trips,
    and mode 0 (P4) over a 16,384-entry list, take more than 20x their
    time at 0 trips (or over a 4-entry list). Mode 0 runs its list's
    trips at any bound, so its time cannot tell a bound read at every
    trip from one held in a register: the SASS test below does."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk
    from dist_renderer_tpu_torch.utils.profiling import graph_us

    dev = _device()
    i32 = dict(dtype=torch.int32, device=dev)
    t0, tl = torch.zeros(1, **i32), torch.full((1,), 16384, **i32)
    rays, dflt = torch.zeros((16, 512), device=dev), torch.zeros((8, 512), device=dev)
    short, idx512, long = (torch.ones(n, **i32) for n in (4, 512, 16384))
    pairs = {
        "P6": (lambda: pk.scalar_while(t0, zeros=True),
               lambda: pk.scalar_while(tl, zeros=True)),
        "P14": (lambda: pk.index_loop(idx512, t0, rays, dflt, mode=1),
                lambda: pk.index_loop(idx512, tl, rays, dflt, mode=1)),
        "P4": (lambda: pk.index_loop(short, t0, rays, dflt, mode=0),
               lambda: pk.index_loop(long, t0, rays, dflt, mode=0)),
    }
    for pid, (none, many) in pairs.items():
        few_us, many_us = graph_us(none, 20), graph_us(many, 20)
        assert many_us > 20 * few_us, (pid, few_us, many_us)


@pytest.mark.gpu
def test_cuda_loop_probes_read_their_bound_from_shared_memory():
    """In the built library's SASS, scalar_while's and index_loop's trip
    loops each read the bound by an LDS and read no device memory (no LDG,
    no LD through a generic pointer): the bound is on chip at every trip,
    not hoisted into a register and not read from L2."""
    import shutil
    import subprocess

    from dist_renderer_tpu_torch.diag import loop_designs

    _device()
    lib = build.load()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", lib.path], capture_output=True, text=True,
                          check=True).stdout
    loops = loop_designs.sass_loops(sass)
    assert {"scalar_while kernel", "index_loop kernel"} <= set(loops), sorted(loops)
    loop_designs.check_sass(loops)


@pytest.mark.gpu
def test_cuda_graph_replay_of_probes_equals_eager():
    """A CUDA graph of the port's ctypes launches replays them: an aliased
    empty kernel leaves its operand as it was, and a graph of small_mm
    (plain and looped), f32dot, copy and add_one gives eager's bits."""
    from dist_renderer_tpu_torch.ops.kernels import probes as pk
    from dist_renderer_tpu_torch.utils.profiling import capture

    dev = _device()
    g = torch.Generator().manual_seed(7)
    x = (torch.rand((8, 512), generator=g) * 2 - 1).to(dev)
    w = (torch.rand((512, 512), generator=g) * 2 - 1).to(torch.bfloat16).to(dev)
    xd = (torch.rand((24, 512), generator=g) * 2 - 1).to(dev)
    md = (torch.rand((1024, 512), generator=g) * 2 - 1).to(dev)
    keep = x.clone()
    eager = (pk.small_mm(x, w), pk.small_mm(x, w, True), pk.f32dot(xd, md), pk.copy(x),
             pk.add_one(x))
    outs = []
    graph = capture(lambda: outs.append((pk.empty(x, aliased=True), pk.small_mm(x, w),
                                         pk.small_mm(x, w, True), pk.f32dot(xd, md),
                                         pk.copy(x), pk.add_one(x))), 3)
    graph.replay()
    torch.cuda.synchronize()
    assert all(o[0] is x for o in outs[-3:])
    assert torch.equal(x, keep)
    for o in outs[-3:]:
        for got, want in zip(o[1:], eager):
            assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_graph_replay_of_mlp_chains_equals_eager():
    """A CUDA graph of both chains (a cudaLaunchKernelEx launch with a
    tensor map among its parameters) replays eager's bits: int8 and bf16,
    at the smallest and the widest width."""
    from dist_renderer_tpu_torch.ops.kernels import mlp_chain as mc
    from dist_renderer_tpu_torch.utils.profiling import capture

    dev = _device()
    rng = np.random.default_rng(11)
    cases = []
    for width in (128, 512):
        x = torch.from_numpy(rng.standard_normal((width, 320)).astype(np.float32)).to(dev)
        wi = torch.from_numpy(rng.integers(-127, 128, (2, width, width))
                              .astype(np.int8)).to(dev)
        wb = torch.from_numpy((0.05 * rng.standard_normal((2, width, width)))
                              .astype(np.float32)).to(torch.bfloat16).to(dev)
        cases.append((x, wi, wb))
    eager = [(mc.chain_int8(x, wi, 2), mc.chain_bf16(x, wb, 2)) for x, wi, wb in cases]
    outs = []
    graph = capture(lambda: outs.append(
        [(mc.chain_int8(x, wi, 2), mc.chain_bf16(x, wb, 2)) for x, wi, wb in cases]), 2)
    graph.replay()
    torch.cuda.synchronize()
    for o in outs[-2:]:
        for got, want in zip(o, eager):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_cuda_probe_wrappers_reject_bad_inputs():
    from dist_renderer_tpu_torch.ops.kernels import mlp_chain as mc
    from dist_renderer_tpu_torch.ops.kernels import probes as pk

    dev = _device()
    x = torch.zeros((8, 512), device=dev)
    with pytest.raises(ValueError):
        pk.copy(x.double())
    with pytest.raises(ValueError):
        pk.small_mm(x, torch.zeros((512, 512), device=dev))  # fp32 weights
    w = torch.zeros((512, 512), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        pk.small_mm(_misaligned(x), w)  # the kernel's 16-byte loads
    with pytest.raises(ValueError):
        pk.small_mm(x, _misaligned(w))
    with pytest.raises(ValueError):
        pk.f32dot(torch.zeros((33, 512), device=dev), torch.zeros((8, 512), device=dev))
    with pytest.raises(ValueError):
        pk.scan(torch.zeros((1, 2048), device=dev))
    with pytest.raises(ValueError):
        pk.dma_loop(torch.zeros(1, dtype=torch.int32, device=dev), x, x)
    with pytest.raises(ValueError):
        mc.chain_int8(torch.zeros((100, 64), device=dev),
                      torch.zeros((1, 100, 100), dtype=torch.int8, device=dev), 1)
    with pytest.raises(ValueError):
        pk.copy(torch.zeros((8, 512)).to(dev)[:, ::2])  # not contiguous


@pytest.mark.gpu
def test_cuda_experiment_dir_round_trip(tmp_path):
    """Params on the card exported as a DeepSDF experiment directory load
    back onto the card bit for bit, and render the same bits on the
    K1-grid path."""
    from dist_renderer_tpu_torch.models.checkpoint import (
        load_decoder, load_latent_codes, save_deepsdf_experiment,
    )

    dev = _device()
    params, latent = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    exp = str(tmp_path / "exp")
    save_deepsdf_experiment(exp, params, DecoderConfig(), latents=latent[None])
    back, cfg = load_decoder(exp, device=dev)
    assert cfg == DecoderConfig()
    for a, b in zip(params["layers"], back["layers"]):
        assert a["w"].device == b["w"].device
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    z = load_latent_codes(exp, device=dev)[0]
    assert torch.equal(z, latent)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=96 * 1.2, img_hw=(96, 96), device=dev)
    cfg_r = RenderConfig(march=MARCH, compute_dtype="bfloat16", use_pallas=True)
    outs = [SDFRenderer(p, cam.K, (96, 96), cfg=cfg_r).render(z, cam.R, cam.T)
            for p in (params, back)]
    assert outs[0].mask.any()
    for k in ("depth", "mask", "normal", "min_sdf"):
        assert torch.equal(getattr(outs[0], k), getattr(outs[1], k)), k


@pytest.mark.gpu
def test_cuda_fit_step_matches_cpu():
    """One fit_decoder_to_sdf step at 8x512 on the card against the CPU's,
    the same draws from one CPU generator: both round the products'
    operands to bf16 and sum in fp32 in their own orders, so a few bf16
    roundings of activations flip (2^-8 of one point's term each, in a
    mean over 2,048 points). Bars, set from the first reading on an
    H100: the loss within 1e-4 relative (measured 5.7e-6); after the
    Adam step 99.5% of the weights within 1e-6 (measured 99.84%: Adam's
    first step is lr g / (|g| + 1e-8), so a weight whose gradient is near
    that eps follows the gradient's last bits), and none more than 2 lr
    apart."""
    from dist_renderer_tpu_torch.models.analytic import round_union, sphere_sdf, torus_sdf
    from dist_renderer_tpu_torch.models.pretrain import fit_decoder_to_sdf

    dev = _device()
    shape = round_union(torus_sdf(0.55, 0.18), sphere_sdf(0.35, (0.0, 0.25, 0.0)), 0.08)
    runs = []
    for d in ("cpu", dev):
        losses = []
        params, z0 = fit_decoder_to_sdf(lambda p: shape(None, p), DecoderConfig(), steps=1,
                                        batch=2048, gen=torch.Generator().manual_seed(0),
                                        device=d, losses=losses)
        runs.append((params, z0.cpu(), float(losses[0])))
    (pc, zc, lc), (pg, zg, lg) = runs
    assert torch.equal(zc, zg)
    assert abs(lc - lg) <= 1e-4 * abs(lc)
    diff = torch.cat([(a[k] - b[k].cpu()).abs().flatten() for a, b in
                      zip(pc["layers"], pg["layers"]) for k in ("w", "b")])
    assert (diff <= 1e-6).float().mean() >= 0.995
    assert diff.max() <= 2 * 5e-4 + 1e-6


@pytest.mark.gpu
def test_cuda_depth_completion_resume_is_bit_exact(tmp_path):
    """depth_completion --checkpoint-dir on the card (the committed torus
    8x512 decoder, --fast, 128^2): 3 steps, then a resume to 6, equal bit
    for bit to 6 uninterrupted steps (the kernels are deterministic)."""
    from dist_renderer_tpu_torch.tasks import depth_completion

    _device()
    base = ["--fast", "--img", "128", "--lr", "5e-2", "--checkpoint-every", "3"]
    ckpt = str(tmp_path / "ckpt")
    whole = depth_completion.main(base + ["--steps", "6", "--out", str(tmp_path / "w")])
    first = depth_completion.main(base + ["--steps", "3", "--checkpoint-dir", ckpt,
                                          "--out", str(tmp_path / "a")])
    rest = depth_completion.main(base + ["--steps", "6", "--checkpoint-dir", ckpt,
                                         "--out", str(tmp_path / "b")])
    assert torch.equal(rest.variables, whole.variables)
    assert torch.equal(torch.cat([first.loss_history, rest.loss_history]).cpu(),
                       whole.loss_history.cpu())


@pytest.mark.gpu
def test_cuda_sharded_renders_on_two_gloo_ranks():
    """render_batched_c2f_sharded (rounds and queue) and
    trace_sharded_pallas on 2 gloo ranks sharing the card (a (1, 2) mesh:
    two horizontal ray bands), against the single-device renders in this
    process: every march kernel gives each ray the same bits in any tile
    or launch, and the halo rows give the bands the single-device plan,
    so the outputs are equal bit for bit. K1 (and K2 under the queue)
    launched in both ranks; the kernels are built before the ranks
    start."""
    from dist_renderer_tpu_torch.ops.kernels.fused_march import (
        pack_folded, sphere_trace_grid,
    )
    from dist_renderer_tpu_torch.parallel import sharding
    from dist_renderer_tpu_torch.parallel.dryrun import run_calls
    from dist_renderer_tpu_torch.parallel.mesh import run_ranks

    dev = _device()
    build.load()
    params, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    _, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    img, frames = 128, 2
    lat = z0[None] + 0.001 * torch.as_tensor(
        np.random.default_rng(3).standard_normal((frames, z0.shape[0])),
        dtype=torch.float32, device=dev)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img), device=dev)
    o, v = pixel_rays(cam, img, img)
    ob, vb = o[None].expand(frames, -1, 3), v[None].expand(frames, -1, 3)
    kw = dict(params=params, dcfg=pcfg, latents=lat, origins=ob, dirs=vb,
              img_hw=(img, img), march=MARCH, strides=(16, 4), coarse_steps=16)
    packed = pack_folded(fold_latent(params, z0, pcfg), pcfg)
    axes, shape = ("latents", "rays"), (1, 2)
    calls = [(sharding.render_batched_c2f_sharded, axes, shape, dict(kw, scheduler=s))
             for s in ("rounds", "queue")]
    calls.append((sharding.trace_sharded_pallas, ("rays",), (2,),
                  dict(packed=packed, origins=o, dirs=v, march=MARCH)))
    res = run_ranks(run_calls, 2, calls, "cuda", [bm.sphere_trace_persistent, qm.queue_march],
                    backend="gloo", device="cuda")
    for r, sched in zip(res[:2], ("rounds", "queue")):
        ref = bm.render_batched_c2f(params, pcfg, lat, ob, vb, (img, img), MARCH,
                                    strides=(16, 4), coarse_steps=16, scheduler=sched)
        for got, want in zip(r["out"], (ref.depth, ref.hit, ref.min_sdf)):
            assert torch.equal(got, want.cpu()), sched
        assert ref.hit.any()
        assert all(n[0] > 0 for n in r["launches"]), r["launches"]
        if sched == "queue":
            assert all(n[1] > 0 for n in r["launches"]), r["launches"]
    grid = sphere_trace_grid(packed, o, v, MARCH)
    for got, want in zip(res[2]["out"], (grid.depth, grid.hit, grid.min_sdf)):
        assert torch.equal(got, want.cpu())


@pytest.mark.gpu
def test_cuda_polish_batched_matches_plain(k_order):
    """polish_depth_batched on K3 against its plain version with the
    kernels' summation order: depth and residual bit for bit, on a proxy
    march of the bench decoder's frames (as chip_smoke.py's phase 12)."""
    from dist_renderer_tpu_torch.ops.polish import polish_depth_batched

    dev = _device()
    params, latent = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    proxy, pcfg = load_proxy_npz(os.path.join(ROOT, ".bench_proxy.npz"), dev)
    img, frames = 64, 2
    lat = latent[None] + 0.001 * torch.as_tensor(
        np.random.default_rng(5).standard_normal((frames, latent.shape[0])),
        dtype=torch.float32, device=dev)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img), device=dev)
    o, v = pixel_rays(cam, img, img)
    ob, vb = o[None].expand(frames, -1, 3), v[None].expand(frames, -1, 3)
    st = bm.render_batched_c2f(proxy, pcfg, lat, ob, vb, (img, img), MARCH, strides=(16, 4))
    assert st.hit.any()
    n0 = rc.precise_sdg_call.launches
    runs = [polish_depth_batched(params, DecoderConfig(), lat, ob, vb, st.depth, st.hit,
                                 use_kernel=k, return_residual=True) for k in (True, False)]
    assert rc.precise_sdg_call.launches == n0 + 3 * frames
    for a, b in zip(*runs):
        assert _same(a, b)


def _bench_frames(dev, img=128, frames=2):
    """The bench decoder, its proxy with the margins of its error report,
    and two frames of img^2 through the bench camera (latents jittered by
    0.001 from seed 9)."""
    from dist_renderer_tpu_torch.diag import bench_latents, load_bench

    params, dcfg, latent, proxy, (backoff, band) = load_bench(dev, ROOT)
    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img), device=dev)
    o, v = pixel_rays(cam, img, img)
    lat = bench_latents(latent, frames)
    return dict(params=params, dcfg=dcfg, latents=lat, origins=o[None, :1].expand(frames, 1, 3),
                dirs=v[None].expand(frames, -1, 3), img_hw=(img, img), march=MARCH,
                proxy=proxy, proxy_backoff=backoff, proxy_band=band, shared_origin=True)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [dict(), dict(scheduler="queue"), dict(verify_mode="cert"),
                                  dict(verify_band="probe")])
def test_cuda_with_diag_changes_no_bit(mode):
    """render_batched_c2f with_diag=True on the kernels at 128^2: every
    output field the bits of the render without telemetry (rounds, queue,
    cert, hybrid); the residencies are march_tile_steps of K1's launches
    and stay on the card."""
    dev = _device()
    kw = dict(_bench_frames(dev), return_anchor=True, return_steps=True, return_last=True,
              **mode)
    ref = bm.render_batched_c2f(**kw)
    out, diag = bm.render_batched_c2f(with_diag=True, **kw)
    torch.cuda.synchronize()
    assert ref.hit.sum() > 1000
    for name in ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf", "steps",
                 "unresolved"):
        assert _same(getattr(out, name), getattr(ref, name)), name
    assert all(v.is_cuda for v in diag.values())
    assert "verify_key" in diag and "plan_key" in diag
    assert ("fine_r0_block_residency" in diag) == (mode.get("scheduler") != "queue")
    if "verify_mode" in mode or "verify_band" in mode:
        assert int(diag["cert_demoted"]) >= 0 and float(diag["cert_frac"]) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["queue_caps", "verify_gen_caps"])
def test_cuda_queue_cap_sweep_keeps_every_bit(which):
    """K2's generation-cap schedules (diag_queue's, and the verify
    stage's) at 128^2: every schedule gives the first schedule's bits
    (tests/test_torch_queue.py's contract: one uninterrupted march)."""
    dev = _device()
    kw = dict(_bench_frames(dev), scheduler="queue", return_anchor=True, return_steps=True)
    n0 = qm.queue_march.launches
    outs = [bm.render_batched_c2f(**{which: caps}, **kw)
            for caps in ((6, 16), (4, 12), (8,), (6, 16, 32), (1, 2, 6, 16))]
    torch.cuda.synchronize()
    assert qm.queue_march.launches > n0
    for out in outs[1:]:
        for name in ("depth", "hit", "min_sdf", "depth_at_min"):
            assert _same(getattr(out, name), getattr(outs[0], name)), name


@pytest.mark.gpu
def test_cuda_round_cap_sweep_matches_plain(k_order):
    """The rounds scheduler's cap schedules (diag_round_caps) at 64^2 (the
    in-order product is a loop over k): each schedule's kernel render
    equals its plain version with the kernels' summation order bit for
    bit; a schedule moves where a ray stops (results are a function of
    the caps, as in the JAX package) but keeps its hit on >= 0.999 of the
    rays."""
    dev = _device()
    kw = dict(_bench_frames(dev, img=64), scheduler="rounds")
    outs = []
    for caps in ((4, 12), (2, 6, 18)):
        k, p = (bm.render_batched_c2f(round_caps=caps, use_kernel=u, **kw)
                for u in (True, False))
        for name in ("depth", "hit", "min_sdf"):
            assert _same(getattr(k, name), getattr(p, name)), (caps, name)
        outs.append(k)
    assert (outs[0].hit == outs[1].hit).float().mean().item() >= 0.999


# ---- the stage-split and fidelity diagnostics (diag/, chip_smoke.py phase 14) ----

def _stage_cell(frames=1, img=64):
    from dist_renderer_tpu_torch.diag import BenchCell

    return BenchCell(_device(), frames, img)


STAGE_RUNS = {
    "diag_f1_stages": lambda m, tmp: m.measure(_device(), _stage_cell(), "xla,pallas",
                                               proxy=True, reps=1),
    "diag_compose": lambda m, tmp: m.measure(_device(), _stage_cell(), proxy=True, reps=1),
    "diag_glue": lambda m, tmp: m.measure(_device(), _stage_cell(), 1, True, frames=2,
                                          rays=64 * 64),
    "diag_sortcost": lambda m, tmp: m.measure(_device(), 1, frames=2, rays=64 * 64),
    "diag_fused_dd": lambda m, tmp: m.measure(_device(), _stage_cell(), 1),
    "diag_recompute": lambda m, tmp: m.measure(_device(), _stage_cell(), "xla,fused,pallas",
                                               1),
    "diag_precision": lambda m, tmp: m.measure(_device(), _stage_cell(), 20000, 64 * 64, 1),
    "diag_polish_parity": lambda m, tmp: m.measure(_device(), _stage_cell(), reps=1),
    "diag_band_fidelity": lambda m, tmp: m.measure(_device(), _stage_cell(2), 1),
    "debug_band_probe": lambda m, tmp: m.measure(_device()),
    "diag_warm": lambda m, tmp: m.measure(_device(), (64,), 9),
    "retrain_proxy": lambda m, tmp: m.measure(_device(), steps=5,
                                              out=os.path.join(tmp, "proxy_v2.npz")),
    "diag_finalize_compile": lambda m, tmp: m.measure(_device(), 64, 2, reps=1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(STAGE_RUNS))
def test_cuda_stage_diagnostic_runs_and_holds(name, tmp_path):
    """Each module of chip_smoke.py's phase 14 at a small size (one or two
    frames of 64^2; diag_glue and diag_sortcost at 2 x 4,096 rays;
    debug_band_probe its own 32^2 scene; diag_warm 9 steps, past its
    first refresh): measure runs on the card, every
    check inside it holds (renders held to their plain versions with the
    in-order product, bit for bit), and its result is JSON. The bench
    fixtures keep their bytes (retrain_proxy writes into tmp_path)."""
    import hashlib
    import importlib
    import json

    fixtures = [os.path.join(ROOT, n) for n in (".bench_decoder.npz", ".bench_proxy.npz")]
    digest = lambda: [hashlib.sha256(open(p, "rb").read()).hexdigest() for p in fixtures]
    before = digest()
    mod = importlib.import_module(f"dist_renderer_tpu_torch.diag.{name}")
    res = STAGE_RUNS[name](mod, str(tmp_path))
    torch.cuda.synchronize()
    json.dumps(res)
    assert digest() == before
    if name == "retrain_proxy":
        assert res["written"] == [os.path.join(str(tmp_path), "proxy_v2.npz")]
        assert os.path.exists(res["written"][0]) and not res["promoted"]


@pytest.mark.gpu
@pytest.mark.parametrize("verify_hits", ["march", "polish"])
def test_cuda_scan_graph_replays_the_eager_loop(verify_hits, monkeypatch):
    """batched_render --scan's CUDA graph (4 latents x 2 views at 64^2 with
    the bench proxy, 2 chunks of 4 frames): its replay gives the eager
    host loop's hit count and fp64 depth sum bit for bit, a second replay
    repeats the first, main() reports them, and a capture of the loop
    with a host read in it (host_free() made a no-op) raises instead of
    running eagerly."""
    import contextlib

    from dist_renderer_tpu_torch.tasks import batched_render as br

    _device()
    argv = ["--fast", "--pallas", "--stream", "--scan", "--img", "64", "--latents", "4",
            "--views", "2", "--chunk", "4", "--proxy", os.path.join(ROOT, ".bench_proxy.npz"),
            "--verify-hits", verify_hits]
    args = br.parse_args(argv)
    cs = br.chunk_stream(args, br.scene(args))
    assert len(cs.chunks) == 2
    eager = tuple(t.item() for t in br.stream_sums(cs))
    graph, out, info = br.capture_scan(cs)
    assert info["nodes"] > 0
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(tuple(t.item() for t in out))
    assert replays[0] == eager == replays[1] and eager[1] > 0
    res = br.main(argv)
    assert (res["depth_sum"], res["hits"]) == eager
    monkeypatch.setattr(br, "host_free", contextlib.nullcontext)
    with pytest.raises(RuntimeError):
        br.capture_scan(cs)
    # the card still works after the refused capture
    assert tuple(t.item() for t in br.stream_sums(cs)) == eager
