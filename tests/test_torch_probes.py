"""The probe kernels' plain versions (ops/kernels/probes.py) against the
TPU probe scripts' Pallas bodies, run in interpret mode on the CPU.

The scripts (scripts/diag_launch_cost.py, diag_launch2.py,
diag_launch3.py, diag_launch4.py) run TPU work when imported, so each
Pallas body is copied here verbatim, with the script's file:line, and
launched through ``pl.pallas_call`` under
``pltpu.force_tpu_interpret_mode()`` with the script's specs. N, the
scripts' 512 x 512 lanes, is cut to 4 x 512. Inputs are the scripts' own
(d24, pos, surv, xs, tri, xr) and numpy-seeded ones.

Exact kernels (copies, the no-op and aliased kernels, the roll, the
log-shift prefix sum, compaction, 0/1 prefix sums) are held bit for
bit. The products sum in another order than XLA's interpret-mode dot:
seeded fp32 sums of 512 terms bounded by 1 within DOT_TOL, and the bf16
triangular product and small product within DOT_TOL too (every product
of bf16 values is exact in fp32, so only the order of the fp32 sum
differs: 512 terms of |t| <= 1 move a sum by at most ~512 * 2^-24 * 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dist_renderer_tpu_torch.ops.kernels import probes as pk

N = 4 * 512
DOT_TOL = 3e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _jnp_bf16_to_torch(w):
    return _t(w.astype(jnp.float32)).to(torch.bfloat16)


def _same(got: torch.Tensor, want) -> None:
    want = _t(want) if not isinstance(want, torch.Tensor) else want
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


def _call(kernel, out_shape, in_specs, out_specs, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return pl.pallas_call(kernel, grid=(1,), in_specs=in_specs, out_specs=out_specs,
                              out_shape=out_shape, **kw)(*args)


ANY = pl.BlockSpec(memory_space=pl.ANY)
SMEM = pl.BlockSpec(memory_space=pltpu.SMEM)
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
F32 = jnp.float32


# ---- scripts/diag_launch_cost.py ------------------------------------------

# scripts/diag_launch_cost.py:51
def k_empty(in_ref, out_ref):
    pass


# scripts/diag_launch_cost.py:74
def k_scratch_cost(a_ref, b_ref, out_ref, rv, ov, sem):
    pass


# scripts/diag_launch_cost.py:143
def k_noW(live_ref, nl_ref, rays_hbm, bias_hbm, defaults, out_hbm, rv, ov, bv, ts, s1, s2, s3):
    def cond(k): return k < nl_ref[0]
    def body(k): return k + 1
    jax.lax.while_loop(cond, body, 0)


N_CHUNKS = N // 512


# scripts/diag_launch_cost.py:168 (n_chunks = N // 512)
def k_fori(live_ref, nl_ref, rays_hbm, bias_hbm, defaults, out_hbm, rv, ov, bv, ts, s1, s2, s3):
    def body(k, c):
        @pl.when(k < nl_ref[0])
        def _():
            ts[0] = live_ref[k]
        return c
    jax.lax.fori_loop(0, N_CHUNKS, body, 0)


# scripts/diag_launch_cost.py:196
def k_w2(nl_ref, out_ref):
    def cond(k): return k < nl_ref[0]
    def body(k): return k + 1
    jax.lax.while_loop(cond, body, 0)
    out_ref[:, :] = jnp.zeros((8, 128), jnp.float32)


TOTAL = 40  # the bias columns' rows (the bench decoder's shared.total, cut)


def _real_scratch():
    return [pltpu.VMEM((16, 512), F32), pltpu.VMEM((8, 512), F32),
            pltpu.VMEM((TOTAL, 128), F32), pltpu.SMEM((1,), jnp.int32),
            pltpu.SemaphoreType.DMA(()), pltpu.SemaphoreType.DMA(()),
            pltpu.SemaphoreType.DMA(())]


def _seeded(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def test_p1_empty_aliased_returns_its_input():
    x = _seeded((8, N), 0)
    got = _call(k_empty, jax.ShapeDtypeStruct((8, N), F32), [ANY], ANY, jnp.asarray(x),
                input_output_aliases={0: 0})
    _same(pk.empty_plain(_t(x), aliased=True), got)
    # unaliased, the TPU kernel never writes its output: only its shape
    # and type are specified
    got = _call(k_empty, jax.ShapeDtypeStruct((8, N), F32), [ANY], ANY, jnp.asarray(x))
    plain = pk.empty_plain(_t(x))
    assert plain.shape == got.shape and plain.dtype == torch.float32


def test_p2_scratch_returns_the_aliased_operand():
    a, b = _seeded((16, N), 1), _seeded((8, N), 2)
    got = _call(k_scratch_cost, jax.ShapeDtypeStruct((8, N), F32), [ANY, ANY], ANY,
                jnp.asarray(a), jnp.asarray(b), input_output_aliases={1: 0},
                scratch_shapes=[pltpu.VMEM((16, 512), F32), pltpu.VMEM((8, 512), F32),
                                pltpu.SemaphoreType.DMA(())])
    _same(pk.scratch_plain(_t(a), _t(b)), got)


@pytest.mark.parametrize("n_live", [0, 3])
@pytest.mark.parametrize("which", ["noW", "fori"])
def test_p3_p4_real_kernel_scratch_set_return_defaults(which, n_live):
    rng = np.random.default_rng(3)
    live = rng.integers(0, N_CHUNKS, (N_CHUNKS,)).astype(np.int32)
    nl = np.array([n_live], np.int32)
    rays, dflt = _seeded((16, N), 4), _seeded((8, N), 5)
    bias = _seeded((TOTAL, 128), 6)
    kern = k_noW if which == "noW" else k_fori
    got = _call(kern, jax.ShapeDtypeStruct((8, N), F32), [SMEM, SMEM, ANY, ANY, ANY], ANY,
                jnp.asarray(live), jnp.asarray(nl), jnp.asarray(rays), jnp.asarray(bias),
                jnp.asarray(dflt), input_output_aliases={4: 0},
                scratch_shapes=_real_scratch())
    tl, tn, tr, td, tb = map(_t, (live, nl, rays, dflt, bias))
    if which == "noW":
        plain = pk.scalar_while_plain(tn, rays=tr, defaults=td, live=tl, bias=tb,
                                      smem_bytes=1 << 16, n_bars=3)
    else:
        plain = pk.index_loop_plain(tl, tn, tr, td, tb, mode=0)
    _same(plain, got)


# ---- scripts/diag_launch2.py ----------------------------------------------

# scripts/diag_launch2.py:65
def scalar_while_kernel(nl_ref, out_ref):
    def cond(k):
        return k < nl_ref[0]

    def body(k):
        return k + 1

    jax.lax.while_loop(cond, body, 0)
    out_ref[:, :] = jnp.zeros((8, 128), jnp.float32)


@pytest.mark.parametrize("trips", [0, 1, 64])
@pytest.mark.parametrize("kernel", ["k_w2", "scalar_while_kernel"])
def test_p5_p6_scalar_while_gives_zeros(kernel, trips):
    nl = np.array([trips], np.int32)
    got = _call(k_w2 if kernel == "k_w2" else scalar_while_kernel,
                jax.ShapeDtypeStruct((8, 128), F32), [SMEM], VMEM, jnp.asarray(nl))
    _same(pk.scalar_while_plain(_t(nl), zeros=True), got)


# scripts/diag_launch2.py:119
def vec_while_kernel(nl_ref, out_ref):
    def cond(kc):
        k, c = kc
        return (k < nl_ref[0]) & (jnp.max(c) > -1.0)

    def body(kc):
        k, c = kc
        return k + 1, c + 1.0

    _, c = jax.lax.while_loop(cond, body, (0, jnp.zeros((8, 512), jnp.float32)))
    out_ref[:, :] = c


@pytest.mark.parametrize("trips", [0, 8])
def test_p7_vec_while_counts_its_trips(trips):
    nl = np.array([trips], np.int32)
    got = _call(vec_while_kernel, jax.ShapeDtypeStruct((8, 512), F32), [SMEM], VMEM,
                jnp.asarray(nl))
    _same(pk.vec_while_plain(_t(nl)), got)


def test_p7_vec_while_runs_no_trips_below_one():
    """A count below 1 runs no trip: the carry stays at zeros in the TPU
    kernel and in the plain version."""
    nl = np.array([-3], np.int32)
    got = _call(vec_while_kernel, jax.ShapeDtypeStruct((8, 512), F32), [SMEM], VMEM,
                jnp.asarray(nl))
    _same(pk.vec_while_plain(_t(nl)), got)
    assert not np.asarray(got).any()


# scripts/diag_launch2.py:142
def f32dot_kernel(x_ref, m_ref, out_ref):
    out_ref[:, :] = jax.lax.dot_general(
        x_ref[:, :], m_ref[:, :], (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _one_hot_compaction():
    """diag_launch2.py's x and its "even lanes to the front" one-hot m."""
    x = jnp.arange(24 * 512, dtype=jnp.float32).reshape(24, 512)
    pos = jnp.where(jnp.arange(512) % 2 == 0, jnp.arange(512) // 2, 10**6)
    m = (jnp.arange(1024)[:, None] == pos[None, :]).astype(jnp.float32)
    return x, m


@pytest.mark.parametrize("inputs", ["script", "seeded"])
def test_p8_f32dot(inputs):
    if inputs == "script":
        x, m = _one_hot_compaction()
    else:
        x, m = jnp.asarray(_seeded((24, 512), 7)), jnp.asarray(_seeded((1024, 512), 8))
    got = _call(f32dot_kernel, jax.ShapeDtypeStruct((24, 1024), F32), [VMEM, VMEM], VMEM,
                x, m)
    plain = pk.f32dot_plain(_t(x), _t(m))
    if inputs == "script":  # one nonzero term a sum: exact in any order
        _same(plain, got)
        _same(plain[:, :256], _t(x)[:, ::2])
    else:
        assert (plain - _t(got)).abs().max().item() <= DOT_TOL


# scripts/diag_launch2.py:171. The script rolls by -512; JAX's interpret
# mode here refuses a negative shift ("shift must be non-negative"), and
# on 1024 lanes 512 is the same roll, so the copy rolls by 512.
def roll_kernel(x_ref, out_ref):
    out_ref[:, :] = pltpu.roll(x_ref[:, :], 512, 1)


def test_p9_roll_by_half_the_lanes():
    xr = jnp.arange(24 * 1024, dtype=jnp.float32).reshape(24, 1024)
    got = _call(roll_kernel, jax.ShapeDtypeStruct((24, 1024), F32), [VMEM], VMEM, xr)
    _same(pk.roll_lanes_plain(_t(xr), -512), got)
    _same(pk.roll_lanes_plain(_t(xr), 512), got)
    # the script's own check
    _same(_t(got)[:, :512], _t(xr)[:, 512:])


# scripts/diag_launch2.py:189
def cumsum_kernel(x_ref, out_ref):
    c = x_ref[:, :]
    for sh in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        r = pltpu.roll(c, sh, 1)
        mask = jax.lax.broadcasted_iota(jnp.int32, (1, 512), 1) >= sh
        c = c + jnp.where(mask, r, 0.0)
    out_ref[:, :] = c


@pytest.mark.parametrize("inputs", ["script", "seeded"])
def test_p10_log_shift_prefix_sum_bit_for_bit(inputs):
    if inputs == "script":
        xs = (jnp.arange(512, dtype=jnp.float32) % 3 == 0).astype(jnp.float32)[None]
    else:
        xs = jnp.asarray(_seeded((1, 512), 9, -100.0, 100.0))
    got = _call(cumsum_kernel, jax.ShapeDtypeStruct((1, 512), F32), [VMEM], VMEM, xs)
    _same(pk.scan_plain(_t(xs)), got)



def _warp_scan_model(x: torch.Tensor) -> torch.Tensor:
    """csrc/probe_blocks.cu's scan_kernel in torch: a warp per row, lane l
    holding c[l + 32 i], i < K (K the least power of two with 32 K >= L,
    zeros past L); c[i] below is register i of the 32 lanes. A step with
    sh < 32 takes lane l - sh (mod 32)'s register i, by __shfl_sync, or
    its register i - 1 where l < sh (zero for i = 0); one with sh >= 32
    the lane's own register i - sh / 32."""
    rows, lanes = x.shape
    k = 1
    while 32 * k < lanes:
        k *= 2
    pad = torch.zeros((rows, 32 * k))
    pad[:, :lanes] = x.to(torch.float32)
    c = [pad[:, 32 * i:32 * i + 32] for i in range(k)]
    lane = torch.arange(32)
    zero = torch.zeros(())
    for st in range(10):
        sh = 1 << st
        if sh >= 32 * k or sh >= lanes:
            break
        if sh < 32:
            rot = [ci[:, (lane - sh) % 32] for ci in c]  # __shfl_sync(c[i], (l - sh) & 31)
            c = [c[i] + torch.where(lane >= sh, rot[i], rot[i - 1] if i else zero)
                 for i in range(k)]
        else:
            c = [c[i] + (c[i - sh // 32] if i >= sh // 32 else torch.zeros_like(c[i]))
                 for i in range(k)]
    return torch.cat(c, 1)[:, :lanes]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("lanes", [1, 2, 31, 32, 33, 511, 512, 1000, 1024])
def test_scan_kernel_lane_layout_gives_scan_plain_bits(lanes):
    """The kernel's lanes, registers and shuffles make the TPU kernel's
    adds in its order: scan_plain's bits on seeded fp32 rows, a -0.0
    leading one (the first step's +0.0 turns it into 0.0)."""
    x = torch.from_numpy(_seeded((3, lanes), lanes, -100.0, 100.0))
    x[0, 0] = -0.0
    assert torch.equal(_bits(_warp_scan_model(x)), _bits(pk.scan_plain(x)))


@pytest.mark.parametrize("inputs", ["script", "seeded"])
def test_scan_kernel_lane_layout_equals_the_tpu_kernel(inputs):
    """The kernel's lane layout against diag_launch2.py's cumsum_kernel in
    interpret mode at [1, 512], bit for bit."""
    if inputs == "script":
        xs = (jnp.arange(512, dtype=jnp.float32) % 3 == 0).astype(jnp.float32)[None]
    else:
        xs = jnp.asarray(_seeded((1, 512), 10, -100.0, 100.0))
    got = _call(cumsum_kernel, jax.ShapeDtypeStruct((1, 512), F32), [VMEM], VMEM, xs)
    assert torch.equal(_bits(_warp_scan_model(_t(xs))), _bits(_t(got)))

# ---- scripts/diag_launch3.py ----------------------------------------------

def scalar_while(nl_ref):  # scripts/diag_launch3.py:60
    def cond(k):
        return k < nl_ref[0]

    def body(k):
        return k + 1

    jax.lax.while_loop(cond, body, 0)


# scripts/diag_launch3.py:71
def k_any(nl_ref, rays, out_ref):
    scalar_while(nl_ref)


# scripts/diag_launch3.py:85
def k_alias(nl_ref, rays, dflt, out_ref):
    scalar_while(nl_ref)


# scripts/diag_launch3.py:101
def k_scratch3(nl_ref, rays, dflt, out_ref, rv, ov, s1, s2):
    scalar_while(nl_ref)


# scripts/diag_launch3.py:121
def k_smemarr(li_ref, nl_ref, rays, dflt, out_ref):
    def cond(k):
        return k < nl_ref[0]

    def body(k):
        return k + li_ref[k] * 0 + 1

    jax.lax.while_loop(cond, body, 0)


@pytest.mark.parametrize("pid", ["P11", "P12", "P13", "P14"])
def test_p11_to_p14_operand_ladder(pid):
    nl = np.array([5], np.int32)
    rays, dflt = _seeded((16, N), 10), _seeded((8, N), 11)
    li = np.random.default_rng(12).integers(0, 9, (512,)).astype(np.int32)
    out = jax.ShapeDtypeStruct((8, N), F32)
    tn, tr, td, tl = map(_t, (nl, rays, dflt, li))
    if pid == "P11":
        got = _call(k_any, out, [SMEM, ANY], ANY, jnp.asarray(nl), jnp.asarray(rays))
        # never written on the TPU: only its shape and type are specified
        plain = pk.scalar_while_plain(tn, rays=tr)
        assert plain.shape == got.shape and plain.dtype == torch.float32
        return
    if pid == "P12":
        got = _call(k_alias, out, [SMEM, ANY, ANY], ANY, jnp.asarray(nl), jnp.asarray(rays),
                    jnp.asarray(dflt), input_output_aliases={2: 0})
        plain = pk.scalar_while_plain(tn, rays=tr, defaults=td)
    elif pid == "P13":
        got = _call(k_scratch3, out, [SMEM, ANY, ANY], ANY, jnp.asarray(nl),
                    jnp.asarray(rays), jnp.asarray(dflt), input_output_aliases={2: 0},
                    scratch_shapes=[pltpu.VMEM((16, 512), F32), pltpu.VMEM((8, 512), F32),
                                    pltpu.SemaphoreType.DMA(()), pltpu.SemaphoreType.DMA(())])
        plain = pk.scalar_while_plain(tn, rays=tr, defaults=td, smem_bytes=pk.SCRATCH_BYTES,
                                      n_bars=2)
    else:
        got = _call(k_smemarr, out, [SMEM, SMEM, ANY, ANY], ANY, jnp.asarray(li),
                    jnp.asarray(nl), jnp.asarray(rays), jnp.asarray(dflt),
                    input_output_aliases={3: 0})
        plain = pk.index_loop_plain(tl, tn, tr, td, mode=1)
    _same(plain, got)


# scripts/diag_launch3.py:145
def k_dma(nl_ref, rays, dflt, out_ref, rv, ov, s1, s2):
    def cond(k):
        return k < nl_ref[0]

    def body(k):
        cin = pltpu.make_async_copy(rays.at[:, pl.ds(0, 512)], rv, s1)
        cin.start()
        cin.wait()
        ov[:, :] = rv[:8, :] + 1.0
        cout = pltpu.make_async_copy(ov, out_ref.at[:, pl.ds(0, 512)], s2)
        cout.start()
        cout.wait()
        return k + 1

    jax.lax.while_loop(cond, body, 0)


@pytest.mark.parametrize("trips", [0, 1, 2])
def test_p15_dma_loop(trips):
    nl = np.array([trips], np.int32)
    rays, dflt = _seeded((16, N), 13), _seeded((8, N), 14)
    got = _call(k_dma, jax.ShapeDtypeStruct((8, N), F32), [SMEM, ANY, ANY], ANY,
                jnp.asarray(nl), jnp.asarray(rays), jnp.asarray(dflt),
                input_output_aliases={2: 0},
                scratch_shapes=[pltpu.VMEM((16, 512), F32), pltpu.VMEM((8, 512), F32),
                                pltpu.SemaphoreType.DMA(()), pltpu.SemaphoreType.DMA(())])
    _same(pk.dma_loop_plain(_t(nl), _t(rays), _t(dflt)), got)


# scripts/diag_launch3.py:182
def k_tri(x_ref, tri_ref, out_ref):
    pos = jax.lax.dot_general(
        x_ref[:, :], tri_ref[:, :], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    out_ref[:, :] = pos


@pytest.mark.parametrize("inputs", ["script", "random01", "seeded"])
def test_p16_triangular_prefix_sum(inputs):
    tri = (jnp.arange(512)[:, None] <= jnp.arange(512)[None, :]).astype(jnp.bfloat16)
    if inputs == "script":
        xs = (jnp.arange(512) % 3 == 0).astype(jnp.bfloat16)[None]
    elif inputs == "random01":
        xs = jnp.asarray(np.random.default_rng(15).integers(0, 2, (1, 512))
                         .astype(np.float32)).astype(jnp.bfloat16)
    else:
        xs = jnp.asarray(_seeded((1, 512), 16)).astype(jnp.bfloat16)
    got = _call(k_tri, jax.ShapeDtypeStruct((1, 512), F32), [VMEM, VMEM], VMEM, xs, tri)
    tx, ttri = _jnp_bf16_to_torch(xs), _jnp_bf16_to_torch(tri)
    plain = pk.tri_cumsum_plain(tx, ttri)
    scan = pk.scan_plain(tx)  # the CUDA kernel's adds (csrc/probe_blocks.cu)
    if inputs == "seeded":
        assert (plain - _t(got)).abs().max().item() <= DOT_TOL
        assert (scan - _t(got)).abs().max().item() <= DOT_TOL
    else:  # 0/1 sums are exact in any order
        _same(plain, got)
        _same(scan, got)


# scripts/diag_launch3.py:204
def k_compact(d_ref, pos_ref, surv_ref, out_ref):
    d = d_ref[:, :]                       # [24, 512] f32
    pos = pos_ref[:, :]                   # [1, 512] f32 (target slots)
    surv = surv_ref[:, :]                 # [1, 512] f32 0/1
    jj = jax.lax.broadcasted_iota(jnp.float32, (1024, 512), 0)
    m = jnp.where((pos == jj) & (surv > 0.5), 1.0, 0.0).astype(jnp.bfloat16)
    hi = d.astype(jnp.bfloat16)
    mid = (d - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    lo = (d - hi.astype(jnp.float32) - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    acc = None
    for part in (hi, mid, lo):
        r = jax.lax.dot_general(
            part, m, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        acc = r if acc is None else acc + r
    out_ref[:, :] = acc


# scripts/diag_launch4.py:123
def k_compact_int(d_ref, pos_ref, surv_ref, out_ref):
    d = d_ref[:, :]
    pos = pos_ref[:, :].astype(jnp.int32)
    surv = surv_ref[:, :]
    jj = jax.lax.broadcasted_iota(jnp.int32, (1024, 512), 0)
    m = jnp.where((pos == jj) & (surv > 0.5), 1.0, 0.0).astype(jnp.bfloat16)
    hi = d.astype(jnp.bfloat16)
    r1 = (d - hi.astype(jnp.float32))
    mid = r1.astype(jnp.bfloat16)
    lo = (r1 - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    acc = None
    for part in (hi, mid, lo):
        r = jax.lax.dot_general(part, m, (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.float32)
        acc = r if acc is None else acc + r
    out_ref[:, :] = acc


def _compaction_inputs(kind):
    if kind == "script":  # the scripts' d24, pos, surv
        d24 = jnp.arange(24 * 512, dtype=jnp.float32).reshape(24, 512) * 0.001 + 1.0
        surv = (jnp.arange(512) % 2 == 0).astype(jnp.float32)[None]
        pos = (jnp.cumsum(surv[0]) - 1.0)[None] * surv + (1 - surv) * 5000.0
        return d24, pos, surv
    # seeded: random survivors at distinct slots of a random permutation,
    # some slots out of range (negative, >= 1024) and some non-survivors
    # sitting on free slots, all of which must be dropped
    rng = np.random.default_rng(17)
    d = rng.uniform(-4, 4, (24, 512)).astype(np.float32)
    surv = (rng.random((1, 512)) < 0.6).astype(np.float32)
    pos = rng.permutation(np.arange(-40, 1100))[:512].astype(np.float32)[None]
    return jnp.asarray(d), jnp.asarray(pos), jnp.asarray(surv)


@pytest.mark.parametrize("inputs", ["script", "seeded"])
@pytest.mark.parametrize("int_pos", [False, True])
def test_p17_p22_compaction_bit_for_bit(int_pos, inputs):
    d, pos, surv = _compaction_inputs(inputs)
    got = _call(k_compact_int if int_pos else k_compact,
                jax.ShapeDtypeStruct((24, 1024), F32), [VMEM] * 3, VMEM, d, pos, surv)
    plain = pk.compact_plain(_t(d), _t(pos), _t(surv), int_pos=int_pos)
    _same(plain, got)
    if inputs == "script":
        _same(plain[:, :256], _t(d)[:, ::2])


def test_compaction_positions_int_truncates_fp32_needs_integral():
    d = torch.arange(8, dtype=torch.float32).reshape(2, 4) + 1
    pos = torch.tensor([[2.7, -0.5, 3.0, 1030.0]])
    surv = torch.ones((1, 4))
    f = pk.compact_plain(d, pos, surv, slots=8)
    i = pk.compact_plain(d, pos, surv, slots=8, int_pos=True)
    assert torch.equal(f[:, 3], d[:, 2]) and f.count_nonzero() == 2
    assert torch.equal(i[:, 2], d[:, 0]) and torch.equal(i[:, 0], d[:, 1])
    assert torch.equal(i[:, 3], d[:, 2]) and i.count_nonzero() == 6



def _kernel_slot(p, s, slots, int_pos):
    """csrc/probe_blocks.cu's compact_slot on tensors: the slot each lane
    names, -1 where it names none."""
    keep = s > 0.5
    if int_pos:
        keep = keep & (p > -(2.0 ** 31)) & (p < 2.0 ** 31)
    else:
        keep = keep & (p == torch.floor(p)) & (p >= 0) & (p < float(slots))
    slot = torch.where(keep, p, 0.0).to(torch.int64)  # truncation toward zero
    return torch.where(keep & (slot >= 0) & (slot < slots), slot, -1)


def _compact_kernel_model(d, pos, surv, slots, int_pos, rb=1, t=256, lpt=2):
    """csrc/probe_blocks.cu's compact_kernel (rb=1, t=256, lpt=2) and
    diag/block_designs.cu's tiled_compact<RB, T, LPT> in torch: block b
    owns rows r0 = b / chunks * RB .. + RB and slots s0 = (b % chunks) 4 T
    .. + 4 T; its tile starts at zero, takes each round's LPT T lanes (at
    least one round) and is copied out. The output starts as NaN, so a
    slot no block writes shows."""
    rows, lanes = d.shape
    p, s = pos.reshape(-1), surv.reshape(-1)
    chunks = -(-slots // (4 * t))
    out = torch.full((rows, slots), float("nan"))
    for b in range(chunks * -(-rows // rb)):
        r0, s0 = b // chunks * rb, b % chunks * 4 * t
        rn, sn = min(rb, rows - r0), min(4 * t, slots - s0)
        tile = torch.zeros((rb, 4 * t))
        for j0 in range(0, max(lanes, 1), lpt * t):
            for e in range(lpt):
                j = j0 + torch.arange(t) + e * t
                j = j[j < lanes]
                slot = _kernel_slot(p[j], s[j], slots, int_pos) - s0
                ok = (slot >= 0) & (slot < sn)
                tile[:rn, slot[ok]] = d[r0:r0 + rn, j[ok]]
        out[r0:r0 + rn, s0:s0 + sn] = tile[:rn, :sn]
    return out


def _compaction_case(rows, lanes, slots, seed):
    """Seeded d, and pos, surv with distinct integral positions from below
    0 to past the slots, and lanes of every dropped kind (non-survivors at
    0, 0.5 and NaN; NaN, infinite and out-of-int32 positions; p + 0.25)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-4, 4, (rows, lanes)).astype(np.float32)
    surv = (rng.random(lanes) < 0.7).astype(np.float32)
    pos = rng.permutation(np.arange(-lanes, slots + lanes))[:lanes].astype(np.float32)
    kinds = [("surv", 0.5), ("surv", np.nan), ("pos", np.nan), ("pos", np.inf),
             ("pos", -np.inf), ("pos", 2.0 ** 31), ("pos", 3.0e9), ("frac", 0.25)]
    for (kind, v), j in zip(kinds, rng.permutation(lanes)):
        if kind == "surv":
            surv[j] = v
        elif kind == "pos":
            surv[j], pos[j] = 1.0, v
        elif pos[j] >= 0:
            surv[j], pos[j] = 1.0, pos[j] + v
    return torch.from_numpy(d), torch.from_numpy(pos[None]), torch.from_numpy(surv[None])


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 33, 256), (24, 512, 1024), (24, 1000, 1030),
                                   (5, 700, 4096), (64, 512, 255)])
@pytest.mark.parametrize("int_pos", [False, True])
def test_compact_kernel_tiling_writes_every_slot_once(shape, int_pos):
    """compact's tiling (a row and 1,024 slots a block, rounds of 512
    lanes: the kernel's; the designs' 2 rows a block and 256 slots of 64
    threads, 8 lanes each a round) covers every output slot, lanes past a
    round and ragged slot chunks included, and gives compact_plain's
    bits."""
    rows, lanes, slots = shape
    d, pos, surv = _compaction_case(rows, lanes, slots, sum(shape))
    want = pk.compact_plain(d, pos, surv, slots, int_pos)
    for rb, t, lpt in ((1, 256, 2), (2, 256, 2), (1, 64, 8)):
        got = _compact_kernel_model(d, pos, surv, slots, int_pos, rb, t, lpt)
        assert torch.equal(_bits(got), _bits(want)), (rb, t, lpt)

# ---- scripts/diag_launch4.py ----------------------------------------------

# scripts/diag_launch4.py:66
def k_copy(x_ref, o_ref):
    o_ref[:, :] = x_ref[:, :]


# scripts/diag_launch4.py:70
def k_add(x_ref, o_ref):
    o_ref[:, :] = x_ref[:, :] + 1.0


# scripts/diag_launch4.py:74
def k_mm(x_ref, w_ref, o_ref):
    o_ref[:, :] = jax.lax.dot_general(
        x_ref[:, :].astype(jnp.bfloat16), w_ref[:, :],
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)


# scripts/diag_launch4.py:80
def k_mm_in_while(x_ref, w_ref, o_ref):
    def cond(kc):
        return kc[0] < 1

    def body(kc):
        k, acc = kc
        return k + 1, jax.lax.dot_general(
            x_ref[:, :].astype(jnp.bfloat16), w_ref[:, :],
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)

    _, acc = jax.lax.while_loop(cond, body, (0, jnp.zeros((8, 512), jnp.float32)))
    o_ref[:, :] = acc


def _vcall(kernel, outshape, *args):  # scripts/diag_launch4.py:57 (call)
    return _call(kernel, outshape, [VMEM for _ in args], VMEM, *args)


O8 = jax.ShapeDtypeStruct((8, 512), F32)


@pytest.mark.parametrize("which", ["copy", "add"])
def test_p18_p19_copy_and_add(which):
    x = _seeded((8, 512), 18)
    got = _vcall(k_copy if which == "copy" else k_add, O8, jnp.asarray(x))
    plain = pk.copy_plain(_t(x)) if which == "copy" else pk.add_one_plain(_t(x))
    _same(plain, got)


@pytest.mark.parametrize("inputs", ["script", "seeded"])
@pytest.mark.parametrize("looped", [False, True])
def test_p20_p21_small_product(looped, inputs):
    if inputs == "script":  # the script's ones: exact in any order
        x, w = jnp.ones((8, 512), F32), jnp.ones((512, 512), jnp.bfloat16)
    else:
        x = jnp.asarray(_seeded((8, 512), 19))
        w = jnp.asarray(_seeded((512, 512), 20)).astype(jnp.bfloat16)
    got = _vcall(k_mm_in_while if looped else k_mm, O8, x, w)
    plain = pk.small_mm_plain(_t(x), _jnp_bf16_to_torch(w), looped)
    if inputs == "script":
        _same(plain, got)
    else:
        assert (plain - _t(got)).abs().max().item() <= DOT_TOL


def test_p21_without_a_trip_is_zero():
    x = torch.from_numpy(_seeded((8, 512), 21))
    w = torch.from_numpy(_seeded((512, 512), 22)).to(torch.bfloat16)
    assert torch.equal(pk.small_mm_plain(x, w, True, 0), torch.zeros((8, 512)))


def test_cpu_tensors_take_the_plain_versions_uncounted():
    """On the CPU every wrapper runs its plain version and counts no
    launch (a CUDA tensor launches the kernel or raises)."""
    before = [k.launches for k in pk.KERNELS]
    x = torch.from_numpy(_seeded((8, 512), 23))
    n1 = torch.ones(1, dtype=torch.int32)
    w = torch.ones((512, 512), dtype=torch.bfloat16)
    rays, dflt = torch.zeros((16, N)), torch.zeros((8, N))
    assert torch.equal(pk.copy(x), x) and torch.equal(pk.add_one(x), x + 1)
    assert torch.equal(pk.small_mm(x, w), pk.small_mm_plain(x, w))
    assert pk.empty(x, aliased=True) is x and pk.scratch(rays, dflt) is dflt
    assert torch.equal(pk.scalar_while(n1, zeros=True), torch.zeros((8, 128)))
    assert pk.index_loop(n1, n1, rays, dflt) is dflt
    assert torch.equal(pk.vec_while(n1), torch.ones((8, 512)))
    out = pk.dma_loop(n1, rays, dflt)
    assert out is dflt and torch.equal(out[:, :512], torch.ones((8, 512)))
    assert torch.equal(pk.roll_lanes(x, 5), torch.roll(x, 5, 1))
    assert torch.equal(pk.scan(x[:1]), pk.scan_plain(x[:1]))
    assert torch.equal(pk.f32dot(x, x), pk.f32dot_plain(x, x))
    pos = torch.arange(512, dtype=torch.float32)[None]
    assert torch.equal(pk.compact(x, pos, torch.ones_like(pos))[:, :512], x)
    assert [k.launches for k in pk.KERNELS] == before


def _noop_cases():
    from dist_renderer_tpu_torch.diag import diag_launch3, diag_launch_cost

    return {**diag_launch_cost.probe_calls(1024), **diag_launch3.ladder()}


@pytest.mark.parametrize("pid", ["P1", "P1 aliased", "P2", "P3", "P4", "P5", "P11", "P12",
                                 "P13", "P14"])
@pytest.mark.parametrize("n_live", [0, 512])
def test_noop_probe_checks_pass_the_plain_versions(pid, n_live):
    """The card checks of the kernels that do no work (diag.check_probe),
    run here on the plain versions: seeded operands, a clone taken
    before, nothing changed."""
    from dist_renderer_tpu_torch.diag import Operands, check_probe

    run, plain, written = _noop_cases()[pid]
    o = Operands(torch.device("cpu"), total=3, seed=0, n_live=n_live)
    assert check_probe(pid, run, plain, o, written) == 0.0


@pytest.mark.parametrize("fault", ["writes its aliased output", "writes an input",
                                   "gives another shape"])
def test_noop_probe_check_fails_a_kernel_that_writes(fault):
    """check_probe must fail a kernel that writes into its aliased output
    or an input, or whose unwritten output has another shape: the card
    check compares the output with a clone taken before the launch, not
    with itself."""
    from dist_renderer_tpu_torch.diag import Operands, check_probe

    def kernel(o):
        if fault == "writes its aliased output":
            o.x8[3, 7] += 1.0
        elif fault == "writes an input":
            o.x16[0, 0] = 0.5
        else:
            return torch.empty((8, 7))
        return o.x8

    o = Operands(torch.device("cpu"), seed=2)
    plain = lambda o: pk.empty_plain(o.x8, fault != "gives another shape")
    with pytest.raises(AssertionError):
        check_probe("faulty", kernel, plain, o, written=fault != "gives another shape")


def test_f32dot_designs_needs_a_card(monkeypatch):
    """The f32dot design comparison measures the card: without one it
    raises SystemExit before it builds anything."""
    from dist_renderer_tpu_torch.diag import f32dot_designs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        f32dot_designs.main([])


def test_copy_designs_needs_a_card(monkeypatch):
    """The copy / add_one design comparison measures the card: without
    one it raises SystemExit before it builds anything."""
    from dist_renderer_tpu_torch.diag import copy_designs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        copy_designs.main([])


def test_copy_designs_reads_each_kernels_memory_ops_in_order():
    """copy_designs' SASS reading: each named kernel's global loads and
    stores in program order, other kernels' left out."""
    from dist_renderer_tpu_torch.diag.copy_designs import memory_ops

    sass = """
        Function : _ZN12_GLOBAL__N_110first_copyEPKfPfi
        /*0070*/  LDG.E R5, desc[UR4][R2.64] ;
        /*0090*/  STG.E desc[UR4][R4.64], R5 ;
        /*00a0*/  LDG.E R7, desc[UR4][R2.64+0x400] ;
        /*00b0*/  STG.E desc[UR4][R4.64+0x400], R7 ;
        Function : _Z18first_add_restrictPKfPfi
        /*0070*/  LDG.E.CONSTANT R5, desc[UR4][R2.64] ;
        Function : _ZN3drt2pr13stream_kernelILb0ELb1EEEvPKfPfx
        /*0070*/  LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0080*/  STG.E.128 desc[UR4][R8.64], R4 ;
    """
    assert memory_ops(sass) == {
        "first version": "LDG.E STG.E LDG.E STG.E",
        "kernel (vector body)": "LDG.E.128.CONSTANT STG.E.128",
    }


def test_chain_designs_needs_a_card(monkeypatch):
    """The MLP chain design comparison measures the card: without one it
    raises SystemExit before it builds or computes anything."""
    from dist_renderer_tpu_torch.diag import chain_designs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        chain_designs.main([])


def test_chain_designs_reads_registers_and_spills():
    """chain_designs' ptxas reading: each matching entry function's
    registers and spill bytes, other functions left out."""
    from dist_renderer_tpu_torch.diag.chain_designs import ptxas_report

    log = """
ptxas info    : Compiling entry function '_ZN3drt2mc12chain_kernelINS0_3CfgILb1EEE' for 'sm_90a'
ptxas info    : Function properties for _ZN3drt2mc12chain_kernelINS0_3CfgILb1EEE
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN3drt2pr5emptyEv' for 'sm_90a'
ptxas info    : Function properties for _ZN3drt2pr5emptyEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 4 registers
"""
    assert ptxas_report(log) == {"_ZN3drt2mc12chain_kernelINS0_3CfgILb1EEE": {
        "spill_stores": 12, "spill_loads": 16, "registers": 168}}


def test_chain_designs_counts_the_mma_opcodes():
    """chain_designs' SASS reading: each chain kernel's warpgroup and warp
    MMA opcodes (HGMMA, IGMMA, HMMA, IMMA), other kernels left out."""
    from dist_renderer_tpu_torch.diag.chain_designs import mma_counts

    sass = """
        Function : _ZN3drt2mc12chain_kernelINS0_3CfgILb0ELi512EEELi7EEEvNS0_4ArgsE
        /*16d0*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24 ;
        /*1780*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24, gsb0 ;
        Function : _ZN3drt2mc12chain_kernelINS0_3CfgILb1ELi512EEELi7EEEvNS0_4ArgsE
        /*16d0*/   IGMMA.64x128x32.S8.S8 R24, gdesc[UR12], R24 ;
        Function : _ZN3drt2pb8small_mmEv
        /*0100*/   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
    """
    got = mma_counts(sass)
    assert list(got) == ["_ZN3drt2mc12chain_kernelINS0_3CfgILb0ELi512EEELi7EEEvNS0_4ArgsE",
                         "_ZN3drt2mc12chain_kernelINS0_3CfgILb1ELi512EEELi7EEEvNS0_4ArgsE"]
    assert [tuple(v.values()) for v in got.values()] == [(2, 0, 0, 0), (0, 1, 0, 0)]


@pytest.mark.parametrize("kind,row,ok", [
    ("int8", {"ms": 1.0, "max_abs_err": 0.0, "equal": True}, True),
    ("int8", {"ms": 1.0, "max_abs_err": 1e-7, "equal": False}, False),
    ("bf16", {"ms": 1.0, "max_abs_err": 5e-3, "equal": False}, True),
    ("bf16", {"ms": 1.0, "max_abs_err": 2e-2, "equal": False}, False),
    ("bf16", {"ms": 1.0, "max_abs_err": float("inf"), "equal": False}, False),
    ("int8", {"ms": 1.0}, True),
])
def test_chain_designs_holds_each_design_to_its_bar(kind, row, ok):
    """chain_designs' check: int8 designs bit for bit, bf16 within
    CHAIN_BF16_BAR (NaN or inf fails); rows without a comparison (the
    parts of a design) pass."""
    from dist_renderer_tpu_torch.diag.chain_designs import check

    res = {kind: {"design": row}}
    if ok:
        check(res)
    else:
        with pytest.raises(AssertionError):
            check(res)


def test_dma_designs_needs_a_card(monkeypatch):
    """The dma_loop / vec_while design comparison measures the card:
    without one it raises SystemExit before it builds anything."""
    from dist_renderer_tpu_torch.diag import dma_designs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        dma_designs.main([])


def test_dma_designs_imports_no_jax():
    """dma_designs imports nothing of JAX or the JAX package (a fresh
    interpreter: this test process imports both)."""
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "import dist_renderer_tpu_torch.diag.dma_designs\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dist_renderer_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=root, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dma_designs_counts_what_each_loop_holds():
    """dma_designs' SASS reading: a named kernel's global loads in order,
    its backward branches, and the counted opcodes inside a loop's address
    range (predicated or not), all loops together and loop by loop; code
    before and after the loop, the branch to itself that pads a kernel's
    end and other kernels left out."""
    from dist_renderer_tpu_torch.diag.dma_designs import loop_ops

    sass = """
        Function : _ZN3drt2pr16vec_while_kernelEPKiPfi
        /*0040*/                   LDG.E R2, desc[UR4][R2.64] ;   /* 0x0000000402027981 */
        /*0050*/                   FADD R1, R1, 1 ;
        /*0060*/                   FSETP.GT.AND P1, PT, R5, -1, PT ;
        /*0070*/                   FADD R5, R5, 1 ;
        /*0080*/                   BAR.RED.OR.DEFER_BLOCKING 0x0, P0 ;
        /*0090*/              @P0 BRA 0x60 ;
        /*00a0*/                   STG.E.128 desc[UR4][R8.64], R4 ;
        /*00b0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_115first_vec_whileEPKiPfi
        /*0040*/                   LD.E.STRONG.SYS R3, desc[UR4][R2.64] ;
        /*0050*/                   BAR.RED.OR.DEFER_BLOCKING 0x0, P0 ;
        /*0060*/              @!P0 BRA 0x40 ;
        /*0070*/                   BRA 0x70 ;
        Function : _ZN3drt2pr12empty_kernelEPKfPf
        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;
    """
    assert loop_ops(sass) == {
        "vec_while kernel": dict(loads="LDG.E", loops=1,
                                 in_loops={"FSETP": 1, "FADD": 1, "BAR": 1},
                                 per_loop=[{"FSETP": 1, "FADD": 1, "BAR": 1}]),
        "vec_while first version": dict(loads="LD.E.STRONG.SYS", loops=1,
                                        in_loops={"LD": 1, "BAR": 1},
                                        per_loop=[{"LD": 1, "BAR": 1}]),
    }


def test_loop_designs_needs_a_card(monkeypatch):
    """The scalar_while / index_loop design comparison measures the card:
    without one it raises SystemExit before it builds anything."""
    from dist_renderer_tpu_torch.diag import loop_designs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        loop_designs.main([])


LOOP_SASS = """
        Function : _ZN3drt2pr19scalar_while_kernelEPKiS2_PKfS4_PfS5_iii
        /*0040*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0050*/                   STS [UR4], R2 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/                   LDS R3, [UR4] ;
        /*0080*/                   ISETP.GT.AND P0, PT, R3, R0, PT ;
        /*0090*/              @P0 IADD3 R0, R0, 0x1, RZ ;
        /*00a0*/              @P0 BRA 0x70 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   BRA 0xc0;
        Function : _ZN12_GLOBAL__N_118first_scalar_whileEPKiPfi
        /*0040*/                   LD.E.STRONG.SYS R3, desc[UR4][R2.64] ;
        /*0050*/                   ISETP.GT.AND P0, PT, R3, R0, PT ;
        /*0060*/              @P0 BRA 0x40 ;
        /*0070*/                   STG.E desc[UR4][R4.64], RZ ;
        Function : _ZN12_GLOBAL__N_112index_designILNS_5BoundE1ELb1ELb1ELNS_4BodyE0EEEvPKiiS2_ii
        /*0040*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0050*/                   STS.128 [R7], R4 ;
        /*0060*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0070*/                   ISETP.GE.AND P0, PT, R0, R9, PT ;
        /*0080*/             @!P0 BRA 0x60 ;
        Function : _ZN12_GLOBAL__N_112while_designILNS_5BoundE0ELb1ELb1EEEvPKiPfi
        /*0040*/                   LDS R3, [UR4] ;
        /*0050*/              @P0 BRA 0x40 ;
        Function : _ZN3drt2pr12empty_kernelEPKfPf
        /*0000*/                   EXIT ;
"""


def test_loop_designs_reads_what_each_loop_holds():
    """loop_designs' SASS reading: each named kernel's global loads, its
    loops and the shared and global loads, shared stores and barriers
    inside them; template designs told apart by their arguments, other
    kernels left out."""
    from dist_renderer_tpu_torch.diag.loop_designs import sass_loops

    assert sass_loops(LOOP_SASS) == {
        "scalar_while kernel": dict(loads="LDG.E", loops=1, in_loops={"LDS": 1},
                                    per_loop=[{"LDS": 1}]),
        "scalar_while (a) first version": dict(loads="LD.E.STRONG.SYS", loops=1,
                                               in_loops={"LD": 1}, per_loop=[{"LD": 1}]),
        "index_loop (e) register bound": dict(loads="LDG.E.128.CONSTANT", loops=1,
                                              in_loops={}, per_loop=[{}]),
        "scalar_while (c) one warp": dict(loads="", loops=1, in_loops={"LDS": 1},
                                          per_loop=[{"LDS": 1}]),
    }


@pytest.mark.parametrize("per_loop,ok", [
    ([{"LDG": 1, "STS": 1}, {"LDS": 1}], True),          # staging, then the trips
    ([{"LDS": 2, "STS": 1}, {"LDS": 2}], True),
    ([{"LDG": 1, "STS": 1}], False),                     # no trip loop
    ([{"LDS": 1, "LDG": 1}], False),                     # the bound from device memory
    ([{"LD": 1}, {"LDS": 1, "LD": 1}], False),
])
def test_loop_designs_requires_a_shared_bound_in_each_kernel_loop(per_loop, ok):
    """Each kernel needs a trip loop (one holding an LDS), and no loop with
    an LDS may read device memory; staging loops may."""
    from dist_renderer_tpu_torch.diag.loop_designs import check_sass

    loops = {"scalar_while kernel": dict(per_loop=[{"LDS": 1}]),
             "index_loop kernel": dict(per_loop=per_loop)}
    if ok:
        check_sass(loops)
    else:
        with pytest.raises(AssertionError):
            check_sass(loops)


def test_loop_designs_reads_registers():
    """loop_designs' ptxas reading: the registers of each named kernel,
    other entry functions left out."""
    from dist_renderer_tpu_torch.diag.loop_designs import registers

    log = """
ptxas info    : Compiling entry function '_ZN3drt2pr17index_loop_kernelEPKiiS2_PKfS4_Pfii' for 'sm_90a'
ptxas info    : Function properties for _ZN3drt2pr17index_loop_kernelEPKiiS2_PKfS4_Pfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 14 registers, 4 bytes smem, 408 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112while_designILNS_5BoundE0ELb0ELb1EEEvPKiPfi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 9 registers, 4 bytes smem
ptxas info    : Compiling entry function '_ZN3drt2pr12empty_kernelEPKfPf' for 'sm_90a'
ptxas info    : Used 4 registers
"""
    assert registers(log) == {"index_loop kernel": 14, "scalar_while (b) shared bound": 9}


def test_loop_designs_derives_trip_costs_and_floors():
    """loop_designs' arithmetic: us a trip from the times at 16,384 and 0
    trips, the shared-load latency from the chase alike, and each
    kernel's floor, trips x that latency + the empty launch (P4's body:
    its 512-entry list at every n_live)."""
    from dist_renderer_tpu_torch.diag.loop_designs import OPS, derive

    trips = {op: ("0", "512") if op.endswith("0") else ("0", "1", "64", "512", "1024",
                                                          "16384") for op in OPS}
    res = {"chase": {"us": {"0": 1.5, "16384": 1.5 + 16384 * 0.02}}}
    for op in OPS:
        res[op] = {"kernel": {"us": {t: 1.0 + 0.03 * int(t) for t in trips[op]},
                              "equal": True},
                   "empty launch": {"us": {t: 0.8 for t in trips[op]}, "equal": None}}
    out = derive(res)
    assert out["load_us"] == pytest.approx(0.02)
    assert out["scalar_while"]["kernel"]["us_per_trip"] == pytest.approx(0.03)
    assert "us_per_trip" not in out["index_loop mode 0"]["kernel"]
    assert out["floor_us"]["index_loop mode 1"]["64"] == pytest.approx(0.8 + 64 * 0.02)
    assert out["floor_us"]["index_loop mode 0"] == pytest.approx(
        {"0": 0.8 + 512 * 0.02, "512": 0.8 + 512 * 0.02})


def test_loop_designs_fails_a_design_that_differs():
    """A design whose zeros or inputs were not as its plain version's
    fails; the unchecked empty launch passes."""
    from dist_renderer_tpu_torch.diag.loop_designs import OPS, check

    res = {op: {"empty launch": {"equal": None}, "kernel": {"equal": True}} for op in OPS}
    check(res)
    res["index_loop mode 0"]["(b) shared bound"] = {"equal": False}
    with pytest.raises(AssertionError, match="shared bound"):
        check(res)


@pytest.mark.parametrize("entry", ["drt_probe_copy", "drt_probe_add_one"])
def test_copy_and_add_one_take_a_64_bit_count(entry):
    """The count ctypes hands copy's and add_one's C entries is 64-bit on
    both sides of the call (a 32-bit one would cut tensors past 2^31
    values)."""
    import ctypes
    import os
    import re

    from dist_renderer_tpu_torch.ops.kernels import build

    assert build.SIGNATURES[entry][2] is ctypes.c_longlong
    with open(os.path.join(build.CSRC, "probe_launch.cu")) as f:
        src = f.read()
    decl = re.search(r'extern "C" int %s\(([^)]*)\)' % entry, src).group(1)
    assert [a.strip().rsplit(" ", 1)[0] for a in decl.split(",")] == [
        "const float*", "float*", "long long", "void*"]



def test_block_designs_needs_a_card(monkeypatch):
    """The compact / scan design comparison measures the card: without one
    it raises SystemExit before it builds anything."""
    from dist_renderer_tpu_torch.diag import block_designs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        block_designs.main([])


BLOCK_SASS = """
        Function : _ZN3drt2pb14compact_kernelILb1EEEvPKfS3_S3_Pfiiii
        /*0040*/                   LDG.E.64.CONSTANT R2, desc[UR4][R2.64] ;
        /*0050*/                   STS.128 [R7], RZ ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/              @!P0 STS [R4], R2 ;
        /*0080*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0090*/                   LDS.128 R8, [R5] ;
        /*00a0*/                   STG.E.128 desc[UR4][R2.64], R8 ;
        /*00b0*/              @!P1 STG.E desc[UR4][R2.64], R9 ;
        Function : _ZN3drt2pb14compact_kernelILb0EEEvPKfS3_S3_Pfiiii
        /*0040*/                   LDG.E.CONSTANT R2, desc[UR4][R2.64] ;
        /*00a0*/                   STG.E.128 desc[UR4][R2.64], R8 ;
        Function : _ZN3drt2pb11scan_kernelILi16EfEEvPKT0_Pfii
        /*0040*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0050*/                   SHFL.IDX PT, R5, R4, R3, 0x1f ;
        /*0060*/                   SHFL.IDX PT, R6, R4, R3, 0x1f ;
        /*0070*/                   STG.E desc[UR4][R2.64], R5 ;
        Function : _ZN3drt2pb11scan_kernelILi16E13__nv_bfloat16EEvPKT0_Pfii
        /*0040*/                   LDG.E.U16.CONSTANT R4, desc[UR4][R2.64] ;
        /*0070*/                   STG.E desc[UR4][R2.64], R5 ;
        Function : _ZN12_GLOBAL__N_110first_scanEPKvPfii
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        Function : _ZN3drt2pb11scan_kernelILi8EfEEvPKT0_Pfii
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
"""


def test_block_designs_counts_each_kernels_memory_ops():
    """block_designs' SASS reading: each named kernel's global and shared
    loads and stores, shuffles and barriers by opcode with its modifiers,
    predicated ones too; kernels not named (another K) left out."""
    from dist_renderer_tpu_torch.diag.block_designs import sass_ops

    assert sass_ops(BLOCK_SASS) == {
        "compact kernel": {"LDG.E.64.CONSTANT": 1, "STS.128": 1,
                           "BAR.SYNC.DEFER_BLOCKING": 2, "STS": 1, "LDS.128": 1,
                           "STG.E.128": 1, "STG.E": 1},
        "compact (b) 4-byte loads": {"LDG.E.CONSTANT": 1, "STG.E.128": 1},
        "scan kernel": {"LDG.E.CONSTANT": 1, "SHFL.IDX": 2, "STG.E": 1},
        "scan kernel bf16": {"LDG.E.U16.CONSTANT": 1, "STG.E": 1},
        "scan (a) first version": {"BAR.SYNC.DEFER_BLOCKING": 1},
    }


@pytest.mark.parametrize("fault", [None, "4-byte stores", "4-byte stores, 4-byte loads",
                                   "a barrier", "bf16 barrier", "missing"])
def test_block_designs_requires_16_byte_stores_and_no_barrier(fault):
    """check_sass passes the shipped kernels' SASS and fails either of
    compact's without STG.E.128, either scan kernel with a BAR, or a
    kernel not found."""
    from dist_renderer_tpu_torch.diag.block_designs import check_sass, sass_ops

    ops = sass_ops(BLOCK_SASS)
    if fault is None:
        check_sass(ops)
        return
    if fault == "4-byte stores":
        ops["compact kernel"] = {"STG.E": 4}
    elif fault == "4-byte stores, 4-byte loads":
        ops["compact (b) 4-byte loads"] = {"LDG.E.CONSTANT": 1, "STG.E": 4}
    elif fault == "a barrier":
        ops["scan kernel"]["BAR.SYNC.DEFER_BLOCKING"] = 1
    elif fault == "bf16 barrier":
        ops["scan kernel bf16"]["BAR.SYNC"] = 1
    else:
        del ops["scan kernel bf16"]
    with pytest.raises(AssertionError):
        check_sass(ops)


def test_block_designs_fails_a_design_that_differs():
    """A design whose output was not its plain version's fails; the
    unchecked empty launch and memset pass."""
    from dist_renderer_tpu_torch.diag.block_designs import check

    ops = ("compact", "compact int", "scan", "scan bf16")
    res = {op: {"empty launch": {"equal": None}, "kernel": {"equal": True}} for op in ops}
    check(res)
    res["scan bf16"]["(b) contiguous lanes"] = {"equal": False}
    with pytest.raises(AssertionError, match="contiguous lanes"):
        check(res)


def test_block_designs_reads_registers():
    """block_designs' ptxas reading: registers and spills of each named
    kernel, other entry functions left out."""
    from dist_renderer_tpu_torch.diag.block_designs import registers

    log = """
ptxas info    : Compiling entry function '_ZN3drt2pb11scan_kernelILi16EfEEvPKT0_Pfii' for 'sm_90a'
ptxas info    : Function properties for _ZN3drt2pb11scan_kernelILi16EfEEvPKT0_Pfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 55 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN3drt2pb11scan_kernelILi4EfEEvPKT0_Pfii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 19 registers, used 0 barriers
"""
    assert registers(log) == {"scan kernel": {"registers": 55, "spill_stores": 0,
                                              "spill_loads": 0}}
