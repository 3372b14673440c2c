"""The TPU probe scripts' kernels (scripts/diag_launch_cost.py,
diag_launch2.py, diag_launch3.py, diag_launch4.py; P1-P22 in PERF.md),
each with its plain PyTorch version.

The launch-feature kernels (``csrc/probe_launch.cu``) do no work: they
measure what a launch costs through the port's route (ctypes -> an
``extern "C"`` entry -> ``<<<>>>`` on the caller's stream) and what a
kernel's features add to it. The building blocks (``csrc/probe_blocks.cu``)
are the small products and data movements the work-queue kernel was built
from on the TPU. A CUDA tensor launches the kernel; a CPU tensor runs the
plain version, which gives what the TPU kernel's outputs hold. Each
wrapper counts its launches (``fn.launches``).

An aliased TPU output (``input_output_aliases``) is the input tensor
itself here: the wrapper returns it, and ``dma_loop`` writes into it.
"""

from __future__ import annotations

from typing import Optional

import torch

from dist_renderer_tpu_torch.ops.kernels import build

N_LANES = 512                # the TPU's 512-lane chunk
SCRATCH_BYTES = (16 + 8) * N_LANES * 4   # VMEM [16, 512] + [8, 512] fp32
ZEROS_SHAPE = (8, 128)       # P5/P6's VMEM output


def _check(t: torch.Tensor, dtype, name: str) -> None:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}")


def _cuda(*tensors) -> bool:
    """True when the inputs lie on one CUDA device, False when all lie on
    the CPU; raises on a mix."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError("the inputs must lie on one device")
    return next(iter(devs)).type == "cuda"


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else build.ptr(t)


def _call(name: str, anchor: torch.Tensor, *args) -> None:
    build.load().call(name, *args, build.stream_of(anchor))


# ---- csrc/probe_launch.cu ------------------------------------------------

def empty_plain(x: torch.Tensor, aliased: bool = False) -> torch.Tensor:
    return x if aliased else torch.empty_like(x)


def empty(x: torch.Tensor, aliased: bool = False) -> torch.Tensor:
    """P1 (diag_launch_cost.py's k_empty): a kernel that does nothing with
    a pointer in and a pointer out. Aliased, the output is x itself;
    otherwise an [x's shape] buffer the kernel never writes (the TPU
    kernel never wrote its output either: its contents are unspecified,
    and nothing reads them)."""
    if not _cuda(x):
        return empty_plain(x, aliased)
    _check(x, torch.float32, "x")
    out = x if aliased else torch.empty_like(x)
    _call("drt_probe_empty", x, build.ptr(x), build.ptr(out))
    empty.launches += 1
    return out


empty.launches = 0


def scratch_plain(a: torch.Tensor, b: torch.Tensor, smem_bytes: int = SCRATCH_BYTES,
                  n_bars: int = 1) -> torch.Tensor:
    return b


def scratch(a: torch.Tensor, b: torch.Tensor, smem_bytes: int = SCRATCH_BYTES,
            n_bars: int = 1) -> torch.Tensor:
    """P2 (diag_launch_cost.py's k_scratch): nothing done with
    ``smem_bytes`` of shared memory and ``n_bars`` mbarriers set up (the
    TPU kernel's VMEM scratch and DMA semaphore); the output is b
    (aliased)."""
    if not _cuda(a, b):
        return scratch_plain(a, b, smem_bytes, n_bars)
    _check(a, torch.float32, "a")
    _check(b, torch.float32, "b")
    _call("drt_probe_scratch", a, build.ptr(a), build.ptr(b), smem_bytes, n_bars)
    scratch.launches += 1
    return b


scratch.launches = 0


def scalar_while_plain(n_live: torch.Tensor, rays=None, defaults=None, live=None,
                       bias=None, zeros: bool = False, smem_bytes: int = 0,
                       n_bars: int = 0) -> torch.Tensor:
    if zeros:
        return torch.zeros(ZEROS_SHAPE, dtype=torch.float32, device=n_live.device)
    if defaults is not None:
        return defaults
    return torch.empty((8, rays.shape[1]), dtype=torch.float32, device=rays.device)


def scalar_while(n_live: torch.Tensor, rays: Optional[torch.Tensor] = None,
                 defaults: Optional[torch.Tensor] = None,
                 live: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None, zeros: bool = False,
                 smem_bytes: int = 0, n_bars: int = 0) -> torch.Tensor:
    """A while loop of n_live[0] trips (int32 [1] on the device) that
    does nothing: P3 (k_noW, with the real kernel's scratch set), P5 and
    P6 (zeros=True: an [8, 128] zero output, the TPU's VMEM block), P11
    (k_any: rays in, an [8, N] output never written, its contents
    unspecified), P12 (k_alias: the output is ``defaults``), P13
    (k_scratch: with scratch and barriers). The kernel loads the bound
    into shared memory once and reads it there at every trip, as the TPU
    kernels read their SMEM scalar; one warp runs the trips. The output:
    zeros, else ``defaults`` (aliased), else the unwritten one. ``live``,
    ``rays`` and ``bias`` are operands the body never reads."""
    if not _cuda(n_live, rays, defaults, live, bias):
        return scalar_while_plain(n_live, rays, defaults, live, bias, zeros,
                                  smem_bytes, n_bars)
    _check(n_live, torch.int32, "n_live")
    if zeros:
        out = torch.empty(ZEROS_SHAPE, dtype=torch.float32, device=n_live.device)
    elif defaults is not None:
        out = defaults
    else:
        out = torch.empty((8, rays.shape[1]), dtype=torch.float32, device=rays.device)
    _call("drt_probe_scalar_while", n_live, build.ptr(n_live), _ptr(live), _ptr(rays),
          _ptr(bias), None if zeros else build.ptr(out), build.ptr(out) if zeros else None,
          out.numel() if zeros else 0, smem_bytes, n_bars)
    scalar_while.launches += 1
    return out


scalar_while.launches = 0


def index_loop_plain(live: torch.Tensor, n_live: torch.Tensor, rays: torch.Tensor,
                     defaults: torch.Tensor, bias=None, mode: int = 0,
                     smem_bytes: int = 0, n_bars: int = 0) -> torch.Tensor:
    return defaults


def index_loop(live: torch.Tensor, n_live: torch.Tensor, rays: torch.Tensor,
               defaults: torch.Tensor, bias: Optional[torch.Tensor] = None,
               mode: int = 0, smem_bytes: int = 0, n_bars: int = 0) -> torch.Tensor:
    """The int32 list ``live`` staged in shared memory and walked: mode 0
    is P4 (k_fori: a loop over the whole list copying entry k to a
    shared scalar while k < n_live[0]), mode 1 is P14 (k_smemarr: a while
    loop of n_live[0] trips reading entry k). The bound is read as in
    ``scalar_while``; the list is staged by 16-byte loads where its length
    is a multiple of 4 and it starts on a 16-byte boundary, by 4-byte
    loads otherwise. ``smem_bytes`` (at least 16 n_bars + 4 (len(live) +
    1)) and ``n_bars`` give P4 the real kernel's scratch set. The output
    is ``defaults`` (aliased)."""
    if not _cuda(live, n_live, rays, defaults, bias):
        return index_loop_plain(live, n_live, rays, defaults, bias, mode,
                                smem_bytes, n_bars)
    _check(live, torch.int32, "live")
    _check(n_live, torch.int32, "n_live")
    smem = max(smem_bytes, 16 * n_bars + 4 * (live.numel() + 1))
    _call("drt_probe_index_loop", live, build.ptr(live), live.numel(), build.ptr(n_live),
          build.ptr(rays), _ptr(bias), build.ptr(defaults), mode, smem, n_bars)
    index_loop.launches += 1
    return defaults


index_loop.launches = 0


def vec_while_plain(trips: torch.Tensor, shape=(8, N_LANES)) -> torch.Tensor:
    # the carry stays above -1, so the loop runs its trips, none for a
    # count below 1: c = trips, held at 2^24, where c + 1 rounds to c
    c = trips[0].clamp(0, 1 << 24).float()
    return torch.zeros(shape, dtype=torch.float32, device=trips.device) + c


def vec_while(trips: torch.Tensor, shape=(8, N_LANES)) -> torch.Tensor:
    """P7 (diag_launch2.py's vec_while_kernel): a carry of ``shape`` fp32
    zeros (at most 4,096 values), +1 a trip while k < trips[0] and its max
    > -1. One block of 256 threads, 16 values each; the count is read from
    the device once, before the loop, and the block votes on the test
    every trip."""
    if not _cuda(trips):
        return vec_while_plain(trips, shape)
    _check(trips, torch.int32, "trips")
    out = torch.empty(shape, dtype=torch.float32, device=trips.device)
    _call("drt_probe_vec_while", trips, build.ptr(trips), build.ptr(out), out.numel())
    vec_while.launches += 1
    return out


vec_while.launches = 0


def dma_loop_plain(trips: torch.Tensor, rays: torch.Tensor,
                   defaults: torch.Tensor) -> torch.Tensor:
    blk = defaults[:, :N_LANES]
    blk.copy_(torch.where(trips[0] >= 1, rays[:8, :N_LANES] + 1.0, blk))
    return defaults


def dma_loop(trips: torch.Tensor, rays: torch.Tensor,
             defaults: torch.Tensor) -> torch.Tensor:
    """P15 (diag_launch3.py's k_dma): trips[0] times, rays[0:8, 0:512]
    into shared memory by bulk copies on an mbarrier, + 1 in place, back
    to the output's columns 0-511 by bulk copies (rays' rows 8-15, in the
    TPU kernel's window, are never used). The output is ``defaults``,
    written in place (the TPU's aliasing): after a trip its first 512
    columns hold rays[0:8, 0:512] + 1. The kernel splits the rows over 8
    blocks, each with its own mbarriers and loop; it reads the count from
    the device once, issues the first trip's copy in before the count
    arrives (at 0 trips too, writing nothing) and each next trip's at the
    trip before, into a second stage of shared memory."""
    if not _cuda(trips, rays, defaults):
        return dma_loop_plain(trips, rays, defaults)
    _check(trips, torch.int32, "trips")
    _check(rays, torch.float32, "rays")
    _check(defaults, torch.float32, "defaults")
    if rays.shape[0] != 16 or defaults.shape[0] != 8 or rays.shape[1] != defaults.shape[1]:
        raise ValueError("rays must be [16, N] and defaults [8, N]")
    _call("drt_probe_dma_loop", rays, build.ptr(trips), build.ptr(rays),
          build.ptr(defaults), rays.shape[1])
    dma_loop.launches += 1
    return defaults


dma_loop.launches = 0


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def copy(x: torch.Tensor) -> torch.Tensor:
    """P18 (diag_launch4.py's k_copy): out = x bit for bit, any contiguous
    fp32 x (64-bit count). The kernel fills a grid sized to x (4 blocks
    of 256 threads at [8, 512], one round trip each) with 16-byte loads
    and stores where x starts on a 16-byte boundary, 4-byte ones
    otherwise; its first version, the TPU's one block, made each thread
    wait out 16 round trips in turn."""
    if not _cuda(x):
        return copy_plain(x)
    _check(x, torch.float32, "x")
    out = torch.empty_like(x)
    if x.numel():  # an empty x launches nothing
        _call("drt_probe_copy", x, build.ptr(x), build.ptr(out), x.numel())
        copy.launches += 1
    return out


copy.launches = 0


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """P19 (diag_launch4.py's k_add): out = x + 1 in fp32, any contiguous
    fp32 x; copy's kernel body and grid with the add."""
    if not _cuda(x):
        return add_one_plain(x)
    _check(x, torch.float32, "x")
    out = torch.empty_like(x)
    if x.numel():  # an empty x launches nothing
        _call("drt_probe_add_one", x, build.ptr(x), build.ptr(out), x.numel())
        add_one.launches += 1
    return out


add_one.launches = 0


# ---- csrc/probe_blocks.cu -------------------------------------------------

def small_mm_plain(x: torch.Tensor, w: torch.Tensor, looped: bool = False,
                   trips: int = 1) -> torch.Tensor:
    out = torch.matmul(x.to(torch.bfloat16).to(torch.float32), w.to(torch.float32))
    return torch.zeros_like(out) if looped and trips < 1 else out


def small_mm(x: torch.Tensor, w: torch.Tensor, looped: bool = False,
             trips: int = 1) -> torch.Tensor:
    """P20 (diag_launch4.py's k_mm): x [M, K] fp32 rounded to bf16 times w
    [K, N] bf16, fp32 sums, on mma.sync. looped=True is P21
    (k_mm_in_while): the product inside a while loop of ``trips`` trips
    (the TPU kernel's one), zeros after none. The kernel computes out^T =
    w^T x^T, a block per 16 columns of N with w's slice and x (rounded
    once) staged in shared memory, K split over 8 warps whose partials
    are summed in a fixed order (the same bits every launch, P20 and P21
    alike); the looped form repeats only the MMAs. The tensor cores sum
    in another order than the plain version's fp32 GEMM. x and w must
    start on 16-byte boundaries (the kernel's 16-byte loads)."""
    if not _cuda(x, w):
        return small_mm_plain(x, w, looped, trips)
    _check(x, torch.float32, "x")
    _check(w, torch.bfloat16, "w")
    m, k = x.shape
    if w.shape[0] != k or k % 16 or w.shape[1] % 8:
        raise ValueError("small_mm takes x [M, K], w [K, N] with K % 16 == 0, N % 8 == 0")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("small_mm takes x and w starting on 16-byte boundaries")
    out = torch.empty((m, w.shape[1]), dtype=torch.float32, device=x.device)
    _call("drt_probe_small_mm", x, build.ptr(x), build.ptr(w), build.ptr(out), m, k,
          w.shape[1], int(looped), trips)
    small_mm.launches += 1
    return out


small_mm.launches = 0


def compact_plain(d: torch.Tensor, pos: torch.Tensor, surv: torch.Tensor,
                  slots: int = 1024, int_pos: bool = False) -> torch.Tensor:
    p, s = pos.reshape(-1), surv.reshape(-1)
    if int_pos:
        fin = torch.isfinite(p) & (p.abs() < 2.0 ** 31)
        slot = torch.where(fin, p, 0.0).to(torch.int64)
        ok = fin & (slot >= 0) & (slot < slots)
    else:
        slot = torch.where(torch.isfinite(p), p, -1.0)
        ok = (slot == torch.floor(slot)) & (slot >= 0) & (slot < slots)
        slot = slot.to(torch.int64)
    keep = ok & (s > 0.5)
    out = torch.zeros((d.shape[0], slots), dtype=torch.float32, device=d.device)
    out[:, slot[keep]] = d[:, keep]
    return out


def compact(d: torch.Tensor, pos: torch.Tensor, surv: torch.Tensor,
            slots: int = 1024, int_pos: bool = False) -> torch.Tensor:
    """P17 (diag_launch3.py's k_compact) and, with int_pos, P22
    (diag_launch4.py's): d [R, L] fp32, pos and surv [1, L] fp32 ->
    [R, slots] with out[:, pos[j]] = d[:, j] for each survivor j
    (surv > 0.5) whose position names a slot (an integral value in
    [0, slots); with int_pos, the position truncated toward zero), zeros
    elsewhere. Survivors' positions are distinct, as in a compaction. The
    TPU kernels reached this through a one-hot bf16x3 product; the kernel
    writes it directly: a block per row and 1,024 slots builds them in
    shared memory (zeros, then the survivors' values) and writes each
    output word once, by 16-byte stores where slots % 4 == 0. An empty
    output launches nothing."""
    if not _cuda(d, pos, surv):
        return compact_plain(d, pos, surv, slots, int_pos)
    for t, name in ((d, "d"), (pos, "pos"), (surv, "surv")):
        _check(t, torch.float32, name)
    lanes = d.shape[1]
    if pos.numel() != lanes or surv.numel() != lanes:
        raise ValueError("pos and surv must have one entry per column of d")
    out = torch.empty((d.shape[0], slots), dtype=torch.float32, device=d.device)
    if out.numel():
        _call("drt_probe_compact", d, build.ptr(d), build.ptr(pos), build.ptr(surv),
              build.ptr(out), d.shape[0], lanes, slots, int(int_pos))
        compact.launches += 1
    return out


compact.launches = 0


def f32dot_plain(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, m.T)


def f32dot(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """P8 (diag_launch2.py's f32dot_kernel): x [R, K] times m [S, K]
    transposed, fp32 on CUDA cores (R <= 32): each output one fmaf chain
    over k in order, so two launches give the same bits. A block per 8
    columns stages its rows of m and all of x in shared memory (16-byte
    cp.async groups in flight together; 4-byte copies when K % 4 != 0 or
    a pointer is not 16-byte aligned), each thread two outputs of one
    row."""
    if not _cuda(x, m):
        return f32dot_plain(x, m)
    _check(x, torch.float32, "x")
    _check(m, torch.float32, "m")
    if x.shape[1] != m.shape[1] or not 0 < x.shape[0] <= 32:
        raise ValueError("f32dot takes x [R <= 32, K] and m [S, K]")
    out = torch.empty((x.shape[0], m.shape[0]), dtype=torch.float32, device=x.device)
    _call("drt_probe_f32dot", x, build.ptr(x), build.ptr(m), build.ptr(out), x.shape[0],
          x.shape[1], m.shape[0])
    f32dot.launches += 1
    return out


f32dot.launches = 0


def roll_lanes_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(x, shift, dims=1)


def roll_lanes(x: torch.Tensor, shift: int) -> torch.Tensor:
    """P9 (diag_launch2.py's roll_kernel): out[:, j] = x[:, (j - shift)
    mod L], pltpu.roll's and jnp.roll's direction; any integer shift."""
    if not _cuda(x):
        return roll_lanes_plain(x, shift)
    _check(x, torch.float32, "x")
    rows, lanes = x.shape
    out = torch.empty_like(x)
    _call("drt_probe_roll", x, build.ptr(x), build.ptr(out), rows, lanes, shift % lanes)
    roll_lanes.launches += 1
    return out


roll_lanes.launches = 0


def scan_plain(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's log-shift prefix sum: c += c shifted right by 1,
    2, 4, ... with zeros shifted in, in fp32."""
    c = x.to(torch.float32)
    lanes = c.shape[-1]
    sh = 1
    while sh < lanes:
        shifted = torch.zeros_like(c)
        shifted[..., sh:] = c[..., :-sh]
        c = c + shifted
        sh *= 2
    return c


def tri_cumsum_plain(x: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """diag_launch3.py's k_tri: bf16 x times a bf16 upper-triangular ones
    matrix, fp32 sums (an fp32 GEMM of the bf16 values)."""
    return torch.matmul(x.to(torch.float32), tri.to(torch.float32))


def scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of each row of x [R, L] (L <= 1024), fp32 or
    bf16 in, fp32 out: P10 (diag_launch2.py's cumsum_kernel, whose adds
    it makes in the same order: scan_plain, bit for bit on fp32) and P16
    (diag_launch3.py's k_tri, the triangular product: equal on 0/1 rows,
    whose sums are exact in any order). The kernel runs a warp per row
    with no barrier: lane l holds K contiguous values (K the least power
    of two with 32 K >= L; 16 at L = 512), and each log-shift step's
    addend comes from the lane's own registers or, by a shuffle, from a
    lane before it. No rows launch nothing."""
    if not _cuda(x):
        return scan_plain(x)
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError("scan takes a contiguous fp32 or bf16 [R, L]")
    rows, lanes = x.shape
    if lanes > 1024:
        raise ValueError("scan takes rows of at most 1024 lanes")
    out = torch.empty((rows, lanes), dtype=torch.float32, device=x.device)
    if rows:
        _call("drt_probe_scan", x, build.ptr(x), build.ptr(out), rows, lanes,
              int(x.dtype == torch.bfloat16))
        scan.launches += 1
    return out


scan.launches = 0

KERNELS = (empty, scratch, scalar_while, index_loop, vec_while, dma_loop, copy,
           add_one, small_mm, compact, f32dot, roll_lanes, scan)
