"""What one launch costs on the card, and what a kernel's features add
to it: the counterpart of scripts/diag_launch_cost.py (which found, on
a TPU, a fixed cost per launch of any kernel with scalar control flow).

Each case gives the host us per launch, eager through the port's route
(ctypes -> ``extern "C"`` entry -> ``<<<>>>`` on the current stream; the
median of 200 back-to-back launches), and the device us per launch
inside one CUDA graph of 200 of them:

  - a torch elementwise op on [8, N] (the baseline);
  - P1, an empty kernel with a pointer in and out, plain and aliased;
  - P2, the same with 48 KB of shared scratch and an mbarrier;
  - the real kernels at zero work, their C entries called directly (the
    wrappers' host-side preparation is not a launch's cost; K1's is
    shown beside): K1 on the bench decoder over N rays all inactive
    (the TPU script's empty live list), K2's seed over N inactive rays
    and a K2 generation whose queue is empty, K3 and K4 on one point
    (their entries launch nothing for none);
  - P3, a scalar while loop of 0 trips with the march kernels' shared
    memory plan and three mbarriers; P4, a static loop over a 512-entry
    list staged in shared memory; P5, the bare loop writing [8, 128]
    zeros.

It counts the C entries a bench frame of the main path launches, and
multiplies each by its host cost at zero work, to give the launches'
share of a frame's host time; and it counts the ops of that frame that
make the host wait for the card (``frame_syncs``), with their call
sites, and the ATen ops it dispatches.

    python -m dist_renderer_tpu_torch.diag.diag_launch_cost
"""

from __future__ import annotations

import ctypes
import os

import torch

from dist_renderer_tpu_torch.diag import (
    N, ROOT, Operands, check_probe, device, emit, kernel_row, launch_row,
)
from dist_renderer_tpu_torch.ops.kernels import build
from dist_renderer_tpu_torch.ops.kernels import probes as pk

# The main path's C entries, by their rows in the launch-cost table
ENTRIES = {"drt_sphere_trace_persistent": "K1", "drt_queue_seed": "K2 seed",
           "drt_queue_generation": "K2 generation", "drt_precise_sdg": "K3",
           "drt_precise_bias_grads": "K4"}
LAUNCHES = 200
SRC = "dist_renderer_tpu_torch/csrc/probe_launch.cu"
TPU = "scripts/diag_launch_cost.py"


def bench_decoder(dev):
    """The bench fixture's 8x512 decoder: (params, dcfg, latent)."""
    from dist_renderer_tpu_torch.config import DecoderConfig
    from dist_renderer_tpu_torch.models.pretrain import load_params_npz

    params, latent = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"), dev)
    return params, DecoderConfig(), latent


def real_entries(dev):
    """Zero-work calls of the C entries the main path launches: a dict of
    name -> a function that launches it once on the current stream, and
    the march kernels' shared-memory plan in bytes."""
    from dist_renderer_tpu_torch.config import MarchConfig
    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels import queue_march as qm
    from dist_renderer_tpu_torch.ops.kernels import recompute as rc
    from dist_renderer_tpu_torch.ops.kernels.mlp_eval import mma_smem_bytes

    params, dcfg, latent = bench_decoder(dev)
    shared = bm.pack_shared(params, dcfg)
    bank = bm.fold_bias_bank(params, latent[None], dcfg, shared)
    march = MarchConfig(max_steps=32)
    lib = build.load()
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    rays = torch.zeros((16, N), **f32)          # row 9 (active) all 0
    out = torch.empty((8, N), **f32)
    k1_args = (build.ptr(rays), N, N, *bm.mma_march_args(shared, bank),
               march.convergence_eps, march.depth_eps, march.alpha, march.far_margin,
               march.max_steps, 1, build.ptr(out))
    state = torch.empty((12, N), **f32)
    queues = torch.empty((2, N), **i32)
    counts = torch.zeros(2, **i32)               # the seed appends none
    gen_args = qm.generation_args(shared, bank, rays, N, march, 6, state, queues[0],
                                  counts[0:1], queues[1], counts[1:2])

    packed = rc.pack_precise(params, dcfg)
    biases = rc.fold_bias_precise(params, latent, dcfg, packed)
    bias = torch.cat([b.reshape(-1) for b in biases]).contiguous()
    tab = (ctypes.c_int * len(packed.table))(*packed.table)
    pts = torch.zeros((1, 3), **f32)
    dirs = torch.tensor([[0.0, 0.0, 1.0]], **f32)
    k3_out = torch.empty((5, 1), **f32)
    ties = torch.zeros(2, **i32)
    u_rows = sum(m.out_p for m in packed.meta if m.takes_z)
    slots = rc.k4_slots(1)
    ct = torch.ones((1, 1), **f32)
    partials = torch.empty(slots * u_rows, dtype=torch.float64, device=dev)
    scratch = torch.empty(((slots + rc.SUM_CHUNK - 1) // rc.SUM_CHUNK) * u_rows,
                          dtype=torch.float64, device=dev)
    u = torch.empty(u_rows, **f32)
    mma = rc._mma_ptrs(packed)
    stream = lambda: build.stream_of(rays)
    rs = bm.ray_setup(torch.zeros((N, 3), **f32), torch.zeros((N, 3), **f32), march,
                      init_active=torch.zeros(N, dtype=torch.bool, device=dev))
    o3 = torch.zeros((N, 3), **f32)
    entries = {
        "K1": lambda: lib.call("drt_sphere_trace_persistent", *k1_args, stream()),
        "K1 wrapper": lambda: bm.march_rows_cuda(shared, bank, N, o3, o3, rs, march, True),
        "K2 seed": lambda: lib.call("drt_queue_seed", build.ptr(rays), N,
                                    build.ptr(state), build.ptr(queues[0]),
                                    build.ptr(counts[0:1]), stream()),
        "K2 generation": lambda: lib.call("drt_queue_generation", *gen_args, stream()),
        "K3": lambda: lib.call("drt_precise_sdg", build.ptr(pts), build.ptr(dirs), 1, *mma,
                               build.ptr(bias), tab, len(packed.meta), build.ptr(k3_out),
                               build.ptr(ties), stream()),
        "K4": lambda: lib.call("drt_precise_bias_grads", build.ptr(pts), build.ptr(ct), 1, 1,
                               1, *mma, build.ptr(bias), tab, len(packed.meta), None,
                               build.ptr(partials), build.ptr(scratch), slots,
                               rc.SUM_CHUNK, build.ptr(u), build.ptr(ties), stream()),
    }
    return entries, mma_smem_bytes(shared, march=True), shared.total


def probe_calls(plan_bytes: int) -> dict:
    """The probe cases: id -> (kernel call, plain call), each a function
    of the Operands, and whether the kernel writes its output."""
    def real(o):
        return dict(rays=o.x16, defaults=o.x8, live=o.live, bias=o.bias,
                    smem_bytes=plan_bytes, n_bars=3)

    return {
        # unaliased, P1's output is never written (unspecified, as on the TPU)
        "P1": (lambda o: pk.empty(o.x8), lambda o: pk.empty_plain(o.x8), False),
        "P1 aliased": (lambda o: pk.empty(o.x8, True),
                       lambda o: pk.empty_plain(o.x8, True), True),
        "P2": (lambda o: pk.scratch(o.x16, o.x8),
               lambda o: pk.scratch_plain(o.x16, o.x8), True),
        "P3": (lambda o: pk.scalar_while(o.n_live, **real(o)),
               lambda o: pk.scalar_while_plain(o.n_live, **real(o)), True),
        "P4": (lambda o: pk.index_loop(o.live, o.n_live, o.x16, o.x8, o.bias, 0,
                                       plan_bytes, 3),
               lambda o: pk.index_loop_plain(o.live, o.n_live, o.x16, o.x8), True),
        "P5": (lambda o: pk.scalar_while(o.n_live, zeros=True),
               lambda o: pk.scalar_while_plain(o.n_live, zeros=True), True),
    }


def check(dev) -> list:
    """P1-P5 against their plain versions, with their kernel rows: on
    seeded operands at the path's n_live = 0 and at a full live list
    (N / 512 trips)."""
    _, plan_bytes, total = real_entries(dev)
    calls = probe_calls(plan_bytes)
    seeded = [Operands(dev, total, seed=0, n_live=n) for n in (0, N // 512)]
    rows = []
    for pid, line, kern in (("P1", 51, pk.empty), ("P2", 74, pk.scratch),
                            ("P3", 143, pk.scalar_while), ("P4", 168, pk.index_loop),
                            ("P5", 196, pk.scalar_while)):
        err = 0.0
        for case in (pid, "P1 aliased") if pid == "P1" else (pid,):
            run, plain, written = calls[case]
            for o in seeded:
                err = max(err, check_probe(f"{case} (n_live {int(o.n_live[0])})", run,
                                           plain, o, written))
        run, plain, _ = calls[pid]
        o = seeded[0]
        nbytes = 4 * (128 * 8 if pid == "P5" else 0) + (4 if pid in ("P3", "P4", "P5") else 0)
        # P5's function is its zeros, at any n_live: one torch.zeros
        library = (lambda: torch.zeros(pk.ZEROS_SHAPE, device=dev)) if pid == "P5" else None
        rows.append(kernel_row(pid, kern, SRC, f"{TPU}:{line}", err, lambda: run(o),
                               lambda: plain(o), library, nbytes=nbytes,
                               graphs=library is not None))
    return rows


def _site(filename: str, lineno: int) -> str:
    """file:line, relative to the repo, or to site-packages outside it."""
    path = os.path.relpath(filename, ROOT)
    if path.startswith(".."):
        path = filename.split("site-packages" + os.sep)[-1]
    return f"{path}:{lineno}"


def frame_syncs(dev) -> dict:
    """The host's side of a bench frame: one trace_frame render of the
    bench cell (profile_render.bench_frames), fwd and fwd+bwd. It counts
    the C entries the frame launches, by name (the library's ``call``
    wrapped for the render; their sum must equal the main-path wrappers'
    launch counts, read after the same render). Under
    ``torch.cuda.set_sync_debug_mode("warn")``, which warns at every op
    that makes the host wait for the card (a device-to-host copy, an
    ``.item()``, a data-dependent shape), it counts those ops and their
    call sites (file:line, as the warnings name them); in a third render
    it counts the ATen ops the frame dispatches (a TorchDispatchMode), each
    a host call of a few us, and names the commonest."""
    import collections
    import warnings

    from torch.utils._python_dispatch import TorchDispatchMode

    from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
    from dist_renderer_tpu_torch.ops.kernels import fused_march as fm
    from dist_renderer_tpu_torch.ops.kernels import mlp_eval as me
    from dist_renderer_tpu_torch.ops.kernels import queue_march as qm
    from dist_renderer_tpu_torch.ops.kernels import recompute as rc
    from dist_renderer_tpu_torch.profile_render import bench_frames

    class OpCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    lib = build.load()
    wrappers = (bm.sphere_trace_persistent, bm.sphere_trace_batched, fm.sphere_trace_grid,
                qm.queue_march, rc.precise_sdg_call, rc.precise_bias_grads_call,
                me.point_eval, me.point_eval_banked)
    fwd, fwdbwd, _ = bench_frames(dev)
    out = {}
    for mode, run in (("fwd", fwd), ("fwdbwd", fwdbwd)):
        run()
        torch.cuda.synchronize()
        entries = collections.Counter()

        def counted(name, *args, call=lib.call):
            entries[name] += 1
            call(name, *args)

        for w in wrappers:
            w.launches = 0
        lib.call = counted
        try:
            run()
        finally:
            del lib.call
        wrapped = sum(w.launches for w in wrappers)
        if sum(entries.values()) != wrapped:
            raise AssertionError(f"a {mode} frame launched {dict(entries)} through the "
                                 f"library, but its wrappers counted {wrapped}")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = collections.Counter(_site(w.filename, w.lineno) for w in caught
                                    if "synchroniz" in str(w.message))
        with OpCount() as count:
            run()
        out[mode] = dict(launches=dict(entries), syncs=sum(sites.values()),
                         sites=dict(sites.most_common()),
                         aten_ops=sum(count.ops.values()),
                         commonest_ops=dict(count.ops.most_common(12)))
    return out


def measure(dev, n: int = LAUNCHES) -> dict:
    """The launch-cost table, a bench frame's host calls, and the main
    path's launches' host cost a frame: each C entry's launches in the
    frame (counted there) times its host us at zero work."""
    entries, plan_bytes, total = real_entries(dev)
    ops = Operands(dev, total)
    calls = probe_calls(plan_bytes)
    table = {"torch x8 + 1": launch_row(lambda: ops.x8 + 1.0, n)}
    for pid in ("P1", "P1 aliased", "P2"):
        table[pid] = launch_row(lambda run=calls[pid][0]: run(ops), n)
    for name, fn in entries.items():
        # the wrapper prepares its inputs with torch ops: host cost only
        table[name] = launch_row(fn, n, graph=name != "K1 wrapper")
    for pid in ("P3", "P4", "P5"):
        table[pid] = launch_row(lambda run=calls[pid][0]: run(ops), n)
    frames = frame_syncs(dev)
    res = dict(launches=n, table=table, march_plan_bytes=plan_bytes, frame_syncs=frames)
    for mode, frame in frames.items():
        unknown = set(frame["launches"]) - set(ENTRIES)
        if unknown:
            raise AssertionError(f"a {mode} frame launched {sorted(unknown)}, which "
                                 f"the launch-cost table does not measure")
        res[f"host_us_per_frame_{mode}"] = sum(
            count * table[ENTRIES[name]]["host_us"]
            for name, count in frame["launches"].items())
    return res


def main() -> int:
    dev = device()
    rows = check(dev)
    emit("diag_launch_cost", dict(
        kernels=[{k: v for k, v in r.items() if k != "kernel"} for r in rows],
        **measure(dev)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
