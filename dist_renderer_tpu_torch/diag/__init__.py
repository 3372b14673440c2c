"""Card measurements: the counterparts of the JAX package's diagnostic
scripts. Each module runs on one CUDA card, ``python -m
dist_renderer_tpu_torch.diag.<name>`` (``SystemExit`` without one), and
prints the card's name and power limit, then its measurements as one
JSON line.

- The TPU probe scripts (``scripts/diag_launch_cost.py``,
  ``diag_launch2.py``, ``diag_launch3.py``, ``diag_launch4.py``,
  ``diag_int8.py``): each module holds every probe kernel it launches to
  its plain version. ``chip_smoke.py``'s phase 10 runs them all.
- The scheduling diagnostics (``scripts/diag_perf.py``, ``diag_proxy.py``,
  ``diag_proxy_ab.py``, ``diag_kernel.py``, ``diag_proxy_cost.py``,
  ``diag_binning.py``, ``diag_round_caps.py``, ``diag_verify_caps.py``,
  ``diag_queue.py``, ``diag_caps_ab.py``): the batched render's phases,
  straggler telemetry (``render_batched_c2f(..., with_diag=True)``), the
  verify stage's cost (``proxy_verify=False``), the march kernels' cost
  per tile-step and the cap sweeps, on the bench cell (``BenchCell``).
  Each holds every render it times to the same render through the plain
  versions (``use_kernel=False``) with the kernels' summation order
  (``in_order``), bit for bit, on its first ``PLAIN_FRAMES`` frames. ``chip_smoke.py``'s phase 13
  runs them all in one process.
- The stage splits and the fidelity diagnostics (``scripts/diag_f1_stages.py``,
  ``diag_compose.py``, ``diag_glue.py``, ``diag_sortcost.py``,
  ``diag_fused_dd.py``, ``diag_recompute.py``, ``diag_precision.py``,
  ``diag_polish_parity.py``, ``diag_band_fidelity.py``,
  ``debug_band_probe.py``, ``diag_warm.py``, ``retrain_proxy.py``,
  ``diag_finalize_compile.py``): the single-frame render's stages and
  compose's pieces, the reordering glue, the recompute routes and value
  paths, polish and band-probe fidelity, warm fits, a re-distilled proxy
  and the batched polish's trace / finalize split, on the bench cell;
  each render held to its plain versions (``BenchCell.hold_frame``,
  ``hold_to_plain``), two recompute routes to each other under
  ``ROUTE_BARS``. Each module's command is in its docstring; the CPU
  tests are ``tests/test_torch_diag_stages.py`` and the card tests
  ``-k stage_diagnostic`` in ``tests/test_torch_cuda.py``.
  ``chip_smoke.py``'s phase 14 runs them all in one process at 512^2.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import statistics
import subprocess
from typing import Optional

import numpy as np
import torch

from dist_renderer_tpu_torch.ops.kernels import build
from dist_renderer_tpu_torch.utils.profiling import (
    PEAK_BF16, bound_ms, device_kernels, graph_us, host_us, per_call_ms, timed,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N = 512 * 512        # the scripts' [rows, N] operands: one 512x512 frame


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("this measurement needs a CUDA card")
    return torch.device("cuda", 0)


def launch_row(fn, n: int = 200, graph: bool = True) -> dict:
    """A launch's cost: the host us per call, eager (median of n
    back-to-back calls), and the device us per call inside one CUDA graph
    of n calls."""
    row = {"host_us": host_us(fn, n)}
    if graph:
        row["graph_us"] = graph_us(fn, n)
    return row


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Raise unless got equals want (bit for bit where they are numbers;
    NaN where NaN); return the largest absolute difference, 0.0."""
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item() \
            if got.shape == want.shape else float("inf")
        raise AssertionError(f"{name}: the kernel differs from its plain version "
                             f"(max |diff| {diff:.3e})")
    return 0.0


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, bar: float) -> float:
    """Raise unless every |got - want| <= bar; return the largest."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    diff = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    if not diff <= bar:
        raise AssertionError(f"{name}: max |kernel - plain| {diff:.3e} > {bar:.1e}")
    return diff


def emit(name: str, result: dict) -> None:
    """Print the card line and one JSON line {name: result}."""
    print(card_line())
    print(json.dumps({name: result}), flush=True)


def run_program(src: str, timeout: int = 300, args=()) -> tuple:
    """Build the standalone CUDA program ``src`` (a file beside this one)
    with the port's nvcc flags into the kernel build directory (nvcc's
    report in ``build.log`` beside the executable), run it with ``args``,
    and return (its executable's path, the JSON of its last line)."""
    name = os.path.splitext(src)[0]
    out_dir = os.path.join(build.BUILD_ROOT, name)
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, name)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", exe,
                           os.path.join(os.path.dirname(os.path.abspath(__file__)), src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed building {src}:\n" + proc.stdout + proc.stderr)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    run = subprocess.run([exe, *args], capture_output=True, text=True, timeout=timeout)
    if run.returncode:
        raise RuntimeError(f"{name} failed:\n" + run.stdout + run.stderr)
    return exe, json.loads(run.stdout.strip().splitlines()[-1])


def kernel_row(pid: str, kernel, source: str, replaces: str, max_abs_err: float,
               run, plain, library=None, nbytes: float = 0.0, ops: float = 0.0,
               peak: float = PEAK_BF16, calls: int = 20, graphs: bool = False) -> dict:
    """One probe kernel's row: its id (P1-P24), the wrapper that launches
    it, its source and the TPU kernel it replaces (file:line), the largest
    |kernel - plain| of its check, and the device ms per call of the
    kernel (``run``), its plain version and, where one PyTorch call
    computes the same function, that call (eager, CUDA events), beside
    the bound of the bytes and operations its function needs. graphs=True
    adds the kernel's ``launch_row`` and, where there is a library call,
    that call's: host us eager, device us inside a CUDA graph of 200,
    where the host's cost of a launch drops out."""
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    row = dict(id=pid, kernel=kernel, source=source, replaces=replaces,
               max_abs_err=max_abs_err, ms=per_call_ms(run, calls),
               plain_ms=per_call_ms(plain, calls),
               library_ms=None if library is None else per_call_ms(library, calls),
               bound_ms=b_ms, bound_by=b_by)
    if graphs:
        row["launch"] = launch_row(run)
        if library is not None:
            row["library_launch"] = launch_row(library)
    return row


class Operands:
    """The TPU scripts' operands on the card: x8 [8, N] and x16 [16, N]
    fp32, the loop bound n_live (int32 [1]), the live list of N / 512
    chunks, a 512-entry list (int32) and the bias columns [total, 128]
    fp32. Without a seed they are the scripts' zeros (n_live = 0, the
    zero-work case); with one, the values and lists are drawn from it and
    n_live is ``n_live``, so that a kernel which wrote or read where it
    should not shows."""

    def __init__(self, dev, total: int = 1, seed: Optional[int] = None,
                 n_live: int = 0):
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.n_live = torch.full((1,), n_live, **i32)
        if seed is None:
            self.x8 = torch.zeros((8, N), **f32)
            self.x16 = torch.zeros((16, N), **f32)
            self.live = torch.zeros((N // 512,), **i32)
            self.idx512 = torch.zeros((512,), **i32)
            self.bias = torch.zeros((total, 128), **f32)
            return
        rng = np.random.default_rng(seed)
        normal = lambda *shape: torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
        self.x8, self.x16, self.bias = normal(8, N), normal(16, N), normal(total, 128)
        self.live = torch.from_numpy(rng.permutation(N // 512).astype(np.int32)).to(dev)
        self.idx512 = torch.from_numpy(rng.integers(1, 512, 512, dtype=np.int32)).to(dev)

    def clone(self) -> "Operands":
        twin = copy.copy(self)
        for name, t in vars(self).items():
            setattr(twin, name, t.clone())
        return twin


def check_probe(name: str, run, plain, o: Operands, written: bool = True) -> float:
    """Hold a probe kernel whose operands are ``o`` to its plain version:
    run(o) launches the kernel, plain(twin) runs the plain version on a
    clone of o taken before. The outputs must be equal (an aliased
    output, o's own buffer, against the untouched clone's), and every
    operand must be as it was: these kernels read, at most, and write
    only their own outputs. ``written=False`` is for an output the kernel
    never writes (its contents unspecified, as on the TPU): its shape and
    type are checked. Returns the largest |kernel - plain|, 0.0."""
    twin = o.clone()
    got = run(o)
    want = plain(twin)
    if written:
        err = check_equal(name, got, want)
    elif (got.shape, got.dtype, got.device) != (want.shape, want.dtype, want.device):
        raise AssertionError(f"{name}: output {tuple(got.shape)} {got.dtype} {got.device}, "
                             f"not {tuple(want.shape)} {want.dtype} {want.device}")
    else:
        err = 0.0
    for op, t in vars(o).items():
        check_equal(f"{name}: operand {op} changed", t, getattr(twin, op))
    return err


def scatter_ms(dev, calls: int = 10) -> dict:
    """The scripts' XLA scatters of queue results into a frame: [8, qn]
    into a copy of [8, N] at qn = N/4 and N/16 (index_copy_; JAX's
    .at[].set copies too), device ms per call."""
    tgt = torch.zeros((8, N), dtype=torch.float32, device=dev)
    out = {}
    for qn in (N // 4, N // 16):
        qpix = (torch.arange(qn, dtype=torch.int64, device=dev) * 3) % N
        qval = torch.ones((8, qn), dtype=torch.float32, device=dev)
        out[f"scatter [8,{qn}] -> [8,N]"] = per_call_ms(
            lambda: tgt.clone().index_copy_(1, qpix, qval), calls)
    return out


# ---- the scheduling diagnostics' bench cell ----------------------------------

# A render is held to the same render through the plain versions with
# their products summed in k order (``in_order``, the kernels' order), as
# chip_smoke.py's phase 8 does first: every ray's bits equal. (Against the
# card's GEMM only agreement shares can hold, and they depend on the
# shapes cuBLAS sees: the full decoder's stride-16 level of one 512^2
# frame, 1,024 rays, moved 50,902 of 262,144 depths and 6.3% of the hits
# by more than 1e-5 on an H100, where the stride-4 pyramid moved none.)
PLAIN_FRAMES = 1     # frames of a render held to its plain versions
TRACE_FIELDS = ("depth", "hit", "min_sdf", "depth_at_min", "last_sdf", "steps",
                "unresolved", "weak")
RENDER_FIELDS = ("depth", "mask", "min_sdf", "normal")   # render()'s output


def load_bench(dev, root: str = ROOT):
    """bench.py's fixture on ``dev``: (params, dcfg, latent, (proxy, pcfg),
    (proxy_backoff, proxy_band)). The 8x512 decoder and its latent come
    from ``.bench_decoder.npz``, the 4x256 proxy from ``.bench_proxy.npz``
    and its margins from the error report stored there
    (``proxy_march_margins`` at eps 2e-3; 0.015 and 0.02 without one). A
    missing file is fitted (1,500 steps) or distilled (6,000 steps, latent
    jitter 0.002) on the card, as bench.py does, and written there."""
    from dist_renderer_tpu_torch.config import DecoderConfig
    from dist_renderer_tpu_torch.models.analytic import round_union, sphere_sdf, torus_sdf
    from dist_renderer_tpu_torch.models.pretrain import get_or_fit_cached
    from dist_renderer_tpu_torch.models.proxy import (
        default_proxy_cfg, get_or_distill_cached, load_proxy_meta,
        proxy_march_margins,
    )

    dcfg = DecoderConfig()
    shape = round_union(torus_sdf(0.55, 0.18), sphere_sdf(0.35, (0.0, 0.25, 0.0)), 0.08)
    params, latent = get_or_fit_cached(os.path.join(root, ".bench_decoder.npz"),
                                       lambda p: shape(None, p), dcfg, steps=1500,
                                       device=dev)
    ppath = os.path.join(root, ".bench_proxy.npz")
    proxy = get_or_distill_cached(ppath, params, dcfg, latent[None],
                                  proxy_cfg=default_proxy_cfg(dcfg, width=256, depth=4),
                                  steps=6000, latent_jitter=0.002)
    meta = load_proxy_meta(ppath)
    margins = proxy_march_margins(meta, 2e-3) if meta else (0.015, 0.02)
    return params, dcfg, latent, proxy, margins


def bench_camera(dev, img: int = 512):
    """The scripts' pinhole camera at (0, 0, -2.5), focal 1.2 img: (camera,
    origins [N, 3], dirs [N, 3])."""
    from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays

    cam = Camera.looking_at((0.0, 0.0, -2.5), focal=img * 1.2, img_hw=(img, img),
                            device=dev)
    return (cam,) + tuple(pixel_rays(cam, img, img))


def bench_latents(latent: torch.Tensor, frames: int, seed: int = 9) -> torch.Tensor:
    """[frames, L]: the bench latent + 0.001 N(0, 1) each, drawn from a CPU
    torch.Generator seeded with ``seed`` (the scripts' PRNGKey(9)); the
    first f rows of any draw are the draw of f."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    noise = torch.randn((frames, latent.shape[0]), generator=gen)
    return latent[None] + 0.001 * noise.to(latent.device)


class BenchCell:
    """The scripts' batched cell: the bench fixture, ``frames`` frames of
    img^2 through one pinhole camera, latents from ``bench_latents``,
    50 march steps at eps 2e-3 / 5e-4, c2f strides (16, 4) with 16 coarse
    steps, the proxy and its margins; weights packed once. ``fixture``:
    load_bench's tuple, if already loaded."""

    def __init__(self, dev, frames: int = 8, img: int = 512, steps: int = 50,
                 strides=(16, 4), coarse_steps: int = 16, seed: int = 9,
                 fixture=None):
        from dist_renderer_tpu_torch.config import MarchConfig
        from dist_renderer_tpu_torch.ops.kernels import batched_march as bm

        self.dev, self.frames, self.img = dev, frames, img
        self.fixture = fixture or load_bench(dev)
        (self.params, self.dcfg, self.latent, self.proxy,
         (self.backoff, self.band)) = self.fixture
        self.cam, self.origins, self.dirs = bench_camera(dev, img)
        self.lats = bench_latents(self.latent, frames, seed)
        self.strides, self.coarse_steps = tuple(strides), coarse_steps
        self.march = MarchConfig(max_steps=steps, convergence_eps=2e-3, depth_eps=5e-4,
                                 coarse_to_fine=True, c2f_strides=self.strides,
                                 c2f_coarse_steps=coarse_steps)
        self.packed = (bm.pack_shared(self.params, self.dcfg), bm.pack_shared(*self.proxy))

    def render(self, f: Optional[int] = None, proxy: bool = True,
               use_kernel: bool = True, march=None, **kw):
        """render_batched_c2f of the first f frames (default all) on the
        pinhole layout, at ``march`` (default the cell's); proxy=True
        marches the proxy with its margins (kw overrides any argument)."""
        from dist_renderer_tpu_torch.ops.kernels import batched_march as bm

        f = self.frames if f is None else f
        args = dict(strides=self.strides, coarse_steps=self.coarse_steps,
                    shared_origin=True, packed=self.packed, use_kernel=use_kernel)
        if proxy:
            args.update(proxy=self.proxy, proxy_backoff=self.backoff,
                        proxy_band=self.band)
        args.update(kw)
        with torch.no_grad():
            return bm.render_batched_c2f(self.params, self.dcfg, self.lats[:f],
                                         *self.rays(f), (self.img, self.img),
                                         march or self.march, **args)

    def rays(self, f: int):
        """(origins [f, 1, 3], dirs [f, N, 3]) of the first f frames."""
        return (self.origins[None, :1].expand(f, 1, 3),
                self.dirs[None].expand(f, self.img * self.img, 3))

    def frame_cfg(self, grad=None, proxy: bool = False, **march_kw):
        """bench.py's single-frame RenderConfig at the cell's march: the
        IFT gradient on an n/4 bucket (``grad``, default
        ``GradConfig(mode="ift", compact_frac=4)``), bf16 march, the
        kernels; proxy=True adds the proxy's margins (march_kw overrides
        any MarchConfig field)."""
        from dist_renderer_tpu_torch.config import GradConfig, RenderConfig

        if proxy:
            march_kw = dict(dict(proxy_backoff=self.backoff, proxy_band=self.band),
                            **march_kw)
        return RenderConfig(img_h=self.img, img_w=self.img,
                            march=dataclasses.replace(self.march, **march_kw),
                            grad=grad or GradConfig(mode="ift", compact_frac=4),
                            compute_dtype="bfloat16", use_pallas=True)

    def factory(self, cfg, proxy: bool = False, use_kernel: bool = True):
        """make_march_factory of the 8x512 decoder at ``cfg``, marching the
        proxy when proxy=True."""
        from dist_renderer_tpu_torch.ops.renderer import make_march_factory

        kw = dict(march_params=self.proxy[0], march_dcfg=self.proxy[1]) if proxy else {}
        return make_march_factory(self.params, self.dcfg, cfg, use_kernel=use_kernel, **kw)

    def sdf(self, use_kernel: bool = True):
        """The 8x512 decoder's precise value (make_precise_sdf)."""
        from dist_renderer_tpu_torch.models.decoder import make_precise_sdf

        return make_precise_sdf(self.params, self.dcfg, use_kernel)

    def frame_fns(self, cfg, factory, sdf=None):
        """(fwd, fwdbwd) of render() of the bench latent at ``cfg``: fwd
        under no_grad returns the RenderOutput, fwdbwd (out, gradient of
        the scripts' depth L1 to 1.5 over every pixel to the latent)."""
        from dist_renderer_tpu_torch.ops.renderer import render
        from dist_renderer_tpu_torch.utils.losses import masked_l1

        sdf = sdf or self.sdf()
        target = torch.full((self.img, self.img), 1.5, device=self.dev)
        everywhere = torch.ones((self.img, self.img), dtype=torch.bool, device=self.dev)

        def fwd():
            with torch.no_grad():
                return render(sdf, self.latent, self.cam, cfg, factory)

        def fwdbwd():
            z = self.latent.detach().clone().requires_grad_(True)
            out = render(sdf, z, self.cam, cfg, factory)
            return out, torch.autograd.grad(masked_l1(out.depth, target, everywhere), z)[0]

        return fwd, fwdbwd

    def hold_frame(self, name: str, cfg, out, proxy: bool = False) -> dict:
        """Hold render()'s output ``out`` at ``cfg`` to the same render
        through the plain versions with the in-order product, bit for bit
        (``hold_to_plain`` on depth, mask, min_sdf, normal)."""
        from dist_renderer_tpu_torch.ops.renderer import render

        with torch.no_grad(), in_order():
            plain = render(self.sdf(False), self.latent, self.cam, cfg,
                           self.factory(cfg, proxy, use_kernel=False))
        return hold_to_plain(name, out, plain, RENDER_FIELDS)

    def timed_render(self, reps: int = 1, held: bool = True, **kw):
        """(output, median device ms of ``reps`` renders after a warm-up,
        CUDA events, and how it held to its plain versions): render(**kw),
        its first PLAIN_FRAMES frames held to the same render through the
        plain versions with the in-order product (``hold_to_plain``;
        held=False: not held)."""
        out, ms = time_ms(lambda: self.render(**kw), reps)
        check = None
        if held:
            trace = out[0] if kw.get("with_diag") else out
            pkw = {k: v for k, v in kw.items() if k not in ("f", "with_diag")}
            if kw.get("scheduler") == "auto":   # the scheduler of the render's F
                pkw["scheduler"] = "queue" if kw.get("f", self.frames) == 1 else "rounds"
            with in_order():
                plain = self.render(f=PLAIN_FRAMES, use_kernel=False, **pkw)
            check = hold_to_plain(str(kw), trace, plain)
        return out, ms, check


def time_ms(fn, reps: int = 1):
    """(fn()'s last output, median device ms of ``reps`` calls after one
    warm-up call), CUDA events around each call."""
    out = fn()
    times = []
    for _ in range(reps):
        out, t = timed(fn)
        times.append(t)
    return out, statistics.median(times)


def busy_split(fn, ms: float, top: int = 4) -> dict:
    """One more call of fn() under torch.profiler (``device_kernels``):
    the card's kernel time (``device_ms``, the sum of every kernel's), its
    idle share of ``ms`` (fn's CUDA-event time from the same process), the
    launches and the ``top`` kernels by device ms."""
    kernels, launches = device_kernels(fn)
    busy = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ms=busy, idle_share=1.0 - busy / ms, launches=int(launches),
                top_ms={k[:80]: v for k, v in ranked})


def hold_to_plain(name: str, got, want, fields=TRACE_FIELDS) -> dict:
    """Raise unless the kernels' render ``got`` (at least as many frames)
    and the same render of its first frames through the plain versions
    with the in-order product, ``want``, carry the same bits in every
    field both have (render_batched_c2f's StageResult, or render()'s
    output with fields depth, mask, min_sdf, normal). Returns the frames
    held and the rays whose bits differ per field (all 0)."""
    f = want.depth.shape[0]
    diff = {}
    for k in fields:
        a, b = getattr(got, k, None), getattr(want, k, None)
        if a is not None and b is not None:
            diff[k] = int(differ(a[:f], b).sum())
    if any(diff.values()):
        raise AssertionError(f"{name}: the kernels' render differs from the plain "
                             f"versions' with the in-order product: rays differing {diff}")
    return dict(frames=f, rays_differing=diff)


@contextlib.contextmanager
def in_order():
    """The plain versions' products summed in k order, the kernels' order
    (decoder.dot_f32_in_order), inside the block: the plain versions then
    give the march kernels' bits."""
    from dist_renderer_tpu_torch.models.decoder import dot_f32_in_order
    from dist_renderer_tpu_torch.ops.kernels import march_body, recompute

    real = march_body.dot_f32, recompute.dot_f32
    march_body.dot_f32 = recompute.dot_f32 = dot_f32_in_order
    try:
        yield
    finally:
        march_body.dot_f32, recompute.dot_f32 = real


def differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Where two outputs' bits differ (NaN equals NaN)."""
    if a.is_floating_point():
        return (a != b) & ~(a.isnan() & b.isnan())
    return a != b


def quantiles(x, qs=(50, 95)) -> dict:
    """The p50, p95 (``qs``) and max of a tensor or array of errors (n 0:
    none), as the scripts print them."""
    a = np.asarray(x.detach().double().cpu() if isinstance(x, torch.Tensor) else x,
                   dtype=np.float64).ravel()
    if a.size == 0:
        return dict(n=0)
    return dict(n=int(a.size), **{f"p{q}": float(np.percentile(a, q)) for q in qs},
                max=float(a.max()))


def compare_routes(a, ga, b, gb, dirs) -> dict:
    """Two renders of one frame (RenderOutputs a, b, and their latent
    gradients ga, gb): hit agreement, the depth difference on common hits
    (shares within 1e-5 and 1e-3, max, p95 on the frontal ones, |<n, v>|
    > 0.2 with a's normal), and the gradients' cosine and relative L2."""
    both = a.mask & b.mask
    dd = (a.depth - b.depth).detach().abs()
    frontal = both & ((a.normal * dirs.reshape(a.normal.shape)).sum(-1).abs() > 0.2)
    return dict(hit_agree=float((a.mask == b.mask).float().mean()),
                within_1e5=float((dd[both] <= 1e-5).float().mean()),
                within_1e3=float((dd[both] <= 1e-3).float().mean()),
                max=float(dd[both].max()) if both.any() else 0.0,
                frontal_p95=float(dd[frontal].quantile(0.95)) if frontal.any() else 0.0,
                frontal_share=float(frontal.sum() / max(int(both.sum()), 1)),
                grad_cos=float(ga @ gb / (ga.norm() * gb.norm())),
                grad_rel=float((gb - ga).norm() / ga.norm()))


# chip_smoke.py phase 12 (f)'s bars between two recompute routes of one
# render: the IFT denominator of all but the K3 route is a bf16 slope
# (fused_dd's tangent, the xla route's march-function gradient), ~1e-2
# relative, so a grazing hit's depth moves by its |f| times that over
# |dd|: tests/test_parity.py's p95 on the frontal common hits, and the
# whole-render gradient bars of tests/test_torch_grad.py
ROUTE_BARS = dict(hit_agree=0.999, frontal_p95=1e-3, grad_cos=0.999, grad_rel=3e-2)


def routes_within(name: str, cmp: dict) -> None:
    """Raise unless compare_routes' numbers hold ROUTE_BARS."""
    b = ROUTE_BARS
    if not (cmp["hit_agree"] >= b["hit_agree"] and cmp["frontal_p95"] <= b["frontal_p95"]
            and cmp["grad_cos"] >= b["grad_cos"] and cmp["grad_rel"] <= b["grad_rel"]):
        raise AssertionError(f"{name}: the routes differ beyond the bars {b}: {cmp}")


def summary(x) -> dict:
    """Mean, p50, p90, max, share of zeros and sum of a tensor of counts."""
    a = x.detach().flatten().double().cpu().numpy()
    if a.size == 0:
        return dict(n=0)
    return dict(n=int(a.size), sum=float(a.sum()), mean=float(a.mean()),
                p50=float(np.percentile(a, 50)), p90=float(np.percentile(a, 90)),
                max=float(a.max()), zero_frac=float((a == 0).mean()))


def residency(diag: dict) -> dict:
    """Each residency of a with_diag render as tiles, tile-steps (its sum)
    and lane-steps (64 a tile-step), beside its statistics."""
    from dist_renderer_tpu_torch.ops.kernels.batched_march import MARCH_TILE

    out = {}
    for k, v in diag.items():
        if k.endswith("_block_residency"):
            s = summary(v)
            s["lane_steps"] = s.get("sum", 0.0) * MARCH_TILE
            out[k[:-len("_block_residency")]] = s
    return out


def stage_lanes(diag: dict, fine_ray_steps: int, verify_ray_steps=None) -> dict:
    """Per stage of a with_diag render, the lane-steps its march launches
    paid (64 a tile-step) against the active ray-steps it needed: each
    coarse level (its ray steps), the fine stage's rounds (the render's
    ``fine_ray_steps``) and the verify stage's rounds (``verify_ray_steps``,
    when given). The ratio is what the tiles' stragglers cost."""
    from dist_renderer_tpu_torch.ops.kernels.batched_march import MARCH_TILE

    lanes = lambda pre: MARCH_TILE * sum(int(v.sum()) for k, v in diag.items()
                                         if k.startswith(pre) and k.endswith("_block_residency"))
    stages = {}
    for k, v in diag.items():
        if k.startswith("coarse") and k.endswith("_ray_steps"):
            name = k[:-len("_ray_steps")]
            stages[name] = (lanes(name + "_"), int(v.sum()))
    stages["fine"] = (lanes("fine_r"), int(fine_ray_steps))
    if verify_ray_steps is not None:
        stages["verify"] = (lanes("verify_fine_r"), int(verify_ray_steps))
    return {k: dict(lane_steps=a, ray_steps=b, ratio=a / b if b else None)
            for k, (a, b) in stages.items()}


def parser(doc: str):
    """An argument parser whose description is the module's docstring."""
    import argparse

    return argparse.ArgumentParser(description=doc.split("\n\n")[0],
                                   formatter_class=argparse.RawDescriptionHelpFormatter)
