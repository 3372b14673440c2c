"""The port's ``batched_render --scan`` on the CPU (``--cpu``), at the CLI
tests' scene (tests/test_torch_batched_cli.py: 2 latents x 2 views of
32x32, 24 march steps, --fast, the committed torus 8x512 decoder and the
bench proxy, the JAX CLI's latent draws).

On the CPU --scan runs the chunk loop inside ``batched_march.host_free()``
with no capture: every round at the full width, both finalize branches
with the choice made on the device, and the plain march to its whole step
budget. Its hit count and fp64 depth sum must equal the host loop's
exactly (the eager call's bits, as host_free() documents), and the loop
must make no host read: a
``TorchDispatchMode`` that raises on every op that reads the device on
the host runs around it, and trips on the eager loop's width choice
(``fine_march_rounds``' ``fit``). Against the JAX CLI's --scan (Pallas in
interpret mode, as tests/test_tasks.py runs it): tests/test_torch_batched_cli.py's
bars, hit_frac within 1e-3 and the mean hit depth within 2e-2 relative.
"""

import json
import traceback

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dist_renderer_tpu.ops.tracer import live_counts_from_steps as jlive_counts
from dist_renderer_tpu.tasks import batched_render as jbatched_render
from dist_renderer_tpu_torch.ops.kernels import batched_march as bm
from dist_renderer_tpu_torch.ops.kernels import march_body
from dist_renderer_tpu_torch.ops.tracer import live_counts_from_steps
from dist_renderer_tpu_torch.tasks import batched_render
from test_torch_batched_cli import _jax_draws
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

TINY = ["--cpu", "--img", "32", "--march-steps", "24", "--fast", "--latents", "2",
        "--views", "2", "--pallas", "--proxy", ".bench_proxy.npz", "--stream"]
CASES = [(vh, chunk) for vh in ("march", "polish") for chunk in (None, 2)]
aten = torch.ops.aten


class HostRead(RuntimeError):
    pass


class HostReadGuard(TorchDispatchMode):
    """Raises HostRead on every op that reads a tensor's values on the host
    (a device sync on the card): a scalar read (.item(), int(), bool()),
    and the ops whose output size depends on the data (bincount, nonzero,
    unique, masked_select, repeat_interleave without output_size, indexing
    with a bool mask). Counts the ops it lets through."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        banned = func in (aten._local_scalar_dense.default, aten.bincount.default,
                          aten.nonzero.default, aten._unique2.default,
                          aten.masked_select.default)
        banned |= func is aten.repeat_interleave.Tensor and kwargs.get("output_size") is None
        banned |= func is aten.index.Tensor and any(
            i is not None and i.dtype == torch.bool for i in args[1])
        if banned:
            raise HostRead(f"{func} reads the device on the host")
        self.ops += 1
        return func(*args, **kwargs)


def _argv(vh, chunk, scan=False):
    return (TINY + ["--verify-hits", vh] + ([] if chunk is None else ["--chunk", str(chunk)])
            + (["--scan"] if scan else []))


@pytest.fixture(scope="module")
def runs():
    """Each case's host loop and --scan results, the --scan loop (every
    chunk) under HostReadGuard, with the ops it let through."""
    out = {}
    real = batched_render.stream_sums

    def guarded(cs):
        guard = HostReadGuard()
        with guard:
            res = real(cs)
        out["guarded_ops"].append(guard.ops)
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batched_render, "latent_draws", _jax_draws)
        for vh, chunk in CASES:
            host = batched_render.main(_argv(vh, chunk))
            out["guarded_ops"] = []
            mp.setattr(batched_render, "stream_sums", guarded)
            scan = batched_render.main(_argv(vh, chunk, scan=True))
            mp.setattr(batched_render, "stream_sums", real)
            out[vh, chunk] = dict(host=host, scan=scan, guarded_ops=out.pop("guarded_ops"))
    return out


@pytest.mark.parametrize("vh,chunk", CASES)
def test_scan_equals_the_host_loop(runs, vh, chunk):
    """--scan's hit count and fp64 depth sum equal the host loop's exactly,
    and so its result line; the loop ran once, under the guard."""
    r = runs[vh, chunk]
    host, scan = r["host"], r["scan"]
    assert (scan["hits"], scan["depth_sum"]) == (host["hits"], host["depth_sum"])
    assert host["hit_frac"] > 0.005
    assert {k: v for k, v in scan.items() if k != "seconds" and k != "Mrays_per_s"} == {
        k: v for k, v in host.items() if k != "seconds" and k != "Mrays_per_s"}
    assert scan["chunk_frames"] == (chunk or 4)
    assert len(r["guarded_ops"]) == 1 and r["guarded_ops"][0] > 1000


def test_scan_chunk_must_divide(monkeypatch):
    monkeypatch.setattr(batched_render, "latent_draws", _jax_draws)
    with pytest.raises(SystemExit):
        batched_render.main(_argv("march", 3, scan=True))


@pytest.mark.parametrize("vh", ["march", "polish"])
def test_host_read_guard_trips_on_the_eager_loop(runs, vh, monkeypatch):
    """The guard let the host_free() loop of every chunk through (the
    runs fixture); on the eager body of one chunk it trips, at fit's live
    count (the plain march's own early exit, a read the card's kernels do
    not make, kept out of the way)."""
    assert all(n > 1000 for chunk in (None, 2) for n in runs[vh, chunk]["guarded_ops"])
    args = batched_render.parse_args(_argv(vh, None))
    cs = batched_render.chunk_stream(args, batched_render.scene(args))
    monkeypatch.setattr(march_body, "in_host_free", lambda: True)
    with pytest.raises(HostRead) as info, HostReadGuard():
        cs.render_chunk(cs.chunks[0])
    frames = [f.name for f in traceback.extract_tb(info.tb)]
    assert "fit" in frames and "fine_march_rounds" in frames, frames
    with bm.host_free(), HostReadGuard():
        assert march_body.in_host_free() and bm.in_host_free()
    assert not bm.in_host_free()


def test_scan_matches_jax_scan(runs, capsys):
    """The port's --scan against the JAX CLI's (one lax.map over the chunks
    in one jit, Pallas in interpret mode), under --verify-hits march at the
    default chunk: tests/test_torch_batched_cli.py's bars."""
    capsys.readouterr()
    jbatched_render.main([a for a in _argv("march", None, scan=True)
                          if a not in ("--verify-hits", "march")])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = runs["march", None]["scan"]
    assert ref["total_rays"] == out["total_rays"] and ref["chunk_frames"] == 4
    assert abs(out["hit_frac"] - ref["hit_frac"]) <= 1e-3 and out["hit_frac"] > 0.005
    assert abs(out["mean_hit_depth"] - ref["mean_hit_depth"]) <= 2e-2 * ref["mean_hit_depth"]


def test_live_counts_need_no_host_read():
    """live_counts_from_steps (fixed bins, no bincount) equals the bincount
    version and JAX's on random steps, 0 and max_steps included, beyond
    the clamp too, with no host read."""
    rng = np.random.default_rng(0)
    for max_steps in (1, 24, 50):
        s = rng.integers(-3, max_steps + 4, size=4096).astype(np.int32)
        s[:3] = (0, max_steps, max_steps)
        c = torch.cumsum(torch.bincount(torch.as_tensor(s).clamp(0, max_steps).long(),
                                        minlength=max_steps + 1), 0)
        with HostReadGuard():
            got = live_counts_from_steps(torch.as_tensor(s), max_steps)
        assert got.dtype == torch.int32 and torch.equal(got, (c[-1] - c[:-1]).int())
        assert np.array_equal(got.numpy(), np.asarray(jlive_counts(jax.numpy.asarray(s),
                                                                   max_steps)))
