"""The port's profiling and debug helpers (utils/profiling.py,
utils/debug.py), mirroring tests/test_profiling_debug.py, and
march_efficiency against the JAX package's on the same live counts."""

import jax.numpy as jnp
import pytest
import torch

from dist_renderer_tpu.utils.profiling import march_efficiency as jmarch_efficiency
from dist_renderer_tpu_torch.config import MarchConfig
from dist_renderer_tpu_torch.models.analytic import sphere_sdf
from dist_renderer_tpu_torch.ops.camera import Camera, pixel_rays
from dist_renderer_tpu_torch.ops.tracer import TraceResult, sphere_trace
from dist_renderer_tpu_torch.utils import profiling
from dist_renderer_tpu_torch.utils.debug import checkify_render, debug_mode
from dist_renderer_tpu_torch.utils.profiling import Timer, march_efficiency


def test_timer_records():
    t = Timer()
    out = t.timeit("matmul", lambda: torch.ones((32, 32)) @ torch.ones((32, 32)),
                   warmup=1, iters=2)
    assert torch.equal(out, torch.full((32, 32), 32.0))
    with t.time("matmul", result=out):
        pass
    s = t.summary()
    assert "matmul" in s and s["matmul"]["mean_ms"] >= 0.0 and s["matmul"]["count"] == 2
    assert set(s["matmul"]) == {"mean_ms", "min_ms", "count"}
    assert "matmul" in t.dump()


def test_march_efficiency_reports_savings():
    cam = Camera.looking_at((0.0, 0.0, -2.0), focal=40.0, img_hw=(32, 32))
    o, v = pixel_rays(cam, 32, 32)
    f = lambda p: sphere_sdf(0.5)(None, p)
    res = sphere_trace(f, o, v, MarchConfig(max_steps=64))
    eff = march_efficiency(res)
    assert eff["ray_steps"] > 0
    assert eff["savings"] >= 1.0  # live set shrinks => fewer than naive


@pytest.mark.parametrize("counts", [[1024, 800, 512, 100, 3, 0, 0], [0, 0], [7]])
def test_march_efficiency_matches_jax(counts):
    class J:
        live_counts = jnp.asarray(counts, jnp.int32)

    res = TraceResult(*([None] * 6), live_counts=torch.tensor(counts, dtype=torch.int32),
                      unresolved=None)
    assert march_efficiency(res) == jmarch_efficiency(J)


def test_debug_mode_restores_flags():
    before = torch.is_anomaly_enabled()
    with debug_mode(nans=True):
        assert torch.is_anomaly_enabled() is True
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor([-1.0]))
    assert torch.is_anomaly_enabled() == before
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()  # no check outside
    with debug_mode(nans=False):
        assert torch.is_anomaly_enabled() is False
        torch.log(torch.tensor([-1.0]))
    assert torch.is_anomaly_enabled() == before


def test_checkify_catches_nan():
    def f(x):
        return torch.log(x)  # nan for x < 0

    checked = checkify_render(f)
    err, out = checked(torch.tensor([-1.0]))
    assert err.get() is not None  # NaN reported, not silently propagated
    with pytest.raises(FloatingPointError):
        err.throw()
    err, out = checked(torch.tensor([2.0]))
    assert err.get() is None
    err.throw()


def test_card_timers_refuse_without_a_card(monkeypatch):
    """A timer of the card raises without one: no CPU time is reported as
    the card's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for timer in (profiling.cuda_ms, profiling.host_us, profiling.graph_us,
                  profiling.per_call_ms):
        with pytest.raises(RuntimeError, match="CUDA card"):
            timer(lambda: None)


def test_device_profile_writes_a_trace(tmp_path):
    with profiling.device_profile(str(tmp_path)):
        with profiling.annotate("region"):
            torch.ones(4) + 1
    assert (tmp_path / "trace.json").exists()
    assert "region" in (tmp_path / "trace.json").read_text()
