"""The work arithmetic against a hand count, and each per-layer reader on
a synthetic profile."""

import pytest

from helpers import ROOT  # noqa: F401  (puts the repository on the path)
from port_bench import trace as tr
from port_bench.context import Context
from port_bench.harness import load_json, reader
from port_bench.work import PEAK_BF16, folded_macs, layer_dims


def test_folded_macs_match_a_hand_count():
    # 8x512, latent 256, skip at layer 4: xyz into 512; 512x512 twice;
    # 512 -> 512 - 259 = 253; (253 + xyz) into 512; 512x512 three times; 512 -> 1
    hand = 3 * 512 + 2 * 512 * 512 + 512 * 253 + (253 + 3) * 512 + 3 * 512 * 512 + 512
    assert hand == 1_573_376
    assert folded_macs(256, [512] * 8, [4]) == 1_573_376
    # the 4x256 proxy has no skip: xyz into 256, 256x256 three times, 256 -> 1
    assert 3 * 256 + 3 * 256 * 256 + 256 == 197_632
    assert folded_macs(256, [256] * 4, []) == 197_632


@pytest.mark.parametrize("hidden,latent_in", [((512,) * 8, (4,)), ((256,) * 4, ()),
                                              ((64,) * 6, (2, 4))])
def test_layer_dims_follow_the_decoder_rule(hidden, latent_in):
    from dist_renderer_tpu_torch.config import DecoderConfig

    want = DecoderConfig(latent_size=16, hidden_dims=hidden, latent_in=latent_in).layer_dims
    assert layer_dims(16, hidden, latent_in) == want


def _trace():
    """A 10 ms window: K1 2-4 ms, glue 3-5 ms (overlapping), K2 6-7 ms, a
    copy 8-8.5 ms; host spans: render 1-7 ms, d2h 7.5-9 ms."""
    ms = 1e-3
    ops = [("void drt::mm::march_mma_kernel<true>(drt::mm::MarchArgs)", 2 * ms, 4 * ms),
           ("void at::native::vectorized_elementwise_kernel<4>", 3 * ms, 5 * ms),
           ("queue_generation_kernel(drt::mm::MarchArgs)", 6 * ms, 7 * ms),
           ("Memcpy DtoH (Device -> Pageable)", 8 * ms, 8.5 * ms),
           ("void at::native::late_kernel", 9.5 * ms, 11 * ms)]   # past the window's end
    spans = [("render", 1 * ms, 7 * ms), ("d2h", 7.5 * ms, 9 * ms)]
    return tr.TraceData((0.0, 10 * ms), ops, spans)


def test_busy_idle_and_gaps():
    t = _trace()
    assert tr.busy_intervals(t) == [(0.002, 0.005), (0.006, 0.007), (0.008, 0.0085),
                                    (0.0095, 0.01)]
    assert tr.busy_s(t) == pytest.approx(0.005)
    gaps = tr.idle_gaps(t)
    assert [(n, round(a, 4), round(b, 4)) for n, a, b in gaps] == [
        ("harness", 0.0, 0.002), ("render", 0.005, 0.006), ("harness", 0.007, 0.008),
        ("d2h", 0.0085, 0.0095)]
    bd = tr.breakdown(t, top=2)
    assert bd["device_ops"][0][0].startswith("void drt::mm::march_mma_kernel")
    assert bd["device_ops"][0][1] == pytest.approx(0.002)
    assert [g[0] for g in bd["idle_gaps"]] == ["harness", "render"]


def _ctx():
    kernels = tr.source_kernels(f"{ROOT}/dist_renderer_tpu_torch/csrc")
    work = {"K1": 1e12, "K2": 2e11, "all": 1.3e12}
    return Context(_trace(), work, units=2, answered=4, source_kernels=kernels)


def test_readers_on_a_synthetic_profile():
    ctx = _ctx()
    assert reader("idle.batch")(ctx) == pytest.approx(50.0)
    assert reader("idle.frame")(ctx) == pytest.approx(50.0)
    assert reader("mfu.batch")(ctx) == pytest.approx(100 * 1.3e12 / (0.01 * PEAK_BF16))
    assert reader("k1_roofline.batch")(ctx) == pytest.approx(100 * 1e12 / PEAK_BF16 / 0.002)
    assert reader("k2_roofline.frame")(ctx) == pytest.approx(100 * 2e11 / PEAK_BF16 / 0.001)
    # glue: every operation not from csrc/ inside the window: the
    # elementwise kernel 2 ms, the copy 0.5 ms, the late kernel's 0.5 ms
    assert reader("glue_ms.batch")(ctx) == pytest.approx(1e3 * 0.003 / 4)


def test_a_reader_with_nothing_to_read_returns_nothing():
    ctx = _ctx()._replace(trace=tr.TraceData((0.0, 0.01), [], []), work={})
    for name in ("idle.batch", "mfu.frame", "k1_roofline.batch", "k2_roofline.frame",
                 "glue_ms.batch"):
        assert reader(name)(ctx) is None, name


def test_source_kernels_are_found_by_name():
    ks = tr.source_kernels(f"{ROOT}/dist_renderer_tpu_torch/csrc")
    assert {"march_mma_kernel", "queue_generation_kernel", "precise_kernel"} <= set(ks)
    assert tr.is_source_kernel("void drt::mm::march_mma_kernel<true>(drt::mm::MarchArgs)", ks)
    assert not tr.is_source_kernel("void at_cuda_detail::cub::DeviceScanKernel<...>", ks)


def test_every_per_layer_metric_has_a_reader():
    bench = load_json(ROOT, "BENCHMARK.json")
    for m in bench["per_layer"]:
        assert callable(reader(m["name"])), m["name"]
