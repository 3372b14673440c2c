"""The port's ``batched_render`` CLI against the JAX package's, on the
CPU (``--cpu``) at 2 latents x 2 views of 32x32, 24 march steps, on the
committed torus 8x512 decoder cache. Both draw the same latent offsets
(the JAX CLI's, handed to the port's ``latent_draws``); the JAX side runs
its kernels in interpret mode.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from dist_renderer_tpu.tasks import batched_render as jbatched_render
from dist_renderer_tpu_torch.tasks import batched_render
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

N = 32 * 32


TINY = ["--cpu", "--img", "32", "--march-steps", "24", "--latents", "2",
        "--views", "2", "--fast"]


def _jax_draws(n, size, device):
    """The JAX CLI's latent draws (its PRNGKey(0))."""
    return torch.as_tensor(np.array(jax.random.normal(jax.random.PRNGKey(0),
                                                      (n, size)))).to(device)


def _jax_cli(argv, capsys, verify_hits="march", monkeypatch=None):
    if verify_hits != "march":
        make = jbatched_render.make_render_cfg
        monkeypatch.setattr(jbatched_render, "make_render_cfg", lambda a: dataclasses.replace(
            make(a), march=dataclasses.replace(make(a).march, proxy_verify_hits=verify_hits)))
    capsys.readouterr()
    jbatched_render.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("path", [["--pallas", "--proxy", ".bench_proxy.npz"], []])
def test_batched_render_cli_matches_jax(path, capsys, monkeypatch):
    """The port's CLI against the JAX package's on the committed torus
    8x512 decoder (the bench proxy is another shape's: the verify stage
    keeps the torus's hits). --pallas: the same trace, hit_frac within
    1e-3; the render_rays path marches the bf16 point function, whose
    CPU sums differ between the packages: hit_frac within 2e-3."""
    monkeypatch.setattr(batched_render, "latent_draws", _jax_draws)
    argv = TINY + path
    ref = _jax_cli(argv, capsys)
    out = batched_render.main(argv)
    tol = 1e-3 if path else 2e-3
    assert out["total_rays"] == ref["total_rays"] == 4 * N
    assert abs(out["hit_frac"] - ref["hit_frac"]) <= tol and out["hit_frac"] > 0.005
    assert abs(out["mean_hit_depth"] - ref["mean_hit_depth"]) <= 2e-2 * ref["mean_hit_depth"]
    if path:
        assert out["chunk_frames"] == 4


def test_batched_render_cli_stream_and_chunks(monkeypatch):
    """--stream reduces every chunk to its hit count and depth sum: the
    same hit_frac and mean depth as keeping the maps, whatever the chunk."""
    monkeypatch.setattr(batched_render, "latent_draws", _jax_draws)
    argv = TINY + ["--pallas"]
    kept = batched_render.main(argv)
    out = batched_render.main(argv + ["--stream", "--chunk", "2"])
    assert out["hit_frac"] == kept["hit_frac"] and out["chunk_frames"] == 2
    assert abs(out["mean_hit_depth"] - kept["mean_hit_depth"]) <= 1e-4
    with pytest.raises(SystemExit):
        batched_render.main(argv + ["--chunk", "3"])


def test_batched_render_cli_counts_finalized_hits(capsys, monkeypatch):
    """Under --verify-hits polish the port's hit_frac counts the hits
    finalize_hits_batched leaves; the JAX CLI's counts the trace's
    unverified proxy hits (ROADMAP C), which the port's trace reproduces."""
    from dist_renderer_tpu_torch.ops import renderer as trenderer

    monkeypatch.setattr(batched_render, "latent_draws", _jax_draws)
    argv = TINY + ["--pallas", "--proxy", ".bench_proxy.npz"]
    ref = _jax_cli(argv, capsys, "polish", monkeypatch)
    seen = {}
    finalize = trenderer.finalize_hits_batched

    def spy(*a, **kw):
        seen["trace_hits"] = seen.get("trace_hits", 0) + int(a[6].sum())
        out = finalize(*a, **kw)
        seen["hits"] = seen.get("hits", 0) + int(out[1].sum())
        return out

    monkeypatch.setattr(batched_render, "finalize_hits_batched", spy)
    out = batched_render.main(argv + ["--verify-hits", "polish"])
    # one call of every chunk (no warm-up on the CPU)
    trace_frac, final_frac = (seen[k] / out["total_rays"] for k in ("trace_hits", "hits"))
    assert out["hit_frac"] == round(final_frac, 4)
    assert abs(ref["hit_frac"] - trace_frac) <= 1e-3
    assert trace_frac - final_frac > 5e-3      # the finalize demoted hits
