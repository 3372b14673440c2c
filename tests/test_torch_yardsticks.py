"""chip_smoke.py's library yardstick for K3 and K4 (precise_chain: the
folded decoder and its reverse sweep as a chain of F.linear calls) computes
their function: on fp32 weights and activations it equals the fp64
autograd truth (folded_reference) on the bench 8x512 decoder and on the
recompute tests' decoders (a skip layer, xyz in every layer, tanh). The
bf16 chain whose time fills K3's and K4's library column differs from it
only by its roundings.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.models.pretrain import load_params_npz

from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)
from test_torch_recompute import ARCHS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               os.path.join(ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _decoder(which):
    if which == "bench":
        params, z0 = load_params_npz(os.path.join(ROOT, ".bench_decoder.npz"))
        return params, DecoderConfig(), z0
    cfg = DecoderConfig(**ARCHS[which])
    rng = np.random.default_rng(which)
    params = params_from_numpy({"layers": [
        {"w": rng.standard_normal((i, o)) * np.sqrt(2.0 / i),
         "b": 0.05 * rng.standard_normal(o)} for i, o in cfg.layer_dims]})
    z = torch.as_tensor(0.3 * rng.standard_normal(cfg.latent_size), dtype=torch.float32)
    return params, cfg, z


@pytest.mark.parametrize("which", ["bench", 0, 1, 2])
def test_fp32_precise_chain_equals_the_fp64_truth(which):
    params, cfg, z = _decoder(which)
    rng = np.random.default_rng(7)
    pts = torch.as_tensor(rng.uniform(-0.6, 0.6, (512, 3)), dtype=torch.float32)
    dirs = torch.nn.functional.normalize(
        torch.as_tensor(rng.standard_normal((512, 3)), dtype=torch.float32), dim=-1)
    ct = torch.as_tensor(rng.standard_normal(512), dtype=torch.float32)
    chain = smoke.precise_chain(torch, params, cfg, z, dtype=torch.float32)
    s, dd, g = chain.sdg(pts, dirs)
    u = torch.cat(chain.bias_grads(pts, ct))
    s64, g64, u64, _ = smoke.folded_reference(torch, params, cfg, z, pts, ct)
    rel = lambda a, b: ((a.double() - b).norm() / b.norm()).item()
    assert rel(s, s64) <= 1e-5 and rel(g, g64) <= 1e-5 and rel(u, u64) <= 1e-5
    assert rel(dd, (g64 * dirs.double()).sum(-1)) <= 1e-5
    # the bf16 chain computes the same function, up to its roundings
    s16, _, g16 = smoke.precise_chain(torch, params, cfg, z).sdg(pts, dirs)
    assert rel(s16, s64) <= 0.05 and rel(g16, g64) <= 0.2
