"""Checkpoint I/O of the PyTorch port against the JAX package: DeepSDF
experiment directories (the published weight-normed layout and each
package's export), the decoder and proxy npz files, and the saved state
of an optimization loop.

Bars: files cross between the packages bit for bit (both fold weight
norm in numpy from the same float32 tensors, and write float32 as they
read it); a forward of the loaded published decoder matches JAX's
fp32 forward within 1e-6 (two fp32 GEMMs summing 512 terms in their own
orders; measured 9.3e-9) and the torch module it was saved from within
2e-6, JAX's own bar (measured 5.6e-9).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.models import checkpoint as jck
from dist_renderer_tpu.models import decoder as jdec
from dist_renderer_tpu.models import pretrain as jpre
from dist_renderer_tpu.models import proxy as jproxy
from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models import checkpoint as tck
from dist_renderer_tpu_torch.models import decoder as tdec
from dist_renderer_tpu_torch.models import pretrain as tpre
from dist_renderer_tpu_torch.models import proxy as tproxy
from test_torch_decoder import _weights

EPOCH = 2000
CODE_LEN = 256
DIMS = [512] * 8
FWD_TOL = 1e-6

# the field set of facebookresearch/DeepSDF's examples/chairs/specs.json
PUBLISHED_SPECS = {
    "Description": ["chairs experiment"],
    "DataSource": "data/",
    "TrainSplit": "examples/splits/sv2_chairs_train.json",
    "TestSplit": "examples/splits/sv2_chairs_test.json",
    "NetworkArch": "deep_sdf_decoder",
    "NetworkSpecs": {
        "dims": DIMS,
        "dropout": [0, 1, 2, 3, 4, 5, 6, 7],
        "dropout_prob": 0.2,
        "norm_layers": [0, 1, 2, 3, 4, 5, 6, 7],
        "latent_in": [4],
        "xyz_in_all": False,
        "use_tanh": False,
        "latent_dropout": True,
        "weight_norm": True,
    },
    "CodeLength": CODE_LEN,
    "NumEpochs": 2000,
    "SnapshotFrequency": 100,
    "AdditionalSnapshots": [1, 5],
    "LearningRateSchedule": [
        {"Type": "Step", "Initial": 0.0005, "Interval": 500, "Factor": 0.5},
        {"Type": "Step", "Initial": 0.001, "Interval": 500, "Factor": 0.5},
    ],
    "SamplesPerScene": 16384,
    "ScenesPerBatch": 64,
    "DataLoaderThreads": 16,
    "ClampingDistance": 0.1,
    "CodeRegularization": True,
    "CodeRegularizationLambda": 1e-4,
}


class PublishedDecoder(nn.Module):
    """DeepSDF's decoder construction (deep_sdf/networks/deep_sdf_decoder.py):
    nn.Linear layers lin0..lin8, weight norm on every layer in norm_layers,
    the output shrunk before a latent_in skip layer, a final tanh."""

    def __init__(self, latent_size, dims, latent_in, norm_layers):
        super().__init__()
        dims = [latent_size + 3] + list(dims) + [1]
        self.num_layers = len(dims)
        self.latent_in = latent_in
        for layer in range(self.num_layers - 1):
            out_dim = dims[layer + 1] - (dims[0] if layer + 1 in latent_in else 0)
            lin = nn.Linear(dims[layer], out_dim)
            if layer in norm_layers:
                lin = nn.utils.weight_norm(lin)
            setattr(self, "lin" + str(layer), lin)

    def forward(self, inp):
        x = inp
        for layer in range(self.num_layers - 1):
            if layer in self.latent_in:
                x = torch.cat([x, inp], 1)
            x = getattr(self, "lin" + str(layer))(x)
            if layer < self.num_layers - 2:
                x = torch.relu(x)
        return torch.tanh(x)


def _published_decoder():
    torch.manual_seed(0)
    return PublishedDecoder(CODE_LEN, DIMS, latent_in=[4],
                            norm_layers=[0, 1, 2, 3, 4, 5, 6, 7])


@pytest.fixture(scope="module")
def published_dir(tmp_path_factory):
    """What DeepSDF's train_deep_sdf.py writes: the DataParallel "module."
    prefix on weight-normed layers, {"epoch", "model_state_dict"}, and the
    latent table as an nn.Embedding's state_dict."""
    exp = str(tmp_path_factory.mktemp("deepsdf") / "chairs")
    os.makedirs(os.path.join(exp, "ModelParameters"))
    os.makedirs(os.path.join(exp, "LatentCodes"))
    with open(os.path.join(exp, "specs.json"), "w") as f:
        json.dump(PUBLISHED_SPECS, f, indent=4)
    sd = {"module." + k: v for k, v in _published_decoder().state_dict().items()}
    torch.save({"epoch": EPOCH, "model_state_dict": sd},
               os.path.join(exp, "ModelParameters", f"{EPOCH}.pth"))
    lat = nn.Embedding(7, CODE_LEN, max_norm=1.0)
    torch.save({"epoch": EPOCH, "latent_codes": lat.state_dict()},
               os.path.join(exp, "LatentCodes", f"{EPOCH}.pth"))
    return exp


def _assert_params_equal(tp, jp):
    assert len(tp["layers"]) == len(jp["layers"])
    for a, b in zip(tp["layers"], jp["layers"]):
        for k in ("w", "b"):
            x, y = a[k], b[k]
            x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_published_dir_loads_as_in_jax(published_dir):
    """Weight norm folded, the prefix stripped, the bits of JAX's loader;
    the forward within FWD_TOL of JAX's and 2e-6 of the torch module."""
    tp, tcfg = tck.load_decoder(published_dir, str(EPOCH))
    jp, jcfg = jck.load_decoder(published_dir, str(EPOCH))
    assert tcfg == DecoderConfig(**{f: getattr(jcfg, f) for f in (
        "latent_size", "hidden_dims", "latent_in", "xyz_in_all", "use_tanh",
        "clamp_dist")})
    assert tcfg.layer_dims[3] == (512, 512 - (CODE_LEN + 3))
    _assert_params_equal(tp, jp)

    rng = np.random.RandomState(1)
    z = (rng.randn(CODE_LEN) * 0.1).astype(np.float32)
    pts = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    ours = tdec.decoder_apply(tp, torch.tensor(z), torch.tensor(pts), tcfg).numpy()
    theirs = np.asarray(jdec.decoder_apply(jp, jnp.asarray(z), jnp.asarray(pts), jcfg))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=FWD_TOL)
    dec = _published_decoder().eval()
    with torch.no_grad():
        golden = dec(torch.cat([torch.tensor(z).expand(64, -1), torch.tensor(pts)],
                               dim=1))[:, 0].numpy()
    np.testing.assert_allclose(ours, golden, rtol=0, atol=2e-6)


def test_published_latent_containers(published_dir, tmp_path):
    """The nn.Embedding container and the legacy bare [N, 1, L] tensor,
    read into the bits JAX's reader gives."""
    t = tck.load_latent_codes(published_dir, str(EPOCH))
    j = jck.load_latent_codes(published_dir, str(EPOCH))
    assert t.shape == (7, CODE_LEN)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    exp = str(tmp_path / "legacy")
    os.makedirs(os.path.join(exp, "LatentCodes"))
    legacy = torch.randn(5, 1, CODE_LEN, generator=torch.Generator().manual_seed(2))
    torch.save({"epoch": 100, "latent_codes": legacy},
               os.path.join(exp, "LatentCodes", "100.pth"))
    t = tck.load_latent_codes(exp, "100")
    np.testing.assert_array_equal(t.numpy(), legacy.numpy().reshape(5, -1))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jck.load_latent_codes(exp, "100")))


@pytest.mark.parametrize("prefix", ["", "decoder.", "module."])
def test_state_dict_forms(prefix):
    """Plain ``weight`` layers with either prefix or none convert to the
    same params as JAX's converter; a missing layer or a wrong shape
    raises."""
    kw = dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,))
    params, _, _ = _weights(kw)
    sd = {}
    for i, l in enumerate(params["layers"]):
        sd[f"{prefix}lin{i}.weight"] = torch.tensor(l["w"].T.copy())
        sd[f"{prefix}lin{i}.bias"] = torch.tensor(l["b"])
    tp = tck.convert_torch_state_dict(sd, DecoderConfig(**kw))
    _assert_params_equal(tp, jck.convert_torch_state_dict(sd, JDecoderConfig(**kw)))
    _assert_params_equal(tp, params)
    with pytest.raises(KeyError):
        tck.convert_torch_state_dict({k: v for k, v in sd.items() if "lin2" not in k},
                                     DecoderConfig(**kw))
    with pytest.raises(ValueError):
        tck.convert_torch_state_dict(sd, DecoderConfig(**dict(kw, hidden_dims=(16,) * 4)))


KW = dict(latent_size=6, hidden_dims=(24,) * 4, latent_in=(2,))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_experiment_dir_crosses_packages(writer, tmp_path):
    """An experiment directory written by one package loads in the other
    (and in its own) into the same bits: params, specs and latents."""
    params, lat, _ = _weights(KW, seed=3)
    exp = str(tmp_path / "exp")
    if writer == "port":
        tck.save_deepsdf_experiment(exp, tdec.params_from_numpy(params),
                                    DecoderConfig(**KW), latents=torch.tensor(lat))
    else:
        jck.save_deepsdf_experiment(exp, jax.tree_util.tree_map(jnp.asarray, params),
                                    JDecoderConfig(**KW), latents=jnp.asarray(lat))
    tp, tcfg = tck.load_decoder(exp)
    jp, jcfg = jck.load_decoder(exp)
    for p in (tp, jp):
        _assert_params_equal(p, params)
    assert (tcfg.hidden_dims, tcfg.latent_in, tcfg.latent_size) == (
        jcfg.hidden_dims, jcfg.latent_in, jcfg.latent_size) == (
        KW["hidden_dims"], KW["latent_in"], KW["latent_size"])
    np.testing.assert_array_equal(tck.load_latent_codes(exp).numpy(), lat)
    np.testing.assert_array_equal(np.asarray(jck.load_latent_codes(exp)), lat)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_params_npz_crosses_packages(writer, tmp_path):
    params, lat, _ = _weights(KW, seed=4)
    path = str(tmp_path / "p.npz")
    if writer == "port":
        tpre.save_params_npz(path, tdec.params_from_numpy(params), torch.tensor(lat[0]))
    else:
        jpre.save_params_npz(path, jax.tree_util.tree_map(jnp.asarray, params),
                             jnp.asarray(lat[0]))
    tp, tz = tpre.load_params_npz(path)
    jp, jz = jpre.load_params_npz(path)
    _assert_params_equal(tp, params)
    _assert_params_equal(jp, params)
    np.testing.assert_array_equal(tz.numpy(), lat[0])
    np.testing.assert_array_equal(np.asarray(jz), lat[0])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_proxy_npz_crosses_packages(writer, tmp_path):
    """The proxy file with its error quantiles: architecture, weights and
    quantiles read back the same in both packages."""
    pkw = dict(latent_size=6, hidden_dims=(16,) * 3, latent_in=(), use_tanh=True)
    params, _, _ = _weights(pkw, seed=5)
    rep = {"p50": 1.25e-4, "p95": 8.5e-4, "p99": 2.0e-3, "max": 7.75e-3, "n": 100}
    path = str(tmp_path / "proxy.npz")
    if writer == "port":
        tproxy.save_proxy_npz(path, tdec.params_from_numpy(params),
                              DecoderConfig(**pkw), err_report=rep)
    else:
        jproxy.save_proxy_npz(path, jax.tree_util.tree_map(jnp.asarray, params),
                              JDecoderConfig(**pkw), err_report=rep)
    tp, tcfg = tproxy.load_proxy_npz(path)
    jp, jcfg = jproxy.load_proxy_npz(path)
    _assert_params_equal(tp, params)
    _assert_params_equal(jp, params)
    assert tcfg == DecoderConfig(**pkw)
    assert jcfg == JDecoderConfig(**pkw)
    want = {k: rep[k] for k in ("p50", "p95", "p99", "max")}
    assert tproxy.load_proxy_meta(path) == jproxy.load_proxy_meta(path) == want


def test_state_round_trip_and_latest_step(tmp_path):
    """save_state / restore_state: the latest step by default, a named
    step on request, nested containers and numbers kept; the JAX
    package's orbax round trip checks the same (test_checkpoint_data.py)."""
    path = str(tmp_path / "ckpt")
    for step in (3, 10):
        tck.save_state(path, {"latent": torch.arange(8.0) * step,
                              "opt": {"step": step, "betas": (0.9, 0.999)}}, step)
    state, step = tck.restore_state(path, None)
    assert step == 10
    assert torch.equal(state["latent"], torch.arange(8.0) * 10)
    assert state["opt"] == {"step": 10, "betas": (0.9, 0.999)}
    state, step = tck.restore_state(path, None, step=3)
    assert step == 3 and torch.equal(state["latent"], torch.arange(8.0) * 3)
    assert sorted(os.listdir(path)) == ["step_10.pt", "step_3.pt"]


def test_restore_empty_returns_template(tmp_path):
    template = {"x": torch.ones(3)}
    for path in (tmp_path / "none", tmp_path):
        restored, step = tck.restore_state(str(path), template)
        assert step == 0 and restored is template


def test_deepsdf_decoder_module_round_trips_params():
    """DeepSDFDecoder's parameters are the params' tensors; forward and
    gradient are decode_sdf and sdf_gradient."""
    cfg = DecoderConfig(**KW)
    params = tdec.params_from_numpy(_weights(KW, seed=6)[0])
    mod = tdec.DeepSDFDecoder(cfg, params)
    assert [n for n, _ in mod.named_parameters()][:3] == ["w0", "b0", "w1"]
    back = mod.params()
    for a, b in zip(back["layers"], params["layers"]):
        assert a["w"].data_ptr() == b["w"].data_ptr()
    z = torch.zeros(6)
    pts = torch.rand((20, 3), generator=torch.Generator().manual_seed(0)) - 0.5
    assert torch.equal(mod(z, pts).detach(), tdec.decode_sdf(params, z, pts, cfg))
    assert torch.equal(mod.gradient(z, pts), tdec.sdf_gradient(params, z, pts, cfg))
    fresh = tdec.DeepSDFDecoder(cfg, generator=torch.Generator().manual_seed(1))
    assert len(list(fresh.parameters())) == 2 * len(cfg.layer_dims)
