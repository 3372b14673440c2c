"""The PyTorch port's config tree against the JAX package's, and the
port's import boundary (no JAX)."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import dist_renderer_tpu.config as jcfg
import dist_renderer_tpu_torch.config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLASSES = ["DecoderConfig", "MarchConfig", "GradConfig", "RenderConfig",
           "LossConfig", "OptimConfig", "ShardingConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.default if f.default is not dataclasses.MISSING
           else f.default_factory()) for f in dataclasses.fields(j)]
    tf = [(f.name, f.default if f.default is not dataclasses.MISSING
           else f.default_factory()) for f in dataclasses.fields(t)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, a), (_, b) in zip(jf, tf):
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), n
        else:
            assert a == b, n
    assert t.__dataclass_params__.frozen


@pytest.mark.parametrize("kw", [
    {},
    dict(latent_size=8, hidden_dims=(32,) * 4, latent_in=(2,)),
    dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), xyz_in_all=True),
    dict(latent_size=256, hidden_dims=(256,) * 4, latent_in=()),
    dict(latent_size=4, hidden_dims=(16, 24, 32), latent_in=(1, 2)),
])
def test_layer_dims_skip_shrink_rule(kw):
    j, t = jcfg.DecoderConfig(**kw), tcfg.DecoderConfig(**kw)
    assert t.layer_dims == j.layer_dims
    assert t.input_dim == j.input_dim


def test_full_decoder_dims():
    # the 8x512 bench decoder: the layer before the skip shrinks to 253
    dims = tcfg.DecoderConfig().layer_dims
    assert dims[0] == (259, 512) and dims[3] == (512, 253) and dims[4] == (512, 512)
    assert dims[-1] == (512, 1) and len(dims) == 9


def test_render_config_dtype_and_strides():
    c = tcfg.RenderConfig(img_h=48, img_w=64,
                          march=tcfg.MarchConfig(c2f_strides=(16, 4, 8, 1)))
    j = jcfg.RenderConfig(img_h=48, img_w=64,
                          march=jcfg.MarchConfig(c2f_strides=(16, 4, 8, 1)))
    assert c.c2f_strides_valid() == j.c2f_strides_valid() == (16, 4, 8)
    assert tcfg.RenderConfig().dtype == torch.float32
    assert tcfg.RenderConfig(compute_dtype="bfloat16").dtype == torch.bfloat16


def test_port_imports_no_jax():
    """Importing every module of the port must not load JAX, optax or
    orbax (the card machine has none)."""
    mods = [
        "dist_renderer_tpu_torch",
        "dist_renderer_tpu_torch.models.decoder",
        "dist_renderer_tpu_torch.models.folded",
        "dist_renderer_tpu_torch.models.pretrain",
        "dist_renderer_tpu_torch.models.proxy",
        "dist_renderer_tpu_torch.models.checkpoint",
        "dist_renderer_tpu_torch.models.train_deepsdf",
        "dist_renderer_tpu_torch.data.datasets",
        "dist_renderer_tpu_torch.tasks.make_synthetic_data",
        "dist_renderer_tpu_torch.tasks.train",
        "dist_renderer_tpu_torch.ops.camera",
        "dist_renderer_tpu_torch.ops.tracer",
        "dist_renderer_tpu_torch.ops.c2f",
        "dist_renderer_tpu_torch.ops.renderer",
        "dist_renderer_tpu_torch.ops.kernels.build",
        "dist_renderer_tpu_torch.ops.kernels.march_body",
        "dist_renderer_tpu_torch.ops.kernels.batched_march",
        "dist_renderer_tpu_torch.ops.kernels.queue_march",
        "dist_renderer_tpu_torch.ops.kernels.recompute",
        "dist_renderer_tpu_torch.ops.kernels.probes",
        "dist_renderer_tpu_torch.ops.kernels.mlp_chain",
        "dist_renderer_tpu_torch.utils.profiling",
        "dist_renderer_tpu_torch.utils.debug",
        "dist_renderer_tpu_torch.diag",
        "dist_renderer_tpu_torch.diag.diag_launch_cost",
        "dist_renderer_tpu_torch.diag.diag_launch2",
        "dist_renderer_tpu_torch.diag.diag_launch3",
        "dist_renderer_tpu_torch.diag.diag_launch4",
        "dist_renderer_tpu_torch.diag.diag_int8",
        "dist_renderer_tpu_torch.diag.chain_designs",
        "dist_renderer_tpu_torch.diag.loop_designs",
    ]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('jaxlib') or m.startswith('dist_renderer_tpu.')"
            " or m.split('.')[0] in ('optax', 'orbax')"
            " or m == 'dist_renderer_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_sources_name_no_jax():
    """No source file of the port, and not chip_smoke.py, imports JAX, the
    JAX package, optax or orbax, even inside a function (a lazy import would escape
    the subprocess check above)."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "dist_renderer_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    for p in paths:
        bad = {"jax", "jaxlib", "dist_renderer_tpu", "optax", "orbax"} & set(
            _imported_roots(p))
        assert not bad, (p, bad)
