"""The MLP chain probe's plain versions (ops/kernels/mlp_chain.py)
against scripts/diag_int8.py's Pallas kernels in interpret mode on the
CPU, at 2 layers x 128 wide, block 128, 2 steps, 2 blocks.

The script's kernels are module-level factories (make_bf16_kernel :59,
make_int8_kernel :82), so the script is loaded by path: loading runs
nothing but two jax.config updates (a compilation cache directory at
:30-31), which are put back afterwards. Its launch (:127-136) is
repeated here with interpret mode forced.

P24 (int8) is held bit for bit: its sums are exact integers, and the
requantization and carry are the same fp32 operations. P23 (bf16) sums
each layer in another order than XLA's dot, so an activation near a
bf16 rounding boundary may round the other way; it is held within
BF16_TOL. Measured here on four seeds: max |diff| 3.8e-6 to 1.5e-4, on
0.003% to 0.13% of the values, against a carry that moved by 0.12; the
bar is ten times the largest.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dist_renderer_tpu_torch.ops.kernels import mlp_chain as mc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS, WIDTH, BLOCK, STEPS, NBLOCKS = 2, 128, 128, 2, 2
BF16_TOL = 2e-3


CONFIG_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def _load_script():
    saved = {k: getattr(jax.config, k) for k in CONFIG_KEYS}
    spec = importlib.util.spec_from_file_location(
        "diag_int8_script", os.path.join(ROOT, "scripts", "diag_int8.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def diag_int8():
    return _load_script()


def _inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        ws = (0.05 * rng.standard_normal((LAYERS, WIDTH, WIDTH))).astype(np.float32)
    else:
        ws = rng.integers(-127, 128, (LAYERS, WIDTH, WIDTH)).astype(np.int8)
    x = rng.standard_normal((WIDTH, NBLOCKS * BLOCK)).astype(np.float32)
    return x, ws


def _interpret(diag_int8, kind, x, ws):
    """The script's pallas_call (scripts/diag_int8.py:127-136)."""
    jws = [jnp.asarray(w).astype(jnp.bfloat16) if kind == "bf16" else jnp.asarray(w)
           for w in ws]
    make = diag_int8.make_bf16_kernel if kind == "bf16" else diag_int8.make_int8_kernel
    kern = make(LAYERS, STEPS)
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            kern,
            grid=(NBLOCKS,),
            in_specs=[
                pl.BlockSpec((WIDTH, BLOCK), lambda i: (0, i)),
                *[pl.BlockSpec((WIDTH, WIDTH), lambda i: (0, 0)) for _ in jws],
            ],
            out_specs=pl.BlockSpec((WIDTH, BLOCK), lambda i: (0, i)),
            out_shape=jax.ShapeDtypeStruct((WIDTH, NBLOCKS * BLOCK), jnp.float32),
        )(jnp.asarray(x), *jws)
    return torch.from_numpy(np.array(out))


def test_loading_the_script_leaves_jax_config_as_it_was():
    before = {k: getattr(jax.config, k) for k in CONFIG_KEYS}
    mod = _load_script()
    assert callable(mod.make_bf16_kernel) and callable(mod.make_int8_kernel)
    assert {k: getattr(jax.config, k) for k in CONFIG_KEYS} == before


def test_int8_chain_bit_for_bit(diag_int8):
    x, ws = _inputs("int8")
    want = _interpret(diag_int8, "int8", x, ws)
    got = mc.chain_int8_plain(torch.from_numpy(x), torch.from_numpy(ws), STEPS)
    assert torch.equal(got, want)
    # the carry moved: the chain did work
    assert (want - torch.from_numpy(x)).abs().max() > 0.01


def test_bf16_chain_within_its_bar(diag_int8):
    x, ws = _inputs("bf16", seed=1)
    want = _interpret(diag_int8, "bf16", x, ws)
    wb = torch.from_numpy(ws).to(torch.bfloat16)
    got = mc.chain_bf16_plain(torch.from_numpy(x), wb, STEPS)
    assert (got - want).abs().max().item() <= BF16_TOL
    assert (want - torch.from_numpy(x)).abs().max() > 0.01


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_library_chains_compute_the_same_function(kind):
    """The yardsticks: a bf16 torch.matmul chain within the bf16 bar of
    the plain version; the int8 one, where torch has an int8 product on
    the CPU, bit for bit."""
    x, ws = _inputs(kind, seed=2)
    tx = torch.from_numpy(x)
    if kind == "bf16":
        wb = torch.from_numpy(ws).to(torch.bfloat16)
        diff = mc.chain_bf16_library(tx, wb, STEPS) - mc.chain_bf16_plain(tx, wb, STEPS)
        assert diff.abs().max().item() <= BF16_TOL
    else:
        wi = torch.from_numpy(ws)
        assert torch.equal(mc.chain_int8_library(tx, wi, STEPS),
                           mc.chain_int8_plain(tx, wi, STEPS))


def test_cpu_tensors_take_the_plain_versions_uncounted():
    x, ws = _inputs("int8", seed=3)
    before = (mc.chain_bf16.launches, mc.chain_int8.launches)
    tx, wi = torch.from_numpy(x), torch.from_numpy(ws)
    assert torch.equal(mc.chain_int8(tx, wi, 1), mc.chain_int8_plain(tx, wi, 1))
    wb = wi.to(torch.bfloat16) * 0.01
    assert torch.equal(mc.chain_bf16(tx, wb, 1), mc.chain_bf16_plain(tx, wb, 1))
    assert (mc.chain_bf16.launches, mc.chain_int8.launches) == before
    assert mc.chain_macs(LAYERS, WIDTH, NBLOCKS * BLOCK, STEPS) == 2 * 128 * 128 * 256 * 2
