"""The bulk point eval (K5, ops/kernels/mlp_eval.py) and the differentiable
color head (recompute.make_color_vjp) against the JAX package on the CPU:
the port's plain versions against ``pallas_point_eval`` and
``make_color_vjp`` in interpret mode, on the same weights (carried over
with params_from_numpy) and numpy-seeded inputs.

Bars for K5. Both sides take bf16 positions and weights, sum in fp32 and
round each activation to bf16 once; the CPU BLAS behind each sums a row
in its own order, and a last-bit difference can flip an activation's
bf16 rounding (2^-8 relative) and move that point's output. Measured on
4,000 points: p99 |diff| <= 1.2e-7, 0-0.28% of points beyond 1e-5, max
3.0e-3 (8x64), 5.5e-6 (4x48), 2.4e-3 (color logits). Bars: p99 <= 1e-6,
>= 99% of points within 1e-5, max <= 5e-3. The color head's gradients:
relative L2 <= 1e-4, the bar test_torch_grad.py holds K4 to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.models.color_decoder import init_color_params as jinit_color
from dist_renderer_tpu.models.color_decoder import make_color_config as jcolor_config
from dist_renderer_tpu.models.decoder import init_decoder_params
from dist_renderer_tpu.models.folded import fold_latent as jfold_latent
from dist_renderer_tpu.ops.pallas import mlp_eval as jmlp
from dist_renderer_tpu.ops.pallas.fused_march import pack_folded as jpack_folded
from dist_renderer_tpu.ops.pallas.recompute import make_color_vjp as jmake_color_vjp
from dist_renderer_tpu_torch.config import DecoderConfig
from dist_renderer_tpu_torch.models.color_decoder import make_color_config
from dist_renderer_tpu_torch.models.decoder import params_from_numpy
from dist_renderer_tpu_torch.models.folded import fold_latent
from dist_renderer_tpu_torch.ops.kernels import mlp_eval
from dist_renderer_tpu_torch.ops.kernels.fused_march import pack_folded
from dist_renderer_tpu_torch.ops.kernels.recompute import make_color_vjp
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

P99, WITHIN, MAX = 1e-6, 0.99, 5e-3
REL = 1e-4

# (config kwargs, color head?): the two ARCHS of tests/test_mlp_eval.py
# and a 4x48 color head
CASES = [
    (dict(latent_size=32, hidden_dims=(64,) * 8, latent_in=(4,)), False),
    (dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,), xyz_in_all=True), False),
    (dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,)), True),
]


def _case(i, n=4000):
    """(JAX params, JAX config, port params, port config, latent, points,
    out_rows) for CASES[i], inputs from numpy seeds."""
    kw, color = CASES[i]
    if color:
        jcfg, cfg = jcolor_config(**kw), make_color_config(**kw)
        jp = jinit_color(jax.random.PRNGKey(i), jcfg)
    else:
        jcfg, cfg = JDecoderConfig(**kw), DecoderConfig(**kw)
        jp = init_decoder_params(jax.random.PRNGKey(i), jcfg)
    rng = np.random.default_rng(10 + i)
    z = (0.3 * rng.standard_normal(cfg.latent_size)).astype(np.float32)
    pts = (0.8 * rng.standard_normal((n, 3))).astype(np.float32)
    return jp, jcfg, params_from_numpy(jp), cfg, z, pts, 3 if color else 1


def _assert_k5_bars(out, ref):
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert np.quantile(err, 0.99) <= P99, np.quantile(err, 0.99)
    assert (err <= 1e-5).mean() >= WITHIN, (err <= 1e-5).mean()
    assert err.max() <= MAX, err.max()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_point_eval_plain_matches_interpret(case):
    jp, jcfg, params, cfg, z, pts, rows = _case(case)
    ref = jmlp.pallas_point_eval(jpack_folded(jfold_latent(jp, jnp.asarray(z), jcfg), jcfg),
                                 jnp.asarray(pts), interpret=True, out_rows=rows)
    packed = pack_folded(fold_latent(params, torch.tensor(z), cfg), cfg)
    n0 = mlp_eval.point_eval.launches
    out = mlp_eval.point_eval(packed, torch.tensor(pts), out_rows=rows)
    assert mlp_eval.point_eval.launches == n0  # a CPU tensor launches nothing
    assert out.shape == ref.shape and out.dtype == torch.float32
    _assert_k5_bars(out.numpy(), ref)
    assert torch.equal(out, mlp_eval.point_eval_plain(packed, torch.tensor(pts), rows))


def test_point_eval_padding_is_the_prefix():
    """A ragged N evaluates each point as the padded run does: N = 130
    equals the first 130 of 256 (126 zero points appended), bit for bit."""
    _, _, params, cfg, z, pts, _ = _case(0, n=130)
    packed = pack_folded(fold_latent(params, torch.tensor(z), cfg), cfg)
    p = torch.tensor(pts)
    s = mlp_eval.point_eval(packed, p)
    s_full = mlp_eval.point_eval(packed, torch.cat([p, torch.zeros(126, 3)]))
    assert s.shape == (130,)
    assert torch.equal(s, s_full[:130])


@pytest.mark.parametrize("case", [1, 2])
def test_point_and_color_fns_match_jax(case):
    """make_pallas_point_fn / make_pallas_color_fn on [..., 3] points
    against the JAX package's, shapes kept, the sigmoid outside."""
    jp, jcfg, params, cfg, z, pts, rows = _case(case, n=600)
    pts = pts.reshape(20, 30, 3)
    if rows == 1:
        ref = jmlp.make_pallas_point_fn(jp, jnp.asarray(z), jcfg, interpret=True)(
            jnp.asarray(pts))
        out = mlp_eval.make_pallas_point_fn(params, torch.tensor(z), cfg)(torch.tensor(pts))
        assert out.shape == (20, 30)
    else:
        ref = jmlp.make_pallas_color_fn(jp, jnp.asarray(z), jcfg, interpret=True)(
            jnp.asarray(pts))
        out = mlp_eval.make_pallas_color_fn(params, torch.tensor(z), cfg)(torch.tensor(pts))
        assert out.shape == (20, 30, 3)
        assert bool(((out >= 0) & (out <= 1)).all())
    _assert_k5_bars(out.numpy(), ref)


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_color_vjp_matches_jax():
    """make_color_vjp's RGB and its gradients to the texture latent and
    the points (K5 forward, K4 backward with 3 seed rows, plain versions)
    against the JAX package's in interpret mode: relative L2 <= 1e-4."""
    jp, jcfg, params, cfg, z, pts, _ = _case(2, n=500)
    w = np.random.default_rng(3).standard_normal((500, 3)).astype(np.float32)
    jfn = jmake_color_vjp(jp, jcfg, interpret=True)
    ref = jfn(jnp.asarray(z), jnp.asarray(pts))
    gz_r, gp_r = jax.grad(lambda zz, p: jnp.sum(jnp.asarray(w) * jfn(zz, p)),
                          argnums=(0, 1))(jnp.asarray(z), jnp.asarray(pts))
    fn = make_color_vjp(params, cfg)
    zz = torch.tensor(z, requires_grad=True)
    pp = torch.tensor(pts, requires_grad=True)
    rgb = fn(zz, pp)
    assert rgb.shape == (500, 3) and bool(((rgb >= 0) & (rgb <= 1)).all())
    gz, gp = torch.autograd.grad((torch.tensor(w) * rgb).sum(), (zz, pp))
    assert _rel(rgb.detach(), ref) <= REL
    assert _rel(gz, gz_r) <= REL, _rel(gz, gz_r)
    assert _rel(gp, gp_r) <= REL, _rel(gp, gp_r)
    # the forward is K5's: make_pallas_color_fn's RGB
    same = mlp_eval.make_pallas_color_fn(params, torch.tensor(z), cfg)(torch.tensor(pts))
    assert torch.equal(rgb.detach(), same)


def test_color_vjp_and_point_eval_refuse_what_jax_refuses():
    _, _, params, cfg, z, pts, _ = _case(2, n=8)
    with pytest.raises(ValueError, match="sigmoid"):
        make_color_vjp(params, DecoderConfig(**dict(CASES[2][0], final_tanh=True)))
    with pytest.raises(ValueError, match="sigmoid"):
        make_color_vjp(params, DecoderConfig(**dict(CASES[2][0], final_tanh=False,
                                                    use_tanh=True)))
    with pytest.raises(ValueError, match="one latent"):
        make_color_vjp(params, cfg)(torch.tensor(z)[None], torch.tensor(pts))
    packed = pack_folded(fold_latent(params, torch.tensor(z), cfg), cfg)
    with pytest.raises(ValueError):
        mlp_eval.point_eval(packed, torch.tensor(pts), out_rows=2)
    with pytest.raises(ValueError):
        mlp_eval.point_eval(packed, torch.tensor(pts).reshape(4, 6))
