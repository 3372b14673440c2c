"""Training of the PyTorch port against the JAX package: the decoder's
rest (init, chunked evaluation, spatial gradient), decoder fitting,
auto-decoder training and proxy distillation.

``torch.Generator`` and ``jax.random`` draw different numbers, so the
random wholes are held to the behaviour the JAX package's own tests ask
of it, and the deterministic pieces to JAX on the same inputs (numpy
seeds):

- the auto-decoder loss and its gradient at the same params, latents and
  points, against the same expression composed from JAX's
  ``decoder_apply(..., jnp.bfloat16)``: both round the operands to bf16
  and sum in fp32, in their own orders; measured 1.5e-8 on the loss,
  1.8e-7 of the largest gradient entry; bars 1e-6 and 1e-5 relative;
- Adam's steps of the two parameter groups against optax's
  multi_transform, given the same gradients: measured 6e-8; bar 1e-7
  absolute at lr 5e-4 / 1e-3;
- the cosine lr sequence against optax's schedule evaluated in float64:
  bar 1e-7 relative (measured 2.4e-15; against optax's fp32 evaluation
  2.4e-6, bar 5e-6);
- the surface projection from the same starting points: fp32 autograd
  on both sides; bar 1e-6 (measured in the test's message).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dist_renderer_tpu.config import DecoderConfig as JDecoderConfig
from dist_renderer_tpu.models import analytic as janalytic
from dist_renderer_tpu.models import decoder as jdec
from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig
from dist_renderer_tpu_torch.models import analytic as tanalytic
from dist_renderer_tpu_torch.models import decoder as tdec
from dist_renderer_tpu_torch.models import pretrain as tpre
from dist_renderer_tpu_torch.models import proxy as tproxy
from dist_renderer_tpu_torch.models import train_deepsdf as ttrain
from test_torch_decoder import _weights
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

KW = dict(latent_size=16, hidden_dims=(48,) * 4, latent_in=(2,))
LOSS_REL, GRAD_REL, ADAM_ABS, LR_REL, PROJ_ABS = 1e-6, 1e-5, 1e-7, 1e-7, 1e-6


def _jparams(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _with_grad(params):
    tp = tdec.params_from_numpy(params)
    for l in tp["layers"]:
        l["w"].requires_grad_(True)
        l["b"].requires_grad_(True)
    return tp


@pytest.mark.parametrize("clamp_pred", [False, True], ids=["analytic", "samples"])
def test_auto_decoder_loss_and_gradient_match_jax(clamp_pred):
    """train_deepsdf_analytic's loss (clamp_pred=False) and
    train_deepsdf_samples's (True), three shapes of a batch, one drawn
    twice (its latent's gradient sums both)."""
    params, lat, _ = _weights(KW, seed=0)
    rng = np.random.default_rng(1)
    idx = np.array([2, 0, 2])
    pts = rng.uniform(-1, 1, (3, 200, 3)).astype(np.float32)
    tgt = (0.3 * rng.standard_normal((3, 200))).astype(np.float32)
    tp = _with_grad(params)
    tl = torch.tensor(lat, requires_grad=True)
    loss = ttrain.auto_decoder_loss(tp, tl, torch.tensor(idx), torch.tensor(pts),
                                    torch.tensor(tgt), DecoderConfig(**KW), 1e-4, 0.1,
                                    clamp_pred)
    loss.backward()

    def jloss(state):
        # train_deepsdf.py's per-shape loss, vmapped and averaged
        def one(i, p, t):
            z = state["latents"][i]
            pred = jdec.decoder_apply(state["params"], z, p, JDecoderConfig(**KW),
                                      jnp.bfloat16)
            if clamp_pred:
                pred = jnp.clip(pred, -0.1, 0.1)
            return jnp.mean(jnp.abs(pred - jnp.clip(t, -0.1, 0.1))) + 1e-4 * jnp.sum(z ** 2)

        return jnp.mean(jax.vmap(one)(jnp.asarray(idx), jnp.asarray(pts), jnp.asarray(tgt)))

    jl, jg = jax.value_and_grad(jloss)({"params": _jparams(params),
                                        "latents": jnp.asarray(lat)})
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_REL * abs(float(jl))
    pairs = [(a[k].grad, b[k]) for a, b in zip(tp["layers"], jg["params"]["layers"])
             for k in ("w", "b")] + [(tl.grad, jg["latents"])]
    for ours, theirs in pairs:
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=GRAD_REL * np.abs(theirs).max())


def test_fit_loss_and_gradient_match_jax():
    """fit_decoder_to_sdf's loss, clamped_l1 of the bf16-compute decoder,
    and its gradient against pretrain.py's loss_fn composed in JAX."""
    params, lat, pts = _weights(KW, seed=2, n=300)
    tgt = (0.2 * np.random.default_rng(3).standard_normal(300)).astype(np.float32)
    tp = _with_grad(params)
    loss = tpre.clamped_l1(tdec.decoder_apply(tp, torch.tensor(lat[0]), torch.tensor(pts),
                                              DecoderConfig(**KW), torch.bfloat16),
                           torch.tensor(tgt), 0.1)
    loss.backward()
    jl, jg = jax.value_and_grad(lambda p: jnp.mean(jnp.abs(
        jdec.decoder_apply(p, jnp.asarray(lat[0]), jnp.asarray(pts), JDecoderConfig(**KW),
                           jnp.bfloat16) - jnp.clip(jnp.asarray(tgt), -0.1, 0.1))))(
        _jparams(params))
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_REL * abs(float(jl))
    for a, b in zip(tp["layers"], jg["layers"]):
        for k in ("w", "b"):
            theirs = np.asarray(b[k])
            np.testing.assert_allclose(a[k].grad.numpy(), theirs, rtol=0,
                                       atol=GRAD_REL * np.abs(theirs).max())


def test_adam_two_groups_match_optax_multi_transform():
    """Three steps of make_optimizer's Adam (decoder at lr, latents at
    latent_lr) against optax.multi_transform of two adams, on the same
    gradients (the latents' third gradient is zero: Adam still moves)."""
    params, lat, _ = _weights(KW, seed=4)
    rng = np.random.default_rng(5)
    g_p = [rng.standard_normal(np.shape(l[k])).astype(np.float32)
           for l in params["layers"] for k in ("w", "b")]
    g_z = rng.standard_normal(lat.shape).astype(np.float32)
    tp, tl = tdec.params_from_numpy(params), torch.tensor(lat)
    leaves = [t for l in tp["layers"] for t in (l["w"], l["b"])]
    opt = ttrain.make_optimizer(tp, tl, 5e-4, 1e-3)
    tx = optax.multi_transform({"params": optax.adam(5e-4), "latents": optax.adam(1e-3)},
                               {"params": "params", "latents": "latents"})
    state = {"params": _jparams(params), "latents": jnp.asarray(lat)}
    ostate = tx.init(state)
    n = len(params["layers"])
    for step in range(3):
        for t, g in zip(leaves, g_p):
            t.grad = torch.tensor(g) * (step + 1)
        tl.grad = torch.tensor(g_z) * (1 - step)
        opt.step()
        gl = [jnp.asarray(g) * (step + 1) for g in g_p]
        grads = {"params": {"layers": [{"w": gl[2 * i], "b": gl[2 * i + 1]}
                                       for i in range(n)]},
                 "latents": jnp.asarray(g_z) * (1 - step)}
        upd, ostate = tx.update(grads, ostate, state)
        state = optax.apply_updates(state, upd)
        theirs = [x for l in state["params"]["layers"] for x in (l["w"], l["b"])]
        for t, j in zip(leaves + [tl], theirs + [state["latents"]]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ADAM_ABS)


@pytest.mark.parametrize("steps", [50, 1500])
def test_cosine_lr_matches_optax(steps):
    """distill_proxy's schedule: CosineAnnealingLR(T_max=steps, eta_min =
    0.01 lr) stepped after each update gives, for updates 0..steps-1, the
    lr of optax.cosine_decay_schedule(lr, steps, alpha=0.01)."""
    lr = 1e-3
    opt = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=lr)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps, eta_min=0.01 * lr)
    ours = []
    for _ in range(steps):
        ours.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    with jax.enable_x64(True):
        sch = optax.cosine_decay_schedule(lr, steps, alpha=0.01)
        theirs = np.array([float(sch(t)) for t in range(steps)])
    np.testing.assert_allclose(ours, theirs, rtol=LR_REL, atol=0)
    # optax's default fp32 evaluation: its rounding near the end of the
    # decay (1 + cos near 0) measured 1.2e-6 / 2.4e-6 relative at 50 /
    # 1500 steps
    sch = optax.cosine_decay_schedule(lr, steps, alpha=0.01)
    np.testing.assert_allclose(ours, [float(sch(t)) for t in range(steps)], rtol=5e-6,
                               atol=0)


def test_surface_projection_matches_jax():
    """project_to_surface on an analytic shape and on a decoder (the
    proxy sampler's five steps) from the same starting points, against
    the loop of pretrain.py / proxy.py composed in JAX in fp32."""
    rng = np.random.default_rng(6)
    p0 = rng.uniform(-0.8, 0.8, (500, 3)).astype(np.float32)
    tshape = tanalytic.round_union(tanalytic.torus_sdf(0.55, 0.18),
                                   tanalytic.sphere_sdf(0.35, (0.0, 0.25, 0.0)), 0.08)
    jshape = janalytic.round_union(janalytic.torus_sdf(0.55, 0.18),
                                   janalytic.sphere_sdf(0.35, (0.0, 0.25, 0.0)), 0.08)
    params, lat, _ = _weights(KW, seed=7)
    jp = _jparams(params)
    tp = tdec.params_from_numpy(params)
    cases = [
        (lambda q: tshape(None, q), lambda q: jshape(None, q), 4),
        (lambda q: tdec.decoder_apply(tp, torch.tensor(lat[0]), q, DecoderConfig(**KW)),
         lambda q: jdec.decoder_apply(jp, jnp.asarray(lat[0]), q, JDecoderConfig(**KW)), 5),
    ]
    for tfn, jfn, iters in cases:
        ours = tpre.project_to_surface(tfn, torch.tensor(p0), iters).numpy()
        p = jnp.asarray(p0)
        g_fn = jax.grad(lambda q: jnp.sum(jfn(q)))
        for _ in range(iters):
            s, g = jfn(p), g_fn(p)
            g = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-8)
            p = p - s[:, None] * g
        err = np.abs(ours - np.asarray(p)).max()
        assert err <= PROJ_ABS, err


def test_init_decoder_params_he_std_zero_bias():
    """Std sqrt(2 / d_in) (within 3% on the 8x512 decoder's 2M weights),
    zero biases, one seed the same weights on any generator device's
    draw, moved to the target device."""
    cfg = DecoderConfig()
    p = tdec.init_decoder_params(torch.Generator().manual_seed(0), cfg)
    for (d_in, d_out), l in zip(cfg.layer_dims, p["layers"]):
        assert l["w"].shape == (d_in, d_out) and l["w"].dtype == torch.float32
        assert torch.count_nonzero(l["b"]) == 0 and l["b"].shape == (d_out,)
        if d_out > 1:
            assert abs(l["w"].std().item() / np.sqrt(2.0 / d_in) - 1) < 0.03
    q = tdec.init_decoder_params(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(p["layers"], q["layers"]))


def test_decode_sdf_chunks_and_sdf_gradient():
    """decode_sdf with a chunk (ragged last chunk) matches one pass within
    1e-6 (torch's CPU GEMM blocks by row count, so a row's last bit can
    move; measured 3.0e-8) and JAX's chunked decode_sdf; sdf_gradient's
    autograd matches JAX's jax.grad, and central differences (eps 1e-3)
    match autograd."""
    params, lat, pts = _weights(KW, seed=8, n=257)
    tp, jp = tdec.params_from_numpy(params), _jparams(params)
    cfg, jcfg = DecoderConfig(**KW), JDecoderConfig(**KW)
    z, p = torch.tensor(lat[0]), torch.tensor(pts.reshape(257, 1, 3))
    whole = tdec.decode_sdf(tp, z, p, cfg)
    assert whole.shape == (257, 1)
    chunked = tdec.decode_sdf(tp, z, p, cfg, chunk=64)
    assert chunked.shape == (257, 1)
    assert (chunked - whole).abs().max() <= 1e-6
    theirs = np.asarray(jdec.decode_sdf(jp, jnp.asarray(lat[0]), jnp.asarray(pts), jcfg,
                                        chunk=64))
    np.testing.assert_allclose(whole.numpy().reshape(-1), theirs, rtol=0, atol=1e-5)
    g = tdec.sdf_gradient(tp, z, torch.tensor(pts), cfg)
    jg = np.asarray(jdec.sdf_gradient(jp, jnp.asarray(lat[0]), jnp.asarray(pts), jcfg))
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())
    fd = tdec.sdf_gradient(tp, z, torch.tensor(pts), cfg, eps=1e-3)
    # ReLU kinks inside the +-eps stencil move a few points' differences
    close = (fd - g).abs().max(dim=-1).values <= 2e-2 * g.abs().max()
    assert close.float().mean() >= 0.95


def test_train_deepsdf_analytic_tells_two_shapes_apart():
    """tests/test_train_color.py:22 on the port: two spheres (r 0.4 and
    0.6), 300 steps; the loss falls and each latent reconstructs its own
    radius at (0.5, 0, 0): outside the small one, inside the large one."""
    dcfg = DecoderConfig(latent_size=4, hidden_dims=(24,) * 3, latent_in=())
    shapes = [lambda p: tanalytic.sphere_sdf(0.4)(None, p),
              lambda p: tanalytic.sphere_sdf(0.6)(None, p)]
    params, latents, losses = ttrain.train_deepsdf_analytic(
        shapes, dcfg, steps=300, batch_shapes=2, points_per_shape=512, lr=2e-3,
        latent_lr=5e-3, device="cpu")
    assert losses.shape == (300,) and torch.isfinite(losses).all()
    assert losses[-50:].mean() < losses[:50].mean()
    probe = torch.tensor([[0.5, 0.0, 0.0]])
    s0 = tdec.decoder_apply(params, latents[0], probe, dcfg)[0]
    s1 = tdec.decoder_apply(params, latents[1], probe, dcfg)[0]
    assert s0 > s1


def test_train_deepsdf_samples_lowers_its_loss():
    """tests/test_train_color.py:41 on the port: two spheres' [N, 4]
    samples of unequal counts (the padded bank), 200 steps."""
    dcfg = DecoderConfig(latent_size=4, hidden_dims=(24,) * 3, latent_in=())
    rng = np.random.RandomState(0)

    def sample_shape(r, n):
        pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        return np.concatenate([pts, (np.linalg.norm(pts, axis=1) - r)[:, None]], axis=1)

    samples = [sample_shape(0.4, 2000), sample_shape(0.6, 1500)]
    bank, counts = ttrain.sample_bank(samples)
    assert bank.shape == (2, 2000, 4) and counts.tolist() == [2000, 1500]
    assert not bank[1, 1500:].any()
    _, latents, losses = ttrain.train_deepsdf_samples(
        samples, dcfg, steps=200, batch_shapes=2, points_per_shape=256, lr=2e-3,
        latent_lr=5e-3, device="cpu")
    assert latents.shape == (2, 4)
    assert losses[-20:].mean() < losses[:20].mean()


def test_fit_and_distill_reach_jax_error():
    """tests/test_proxy.py's fixture and bars on the port: a 48x4 decoder
    fitted to a sphere (400 steps, batch 2048), a 32x3 proxy distilled
    from it (1500 steps, lr 2e-3); the near-surface error report over
    8192 points: p95 < 1.2e-2, max < 5e-2 (JAX measured p95 ~7e-3), and
    the verify stage's default margins dominate it."""
    dcfg = DecoderConfig(latent_size=8, hidden_dims=(48,) * 4, latent_in=(2,))
    losses = []
    params, z0 = tpre.fit_decoder_to_sdf(lambda p: tanalytic.sphere_sdf(0.5)(None, p),
                                         dcfg, steps=400, batch=2048, device="cpu",
                                         losses=losses)
    assert len(losses) == 400 and losses[-1] < losses[0]
    pcfg = tproxy.default_proxy_cfg(dcfg, width=32, depth=3)
    proxy, pcfg = tproxy.distill_proxy(params, dcfg, z0[None], proxy_cfg=pcfg,
                                       steps=1500, batch=2048, lr=2e-3)
    rep = tproxy.proxy_error_report(params, dcfg, proxy, pcfg, z0[None], n=8192)
    assert rep["p95"] < 1.2e-2 and rep["max"] < 5e-2, rep
    m = MarchConfig()
    assert m.proxy_band > rep["p95"] and m.proxy_backoff > rep["p50"], rep
