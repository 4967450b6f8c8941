"""The port's stage-3 diffusion prior (``models/prior.py``) against the JAX
package's, on the CPU, at a tiny config (dim 32, 4 tokens, depth 2,
4 heads of D 8, 100 timesteps) with seeded random weights from the flax
init tree's shapes, loaded with ``strict=True``.

- ``_rotary`` at even and odd D: within 1e-6 of max(1, max|ref|).
- ``DiffusionPriorNetwork`` under each of the four CFG masks (video and
  spec kept or dropped): 1e-5.
- ``p_losses`` and its gradient over every parameter, JAX's draws (t,
  noise and the two keep masks of its key) handed in through ``draws``,
  with ``clamp_l2norm`` off and on: the loss 1e-5 relative, each leaf's
  gradient 1e-4 of max(1, its max|ref|).
- ``sample`` under JAX's x_T and per-step noise at ``cond_scale`` 1 and 3
  (10 strided steps, the last with σ 0): 1e-4 of max(1, max|ref|), the
  chain's fp32 rounding compounding over the steps.
- ``init_params`` draws flax's scheme (the null embeddings N(0, 1), the
  other weights scaled by their fan-in) and defaults to the card.

The per-head kernels at the prior's head dim 64 are held on the card by
``tests/test_torch_ops.py`` (``gpu``) and ``chip_smoke.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import prior as jp
from diff_foley_tpu_torch.models import prior as tp
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

CFG = dict(dim=32, seq_len=4, depth=2, heads=4, num_timesteps=100)
B = 3


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _models(clamp=False, seed=0):
    jm = jp.DiffusionPrior(jp.PriorConfig(**CFG), clamp_l2norm=clamp)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    params = {"params": random_flax_params(shapes["params"], seed=seed)}
    tm = tp.DiffusionPrior(tp.PriorConfig(**CFG), clamp_l2norm=clamp)
    tm.net.load_state_dict(from_jax_params(params), strict=True)
    return jm, tm, params


def _feats(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, CFG["seq_len"], CFG["dim"]))
            .astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("d", [8, 7])
def test_rotary_matches_jax(d):
    x = np.random.default_rng(d).standard_normal((2, 3, 5, d)).astype(
        np.float32)
    _close(tp._rotary(torch.from_numpy(x)).numpy(),
           jp._rotary(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("video_keep,spec_keep",
                         [(True, True), (False, True), (True, False),
                          (False, False)])
def test_network_matches_jax_under_each_cfg_mask(video_keep, spec_keep):
    jm, tm, params = _models()
    z, v = _feats(1)
    t = np.asarray([0.0, 17.0, 99.0], np.float32)
    vk = np.full((B,), video_keep)
    sk = np.full((B,), spec_keep)
    vk[0] = not video_keep     # one example of the other kind in each
    ref = jax.jit(jm.net.apply)(params, jnp.asarray(z), jnp.asarray(t),
                                jnp.asarray(v), jnp.asarray(vk),
                                jnp.asarray(sk))
    with torch.no_grad():
        out = tm.net(*map(torch.from_numpy, (z, t, v, vk, sk)))
    _close(out.numpy(), ref, 1e-5)


def _jax_loss_draws(jm, key, spec_shape):
    """The draws of JAX's ``p_losses`` from ``key``, in its order."""
    b = spec_shape[0]
    k_t, k_n, k_v, k_s = jax.random.split(key, 4)
    return {"t": jax.random.randint(k_t, (b,), 0, jm.cfg.num_timesteps),
            "noise": jax.random.normal(k_n, spec_shape, jnp.float32),
            "video_keep": jax.random.uniform(k_v, (b,)) >= 0.5,
            "spec_keep": jax.random.uniform(k_s, (b,)) >= 0.5}


@pytest.mark.parametrize("clamp", [False, True])
def test_p_losses_and_gradients_match_jax(clamp):
    jm, tm, params = _models(clamp, seed=2)
    v, s = _feats(3)
    key = jax.random.PRNGKey(2)
    loss_fn = lambda p: jm.p_losses(p, jnp.asarray(v), jnp.asarray(s), key,
                                    video_drop_prob=0.5, spec_drop_prob=0.5)
    ref, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    draws = {k: torch.from_numpy(np.asarray(a)) for k, a in
             _jax_loss_draws(jm, key, s.shape).items()}
    # both masks drop an example and keep one, so both branches run
    for k in ("video_keep", "spec_keep"):
        assert 0 < int(draws[k].sum()) < B, draws[k]
    loss = tm.p_losses(torch.from_numpy(v), torch.from_numpy(s),
                       draws=draws)
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    loss.backward()
    named = dict(tm.net.named_parameters())
    mapped = from_jax_params(jax.tree.map(np.asarray, grads))
    assert named.keys() == mapped.keys()
    for k, g in mapped.items():
        scale = max(1.0, float(g.abs().max()))
        _close(named[k].grad.numpy() / scale, g.numpy() / scale, 1e-4)


@pytest.mark.parametrize("cond_scale", [1.0, 3.0])
def test_sample_matches_jax_under_its_draws(cond_scale):
    jm, tm, params = _models(seed=4)
    v, _ = _feats(5)
    key = jax.random.PRNGKey(11)
    steps = 10
    ref = jm.sample(params, jnp.asarray(v), key, steps=steps,
                    cond_scale=cond_scale)
    k_init, k_loop = jax.random.split(key)
    shape = (B, CFG["seq_len"], CFG["dim"])
    keys = jax.random.split(k_loop, steps)
    draws = {"x_T": torch.from_numpy(np.asarray(
                 jax.random.normal(k_init, shape, jnp.float32))),
             "noise": torch.from_numpy(np.stack([np.asarray(
                 jax.random.normal(k, shape, jnp.float32)) for k in keys]))}
    out = tm.sample(torch.from_numpy(v), steps=steps, cond_scale=cond_scale,
                    draws=draws)
    assert len(tm.coefficients(steps)["t"]) == steps
    _close(out.numpy(), ref, 1e-4)


def test_init_params_draws_flax_scheme_and_defaults_to_the_card():
    tm = tp.DiffusionPrior(tp.PriorConfig(**CFG)).init_params(3, "cpu")
    net = tm.net
    assert abs(float(net.null_video_embeds.std()) - 1.0) < 0.2
    w = net.block0.fc1.weight
    assert abs(float(w.std()) * CFG["dim"]**0.5 - 1.0) < 0.2
    assert not net.block0.fc1.bias.any()
    assert bool((net.norm_out.weight == 1).all())
    assert abs(float(net.time_embed.weight.std()) * CFG["dim"]**0.5
               - 1.0) < 0.2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.DiffusionPrior(tp.PriorConfig(**CFG)).init_params(0)
