"""The port's ``EncoderUNetModel`` and ``AttentionPool2d``
(``models/unet.py``) against the JAX package's, on the CPU, at the JAX
test's tiny config (32 base channels, mult (1, 2), attention at ds 2 with
4 heads of D 16) with seeded random weights from the flax init tree's
shapes, loaded with ``strict=True``.

- ``AttentionPool2d``: the mean token's one query against h·w + 1 keys,
  within 1e-5 of max(1, max|ref|).
- ``EncoderUNetModel`` at each of the four pools: the output within 1e-5
  of max(1, max|ref|), and the gradient of the summed output over the
  input (guided diffusion's classifier gradient) within 1e-4.
- flax's init tree at each pool loads with ``strict=True``, and the
  port's ``init_encoder_unet_weights_`` gives the adaptive head's zero
  logits as flax's init does; the published width
  (``CLASSIFIER_BACKBONE``) matches the JAX model's leaves by name and
  shape.

The kernels at the pool's (B, 8, 1 | 65, 32) shape are held on the card
by ``chip_smoke.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import unet as ju
from diff_foley_tpu_torch.models import unet as tu
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

CFG = dict(in_channels=4, out_channels=10, model_channels=32,
           num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
           num_heads=4, context_dim=24)
X_SHAPE = (2, 16, 32, 4)
T = np.asarray([0.0, 500.0], np.float32)


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal(X_SHAPE).astype(
        np.float32)


def test_attention_pool_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 64)).astype(np.float32)   # NHWC
    jm = ju.AttentionPool2d(num_heads=4, out_dim=10)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_flax_params(shapes["params"], seed=2)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    tm = tu.AttentionPool2d(64, 4 * 6, 4, 10)
    tm.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    _close(out.numpy(), ref, 1e-5)


@pytest.mark.parametrize("pool", tu.POOLS)
def test_encoder_unet_matches_jax(pool):
    jm = ju.EncoderUNetModel(ju.UNetConfig(**CFG), pool=pool)
    x = _x()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(T))
    params = random_flax_params(shapes["params"], seed=3)
    tm = tu.EncoderUNetModel(tu.UNetConfig(**CFG), pool=pool,
                             hw=X_SHAPE[1:3])
    tm.load_state_dict(from_jax_params(params), strict=True)

    def total(xx):
        out = jm.apply({"params": params}, xx, jnp.asarray(T))
        return jnp.sum(out), out

    (_, ref), g_x = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(T))
    assert out.dtype == torch.float32
    _close(out.detach().numpy(), ref, 1e-5)
    out.sum().backward()
    _close(xt.grad.numpy(), g_x, 1e-4)


@pytest.mark.parametrize("pool", tu.POOLS)
def test_encoder_unet_flax_init_tree_loads(pool):
    jm = ju.EncoderUNetModel(ju.UNetConfig(**CFG), pool=pool)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros(X_SHAPE), jnp.asarray(T))
    tm = tu.EncoderUNetModel(tu.UNetConfig(**CFG), pool=pool,
                             hw=X_SHAPE[1:3])
    tm.load_state_dict(from_jax_params(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes)), strict=True)
    tu.init_encoder_unet_weights_(tm, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = tm(torch.from_numpy(_x()), torch.from_numpy(T))
    assert out.shape == (2, 10) and bool(torch.isfinite(out).all())
    if pool == "adaptive":
        # the zero-init head gives exactly zero logits at init, as flax's
        np.testing.assert_array_equal(out.numpy(), 0.0)


def test_encoder_unet_published_width_matches_jax_leaves():
    # CLASSIFIER_BACKBONE over the smoke's (16, 64) latents: the pool's
    # 64 tokens + 1
    x = jax.ShapeDtypeStruct((1, 16, 64, 4), jnp.float32)
    t = jax.ShapeDtypeStruct((1,), jnp.float32)
    shapes = jax.eval_shape(ju.EncoderUNetModel(
        ju.CLASSIFIER_BACKBONE, pool="attention").init,
        jax.random.PRNGKey(0), x, t)
    sd = from_jax_params(jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
    with torch.device("meta"):
        tm = tu.EncoderUNetModel(tu.CLASSIFIER_BACKBONE, pool="attention")
    assert tm.attn_pool.pos_emb.shape == (65, 256)
    ours = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in sd.items()}


def test_encoder_unet_refuses_unknown_pools():
    with pytest.raises(ValueError, match="pool"):
        tu.EncoderUNetModel(tu.UNetConfig(**CFG), pool="mean")
