"""The port's 1-D audio UNet (``models/audio_unet.py``) and its
``SpatialTransformer1D`` against the JAX package's, on the CPU.

- ``SpatialTransformer1D`` with flax's own initialisation (``proj_out``
  zero with ``use_zero_module``, lecun-normal without) and with seeded
  random weights, with a context and without one: within 1e-5 of
  max(1, max|ref|).
- ``convert_spatial_transformer1d`` exactly the JAX walk's tree on a
  seeded random reference state dict, which loads with ``strict=True``.
- ``AudioUNetModel`` at a tiny config with attention at two
  resolutions and in the middle, seeded random weights from the flax
  init tree's shapes (loaded with ``strict=True``), plain and
  ``use_scale_shift_norm``: the output within 1e-5 of max(1, max|ref|);
  the gradient of Σ out² over every parameter and the input within 1e-4
  of max(1, each leaf's max|ref|) (fp32 sums over the whole map in
  different orders); without a context, the forward.
- The port's ``init_audio_unet_weights_`` zeroes the output as flax's
  init does (not without ``use_zero_module``); the published width's
  leaves equal the JAX model's by name and shape.

The packed kernels at the model's head dims 48 and 96 are held on the
card by ``tests/test_torch_ops.py`` (``gpu``) and ``chip_smoke.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import attention as jattn
from diff_foley_tpu.models import audio_unet as ja
from diff_foley_tpu.utils import convert as jconvert
from diff_foley_tpu_torch.models import attention as tattn
from diff_foley_tpu_torch.models import audio_unet as ta
from diff_foley_tpu_torch.utils.convert import (
    convert_spatial_transformer1d, from_jax_params)
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
# attention at two resolutions (ds 1 and 2) and in the middle
TINY = dict(in_channels=8, out_channels=8, model_channels=32,
            num_res_blocks=1, attention_resolutions=(1, 2),
            channel_mult=(1, 2), num_heads=4)
L, LC, CTX = 16, 6, 24


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _inputs(seed, b=2, c=64, l=L, with_context=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    ctx = (rng.standard_normal((b, LC, CTX)).astype(np.float32)
           if with_context else None)
    return x, ctx


@pytest.mark.parametrize("weights", ["flax_zero_module", "flax_lecun",
                                     "random"])
@pytest.mark.parametrize("with_context", [True, False])
def test_spatial_transformer_1d_matches_jax(weights, with_context):
    x, ctx = _inputs(0, with_context=with_context)
    jm = jattn.SpatialTransformer1D(
        heads=4, dim_head=16, use_zero_module=weights == "flax_zero_module")
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if with_context else ())
    params = _np_tree(jm.init(jax.random.PRNGKey(1), *args)["params"])
    if weights == "random":
        params = random_flax_params(params, seed=2)
    ref = jm.apply({"params": params}, *args)
    tm = tattn.SpatialTransformer1D(64, CTX if with_context else None, 4, 16)
    tm.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).transpose(1, 2).contiguous(),
                 None if ctx is None else torch.from_numpy(ctx))
    _close(out.transpose(1, 2).numpy(), ref, OUT_TOL)
    if weights == "flax_zero_module":   # a zero proj_out: the identity
        np.testing.assert_array_equal(np.asarray(ref), x)


def _reference_state_dict(seed, channels=64, inner=64, context=CTX, depth=2):
    """Seeded random weights under the reference 1-D SpatialTransformer's
    keys."""
    rng = np.random.default_rng(seed)
    shapes = {"norm.weight": (channels,), "norm.bias": (channels,),
              "proj_in.weight": (inner, channels, 1), "proj_in.bias": (inner,),
              "proj_out.weight": (channels, inner, 1),
              "proj_out.bias": (channels,)}
    for d in range(depth):
        tb = f"transformer_blocks.{d}"
        for n in (1, 2, 3):
            shapes[f"{tb}.norm{n}.weight"] = shapes[f"{tb}.norm{n}.bias"] = (
                inner,)
        for a, cin in (("attn1", inner), ("attn2", context)):
            shapes[f"{tb}.{a}.to_q.weight"] = (inner, inner)
            shapes[f"{tb}.{a}.to_k.weight"] = (inner, cin)
            shapes[f"{tb}.{a}.to_v.weight"] = (inner, cin)
            shapes[f"{tb}.{a}.to_out.0.weight"] = (inner, inner)
            shapes[f"{tb}.{a}.to_out.0.bias"] = (inner,)
        shapes[f"{tb}.ff.net.0.proj.weight"] = (8 * inner, inner)
        shapes[f"{tb}.ff.net.0.proj.bias"] = (8 * inner,)
        shapes[f"{tb}.ff.net.2.weight"] = (inner, 4 * inner)
        shapes[f"{tb}.ff.net.2.bias"] = (inner,)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}


def test_convert_spatial_transformer1d_matches_the_jax_walk():
    sd = _reference_state_dict(3)
    ours = convert_spatial_transformer1d(sd, depth=2)
    theirs = jconvert.convert_spatial_transformer1d(sd, depth=2)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(ours), flat(theirs)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tm = tattn.SpatialTransformer1D(64, CTX, 4, 16, depth=2)
    tm.load_state_dict(from_jax_params(ours), strict=True)
    with pytest.raises(ValueError, match="no place"):
        convert_spatial_transformer1d({**sd, "extra.weight": sd["norm.bias"]},
                                      depth=2)


def _unet_case(scale_shift, with_context, seed=5):
    """The two models at TINY, seeded random flax parameters (from the
    init's abstract shapes: compiling flax's init costs more than the
    step) and the inputs."""
    kw = dict(TINY, use_scale_shift_norm=scale_shift,
              context_dim=CTX if with_context else None)
    jm = ja.AudioUNetModel(ja.AudioUNetConfig(**kw))
    tm = ta.AudioUNetModel(ta.AudioUNetConfig(**kw))
    x, ctx = _inputs(4, c=8, with_context=with_context)
    t = np.asarray([3.0, 710.0], np.float32)
    jctx = None if ctx is None else jnp.asarray(ctx)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), jctx))
    params = random_flax_params(shapes["params"], seed=seed)
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, tm, params, x, t, ctx


@pytest.mark.parametrize("scale_shift", [False, True])
def test_audio_unet_forward_and_gradients_match_jax(scale_shift):
    jm, tm, params, x, t, ctx = _unet_case(scale_shift, True)

    def loss(p, xx):
        out = jm.apply({"params": p}, xx, jnp.asarray(t), jnp.asarray(ctx))
        return jnp.sum(out**2), out

    (_, ref), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(t), torch.from_numpy(ctx))
    _close(out.detach().numpy(), ref, OUT_TOL)
    (out**2).sum().backward()
    _close(xt.grad.numpy(), g_x, GRAD_TOL)
    grads = from_jax_params(_np_tree(g_params))
    named = dict(tm.named_parameters())
    assert named.keys() == grads.keys()
    for k, g in grads.items():
        scale = max(1.0, float(g.abs().max()))
        _close(named[k].grad.numpy() / scale, g.numpy() / scale, GRAD_TOL)


def test_audio_unet_without_context_matches_jax():
    # attn2 then reads the tokens themselves, its key and value width the
    # block's
    jm, tm, params, x, t, _ = _unet_case(False, False, seed=6)
    ref = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x),
                                     jnp.asarray(t)))(params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t))
    _close(out.numpy(), ref, OUT_TOL)


def test_audio_unet_init_zeroes_the_output():
    # the JAX model's zero-init output conv gives ε = 0 at init; so does
    # the port's flax-style init of a new model, and without
    # use_zero_module it does not
    x, ctx = _inputs(4, c=8, with_context=True)
    t = np.asarray([3.0, 710.0], np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    tm = ta.AudioUNetModel(ta.AudioUNetConfig(**TINY, context_dim=CTX))
    ta.init_audio_unet_weights_(tm, torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_array_equal(tm(*args).numpy(), 0.0)
    lecun = ta.AudioUNetModel(ta.AudioUNetConfig(
        **TINY, context_dim=CTX, use_zero_module=False))
    ta.init_audio_unet_weights_(lecun, torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert float(lecun(*args).abs().max()) > 0.0
    for m in lecun.modules():
        if isinstance(m, tattn.SpatialTransformer1D):
            assert m.proj_out.weight.any()


def test_audio_unet_published_width_matches_jax_leaves():
    cfg = ja.AudioUNetConfig()
    x = jax.ShapeDtypeStruct((1, 16, cfg.in_channels), jnp.float32)
    t = jax.ShapeDtypeStruct((1,), jnp.float32)
    ctx = jax.ShapeDtypeStruct((1, 4, cfg.context_dim), jnp.float32)
    shapes = jax.eval_shape(ja.AudioUNetModel(cfg).init,
                            jax.random.PRNGKey(0), x, t, ctx)
    sd = from_jax_params(jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
    with torch.device("meta"):
        tm = ta.AudioUNetModel(ta.AudioUNetConfig())
    ours = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in sd.items()}


def test_audio_unet_refuses_dropout():
    with pytest.raises(NotImplementedError, match="dropout"):
        ta.AudioUNetModel(ta.AudioUNetConfig(**TINY, dropout=0.1))
