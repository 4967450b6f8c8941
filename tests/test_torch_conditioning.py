"""The port's other conditioning against the JAX package's, on the CPU:
``LatentDiffusion.apply_model`` for every conditioning key, and the
class-conditional (``num_classes``) and positional (``pos_seq_len``)
UNets, at the tiny config of tests/test_parity_extras.py (32 base
channels, mult (1, 2), attention at ds 2 with 4 heads of D 16, context
24), seeded random weights from the flax init tree's shapes carried over
with ``from_jax_params`` and loaded with ``strict=True``, NHWC inputs.

- concat and adm build the context-free UNet: its cross-attention reads
  the tokens, its key and value width the block's (the JAX UNet is
  initialised with no context there, so flax infers that width).
- Outputs in fp32 on both sides within 2e-5 of max(1, max|ref|).
- A positional UNet wider than its ``pos_seq_len`` raises on both sides,
  and a class-conditional one called without ``y`` raises in the port.

The kernels at the full-width shapes of these modes (kernel 1 with no
context and with one key) are held on the card by ``chip_smoke.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.diffusion import latent_diffusion as jld
from diff_foley_tpu.models import cond_text as jct
from diff_foley_tpu.models import unet as ju
from diff_foley_tpu.models import vae as jv
from diff_foley_tpu_torch.diffusion import latent_diffusion as tld
from diff_foley_tpu_torch.models import cond_text as tct
from diff_foley_tpu_torch.models import unet as tu
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

BASE = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
            attention_resolutions=(2,), num_heads=4, context_dim=24)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
X_SHAPE = (2, 16, 32, 4)
T = np.asarray([3.0, 710.0], np.float32)
Y = np.asarray([3, 7], np.int32)
TOL = 2e-5


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    c_concat = rng.standard_normal(X_SHAPE).astype(np.float32)
    ctx = rng.standard_normal((2, 6, 24)).astype(np.float32)
    return x, c_concat, ctx


def _pair(key, seed):
    """A JAX LatentDiffusion and the port's, the UNet's weights shared."""
    num_classes = 10 if key == "adm" else 0
    in_ch = 8 if key in ("concat", "hybrid") else 4
    jcfg = jld.LDMConfig(
        unet=ju.UNetConfig(in_channels=in_ch, num_classes=num_classes,
                           **BASE),
        vae=jv.VAEConfig(**VAE), cond_embed_dim=24, conditioning_key=key)
    jldm = jld.LatentDiffusion(jcfg)
    x0 = jnp.zeros((1, 16, 32, in_ch))
    init_ctx = None if key in ("concat", "adm") else jnp.zeros((1, 6, 24))
    y0 = jnp.zeros((1,), jnp.int32) if num_classes else None
    shapes = jax.eval_shape(lambda: jldm.unet.init(
        jax.random.PRNGKey(0), x0, jnp.zeros((1,)), init_ctx, True, y0))
    params = random_flax_params(shapes["params"], seed=seed)
    tcfg = tld.LDMConfig(
        unet=tu.UNetConfig(in_channels=in_ch, num_classes=num_classes,
                           **BASE),
        vae=tv.VAEConfig(**VAE), cond_embed_dim=24, conditioning_key=key)
    tldm = tld.LatentDiffusion(tcfg)
    tldm.unet.load_state_dict(from_jax_params(params), strict=True)
    return jldm, {"unet": {"params": params}}, tldm


@pytest.mark.parametrize("key", [None, "crossattn", "concat", "hybrid",
                                 "adm"])
def test_apply_model_routes_each_key_as_jax(key):
    jldm, jparams, tldm = _pair(key, seed=10)
    x, c_concat, ctx = _inputs(1)
    kw = {}
    if key in ("concat", "hybrid"):
        kw["c_concat"] = c_concat
    if key == "adm":
        kw["y"] = Y
    ref = jax.jit(lambda p, x, c, kw: jldm.apply_model(p, x, T, c, **kw))(
        jparams, jnp.asarray(x), jnp.asarray(ctx),
        {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out = tldm.apply_model(
            torch.from_numpy(x), torch.from_numpy(T), torch.from_numpy(ctx),
            **{k: torch.from_numpy(v).long() if k == "y" else
               torch.from_numpy(v) for k, v in kw.items()})
    assert out.dtype == torch.float32
    _close(out.numpy(), ref)


def test_context_free_unet_reads_the_tokens():
    # concat and adm: attn2's key and value take the block's own width
    _, _, tldm = _pair("concat", seed=11)
    block = tldm.unet.down_1_0_attn.block0
    assert block.attn2.to_k.weight.shape == (64, 64)
    _, _, tldm = _pair("crossattn", seed=11)
    assert tldm.unet.down_1_0_attn.block0.attn2.to_k.weight.shape == (64, 24)


def test_unknown_conditioning_key_raises():
    with pytest.raises(ValueError, match="conditioning_key"):
        tld.LatentDiffusion(tld.LDMConfig(
            unet=tu.UNetConfig(**BASE), vae=tv.VAEConfig(**VAE),
            conditioning_key="film"))


def test_concat_needs_c_concat():
    _, _, tldm = _pair("concat", seed=12)
    x, _, _ = _inputs(2)
    with pytest.raises(ValueError, match="c_concat"):
        tldm.apply_model(torch.from_numpy(x), torch.from_numpy(T))


def test_crossattn_with_a_class_token_context_matches_jax():
    # a ClassEmbedder's one token as the context: the UNet's
    # cross-attention over one key
    jldm, jparams, tldm = _pair("crossattn", seed=13)
    jemb = jct.ClassEmbedder(embed_dim=24, n_classes=10)
    eshape = jax.eval_shape(jemb.init, jax.random.PRNGKey(0),
                            jnp.asarray(Y))
    eparams = random_flax_params(eshape["params"], seed=14)
    temb = tct.ClassEmbedder(24, 10)
    temb.load_state_dict(from_jax_params(eparams), strict=True)
    x, _, _ = _inputs(3)
    ref = jax.jit(lambda p, e, x, y: jldm.apply_model(
        p, x, T, jemb.apply({"params": e}, y)))(
            jparams, eparams, jnp.asarray(x), jnp.asarray(Y))
    with torch.no_grad():
        ctx = temb(torch.from_numpy(Y).long())
        assert ctx.shape == (2, 1, 24)
        out = tldm.apply_model(torch.from_numpy(x), torch.from_numpy(T), ctx)
    _close(out.numpy(), ref)


def _unet_pair(seed, **extra):
    jm = ju.UNetModel(ju.UNetConfig(**BASE, **extra))
    y0 = jnp.zeros((1,), jnp.int32) if extra.get("num_classes") else None
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 6, 24)), True, y0))
    params = random_flax_params(shapes["params"], seed=seed)
    tm = tu.UNetModel(tu.UNetConfig(**BASE, **extra))
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm


def test_class_conditional_unet_matches_jax():
    jm, params, tm = _unet_pair(20, num_classes=10)
    assert tm.label_emb.weight.shape == (10, 128)
    x, _, ctx = _inputs(4)
    ref = jax.jit(lambda p, x, c, y: jm.apply({"params": p}, x, T, c, True,
                                              y=y))(
        params, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(Y))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(T),
                 torch.from_numpy(ctx), y=torch.from_numpy(Y).long())
        _close(out.numpy(), ref)
        with pytest.raises(ValueError, match="needs y"):
            tm(torch.from_numpy(x), torch.from_numpy(T),
               torch.from_numpy(ctx))


def test_positional_unet_matches_jax_and_raises_past_its_length():
    jm, params, tm = _unet_pair(21, pos_seq_len=32)
    # every ResBlock carries a table: 2 down, 2 mid, 4 up
    tables = [n for n, _ in tm.named_parameters() if n.endswith("pos_emb.weight")]
    assert len(tables) == 8
    x, _, ctx = _inputs(5)
    ref = jax.jit(lambda p, x, c: jm.apply({"params": p}, x, T, c))(
        params, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(T),
                 torch.from_numpy(ctx))
    _close(out.numpy(), ref)
    # W 64 at level 0 against 32 positions: both sides raise
    wide = np.zeros((1, 16, 64, 4), np.float32)
    with pytest.raises(ValueError, match="pos_seq_len"):
        jm.apply({"params": params}, jnp.asarray(wide), T[:1],
                 jnp.asarray(ctx[:1]))
    with pytest.raises(ValueError, match="pos_seq_len"), torch.no_grad():
        tm(torch.from_numpy(wide), torch.from_numpy(T[:1]),
           torch.from_numpy(ctx[:1]))


def test_ldm_structure_with_both_options_matches_jax_leaves():
    # LDM_UNET's levels, attention placement and heads with 309 classes
    # (VGGSound's) and 64 positions, the smoke's adm and positional UNets,
    # at 64 base channels, by name and shape on `meta`
    import dataclasses

    extra = dict(num_classes=309, pos_seq_len=64, model_channels=64)
    shapes = jax.eval_shape(
        ju.UNetModel(dataclasses.replace(ju.LDM_UNET, **extra)).init,
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 16, 64, 4),
                                                    jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.float32), None, True,
        jax.ShapeDtypeStruct((1,), jnp.int32))
    sd = from_jax_params(jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
    with torch.device("meta"):
        tm = tu.UNetModel(dataclasses.replace(tu.LDM_UNET, **extra),
                          with_context=False)
    ours = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in sd.items()}
