"""PyTorch port models, guidance and sampler against the JAX package, on
the CPU, at tiny widths.

Every flax parameter is replaced with seeded random values (a fresh init
zeroes the output layers and would hide the attention) and carried over
with ``from_jax_params``; the port loads with ``strict=True``. JAX runs its
default "xla" attention backend; the port's packed attention runs its plain
version on CPU tensors. Inputs come from a numpy seed.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.diffusion.guidance import GuidanceSpec as JSpec
from diff_foley_tpu.diffusion.guidance import make_guided_eps_fn as j_guided
from diff_foley_tpu.diffusion import latent_diffusion as jld
from diff_foley_tpu.diffusion.samplers import ddim_sample as j_ddim
from diff_foley_tpu.diffusion.samplers import dpm_solver_sample as j_dpm
from diff_foley_tpu.diffusion.schedule import make_ddim_timesteps as j_ddim_ts
from diff_foley_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from diff_foley_tpu.models import cond_encoder as jce
from diff_foley_tpu.models import unet as ju
from diff_foley_tpu.models import vae as jv
from diff_foley_tpu.utils.precision import cast_floating
from diff_foley_tpu_torch.diffusion.guidance import (GuidanceSpec,
                                                     make_guided_eps_fn)
from diff_foley_tpu_torch.diffusion import latent_diffusion as tld
from diff_foley_tpu_torch.diffusion.samplers import ddim_sample, dpm_solver_sample
from diff_foley_tpu_torch.diffusion.schedule import (DiffusionSchedule,
                                                     make_ddim_timesteps)
from diff_foley_tpu_torch.models import cond_encoder as tce
from diff_foley_tpu_torch.models import unet as tu
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

UNET_KW = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
               attention_resolutions=(1, 2), num_heads=4, context_dim=24)
CLF_KW = dict(out_channels=1, model_channels=32, num_res_blocks=1,
              channel_mult=(1, 2, 2), attention_resolutions=(2, 4),
              num_heads=4, context_dim=48)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(out, ref, tol, what=""):
    """max|Δ| ≤ tol · max(1, max|ref|)."""
    out = np.asarray(torch.as_tensor(out).float() if isinstance(out, torch.Tensor)
                     else out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    scale = max(1.0, np.abs(ref).max())
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3e} > {tol:.1e}·{scale:.3g}"


def _pair(jmodel, tmodel, seed, *init_args):
    """Random flax params for ``jmodel`` and ``tmodel`` loaded with them."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *init_args))
    params = random_flax_params(shapes["params"], seed)
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    return {"params": params}, tmodel.eval()


def _inputs(seed, b=2, hw=(8, 16), lctx=6, dctx=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, *hw, 4)).astype(np.float32)
    t = np.array([3.0, 700.0][:b], np.float32)
    ctx = rng.standard_normal((b, lctx, dctx)).astype(np.float32)
    return x, t, ctx


def test_unet_matches():
    # fp32 on both sides; the sums run in other orders: 1e-4 of the output
    cfg = ju.UNetConfig(**UNET_KW)
    x, t, ctx = _inputs(20)
    jp, tm = _pair(ju.UNetModel(cfg), tu.UNetModel(tu.UNetConfig(**UNET_KW)),
                   21, x, t, ctx)
    ref = jax.jit(ju.UNetModel(cfg).apply)(jp, x, t, ctx)
    with torch.no_grad():
        out = tm(_t(x), _t(t), _t(ctx))
    _close(out, ref, 1e-4, "unet")


def _classifier(dtype="float32", seed=22):
    cfg = ju.UNetConfig(**CLF_KW, dtype=dtype)
    x, t, ctx = _inputs(23, dctx=48)
    jp, tm = _pair(ju.ClassifierBackbone(cfg),
                   tu.ClassifierBackbone(tu.UNetConfig(**CLF_KW, dtype=dtype)),
                   seed, x, t, ctx)
    return ju.ClassifierBackbone(cfg), jp, tm, (x, t, ctx)


def test_classifier_logits_and_guidance_grad_match():
    # logits and ∇ₓ Σ log_sigmoid(logits), fp32: 1e-4
    jm, jp, tm, (x, t, ctx) = _classifier()

    def log_p(x_):
        logits = jm.apply(jp, x_, t, ctx, return_logits=True)
        return jnp.sum(jax.nn.log_sigmoid(logits)), logits

    ref_grad, ref_logits = jax.jit(jax.grad(log_p, has_aux=True))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    logits = tm(xt, _t(t), _t(ctx), return_logits=True)
    (grad,) = torch.autograd.grad(
        torch.nn.functional.logsigmoid(logits).sum(), xt)
    _close(logits.detach(), ref_logits, 1e-4, "logits")
    _close(grad, ref_grad, 1e-4, "grad")
    with torch.no_grad():
        _close(tm(_t(x), _t(t), _t(ctx)), jax.nn.sigmoid(ref_logits), 1e-5,
               "sigmoid")


def test_classifier_bf16_dtype_flow_matches():
    # bf16 params and compute on both sides (flax promotion, fp32 norm
    # statistics, fp32 head): the two frameworks round bf16 at other
    # places, so 5e-2 of the logit scale; a norm or head run in bf16 by
    # mistake would miss it
    jm, jp, tm, (x, t, ctx) = _classifier("bfloat16")
    ref = jax.jit(lambda p: jm.apply(p, x, t, ctx, return_logits=True))(
        cast_floating(jp))
    with torch.no_grad():
        out = tm.to(torch.bfloat16)(_t(x), _t(t), _t(ctx), return_logits=True)
    assert out.dtype == torch.float32
    _close(out, ref, 5e-2, "bf16 logits")


def test_cond_encoder_matches():
    rng = np.random.default_rng(24)
    feat = rng.standard_normal((2, 6, 16)).astype(np.float32)
    jp, tm = _pair(jce.VideoFeatEncoderPosembed(embed_dim=24, seq_len=8),
                   tce.VideoFeatEncoderPosembed(16, 24, 8), 25, feat)
    ref = jce.VideoFeatEncoderPosembed(embed_dim=24, seq_len=8).apply(jp, feat)
    with torch.no_grad():
        _close(tm(_t(feat)), ref, 1e-5, "cond encoder")


def _vae_pair(seed):
    """The tiny JAX AutoencoderKL with random params, and the port's loaded
    with the whole tree."""
    jm = jv.AutoencoderKL(jv.VAEConfig(**VAE_KW))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 16, 32, 3))))
    params = random_flax_params(shapes["params"], seed)
    tm = tv.AutoencoderKL(tv.VAEConfig(**VAE_KW))
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, {"params": params}, tm.eval()


def test_vae_decode_matches():
    # post_quant_conv → Decoder, fp32, 1e-4
    jm, jp, tm = _vae_pair(26)
    z = np.random.default_rng(27).standard_normal((2, 8, 16, 4)).astype(
        np.float32)
    ref = jax.jit(lambda p, z_: jm.apply(p, z_, method=lambda m, a: m.decode(a)))(
        jp, z)
    with torch.no_grad():
        out = tm.decode(_t(z))
    _close(out, ref, 1e-4, "vae decode")


def test_vae_encode_matches():
    # Encoder (asymmetric-pad downsample, mid attention) → quant_conv →
    # the posterior's mode and clipped log-variance, and the LDM's
    # encode_first_stage (× 0.18215); fp32, 1e-4
    jm, jp, tm = _vae_pair(34)
    x = np.random.default_rng(35).uniform(size=(2, 16, 32, 3)).astype(
        np.float32)
    mean, logvar = jax.jit(lambda p, a: jm.apply(
        p, a, method=lambda m, a_: (lambda g: (g.mode(), g.logvar))(
            m.encode(a_))))(jp, x)
    jl = jld.LatentDiffusion(jld.LDMConfig(unet=ju.UNetConfig(**UNET_KW),
                                           vae=jv.VAEConfig(**VAE_KW)))
    ref_z = jl.encode_first_stage(jp, x)
    tl = tld.LatentDiffusion(tld.LDMConfig(unet=tu.UNetConfig(**UNET_KW),
                                           vae=tv.VAEConfig(**VAE_KW)))
    tl.vae = tm
    with torch.no_grad():
        post = tm.encode(_t(x))
        z = tl.encode_first_stage(_t(x))
    assert post.mode().shape == (2, 8, 16, 4)
    _close(post.mode(), mean, 1e-4, "mode")
    _close(post.logvar, logvar, 1e-4, "logvar")
    _close(z, ref_z, 1e-4, "encode_first_stage")


def test_guided_eps_fn_matches():
    # CFG 4.5 as one 2×-batch UNet call, plus the classifier term at
    # scale 50·σ_t; fp32, 1e-4 of ε
    ucfg = ju.UNetConfig(**UNET_KW)
    x, t, ctx = _inputs(28)
    jpu, tun = _pair(ju.UNetModel(ucfg), tu.UNetModel(tu.UNetConfig(**UNET_KW)),
                     29, x, t, ctx)
    jm, jpc, tclf, (_, _, feat) = _classifier()
    spec = dict(cfg_scale=4.5, classifier_scale=50.0)
    j_eps = j_guided(
        lambda x_, t_, c_: ju.UNetModel(ucfg).apply(jpu, x_, t_, c_),
        jnp.asarray(ctx), jnp.zeros_like(ctx), JSpec(**spec),
        lambda x_, t_, f_: jax.nn.log_sigmoid(
            jm.apply(jpc, x_, t_, f_, return_logits=True)),
        jnp.asarray(feat))
    t_eps = make_guided_eps_fn(
        tun, _t(ctx), torch.zeros(ctx.shape), GuidanceSpec(**spec),
        lambda x_, t_, f_: torch.nn.functional.logsigmoid(
            tclf(x_, t_, f_, return_logits=True)), _t(feat))
    sigma = np.float32(0.83)
    ref = jax.jit(j_eps)(jnp.asarray(x), jnp.asarray(t), jnp.asarray(sigma))
    _close(t_eps(_t(x), _t(t), float(sigma)), ref, 1e-4, "guided eps")


def _toy_eps_jax(x, t, s):
    return 0.5 * jnp.sin(x) + 1e-3 * t.reshape(-1, 1, 1, 1) * jnp.cos(x) + 0.1 * s


def _toy_eps_torch(x, t, s):
    return 0.5 * torch.sin(x) + 1e-3 * t.reshape(-1, 1, 1, 1) * torch.cos(x) \
        + 0.1 * s


@pytest.mark.parametrize("steps", [25, 3, 6, 14, 15])
def test_dpm_solver_multistep_matches(steps):
    # DPM-Solver++(2M): float64 host tables cast to float32 on both sides; a
    # closed-form ε keeps the comparison on the solver: 1e-5 of x. 14 and 15
    # straddle lower_order_final's switch.
    kw = dict(timesteps=1000, linear_start=0.00085, linear_end=0.0120)
    x_T = np.random.default_rng(30).standard_normal((2, 4, 8, 4)).astype(
        np.float32)
    ref = j_dpm(_toy_eps_jax, JSchedule.create(**kw), jnp.asarray(x_T),
                steps=steps)
    out = dpm_solver_sample(_toy_eps_torch, DiffusionSchedule.create(**kw),
                            _t(x_T), steps=steps)
    _close(out, ref, 1e-5, "dpm multistep")


def test_converter_rules():
    # Dense (in, out) → (out, in), Conv HWIO → OIHW, scale → weight, the
    # GroupNorm_0 scope folded away, pos_emb kept
    rng = np.random.default_rng(31)
    tree = {"params": {
        "d": {"kernel": rng.standard_normal((3, 5))},
        "c": {"kernel": rng.standard_normal((3, 3, 2, 7)), "bias": np.ones(7)},
        "n": {"GroupNorm_0": {"scale": np.ones(4), "bias": np.zeros(4)}},
        "pos_emb": np.zeros((2, 3)),
    }}
    sd = from_jax_params(tree)
    assert sd["d.weight"].shape == (5, 3)
    assert sd["c.weight"].shape == (7, 2, 3, 3)
    np.testing.assert_array_equal(
        sd["c.weight"][4, 1].numpy(), tree["params"]["c"]["kernel"][:, :, 1, 4])
    assert set(sd) == {"d.weight", "c.weight", "c.bias", "n.weight", "n.bias",
                       "pos_emb"}
    # a UNet tree loads strictly and covers every parameter
    cfg = ju.UNetConfig(**UNET_KW)
    x, t, ctx = _inputs(32)
    _pair(ju.UNetModel(cfg), tu.UNetModel(tu.UNetConfig(**UNET_KW)), 33,
          x, t, ctx)


def _ddim_inputs(seed, steps, shape=(2, 8, 16, 4)):
    """x_T, x0, a left-half keep mask and the per-step forward noise."""
    rng = np.random.default_rng(seed)
    n = len(make_ddim_timesteps(steps, 1000))
    assert n == len(j_ddim_ts("uniform", steps, 1000))
    x_T, x0 = (rng.standard_normal(shape).astype(np.float32) for _ in "ab")
    mask = np.zeros(shape[:3] + (1,), np.float32)
    mask[:, :, : shape[2] // 2] = 1.0
    noise = rng.standard_normal((n, *shape)).astype(np.float32)
    return x_T, x0, mask, noise


@pytest.mark.parametrize("steps", [4, 25])
def test_ddim_inpaint_matches_on_tiny_unet(steps):
    # masked DDIM (η 0) with CFG 4.5 and the classifier term at 50·√(1−ᾱ_t)
    # through a tiny UNet and classifier, shared x_T and forward noise;
    # fp32, 1e-4 of x. (3 steps are out of the JAX sampler's range: the
    # stride gives step 1000 of a 1000-entry table.)
    ucfg = ju.UNetConfig(**UNET_KW)
    x, t, ctx = _inputs(36)
    jpu, tun = _pair(ju.UNetModel(ucfg), tu.UNetModel(tu.UNetConfig(**UNET_KW)),
                     37, x, t, ctx)
    jm, jpc, tclf, (_, _, feat) = _classifier()
    spec = dict(cfg_scale=4.5, classifier_scale=50.0)
    j_eps = j_guided(
        lambda x_, t_, c_: ju.UNetModel(ucfg).apply(jpu, x_, t_, c_),
        jnp.asarray(ctx), jnp.zeros_like(ctx), JSpec(**spec),
        lambda x_, t_, f_: jax.nn.log_sigmoid(
            jm.apply(jpc, x_, t_, f_, return_logits=True)),
        jnp.asarray(feat))
    t_eps = make_guided_eps_fn(
        tun, _t(ctx), torch.zeros(ctx.shape), GuidanceSpec(**spec),
        lambda x_, t_, f_: torch.nn.functional.logsigmoid(
            tclf(x_, t_, f_, return_logits=True)), _t(feat))
    kw = dict(timesteps=1000, linear_start=0.00085, linear_end=0.0120)
    x_T, x0, mask, noise = _ddim_inputs(38, steps)
    ref = j_ddim(j_eps, JSchedule.create(**kw), jnp.asarray(x_T),
                 jax.random.PRNGKey(0), steps=steps, mask=jnp.asarray(mask),
                 x0=jnp.asarray(x0), mask_noise=jnp.asarray(noise))
    out = ddim_sample(t_eps, DiffusionSchedule.create(**kw), _t(x_T),
                      steps=steps, mask=_t(mask), x0=_t(x0),
                      mask_noise=_t(noise))
    _close(out, ref, 1e-4, "ddim inpaint")


@pytest.mark.parametrize("steps,masked", [(6, True), (25, False)])
def test_ddim_matches_closed_form_eps(steps, masked):
    # the sampler alone, on a closed-form ε: 6 steps make the stride give
    # 7 (as the reference's does); fp32, 1e-5 of x
    kw = dict(timesteps=1000, linear_start=0.00085, linear_end=0.0120)
    x_T, x0, mask, noise = _ddim_inputs(39, steps, (2, 4, 8, 4))
    jm = dict(mask=jnp.asarray(mask), x0=jnp.asarray(x0),
              mask_noise=jnp.asarray(noise)) if masked else {}
    tm = dict(mask=_t(mask), x0=_t(x0), mask_noise=_t(noise)) if masked else {}
    ref = j_ddim(_toy_eps_jax, JSchedule.create(**kw), jnp.asarray(x_T),
                 jax.random.PRNGKey(0), steps=steps, **jm)
    out = ddim_sample(_toy_eps_torch, DiffusionSchedule.create(**kw),
                      _t(x_T), steps=steps, **tm)
    _close(out, ref, 1e-5, "ddim")
