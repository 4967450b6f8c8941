"""Dropout above 0 and the ``remat_policy`` save policies in the port, on
the CPU.

- With dropout 0.1 in the config and no dropout generator (the JAX
  package's ``deterministic=True``), the UNet, the VAE, the 1-D audio UNet
  and ``EncoderUNetModel`` equal the JAX models with the same rate and
  weights (fp32, max|Δ| ≤ 1e-5 of max(1, max|ref|)).
- The train-mode mask keeps each element with probability 1 − p (the
  count of kept elements within 5σ of the binomial mean), scales the kept
  ones by 1/(1 − p) exactly, and is the same for the same generator state.
- A checkpointed block draws its masks again in the recompute from the
  state its generator had at the forward: the gradients with
  ``use_checkpoint`` equal those without, bit for bit, under every
  policy, in the UNet and through ``LatentDiffusion.p_losses``; a plain
  ``torch.utils.checkpoint`` (which restores only the default
  generators) would not.
- Every ``remat_policy`` gives the gradients of "none" bit for bit and of
  JAX (per leaf, max|Δ| ≤ 1e-4 of the leaf's max|g|), as
  tests/test_remat_policy.py holds the JAX package; "dots" recomputes no
  matrix product, "dots_no_batch" none without a batch dimension, and the
  attention (no matrix product) runs again in the backward of every
  checkpointed block under every policy.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from diff_foley_tpu.models import audio_unet as ja
from diff_foley_tpu.models import unet as ju
from diff_foley_tpu.models import vae as jv
from diff_foley_tpu_torch.diffusion import latent_diffusion as tld
from diff_foley_tpu_torch.models import attention as tattn
from diff_foley_tpu_torch.models import audio_unet as ta
from diff_foley_tpu_torch.models import unet as tu
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.models.layers import Dropout, dropout_draws
from diff_foley_tpu_torch.ops import hopper_attention as ha
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params, randomize_

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
# tests/test_remat_policy.py's UNet
TINY = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
            attention_resolutions=(1, 2), num_heads=4, context_dim=24)
POLICIES = ("none", "dots", "dots_no_batch")


def _close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


@functools.lru_cache(maxsize=None)
def _unet_inputs():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 8, 16, 4)))
    t = np.asarray([10.0, 500.0], np.float32)
    ctx = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 6, 24)))
    return x, t, ctx


@functools.lru_cache(maxsize=None)
def _unet_params():
    x, t, ctx = _unet_inputs()
    shapes = jax.eval_shape(ju.UNetModel(ju.UNetConfig(**TINY)).init,
                            jax.random.PRNGKey(2), x, t, ctx)
    return random_flax_params(shapes["params"], seed=3)


@functools.lru_cache(maxsize=None)
def jax_unet():
    """The JAX UNet with dropout 0.1, deterministic (the rate then acts
    nowhere): the loss mean(out²), its gradients in the port's names, and
    the output, from one jitted call."""
    x, t, ctx = _unet_inputs()
    jm = ju.UNetModel(ju.UNetConfig(**dict(TINY, dropout=0.1)))

    def loss(p):
        out = jm.apply({"params": p}, x, t, ctx)
        return jnp.mean(out ** 2), out

    (jl, out), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        _unet_params())
    return (float(jl), from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                              jg)),
            np.asarray(out))


@pytest.mark.parametrize("model", ["unet", "vae", "audio_unet",
                                   "encoder_unet"])
def test_eval_with_dropout_equals_jax(model):
    rng = np.random.default_rng(7)
    if model == "unet":
        x, t, ctx = _unet_inputs()
        cfg = dict(TINY, dropout=0.1)
        params = _unet_params()
        ref = jax_unet()[2]
        tm = tu.UNetModel(tu.UNetConfig(**cfg))
        args = (x, t, ctx)
    elif model == "vae":
        cfg = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.1)
        x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
        jm = jv.AutoencoderKL(jv.VAEConfig(**cfg))
        params = random_flax_params(jax.eval_shape(
            jm.init, jax.random.PRNGKey(4), x)["params"], seed=5)
        ref = jax.jit(lambda v, q: jm.apply(v, q, method=lambda m, y: m.decode(
            m.encode(y).mode())))({"params": params}, x)
        vae = tv.AutoencoderKL(tv.VAEConfig(**cfg))
        tm = lambda q: vae.decode(vae.encode(q).mode())
        tm.load_state_dict = vae.load_state_dict
        args = (x,)
    elif model == "audio_unet":
        cfg = dict(in_channels=8, out_channels=8, model_channels=32,
                   num_res_blocks=1, attention_resolutions=(1, 2),
                   channel_mult=(1, 2), num_heads=4, context_dim=24,
                   dropout=0.1)
        x = rng.standard_normal((2, 16, 8)).astype(np.float32)
        t = np.asarray([3.0, 700.0], np.float32)
        ctx = rng.standard_normal((2, 6, 24)).astype(np.float32)
        jm = ja.AudioUNetModel(ja.AudioUNetConfig(**cfg))
        params = random_flax_params(jax.eval_shape(
            jm.init, jax.random.PRNGKey(4), x, t, ctx)["params"], seed=6)
        ref = jax.jit(jm.apply)({"params": params}, x, t, ctx)
        tm = ta.AudioUNetModel(ta.AudioUNetConfig(**cfg))
        args = (x, t, ctx)
    else:
        cfg = dict(out_channels=3, model_channels=32, num_res_blocks=1,
                   channel_mult=(1, 2), attention_resolutions=(2,),
                   num_heads=4, dropout=0.1)
        x = rng.standard_normal((2, 8, 16, 4)).astype(np.float32)
        t = np.asarray([3.0, 700.0], np.float32)
        jm = ju.EncoderUNetModel(ju.UNetConfig(**cfg), pool="adaptive")
        params = random_flax_params(jax.eval_shape(
            jm.init, jax.random.PRNGKey(4), x, t)["params"], seed=8)
        ref = jax.jit(jm.apply)({"params": params}, x, t)
        tm = tu.EncoderUNetModel(tu.UNetConfig(**cfg), pool="adaptive",
                                 hw=(8, 16))
        args = (x, t)
    tm.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(np.asarray(a)) for a in args))
    _close(out.numpy(), ref, OUT_TOL)


def test_the_train_mask_has_rate_p_scale_and_seed():
    p, n = 0.25, 200_000
    x = torch.ones(n)
    drop = Dropout(p)
    assert torch.equal(drop(x), x)                    # no generator: identity
    with dropout_draws(torch.Generator().manual_seed(1)):
        y = drop(x)
        assert torch.equal(Dropout(0.0)(x), x)
        assert torch.equal(Dropout(1.0)(x), torch.zeros_like(x))
    kept = int((y != 0).sum())
    assert abs(kept - n * (1 - p)) <= 5 * (n * p * (1 - p)) ** 0.5
    assert set(y[y != 0].unique().tolist()) == {float(
        torch.tensor(1.0) / (1 - p))}
    with dropout_draws(torch.Generator().manual_seed(1)):
        assert torch.equal(drop(x), y)
    with dropout_draws(torch.Generator().manual_seed(2)):
        assert not torch.equal(drop(x), y)
    with dropout_draws(torch.Generator().manual_seed(1)):
        yb = drop(x.bfloat16())
    assert yb.dtype == torch.bfloat16 and torch.equal(yb != 0, y != 0)


def _port_unet(cfg: dict):
    model = tu.UNetModel(tu.UNetConfig(**cfg))
    model.load_state_dict(from_jax_params(_unet_params()), strict=True)
    return model


def _loss_grads(cfg: dict, seed=None):
    """Loss mean(out²) and its gradients, the masks drawn from a generator
    seeded ``seed`` (None: no dropout)."""
    model = _port_unet(cfg)
    args = [torch.from_numpy(np.asarray(a)) for a in _unet_inputs()]
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    with dropout_draws(gen):
        loss = model(*args).square().mean()
    params = list(model.parameters())
    return loss.detach(), torch.autograd.grad(loss, params)


@pytest.mark.parametrize("policy", POLICIES)
def test_checkpointed_dropout_gradients_equal_unchecked(policy):
    cfg = dict(TINY, dropout=0.1)
    l0, g0 = _loss_grads(cfg, seed=11)
    l1, g1 = _loss_grads(dict(cfg, use_checkpoint=True, remat_policy=policy),
                         seed=11)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    # the masks act: another seed gives another loss
    assert not torch.equal(_loss_grads(cfg, seed=12)[0], l0)


def test_a_plain_checkpoint_would_draw_other_masks():
    """The trap ``attention.checkpointed`` closes: torch.utils.checkpoint
    restores only the default generators, so a recompute that draws from
    an explicit generator (here: a backward inside the forward's
    ``dropout_draws``) draws other masks, and the gradients come out
    wrong with no error."""
    torch.manual_seed(0)
    block = tattn.BasicTransformerBlock(32, 32, 2, 16, dropout=0.5)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.2)
    t = torch.randn(2, 5, 32, requires_grad=True)

    def grads(run):
        with dropout_draws(torch.Generator().manual_seed(3)):
            out = run()
            return torch.autograd.grad(out.square().sum(), [t]
                                       + list(block.parameters()))

    ref = grads(lambda: block(t, None))
    ours = grads(lambda: tattn.checkpointed(block, "none", t, None))
    plain = grads(lambda: torch.utils.checkpoint.checkpoint(
        block, t, None, use_reentrant=False))
    assert all(torch.equal(a, b) for a, b in zip(ref, ours))
    assert not all(torch.equal(a, b) for a, b in zip(ref, plain))


def test_p_losses_dropout_under_checkpoint_equals_unchecked():
    def run(use_checkpoint: bool):
        unet = tu.UNetConfig(**dict(TINY, dropout=0.2,
                                    use_checkpoint=use_checkpoint))
        ldm = tld.LatentDiffusion(tld.LDMConfig(
            unet=unet, vae=tv.VAEConfig(ch=32, ch_mult=(1, 1, 1, 1),
                                        num_res_blocks=1),
            cond_embed_dim=24, cond_seq_len=6))
        randomize_(ldm, 21)
        rng = np.random.default_rng(22)
        z = torch.from_numpy(rng.standard_normal((2, 8, 16, 4)).astype(
            np.float32))
        feat = torch.from_numpy(rng.standard_normal((2, 6, 512)).astype(
            np.float32))
        loss, _ = ldm.p_losses(z, feat,
                               generator=torch.Generator().manual_seed(23))
        params = [p for n, p in ldm.named_parameters()
                  if n.startswith(("unet.", "cond."))]
        return loss.detach(), torch.autograd.grad(loss, params)

    (l0, g0), (l1, g1) = run(False), run(True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    with pytest.raises(ValueError, match="generator"):
        ldm = tld.LatentDiffusion(tld.LDMConfig(
            unet=tu.UNetConfig(**dict(TINY, dropout=0.2)), cond_embed_dim=24,
            cond_seq_len=6))
        ldm.p_losses(torch.zeros(1, 8, 16, 4), torch.zeros(1, 6, 512),
                     draws={"t": torch.zeros(1), "noise": torch.zeros(
                         1, 8, 16, 4), "keep": torch.ones(1, 1, 1,
                                                         dtype=torch.bool)})


class _Products(TorchDispatchMode):
    """Counts the matrix products run, with and without a batch axis."""

    def __init__(self):
        super().__init__()
        self.batched = self.flat = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func._overloadpacket
        if packet in (torch.ops.aten.bmm, torch.ops.aten.baddbmm):
            self.batched += 1
        elif packet in (torch.ops.aten.mm, torch.ops.aten.addmm):
            self.flat += 1
        return func(*args, **(kwargs or {}))


def test_the_policies_save_the_products_and_recompute_the_attention(
        monkeypatch):
    calls = []
    real = ha.attention_packed_fwd

    def counted(*a, **k):
        calls.append(None)
        return real(*a, **k)

    monkeypatch.setattr(ha, "attention_packed_fwd", counted)
    args = [torch.from_numpy(np.asarray(a)) for a in _unet_inputs()]
    backward = {}
    for policy in POLICIES:
        model = _port_unet(dict(TINY, use_checkpoint=True,
                                remat_policy=policy))
        calls.clear()
        loss = model(*args).square().mean()
        forward = len(calls)
        with _Products() as mode:
            torch.autograd.grad(loss, list(model.parameters()))
        backward[policy] = (mode.flat, mode.batched)
        # the attention is no product: recomputed under every policy, once
        # per attention of every checkpointed block
        blocks = sum(m.depth for m in model.modules()
                     if isinstance(m, tattn.SpatialTransformer))
        assert forward == len(calls) - forward == 2 * blocks == 14
    # "dots" saves every product, "dots_no_batch" those without a batch
    # axis; what "none" recomputes on top is the forward's share
    none, dots, flat = (backward[p] for p in POLICIES)
    assert none[0] > flat[0] == dots[0]
    assert none[1] >= flat[1] >= dots[1]


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_grads_match_none_and_jax(policy):
    l0, g0 = _loss_grads(TINY)
    l1, g1 = _loss_grads(dict(TINY, use_checkpoint=True,
                              remat_policy=policy))
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    # JAX's gradients: tests/test_remat_policy.py holds them equal under
    # every JAX policy, so one compile serves the three
    jl, ref, _ = jax_unet()
    np.testing.assert_allclose(float(l1), jl, rtol=1e-5)
    names = [n for n, _ in _port_unet(TINY).named_parameters()]
    ours = dict(zip(names, g1))
    assert set(ours) == set(ref)
    # the level-0 norms hold one channel a group, which removes a
    # per-channel shift in front of them: those leaves' gradients are
    # rounding noise on both sides (under 1e-5 of the largest leaf's)
    top = max(float(g.abs().max()) for g in ref.values())
    noise = lambda grads: {k for k, g in grads.items()
                           if float(g.abs().max()) <= 1e-5 * top}
    assert noise(ours) == noise(ref)
    for name, g in ours.items():
        if name in noise(ref):
            continue
        scale = float(ref[name].abs().max())
        _close(g.numpy() / scale, ref[name].numpy() / scale, GRAD_TOL)


def test_unknown_policies_raise():
    with pytest.raises(ValueError, match="remat_policy"):
        tu.UNetModel(tu.UNetConfig(**dict(TINY, remat_policy="all")))
    with pytest.raises(ValueError, match="remat_policy"):
        tattn.checkpointed(torch.nn.Identity(), "everything",
                           torch.zeros(1))
