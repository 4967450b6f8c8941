"""The port's stage-2 spec decoder (``train/stage2_decode.py``) against the
JAX package's, on the CPU.

- ``reconstruct`` and ``encode_spec`` through a tiny decoder (ch 32, one
  res block, ch_mult (1, 1, 2), 32 out channels: 128 mel bins, mid
  attention at D 64) on a tiny frozen CNN14, seeded random weights carried
  over with ``from_jax_params``: within 1e-4 of max(1, max|ref|).
- One MSE step (``DecoderWrapper``) and two GAN steps
  (``GANDecoderWrapper``: L1 + the hinge generator term, then the
  PatchGAN's step, its BatchNorm statistics carried into the next; both
  sides in float64, away from fp32's leaky-ReLU and hinge kinks) against
  JAX's ``make_train_step`` / ``make_gan_train_step``: the losses within
  1e-5 relative; each leaf's gradient (out of Adam's first moment,
  (1 − β1)·g on both sides) within 5e-4 of the leaf's rms; the statistics
  within 1e-5; each leaf after Adam within 1e-4 of its rms, at a rate of
  1e-7, under which Adam's first step of about lr·sign(g) cannot move an
  element by more than that where a gradient near zero flips sign.
- The decoder over a canvas of any channel count leaves ``SD_VAE``'s
  ``Decoder`` as it was; the train state defaults to the card.

The per-head kernels at the decoder's head dim 256 are held on the card
by ``tests/test_torch_ops.py`` (``gpu``), which runs there without flax.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import cavp as jc
from diff_foley_tpu.models import vae as jv
from diff_foley_tpu.train import stage2_decode as jd
from diff_foley_tpu.train.vae_losses import VAELossConfig as JLossConfig
from diff_foley_tpu_torch.models import cavp as tc
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.train import stage2_decode as td
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params
from test_torch_stage1 import CAVPModel64

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

CAVP_KW = dict(embed_dim=16, video_stage_blocks=(1, 1, 1, 1),
               video_base_channels=8, spec_channels=(8, 8, 16, 16, 32, 32))
DECODER = dict(ch=32, ch_mult=(1, 1, 2), num_res_blocks=1, out_channels=32)
LR = 1e-7
# 8 CNN14 steps → a (1, 8) canvas → 128 × 32, which the PatchGAN's
# three stride-2 convolutions take down to 2 × … patches
SPEC = (2, 128, 128)


def _configs():
    jcfg = jd.DecodeConfig(feat_dim=16, decoder=jv.VAEConfig(**DECODER),
                           lr=LR)
    tcfg = td.DecodeConfig(feat_dim=16, decoder=tv.VAEConfig(**DECODER),
                           lr=LR)
    assert jcfg.mel_bins == tcfg.mel_bins == 128
    return jcfg, tcfg


def _named(tree) -> dict:
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def decode_pair():
    """The JAX wrappers and the port's, on the same seeded weights; the
    port's frozen tower and decoder loaded from the JAX trees."""
    jcfg, tcfg = _configs()
    jcavp = jc.CAVPModel(jc.CAVPConfig(**CAVP_KW))
    shapes = jax.eval_shape(lambda: jcavp.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 32, 3)),
        jnp.zeros((1, 128, 64))))
    cavp_vars = {name: random_flax_params(tree, 90 + i)
                 for i, (name, tree) in enumerate(shapes.items())}
    jgan = jd.GANDecoderWrapper(jcfg, jcavp,
                                loss_cfg=JLossConfig(disc_start=0))
    state = jax.eval_shape(lambda: jgan.init_train_state(
        jax.random.PRNGKey(1), t_feat=8, spec_shape=(2, 128, 32)))
    params = random_flax_params(state.params, 92)
    disc = random_flax_params(state.disc_params, 93)
    stats = random_flax_params(state.disc_stats, 94)
    tcavp = tc.CAVPModel(tc.CAVPConfig(**CAVP_KW))
    tcavp.load_state_dict(from_jax_params(cavp_vars), strict=True)
    spec = np.random.default_rng(95).uniform(size=SPEC).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jcavp=jcavp, cavp_vars=cavp_vars,
                jgan=jgan, params=params, disc=disc, stats=stats,
                tcavp=tcavp, spec=spec)


def _port(pair, gan: bool, float64: bool = False):
    cls = td.GANDecoderWrapper if gan else td.DecoderWrapper
    cavp = pair["tcavp"]
    if float64:
        cavp = CAVPModel64(tc.CAVPConfig(**CAVP_KW))
        cavp.load_state_dict(pair["tcavp"].state_dict(), strict=True)
    w = cls(pair["tcfg"], cavp)
    w.decoder.load_state_dict(_named(pair["params"]), strict=True)
    if gan:
        w.disc.load_state_dict(_named({"params": pair["disc"],
                                       "batch_stats": pair["stats"]}),
                               strict=True)
    if float64:
        for m in (w.cavp, w.decoder, *([w.disc] if gan else [])):
            m.double()
    return w, w.init_train_state(None, "cpu")


def _close(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    out = out.detach().double().numpy()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(1.0, np.abs(ref).max()))


def test_reconstruct_and_encode_spec_match_jax(decode_pair):
    p = decode_pair
    jw = p["jgan"]
    feats = jax.jit(jw.encode_spec)(p["cavp_vars"], p["spec"])
    rec = jax.jit(jw.reconstruct)(p["params"], feats)
    tw, _ = _port(p, gan=False)
    with torch.no_grad():
        tfeats = tw.encode_spec(torch.from_numpy(p["spec"]))
        trec = tw.reconstruct(tfeats)
    assert tfeats.shape == (2, 8, 16) and trec.shape == (2, 128, 32)
    assert _close(tfeats, feats) <= 1e-4
    assert _close(trec, rec) <= 1e-4
    # the frozen tower: normalised per-step features, no gradient
    assert torch.allclose(tfeats.norm(dim=-1), torch.ones(2, 8), atol=1e-5)
    assert not any(q.requires_grad for q in tw.cavp.parameters())


def _rms_close(out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    rms = float(ref.double().square().mean().sqrt())
    err = float((out.double() - ref.reshape(out.shape).double()).abs().max())
    return err <= tol * max(rms, 1e-12), err / max(rms, 1e-12)


def _hold_update(names, opt, ref_mu, ref_params, module):
    """Gradients out of the first moments (β1 0.5: m = 0.5·g on the first
    step) within 5e-4 of each leaf's rms (fp32 sums in another order: the
    mid convolutions' weight gradients reach 1.4e-4), and the leaves after
    Adam within 1e-4 of their rms. A leaf
    whose gradient is analytically zero (the attention's key bias: a
    constant over a row of scores, which the softmax takes out) holds
    rounding only on both sides: under 1e-6 of the largest leaf's rms."""
    worst = {}
    mine = dict(zip(names, opt.mu))
    top = max(float(r.double().square().mean().sqrt())
              for r in ref_mu.values())
    for k, r in ref_mu.items():
        if float(r.double().square().mean().sqrt()) < 1e-6 * top:
            assert float(mine[k].abs().max()) < 1e-6 * top, k
            continue
        ok, ratio = _rms_close(mine[k] / 0.5, r / 0.5, 5e-4)
        worst[f"grad {k}"] = ratio
        assert ok, (k, ratio)
    sd = module.state_dict()
    for k, r in ref_params.items():
        ok, ratio = _rms_close(sd[k], r, 1e-4)
        assert ok, (k, ratio)
    return worst


def test_mse_step_matches_jax(decode_pair):
    p = decode_pair
    jw = jd.DecoderWrapper(p["jcfg"], p["jcavp"])
    params = jax.tree_util.tree_map(jnp.asarray, p["params"])
    j0 = jd.DecodeTrainState(jnp.asarray(0, jnp.int32), params,
                             jw.tx.init(params))
    j1, logs = jax.jit(jw.make_train_step())(j0, p["cavp_vars"], p["spec"])
    tw, state = _port(p, gan=False)
    out = tw.train_step(state, torch.from_numpy(p["spec"]))
    assert state.step == 1 and state.opt.count == 1
    assert float(out["l2_loss"]) == pytest.approx(float(logs["l2_loss"]),
                                                  rel=1e-5)
    names = [n for n, _ in tw.decoder.named_parameters()]
    _hold_update(names, state.opt, _named(j1.opt_state[0].mu),
                 _named(j1.params), tw.decoder)


def test_gan_step_matches_jax(decode_pair):
    # in float64 on both sides (JAX under x64; the GroupNorms and the
    # PatchGAN's batch statistics still in fp32): in fp32 a leaky-ReLU or
    # hinge input within rounding of its kink takes either branch by
    # summation order, and the discriminator's gradients differ by a
    # whole element's share (1.7% of bn1.bias's rms at these weights)
    p = decode_pair
    f64 = lambda tree: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), tree)
    with jax.enable_x64(True):
        jw = p["jgan"]
        params, disc = f64(p["params"]), f64(p["disc"])
        j0 = jd.GANDecodeState(jnp.asarray(0, jnp.int32), params, disc,
                               f64(p["stats"]), jw.tx.init(params),
                               jw.disc_tx.init(disc))
        step = jax.jit(jw.make_gan_train_step())
        args = (f64(p["cavp_vars"]), f64(p["spec"]))
        j1, logs = step(j0, *args)
        j2, logs2 = step(j1, *args)
    tw, state = _port(p, gan=True, float64=True)
    spec = torch.from_numpy(p["spec"]).double()
    stats_before = {k: v.clone() for k, v in tw.disc.state_dict().items()
                    if "running" in k}
    out = tw.train_step(state, spec)
    assert set(out) == set(logs)
    for k in out:
        assert float(out[k]) == pytest.approx(float(logs[k]), rel=1e-5), k
    names = [n for n, _ in tw.decoder.named_parameters()]
    _hold_update(names, state.opt, _named(j1.opt_state[0].mu),
                 _named(j1.params), tw.decoder)
    dnames = [n for n, _ in tw.disc.named_parameters()]
    _hold_update(dnames, state.disc_opt, _named(j1.disc_opt_state[0].mu),
                 _named(j1.disc_params), tw.disc)
    # the discriminator's statistics moved, as JAX's, and persist
    ref = _named({"batch_stats": j1.disc_stats})
    sd = tw.disc.state_dict()
    assert set(ref) == set(stats_before)
    for k, r in ref.items():
        torch.testing.assert_close(sd[k], r.double(), rtol=1e-5, atol=1e-6)
        assert not torch.equal(sd[k], stats_before[k]), k
    # a second step starts from them, on both sides
    out2 = tw.train_step(state, spec)
    assert state.step == 2
    for k in out2:
        assert float(out2[k]) == pytest.approx(float(logs2[k]), rel=1e-5), k


def test_decoder_canvas_leaves_sd_vae_unchanged():
    # SD_VAE's decoder still reads its 4 latent channels, key for key; the
    # spec decoder's conv_in reads the 512-channel feature canvas
    with torch.device("meta"):
        sd_vae = tv.Decoder(tv.SD_VAE)
        wide = tv.Decoder(tv.SD_VAE, in_channels=512)
        decode = td.DecodeConfig()
        spec_dec = tv.Decoder(decode.decoder, in_channels=decode.feat_dim)
    assert sd_vae.conv_in.weight.shape == (512, 4, 3, 3)
    assert wide.conv_in.weight.shape == (512, 512, 3, 3)
    assert set(sd_vae.state_dict()) == set(wide.state_dict())
    assert spec_dec.conv_in.weight.shape == (256, 512, 3, 3)
    assert decode.mel_bins == 128
    # every GroupNorm of one decoder forward: 26, the path's kernel-5 calls
    assert sum(isinstance(m, tv.GroupNorm32) for m in spec_dec.modules()) \
        == 26


def test_train_state_defaults_to_the_card():
    w = td.DecoderWrapper(td.DecodeConfig(feat_dim=16, decoder=tv.VAEConfig(
        **DECODER)), tc.CAVPModel(tc.CAVPConfig(**CAVP_KW)))
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w.init_train_state(0)
