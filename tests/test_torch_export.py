"""The port's exporters against the JAX package's, on the CPU.

Each case mirrors tests/test_export_roundtrip.py: seeded random flax
parameters (of ``jax.eval_shape`` of the JAX model's init) go through the
JAX exporter, and the same parameters, carried into the port's modules by
``from_jax_params``, through the port's exporter. The two reference state
dicts must be equal key for key and bit for bit (tolerance 0: every leaf
is the same float32 values moved by transposes). The port's export then
goes back through the port's converters into a fresh module with
``strict=True`` and must give every tensor back bit for bit. A config that
walks a smaller structure than the weights raises from
``assert_complete``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import cavp as jc
from diff_foley_tpu.models import unet as ju
from diff_foley_tpu.models import vae as jv
from diff_foley_tpu.models.cond_encoder import \
    VideoFeatEncoderPosembed as JCond
from diff_foley_tpu.utils import convert as jconv
from diff_foley_tpu_torch.diffusion import latent_diffusion as tld
from diff_foley_tpu_torch.models import cavp as tc
from diff_foley_tpu_torch.models import unet as tu
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.models.cond_encoder import VideoFeatEncoderPosembed
from diff_foley_tpu_torch.utils import convert as tconv
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

UCFG = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
            attention_resolutions=(1, 2), num_heads=4, context_dim=24)
CLF = dict(out_channels=1, model_channels=32, num_res_blocks=1,
           channel_mult=(1, 2), attention_resolutions=(2,), num_heads=4,
           context_dim=16)
VCFG = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
# the JAX exporter walks the shipped (3, 4, 6, 3) SlowOnly stages
CAVP_KW = dict(video_base_channels=8, spec_channels=(8, 8, 16, 16, 32, 32))


def _random(init, seed: int) -> dict:
    shapes = jax.eval_shape(init)
    return {k: random_flax_params(v, seed + i)
            for i, (k, v) in enumerate(shapes.items())}


def _same(port: dict, ref: dict) -> None:
    """Key for key, dtype and shape, bit for bit."""
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert isinstance(port[k], np.ndarray), k
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
        np.testing.assert_array_equal(port[k], v, err_msg=k)


def _reloads(module_cls, sd: dict, back: dict) -> None:
    """``back`` (flax params from the port's converter) loads into a fresh
    module with strict=True and holds ``sd``'s tensors bit for bit."""
    fresh = module_cls()
    fresh.load_state_dict(from_jax_params(back), strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _unet_pair():
    params = _random(lambda: ju.UNetModel(ju.UNetConfig(**UCFG)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 16, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 4, 24))), 0)
    model = tu.UNetModel(tu.UNetConfig(**UCFG))
    model.load_state_dict(from_jax_params(params), strict=True)
    return params, model


def _vae_pair():
    params = _random(lambda: jv.AutoencoderKL(jv.VAEConfig(**VCFG)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))), 10)
    model = tv.AutoencoderKL(tv.VAEConfig(**VCFG))
    model.load_state_dict(from_jax_params(params), strict=True)
    return params, model


def _cond_pair():
    params = _random(lambda: JCond(embed_dim=24, seq_len=8).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, 512))), 20)
    model = VideoFeatEncoderPosembed(512, 24, 8)
    model.load_state_dict(from_jax_params(params), strict=True)
    return params, model


def test_unet_export_equals_jax_and_roundtrips():
    params, model = _unet_pair()
    sd = tconv.export_unet(model, tu.UNetConfig(**UCFG))
    _same(sd, jconv.export_unet(params, ju.UNetConfig(**UCFG)))
    # the stem conv in the reference OIHW layout; the GEGLU halves stacked
    assert sd["input_blocks.0.0.weight"].shape == (32, 4, 3, 3)
    assert sd["input_blocks.1.1.transformer_blocks.0.ff.net.0.proj.weight"] \
        .shape == (2 * 4 * 32, 32)
    # a state dict exports as its module does
    _same(tconv.export_unet(model.state_dict(), tu.UNetConfig(**UCFG)), sd)
    back = tconv.convert_unet(sd, tu.UNetConfig(**UCFG))
    _reloads(lambda: tu.UNetModel(tu.UNetConfig(**UCFG)), model.state_dict(),
             back)


def test_classifier_backbone_export_equals_jax_and_roundtrips():
    params = _random(lambda: ju.ClassifierBackbone(ju.UNetConfig(**CLF)).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 16, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 4, 16))), 30)
    model = tu.ClassifierBackbone(tu.UNetConfig(**CLF))
    model.load_state_dict(from_jax_params(params), strict=True)
    sd = tconv.export_classifier_backbone(model, tu.UNetConfig(**CLF))
    _same(sd, jconv.export_classifier_backbone(params, ju.UNetConfig(**CLF)))
    back = tconv.convert_classifier_backbone(sd, tu.UNetConfig(**CLF))
    _reloads(lambda: tu.ClassifierBackbone(tu.UNetConfig(**CLF)),
             model.state_dict(), back)


def test_vae_and_cond_export_equal_jax_and_roundtrip():
    vp, vae = _vae_pair()
    sd = tconv.export_vae(vae, tv.VAEConfig(**VCFG))
    _same(sd, jconv.export_vae(vp, jv.VAEConfig(**VCFG)))
    _reloads(lambda: tv.AutoencoderKL(tv.VAEConfig(**VCFG)),
             vae.state_dict(), tconv.convert_vae(sd, tv.VAEConfig(**VCFG)))

    ep, enc = _cond_pair()
    sd = tconv.export_cond_encoder(enc)
    _same(sd, jconv.export_cond_encoder(ep))
    assert sd["embedder.0.weight"].shape == (24, 512)
    _reloads(lambda: VideoFeatEncoderPosembed(512, 24, 8), enc.state_dict(),
             tconv.convert_cond_encoder(sd))


def test_composite_ldm_export_equals_jax_and_splits_back():
    up, unet = _unet_pair()
    ep, enc = _cond_pair()
    vp, vae = _vae_pair()
    ref = jconv.export_ldm_state_dict({"unet": up, "cond": ep}, vp,
                                      ju.UNetConfig(**UCFG),
                                      jv.VAEConfig(**VCFG))
    ldm = tld.LatentDiffusion(tld.LDMConfig(
        unet=tu.UNetConfig(**UCFG), vae=tv.VAEConfig(**VCFG),
        cond_embed_dim=24, cond_seq_len=8))
    ldm.unet.load_state_dict(unet.state_dict())
    ldm.cond.load_state_dict(enc.state_dict())
    ldm.vae.load_state_dict(vae.state_dict())
    ucfg, vcfg = tu.UNetConfig(**UCFG), tv.VAEConfig(**VCFG)
    sd = tconv.export_ldm_state_dict(ldm, ldm.vae, ucfg, vcfg)
    _same(sd, ref)
    # a train state's masters ("unet." and "cond." keys) export alike
    masters = {k: p for k, p in ldm.named_parameters()
               if k.startswith(("unet.", "cond."))}
    _same(tconv.export_ldm_state_dict(masters, ldm.vae.state_dict(), ucfg,
                                      vcfg), sd)
    u, v, c = tconv.split_ldm_state_dict(sd)
    _reloads(lambda: tu.UNetModel(ucfg), unet.state_dict(),
             tconv.convert_unet(u, ucfg))
    _reloads(lambda: tv.AutoencoderKL(vcfg), vae.state_dict(),
             tconv.convert_vae(v, vcfg))
    _reloads(lambda: VideoFeatEncoderPosembed(512, 24, 8), enc.state_dict(),
             tconv.convert_cond_encoder(c))


@pytest.fixture(scope="module")
def cavp_pair():
    jm = jc.CAVPModel(jc.CAVPConfig(**CAVP_KW))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 32, 32, 3)),
        jnp.zeros((1, 128, 64)), train=False))
    variables = {k: random_flax_params(v, 40 + i)
                 for i, (k, v) in enumerate(shapes.items())}
    model = tc.CAVPModel(tc.CAVPConfig(**CAVP_KW))
    model.load_state_dict(from_jax_params(variables), strict=True)
    return variables, model


def test_cavp_export_equals_jax_and_roundtrips(cavp_pair):
    variables, model = cavp_pair
    # the port's BatchNorm counts its batches; the export writes 0
    model.video_encoder.conv1.bn.num_batches_tracked.fill_(5)
    sd = tconv.export_cavp(model)
    _same(sd, jconv.export_cavp(variables))
    assert sd["video_encoder.conv1.conv.weight"].shape == (8, 3, 1, 7, 7)
    assert sd["logit_scale"].shape == ()
    assert sd["video_encoder.conv1.bn.num_batches_tracked"].dtype == np.int64
    assert int(sd["video_encoder.conv1.bn.num_batches_tracked"]) == 0
    fresh = tc.CAVPModel(tc.CAVPConfig(**CAVP_KW))
    fresh.load_state_dict(from_jax_params(tconv.convert_cavp(sd)),
                          strict=True)
    theirs = model.state_dict()
    for k, v in fresh.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, theirs[k]), k


def test_cavp_export_checkpoint_envelope(cavp_pair):
    variables, model = cavp_pair
    ckpt = tconv.export_cavp_checkpoint(model, epoch=7, name="unit")
    ref = jconv.export_cavp_checkpoint(variables, epoch=7, name="unit")
    assert set(ckpt) == set(ref) == {"epoch", "name", "state_dict"}
    assert ckpt["epoch"] == 7 and ckpt["name"] == "unit"
    _same(ckpt["state_dict"], ref["state_dict"])


@pytest.mark.parametrize("what", ["unet", "vae", "classifier"])
def test_a_mismatched_config_raises_from_assert_complete(what):
    """A config that walks fewer blocks than the weights hold leaves
    leaves unexported: the export raises (JAX: the same ValueError)."""
    if what == "unet":
        _, model = _unet_pair()
        small = tu.UNetConfig(**{**UCFG, "attention_resolutions": (1,)})
        export = lambda: tconv.export_unet(model, small)
    elif what == "vae":
        _, model = _vae_pair()
        small = tv.VAEConfig(**{**VCFG, "num_res_blocks": 0})
        export = lambda: tconv.export_vae(model, small)
    else:
        model = tu.ClassifierBackbone(tu.UNetConfig(**CLF))
        small = tu.UNetConfig(**{**CLF, "attention_resolutions": ()})
        export = lambda: tconv.export_classifier_backbone(model, small)
    with pytest.raises(ValueError, match="export incomplete"):
        export()


def test_a_larger_config_raises_on_the_missing_leaf():
    _, model = _vae_pair()
    big = tv.VAEConfig(**{**VCFG, "num_res_blocks": 2})
    with pytest.raises(KeyError, match="lack"):
        tconv.export_vae(model, big)
