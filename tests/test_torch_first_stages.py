"""The port's other first stages against the JAX package's, on the CPU, in
fp32 on both sides: ``SimpleDecoder``, ``UpsampleDecoder`` and
``LatentRescaler`` (at factors 2.0 and 1.5) with seeded random weights
from the flax init tree's shapes, loaded with ``strict=True``, NHWC at
the surface; the output within 2e-5 and the gradient of Σ out² over the
input within 1e-4 of max(1, max|ref|). The rescaler's resize is torch's
nearest index rule (src = floor(dst · in/out)), bit for bit the JAX
package's at non-integer factors. ``IdentityFirstStage`` passes its
input through, with the VQ interface's triple on request. The three
reference-checkpoint converters are exact against the JAX converters on
seeded numpy state dicts in the reference layout.

At published widths (the rescaler's attention at L 4096, D 512) they run
on the card in ``chip_smoke.py``'s run f.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import vae as jv
from diff_foley_tpu.utils import convert as jconv
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.utils import convert as tconv
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params, randomize_
from test_torch_cond_encoders import _close, _ref_sd, _same_tree, _x

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

TOL, GRAD_TOL = 2e-5, 1e-4


def _pairs():
    """(name, JAX module, port module, NHWC input shape)."""
    return {
        "simple": (jv.SimpleDecoder(in_channels=32, out_channels=3),
                   tv.SimpleDecoder(32, 3), (2, 4, 8, 32)),
        "upsample": (jv.UpsampleDecoder(out_channels=3, ch=32,
                                        num_res_blocks=1, ch_mult=(1, 2)),
                     tv.UpsampleDecoder(64, 3, 32, 1, (1, 2)), (2, 4, 8, 64)),
        "rescaler-2.0": (jv.LatentRescaler(factor=2.0, mid_channels=32,
                                           out_channels=8, depth=1),
                         tv.LatentRescaler(2.0, 4, 32, 8, depth=1),
                         (2, 4, 6, 4)),
        "rescaler-1.5": (jv.LatentRescaler(factor=1.5, mid_channels=32,
                                           out_channels=8, depth=2),
                         tv.LatentRescaler(1.5, 4, 32, 8, depth=2),
                         (2, 5, 7, 4)),
    }


@pytest.mark.parametrize("name", ["simple", "upsample", "rescaler-2.0",
                                  "rescaler-1.5"])
def test_first_stage_matches_jax(name):
    jm, tm, shape = _pairs()[name]
    x = _x(shape, 1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_flax_params(shapes["params"], seed=2)
    tm.load_state_dict(from_jax_params(params), strict=True)

    def loss(xx):
        out = jm.apply({"params": params}, xx)
        return jnp.sum(out**2), out

    (_, ref), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt)
    assert out.dtype == torch.float32
    _close(out.detach().numpy(), ref, TOL)
    (gt,) = torch.autograd.grad(out.square().sum(), xt)
    _close(gt.numpy(), g, GRAD_TOL)


@pytest.mark.parametrize("src,factor", [((5, 7), 1.5), ((4, 6), 2.0),
                                        ((9, 3), 0.75), ((6, 11), 1.3)])
def test_nearest_resize_is_the_jax_rule(src, factor):
    x = _x((2, *src, 3), 3)
    size = (int(round(src[0] * factor)), int(round(src[1] * factor)))
    ref = np.asarray(jv._torch_nearest_resize(jnp.asarray(x), *size))
    out = tv.NearestResize(factor)(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_upsample_decoder_refuses_dropout():
    # dropout is ported: a rate over 0 builds, and outside
    # ``dropout_draws`` (JAX's deterministic=True) the decoder is its
    # rate-0 self, bit for bit
    model = tv.UpsampleDecoder(64, 3, 32, 1, dropout=0.1)
    plain = tv.UpsampleDecoder(64, 3, 32, 1)
    randomize_(plain, 5)
    model.load_state_dict(plain.state_dict(), strict=True)
    x = torch.from_numpy(_x((1, 4, 4, 64), 6))
    with torch.no_grad():
        assert torch.equal(model(x), plain(x))


@pytest.mark.parametrize("vq", [False, True])
def test_identity_first_stage_matches_jax(vq):
    x = torch.arange(6.0).reshape(1, 2, 3)
    ours, ref = tv.IdentityFirstStage(vq), jv.IdentityFirstStage(vq)
    for m in ("encode", "decode"):
        assert getattr(ours, m)(x, 1, k=2) is x
    assert ours(x) is x
    q, r = ours.quantize(x), ref.quantize(x)
    if vq:
        assert q[0] is x and q[1:] == r[1:] == (None, [None, None, None])
    else:
        assert q is x


def _res_spec(prefix, cin, cout):
    spec = {f"{prefix}.norm1.weight": (cin,), f"{prefix}.norm1.bias": (cin,),
            f"{prefix}.conv1.weight": (cout, cin, 3, 3),
            f"{prefix}.conv1.bias": (cout,),
            f"{prefix}.norm2.weight": (cout,), f"{prefix}.norm2.bias": (cout,),
            f"{prefix}.conv2.weight": (cout, cout, 3, 3),
            f"{prefix}.conv2.bias": (cout,)}
    if cin != cout:
        spec[f"{prefix}.nin_shortcut.weight"] = (cout, cin, 1, 1)
        spec[f"{prefix}.nin_shortcut.bias"] = (cout,)
    return spec


def _conv_spec(key, cout, cin, k):
    return {f"{key}.weight": (cout, cin, k, k), f"{key}.bias": (cout,)}


def test_simple_decoder_converter_matches_jax():
    c = 32
    spec = {**_conv_spec("model.0", c, c, 1),
            **_res_spec("model.1", c, 2 * c), **_res_spec("model.2", 2 * c,
                                                          4 * c),
            **_res_spec("model.3", 4 * c, 2 * c),
            **_conv_spec("model.4", c, 2 * c, 1),
            **_conv_spec("model.5.conv", c, c, 3),
            "norm_out.weight": (c,), "norm_out.bias": (c,),
            **_conv_spec("conv_out", 3, c, 3)}
    sd = _ref_sd(spec, 4)
    tree = tconv.convert_simple_decoder(sd)
    _same_tree(tree, jconv.convert_simple_decoder(sd))
    tv.SimpleDecoder(c, 3).load_state_dict(from_jax_params(tree), strict=True)


def test_upsample_decoder_converter_matches_jax():
    spec = {**_res_spec("res_blocks.0.0", 64, 32),
            **_res_spec("res_blocks.0.1", 32, 32),
            **_conv_spec("upsample_blocks.0.conv", 32, 32, 3),
            **_res_spec("res_blocks.1.0", 32, 64),
            **_res_spec("res_blocks.1.1", 64, 64),
            "norm_out.weight": (64,), "norm_out.bias": (64,),
            **_conv_spec("conv_out", 3, 64, 3)}
    sd = {f"decoder.{k}": v for k, v in _ref_sd(spec, 5).items()}
    tree = tconv.convert_upsample_decoder(sd, 64, 32, 1, (1, 2),
                                          prefix="decoder.")
    _same_tree(tree, jconv.convert_upsample_decoder(sd, 64, 32, 1, (1, 2),
                                                    prefix="decoder."))
    tv.UpsampleDecoder(64, 3, 32, 1, (1, 2)).load_state_dict(
        from_jax_params(tree), strict=True)


def test_latent_rescaler_converter_matches_jax():
    m = 32
    spec = {**_conv_spec("conv_in", m, 4, 3),
            **_res_spec("res_block1.0", m, m),
            **_res_spec("res_block1.1", m, m),
            "attn.norm.weight": (m,), "attn.norm.bias": (m,),
            **{k: s for p in ("q", "k", "v", "proj_out")
               for k, s in _conv_spec(f"attn.{p}", m, m, 1).items()},
            **_res_spec("res_block2.0", m, m),
            **_res_spec("res_block2.1", m, m),
            **_conv_spec("conv_out", 8, m, 1)}
    sd = _ref_sd(spec, 6)
    tree = tconv.convert_latent_rescaler(sd, depth=2)
    _same_tree(tree, jconv.convert_latent_rescaler(sd, depth=2))
    tm = tv.LatentRescaler(1.5, 4, m, 8, depth=2)
    tm.load_state_dict(from_jax_params(tree), strict=True)
    # and runs as the JAX module on the converted weights
    x = _x((1, 5, 7, 4), 7)
    ref = jv.LatentRescaler(factor=1.5, mid_channels=m, out_channels=8,
                            depth=2).apply(jax.tree.map(jnp.asarray, tree),
                                           jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)).numpy(), ref, TOL)
