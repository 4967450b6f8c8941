"""The port's reference-weight helpers against the JAX package's, on the
CPU, on seeded numpy state dicts in the reference layouts (no real
checkpoint is needed):

- ``merge_params`` (strict=False semantics): the merged tree, and the
  missing and unexpected lists in the JAX order, on absent keys, keys
  with no place and a shape mismatch;
- ``convert_slowonly``, ``convert_cnn14`` and
  ``inflate_resnet50_to_slowonly``: the same trees, leaf for leaf;
- ``init_cavp_pretrained_towers``: the merged variables and the report
  equal JAX's, and the variables load into the port's ``CAVPModel`` with
  ``strict=True``;
- ``convert_lpips`` and ``convert_lpaps``: the same trees, and the port's
  LPIPS and LPAPS on them give JAX's distances within 1e-5 of
  max(1e-3, max|ref|) (full VGG16 widths, small inputs).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import cavp as jc
from diff_foley_tpu.train import perceptual as jp
from diff_foley_tpu.utils import convert as jconv
from diff_foley_tpu_torch.models import cavp as tc
from diff_foley_tpu_torch.train import perceptual as tp
from diff_foley_tpu_torch.utils import convert as tconv
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params
from test_torch_cond_encoders import _ref_sd, _same_tree, _x

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

# the shipped tower geometry, cut in width: (3, 4, 6, 3) SlowOnly stages at
# 8 base channels, a narrow CNN14
CAVP_KW = dict(video_base_channels=8, spec_channels=(8, 8, 16, 16, 32, 32))


def test_merge_params_matches_jax():
    rng = np.random.default_rng(0)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    init = {"a": {"kernel": r(2, 3), "bias": r(3)}, "b": {"kernel": r(4, 4)},
            "c": r(5), "d": {"e": {"f": r(2)}}}
    loaded = {"a": {"kernel": r(2, 3), "bias": r(4), "extra": r(1)},
              "c": r(5), "d": {"e": {"f": r(2), "g": r(3)}, "h": r(1)},
              "z": {"kernel": r(2)}}
    ours = tconv.merge_params(init, loaded)
    ref = jconv.merge_params(init, loaded)
    _same_tree(ours[0], ref[0])
    assert ours[1:] == ref[1:]
    assert ours[1] == ["/a/bias", "/b"]
    assert ours[2] == ["/a/extra", "/d/e/g", "/d/h", "/z"]
    assert ours[0]["a"]["kernel"] is loaded["a"]["kernel"]
    assert ours[0]["a"]["bias"] is init["a"]["bias"]


@pytest.fixture(scope="module")
def cavp_variables():
    video = np.zeros((1, 5, 32, 32, 3), np.float32)
    spec = np.zeros((1, 128, 64), np.float32)
    shapes = jax.eval_shape(lambda: jc.CAVPModel(jc.CAVPConfig(**CAVP_KW))
                            .init(jax.random.PRNGKey(0), jnp.asarray(video),
                                  jnp.asarray(spec)))
    return {name: random_flax_params(tree, 1 + i)
            for i, (name, tree) in enumerate(shapes.items())}


def _export(variables, tower, walk, prefix, seed):
    """A tower's reference-layout state dict through the JAX exporter's
    walk, re-drawn from ``seed`` (other values than the init's)."""
    sub = {"params": variables["params"][tower],
           "batch_stats": variables["batch_stats"][tower]}
    m = jconv._BNExportMapper(sub, prefix)
    walk(m)
    rng = np.random.default_rng(seed)
    return {k: (np.abs if k.endswith("running_var") else lambda a: a)(
        rng.standard_normal(np.shape(v)).astype(np.float32))
        if np.ndim(v) else v for k, v in m.out.items()}


def test_tower_converters_match_jax(cavp_variables):
    sd = _export(cavp_variables, "video_encoder", jconv._walk_slowonly,
                 "backbone.", 2)
    _same_tree(tconv.convert_slowonly(sd, "backbone."),
               jconv.convert_slowonly(sd, "backbone."))
    sd = _export(cavp_variables, "spec_encoder", jconv._walk_cnn14, "", 3)
    _same_tree(tconv.convert_cnn14(sd), jconv.convert_cnn14(sd))


def _resnet50_spec(stage_blocks=(3, 4, 6, 3), c=4):
    conv, bn = (c, c, 3, 3), (c,)
    spec = {"conv1.weight": (c, 3, 7, 7), "fc.weight": (10, c),
            "fc.bias": (10,)}
    bns = ["bn1"]
    for s, blocks in enumerate(stage_blocks, start=1):
        for b in range(blocks):
            for j in (1, 2, 3):
                spec[f"layer{s}.{b}.conv{j}.weight"] = conv
                bns.append(f"layer{s}.{b}.bn{j}")
            if b == 0:
                spec[f"layer{s}.{b}.downsample.0.weight"] = (c, c, 1, 1)
                bns.append(f"layer{s}.{b}.downsample.1")
    for key in bns:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            spec[f"{key}.{leaf}"] = bn
    return spec


def test_inflate_resnet50_matches_jax():
    sd = _ref_sd(_resnet50_spec(), 4)
    ours = tconv.inflate_resnet50_to_slowonly(sd)
    _same_tree(ours, jconv.inflate_resnet50_to_slowonly(sd))
    # magnitude kept: stage 3's conv1 is a 3-frame kernel of w / 3
    k = ours["params"]["layer3_0"]["conv1"]["conv"]["kernel"]
    assert k.shape == (3, 3, 3, 4, 4)
    np.testing.assert_allclose(k.sum(0), sd["layer3.0.conv1.weight"]
                               .transpose(2, 3, 1, 0), rtol=1e-6)


def test_init_cavp_pretrained_towers_matches_jax(cavp_variables):
    kinetics = _export(cavp_variables, "video_encoder", jconv._walk_slowonly,
                       "backbone.", 5)
    # a head the walk does not read, and a stem of another width: kept
    # from the initialisation, listed missing
    kinetics["cls_head.fc_cls.weight"] = np.ones((400, 64), np.float32)
    stem = kinetics["backbone.conv1.conv.weight"]
    kinetics["backbone.conv1.conv.weight"] = np.ones(
        (stem.shape[0] + 1, *stem.shape[1:]), np.float32)
    pann = {"model": _export(cavp_variables, "spec_encoder",
                             jconv._walk_cnn14, "", 6)}
    before = cavp_variables["params"]["video_encoder"]
    ours, report = tconv.init_cavp_pretrained_towers(cavp_variables,
                                                     kinetics, pann)
    # the input is left as it was
    assert cavp_variables["params"]["video_encoder"] is before
    copy = jax.tree.map(np.asarray, cavp_variables)   # JAX's mutates its own
    ref, ref_report = jconv.init_cavp_pretrained_towers(copy, kinetics, pann)
    _same_tree(ours, ref)
    assert report == ref_report
    assert report["video"][0] == ["/conv1/conv/kernel"]
    assert report["spec"] == ([], [])
    model = tc.CAVPModel(tc.CAVPConfig(**CAVP_KW))
    model.load_state_dict(from_jax_params(ours), strict=True)
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["video_encoder.layer1_0.conv1.bn.running_mean"].numpy(),
        kinetics["backbone.layer1.0.conv1.bn.running_mean"])


def _vgg_spec(in_ch):
    spec, c = {}, in_ch
    for i, t in enumerate(jconv._VGG_TORCH_CONV_IDX):
        out = tp.VGG_PLAN[[j for j, v in enumerate(tp.VGG_PLAN)
                           if v != "M"][i]]
        s = jconv._vgg_slice_of(t)
        spec[f"net.slice{s}.{t}.weight"] = (out, c, 3, 3)
        spec[f"net.slice{s}.{t}.bias"] = (out,)
        c = out
    for k, ch in enumerate(tp.LPIPS_CHANNELS):
        spec[f"lin{k}.model.1.weight"] = (1, ch, 1, 1)
    return spec


@pytest.mark.parametrize("kind", ["lpips", "lpaps"])
def test_perceptual_converters_match_jax(kind):
    n_freq = 16
    spec = _vgg_spec(3 if kind == "lpips" else 1)
    sd = _ref_sd(spec, 7)
    rng = np.random.default_rng(8)
    for leaf in ("shift", "scale"):
        shape = (1, 3, 1, 1) if kind == "lpips" else (1, n_freq, 1)
        v = rng.standard_normal(shape).astype(np.float32) * 0.1
        sd[f"scaling_layer.{leaf}"] = v + (1.0 if leaf == "scale" else 0.0)
    # the VGG heads take |w| (LPIPS's learned weights are non-negative)
    for k in range(5):
        sd[f"lin{k}.model.1.weight"] = np.abs(sd[f"lin{k}.model.1.weight"])
    conv_t, conv_j = {"lpips": (tconv.convert_lpips, jconv.convert_lpips),
                      "lpaps": (tconv.convert_lpaps,
                                jconv.convert_lpaps)}[kind]
    tree = conv_t(sd)
    _same_tree(tree, conv_j(sd))
    if kind == "lpips":
        jm, tm = jp.LPIPS(), tp.LPIPS()
        x, y = (np.tanh(_x((2, 32, 32, 3), s)) for s in (9, 10))
    else:
        jm, tm = jp.LPAPS(n_freq=n_freq), tp.LPAPS(n_freq=n_freq)
        x, y = (np.tanh(_x((2, n_freq, 32), s)) for s in (9, 10))
    tm.load_state_dict(from_jax_params(tree), strict=True)
    ref = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray, tree),
                                       jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert out.shape == ref.shape == (2,)
    err = float(np.abs(out - ref).max())
    assert err <= 1e-5 * max(1e-3, float(np.abs(ref).max())), err
