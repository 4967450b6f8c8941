"""The port's CAVP towers and reference-checkpoint loaders against the JAX
package, on the CPU.

Towers: a tiny SlowOnly (one block a stage, 8 base channels, 5 frames at
32×32) and a tiny CNN14, seeded random weights with positive random
BatchNorm statistics carried over with ``from_jax_params``, in eval mode;
the contrastive and the temporal forward.
Loaders: tiny JAX parameter trees go through the JAX package's exporters
into reference-layout torch checkpoints (``{"state_dict": …}`` with a
``module.`` prefix); the port's loaders must give exactly
``from_jax_params`` of the same trees. At full width the reference
mappings are checked key by key and shape by shape against modules on
the ``meta`` device, with no weights allocated.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.diffusion import latent_diffusion as jld
from diff_foley_tpu.models import cavp as jc
from diff_foley_tpu.models import unet as ju
from diff_foley_tpu.models import vae as jv
from diff_foley_tpu.utils import convert as jconv
from diff_foley_tpu_torch.diffusion import latent_diffusion as tld
from diff_foley_tpu_torch.models import cavp as tc
from diff_foley_tpu_torch.models import unet as tu
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.models.cond_encoder import VideoFeatEncoderPosembed
from diff_foley_tpu_torch.utils import checkpoint as tck
from diff_foley_tpu_torch.utils import convert as tconv
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params, randomize_
from test_torch_pipeline import CLF_KW, UNET_KW, VAE_KW

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

CAVP_KW = dict(video_stage_blocks=(1, 1, 1, 1), video_base_channels=8,
               spec_channels=(8, 8, 16, 16, 32, 32), pool_kernel=2)
# the JAX exporter walks the shipped (3, 4, 6, 3) stages: the loaders'
# CAVP keeps them, at 8 base channels
CKPT_CAVP_KW = dict(video_base_channels=8,
                    spec_channels=(8, 8, 16, 16, 32, 32))
# fp32 towers: max|Δ| against rms(JAX); measured ≤ 1.4e-6
TOL = 1e-5


def _random_variables(shapes, seed: int) -> dict:
    return {name: random_flax_params(tree, seed + i)
            for i, (name, tree) in enumerate(shapes.items())}


@pytest.fixture(scope="module")
def cavp_pair():
    rng = np.random.default_rng(60)
    video = rng.uniform(size=(2, 5, 32, 32, 3)).astype(np.float32)
    spec = rng.uniform(size=(2, 128, 64)).astype(np.float32)
    jm = jc.CAVPModel(jc.CAVPConfig(**CAVP_KW))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(video), jnp.asarray(spec)))
    variables = _random_variables(shapes, 61)
    tm = tc.CAVPModel(tc.CAVPConfig(**CAVP_KW)).eval()
    tm.load_state_dict(from_jax_params(variables), strict=True)
    return jm, variables, tm, video, spec


def _close(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    out = out.detach().numpy()
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.sqrt(np.square(ref).mean()))


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("tower", ["video", "spec"])
def test_cavp_towers_match_jax(cavp_pair, tower, pool, normalize):
    # pool over windows of 2: 5 frames give 2 windows, the tail dropped;
    # the spec's 64 steps come out of CNN14 as 4
    jm, variables, tm, video, spec = cavp_pair
    x = video if tower == "video" else spec
    method = getattr(jc.CAVPModel, f"encode_{tower}")
    ref = jax.jit(lambda v, a: jm.apply(
        v, a, method=lambda m, b: method(m, b, normalize=normalize,
                                         pool=pool)))(variables, x)
    with torch.no_grad():
        out = getattr(tm, f"encode_{tower}")(torch.from_numpy(x),
                                             normalize=normalize, pool=pool)
    assert _close(out, ref) <= TOL


def test_cavp_forward_matches_jax(cavp_pair):
    jm, variables, tm, video, spec = cavp_pair
    ref = jax.jit(jm.apply)(variables, video, spec)
    with torch.no_grad():
        out = tm(torch.from_numpy(video), torch.from_numpy(spec))
    assert set(out) == set(ref)
    for k in ("video_features", "spec_features"):
        assert out[k].shape == (2, 2, 512)
        assert _close(out[k], ref[k]) <= TOL
    assert float(out["logit_scale"]) == pytest.approx(
        float(ref["logit_scale"]), rel=1e-6)



def test_cavp_forward_temporal_matches_jax(cavp_pair):
    # the temporal losses' inputs: per-frame features and their pooled
    # windows from one tower pass each, in eval mode
    jm, variables, tm, video, spec = cavp_pair
    ref = jax.jit(lambda v, a, b: jm.apply(
        v, a, b, method=jc.CAVPModel.forward_temporal))(variables, video, spec)
    with torch.no_grad():
        out = tm.forward_temporal(torch.from_numpy(video),
                                  torch.from_numpy(spec))
    assert set(out) == set(ref)
    for k in ("video_temporal_features", "spec_temporal_features",
              "video_mean_features", "spec_mean_features"):
        assert _close(out[k], ref[k]) <= TOL
    assert out["video_mean_features"].shape == (2, 2, 512)
    assert float(out["logit_scale"]) == pytest.approx(
        float(ref["logit_scale"]), rel=1e-6)

def test_cavp_rejects_other_towers():
    # every factory tower is ported: an unknown one is refused, and so is
    # a compute dtype on a tower other than the shipped ones, as in JAX
    for kw, match in (({"video_arch": "slowfast"}, "unknown video_arch"),
                      ({"spec_arch": "panns"}, "unknown spec_arch"),
                      ({"video_arch": "x3d", "dtype": "bfloat16"},
                       "only supported")):
        with pytest.raises(ValueError, match=match):
            tc.CAVPModel(tc.CAVPConfig(**kw))


def test_from_jax_params_rank5_kernel():
    # Conv3d: flax tHWIO → torch OItHW; the scalar logit_scale keeps its name
    rng = np.random.default_rng(62)
    k = rng.standard_normal((3, 1, 2, 4, 5)).astype(np.float32)
    sd = from_jax_params({"conv": {"kernel": k},
                          "logit_scale": np.float32(2.5)})
    assert sd["conv.weight"].shape == (5, 4, 3, 1, 2)
    np.testing.assert_array_equal(sd["conv.weight"].numpy(),
                                  k.transpose(4, 3, 0, 1, 2))
    assert sd["logit_scale"].shape == () and float(sd["logit_scale"]) == 2.5
    conv = torch.nn.Conv3d(4, 5, (3, 1, 2), bias=False)
    conv.load_state_dict({"weight": sd["conv.weight"]}, strict=True)
    x = rng.standard_normal((1, 2, 6, 3, 4, 4)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x[0]), jnp.asarray(k), (1, 1, 1), "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    with torch.no_grad():
        out = conv(torch.from_numpy(x[0]).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_random_batchnorm_statistics_are_positive():
    # flax batch_stats and torch BatchNorm buffers: mean N(0, 0.1²),
    # variance 1 + 0.1·|N(0, 1)|; parameters drawn as before
    tree = random_flax_params({"bn": {"mean": np.zeros(4000),
                                      "var": np.zeros(4000)}}, 0)
    assert tree["bn"]["var"].min() >= 1.0
    assert 0.05 < tree["bn"]["mean"].std() < 0.15
    model = randomize_(tc.CAVPModel(tc.CAVPConfig(**CAVP_KW)), 5)
    variances = [b for k, b in model.named_buffers()
                 if k.endswith("running_var")]
    means = [b for k, b in model.named_buffers()
             if k.endswith("running_mean")]
    assert variances and all(float(v.min()) >= 1.0 for v in variances)
    assert all(float(m.abs().max()) > 0.0 for m in means)
    # the parameters are drawn first, by the same law as before
    rng = np.random.default_rng(5)
    first = float(model.logit_scale.detach())
    assert first == rng.standard_normal(size=(), dtype=np.float32)
    w = model.video_encoder.conv1.conv.weight.detach()
    z = rng.standard_normal(size=tuple(w.shape), dtype=np.float32)
    np.testing.assert_array_equal(w.numpy(), z / np.float32(np.sqrt(3 * 49)))


# ---- reference checkpoints ---------------------------------------------------

def _save(tmp_path, name: str, sd: dict) -> str:
    """A reference-layout checkpoint: {"state_dict": …} with "module."."""
    path = str(tmp_path / name)
    torch.save({"epoch": 0, "state_dict": {
        f"module.{k}": torch.from_numpy(np.array(v)) for k, v in sd.items()}},
        path)
    return path


def _assert_exact(module: torch.nn.Module, tree) -> None:
    ref = from_jax_params(tree)
    got = {k: v for k, v in module.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def ldm_trees():
    jcfg = jld.LDMConfig(unet=ju.UNetConfig(**UNET_KW),
                         vae=jv.VAEConfig(**VAE_KW), cond_embed_dim=24)
    ldm = jld.LatentDiffusion(jcfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(ldm.init_params, key)
    params = {name: {"params": random_flax_params(shapes[name]["params"], s)}
              for name, s in (("unet", 63), ("cond", 64))}
    vae = {"params": random_flax_params(jax.eval_shape(
        lambda: ldm.init_vae_params(key))["params"], 65)}
    clf_cfg = ju.UNetConfig(**CLF_KW)
    clf = {"params": random_flax_params(jax.eval_shape(
        lambda: ju.ClassifierBackbone(clf_cfg).init(
            key, jnp.zeros((1, 16, 64, 4)), jnp.zeros((1,)),
            jnp.zeros((1, 32, 512))))["params"], 66)}
    return jcfg, params, vae, clf


def _tiny_ldm():
    return tld.LatentDiffusion(tld.LDMConfig(
        unet=tu.UNetConfig(**UNET_KW), vae=tv.VAEConfig(**VAE_KW),
        cond_embed_dim=24))


def test_reference_ldm_loads_exactly(ldm_trees, tmp_path):
    jcfg, params, vae, _ = ldm_trees
    sd = jconv.export_ldm_state_dict(params, vae, jcfg.unet, jcfg.vae)
    sd["betas"] = np.zeros(1000, np.float32)   # schedule buffers: ignored
    path = _save(tmp_path, "ldm.ckpt", sd)
    ldm = tck.load_reference_ldm(path, _tiny_ldm())
    _assert_exact(ldm.unet, params["unet"])
    _assert_exact(ldm.cond, params["cond"])
    _assert_exact(ldm.vae, vae)
    vae_only = tck.load_vae_checkpoint(path, tv.AutoencoderKL(
        tv.VAEConfig(**VAE_KW)))
    _assert_exact(vae_only, vae)
    bare = _save(tmp_path, "vae.ckpt", jconv.export_vae(vae, jcfg.vae))
    _assert_exact(tck.load_vae_checkpoint(bare, tv.AutoencoderKL(
        tv.VAEConfig(**VAE_KW))), vae)


def test_reference_classifier_loads_exactly(ldm_trees, tmp_path):
    jcfg, params, vae, clf = ldm_trees
    sd = {f"model.{k}": v for k, v in jconv.export_classifier_backbone(
        clf, ju.UNetConfig(**CLF_KW)).items()}
    sd.update({f"cond_model.{k}": v for k, v in
               jconv.export_cond_encoder(params["cond"]).items()})
    sd.update({f"first_stage_model.{k}": v for k, v in
               jconv.export_vae(vae, jcfg.vae).items()})
    out = tck.load_reference_classifier(
        _save(tmp_path, "clf.ckpt", sd), tu.UNetConfig(**CLF_KW),
        tv.VAEConfig(**VAE_KW))
    _assert_exact(out["backbone"], clf)
    _assert_exact(out["cond"], params["cond"])
    _assert_exact(out["vae"], vae)


@pytest.fixture(scope="module")
def cavp_ckpt_variables():
    jm = jc.CAVPModel(jc.CAVPConfig(**CKPT_CAVP_KW))
    return _random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3)),
        jnp.zeros((1, 128, 16)))), 67)


def _ckpt_cavp():
    return tc.CAVPModel(tc.CAVPConfig(**CKPT_CAVP_KW))


def test_reference_cavp_loads_exactly(cavp_ckpt_variables, tmp_path):
    variables = cavp_ckpt_variables
    ckpt = jconv.export_cavp_checkpoint(variables)
    path = _save(tmp_path, "cavp.ckpt", ckpt["state_dict"])
    # the exporter writes num_batches_tracked: accepted and dropped
    assert any(k.endswith("num_batches_tracked") for k in ckpt["state_dict"])
    model = tck.load_reference_cavp(path, _ckpt_cavp())
    _assert_exact(model, variables)


@pytest.mark.parametrize("plant", ["missing", "extra"])
def test_reference_loaders_reject_planted_keys(ldm_trees, cavp_ckpt_variables,
                                               tmp_path, plant):
    jcfg, params, vae, _ = ldm_trees
    variables = cavp_ckpt_variables
    ldm_sd = jconv.export_ldm_state_dict(params, vae, jcfg.unet, jcfg.vae)
    cavp_sd = jconv.export_cavp_checkpoint(variables)["state_dict"]
    load_ldm = lambda path: tck.load_reference_ldm(path, _tiny_ldm())
    load_cavp = lambda path: tck.load_reference_cavp(path, _ckpt_cavp())
    for sd, prefix, load in (
            (ldm_sd, "model.diffusion_model.", load_ldm),
            (ldm_sd, "cond_stage_model.", load_ldm),
            (ldm_sd, "first_stage_model.", load_ldm),
            (cavp_sd, "video_encoder.", load_cavp),
            (cavp_sd, "spec_encoder.", load_cavp),
            (cavp_sd, "video_project_head.", load_cavp)):
        sd = dict(sd)
        if plant == "missing":
            del sd[next(k for k in sd if k.startswith(prefix)
                        and not k.endswith("num_batches_tracked"))]
        else:
            sd[f"{prefix}stray.weight"] = np.zeros(3, np.float32)
        path = _save(tmp_path, "planted.ckpt", sd)
        with pytest.raises((KeyError, ValueError), match="reference"):
            load(path)


def _zeros(shapes):
    """A tree of zero-stride arrays of the given shapes: no memory."""
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)


def test_full_width_mappings_fit_the_modules(monkeypatch):
    # the shipped UNet, VAE, classifier and CAVP: JAX shape trees through
    # the JAX exporters into reference layouts (zero-stride arrays), back
    # through the port's walks, into modules on the meta device with
    # strict=True; from_jax_params makes meta tensors, so no weights exist
    monkeypatch.setattr(tconv, "_to_tensor",
                        lambda a: torch.empty(np.shape(a), device="meta"))
    key = jax.random.PRNGKey(0)
    ldm = jld.LatentDiffusion(jld.LDMConfig())
    unet = _zeros(jax.eval_shape(ldm.init_params, key))
    vae = _zeros(jax.eval_shape(lambda: ldm.init_vae_params(key)))
    clf = _zeros(jax.eval_shape(lambda: ju.ClassifierBackbone(
        ju.CLASSIFIER_BACKBONE).init(key, jnp.zeros((1, 16, 64, 4)),
                                     jnp.zeros((1,)),
                                     jnp.zeros((1, 32, 512)))))
    cavp = _zeros(jax.eval_shape(lambda: jc.CAVPModel().init(
        key, jnp.zeros((1, 1, 224, 224, 3)), jnp.zeros((1, 128, 16)))))
    sd = {k: np.asarray(v) for k, v in jconv.export_ldm_state_dict(
        unet, vae, ju.UNetConfig(), jv.VAEConfig()).items()}
    unet_sd, vae_sd, cond_sd = tconv.split_ldm_state_dict(sd)
    with torch.device("meta"):
        targets = (
            (tu.UNetModel(tu.LDM_UNET),
             tconv.convert_unet(unet_sd, tu.LDM_UNET)),
            (tv.AutoencoderKL(tv.SD_VAE), tconv.convert_vae(vae_sd,
                                                            tv.SD_VAE)),
            (VideoFeatEncoderPosembed(), tconv.convert_cond_encoder(cond_sd)),
            (tu.ClassifierBackbone(tu.CLASSIFIER_BACKBONE),
             tconv.convert_classifier_backbone(
                 jconv.export_classifier_backbone(
                     clf, ju.CLASSIFIER_BACKBONE), tu.CLASSIFIER_BACKBONE)),
            (tc.CAVPModel(), tconv.convert_cavp(
                jconv.export_cavp_checkpoint(cavp)["state_dict"])))
    counts = []
    for module, tree in targets:
        state = from_jax_params(tree)
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()
                if not k.endswith("num_batches_tracked")}
        assert {k: tuple(v.shape) for k, v in state.items()} == want
        module.load_state_dict(state, strict=True, assign=True)
        counts.append(sum(int(np.prod(s)) for s in want.values()))
    assert counts[0] > 859e6 and counts[-1] > 1e8, counts
