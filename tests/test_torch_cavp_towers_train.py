"""Training the port's other CAVP towers, their reference-checkpoint walks,
``spec_augment`` and ``cli.train_cavp`` over them, on the CPU.

- One stage-1 train step of the tiny towers (``test_torch_cavp_towers.
  TINY``) against the JAX step, both sides in float64 (a ReLU input within
  rounding of zero takes either branch by summation order in fp32): the
  metrics within 1e-6 relative, the gradients per leaf before AdamW
  within 1e-5 of the leaf's max|g|, the BatchNorm running statistics
  within 1e-9 relative, the AdamW update within 1e-5·max(1, max|ref|).
- The reference-checkpoint walks: a reference-layout state dict made by
  the JAX package's own walk run in its export direction over tiny JAX
  variables; the port's walk gives exactly ``from_jax_params`` of the
  same variables, which the tower loads with ``strict=True``.
- ``spec_augment`` with the JAX function's draws replayed: bit for bit.
- ``cli.train_cavp --tiny`` on each of ``chip_smoke.py``'s four tower
  pairs (every new tower once), ``load_native_cavp`` and
  ``cli.extract_features`` over each logdir, and ``--mixed-precision``
  with another tower refused as in JAX.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import vivit as jvivit
from diff_foley_tpu.models.cavp import cnn14 as jcnn
from diff_foley_tpu.models.cavp import r2plus1d as jr21
from diff_foley_tpu.models.cavp import spec_towers as jspec
from diff_foley_tpu.models.cavp import x3d as jx3d
from diff_foley_tpu.ops.spec_augment import spec_augment as jax_spec_augment
from diff_foley_tpu.train import stage1_cavp as js1
from diff_foley_tpu.utils import convert as jconv
from diff_foley_tpu_torch.cli import extract_features as ef_cli
from diff_foley_tpu_torch.cli import train_cavp as cavp_cli
from diff_foley_tpu_torch.models import vivit as tvivit
from diff_foley_tpu_torch.models.cavp import cnn14 as tcnn
from diff_foley_tpu_torch.models.cavp import r2plus1d as tr21
from diff_foley_tpu_torch.models.cavp import spec_towers as tspec
from diff_foley_tpu_torch.models.cavp import x3d as tx3d
from diff_foley_tpu_torch.ops.spec_augment import spec_augment
from diff_foley_tpu_torch.train import stage1_cavp as ts1
from diff_foley_tpu_torch.utils import checkpoint as ck
from diff_foley_tpu_torch.utils import convert as tconv
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params
from diff_foley_tpu_torch.video.ingest import extract_cavp_features
from test_torch_cavp_towers import PAIRS, TINY, _jax_model, _port_cfg, \
    _variables
from test_torch_stage1 import CAVPModel64, _named, write_shards
from test_torch_video import write_clip

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

B, CLIP, LR = 2, 2, 1e-3
VIDEO = (B, CLIP, 6, 32, 32, 3)
SPEC = (B, CLIP, 128, 256)
# a BatchNorm video tower beside a LayerNorm audio tower, and the pure
# transformer pair
STEP_PAIRS = (("x3d", "spec_vit"), ("vivit", "spec_vit_mean"))


class Trainer64(ts1.Stage1Trainer):
    """The loss of the fp32-rounded features in float64, as the JAX step
    under x64 forms it (fp32 features, float64 logit scale); the
    cotangents reach the towers rounded to fp32 on both sides."""

    def _loss(self, v, s, logit_scale):
        return super()._loss(v.double(), s.double(), logit_scale)


def _trainer64(model: CAVPModel64):
    model.double().train()
    trainer = Trainer64(model, ts1.Stage1TrainConfig(
        lr=LR, clip_num=CLIP, warmup_steps=2, total_steps=10))
    params = dict(model.named_parameters())
    return trainer, ts1.CAVPTrainState(0, params, ts1.make_optimizer(
        trainer.cfg, params), None, ts1.batch_stats(model))


@pytest.fixture(scope="module", params=STEP_PAIRS, ids="-".join)
def step_run(request):
    """One train step, the towers in float64 on both sides (JAX under
    ``jax.enable_x64``) and the contrastive loss of their features cast to
    fp32, in float64 (``Trainer64``)."""
    pair = request.param
    # one pooled window per clip: the x3d head's 4 frames, vivit's mean
    jm, run = _jax_model(pair, pool_kernel=4)
    data = np.random.default_rng(81)
    batch = {"video": data.uniform(size=VIDEO),
             "spec": data.uniform(size=SPEC)}
    shapes = run(jax.eval_shape, lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(VIDEO[1:]), jnp.zeros(SPEC[1:])))
    variables = {name: jax.tree_util.tree_map(
        lambda a: a.astype(np.float64), random_flax_params(tree, 82 + i))
        for i, (name, tree) in enumerate(shapes.items())}
    variables["params"]["logit_scale"] = np.float64(np.log(1 / 0.07))
    stats = variables.get("batch_stats", {})
    cfg = js1.Stage1TrainConfig(lr=LR, warmup_steps=2, total_steps=10,
                                clip_num=CLIP)
    with jax.enable_x64(True):
        tx = js1.make_optimizer(cfg)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        j0 = js1.CAVPTrainState(jnp.asarray(0, jnp.int32), params,
                                jax.tree_util.tree_map(jnp.asarray, stats),
                                tx.init(params))
        j1, jmetrics = run(lambda: jax.jit(js1.make_train_step(jm, cfg, tx))(
            j0, batch, jax.random.PRNGKey(5)))
        jax.block_until_ready(j1)
        mask_tree = jax.tree_util.tree_map(
            lambda p, m: np.full(np.shape(p), float(m)), params,
            js1._decay_mask(params))

    model = CAVPModel64(_port_cfg(*pair, pool_kernel=4)).double()
    model.load_state_dict(from_jax_params(variables), strict=True)
    trainer, state = _trainer64(model)
    metrics = trainer.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    return dict(
        jmetrics={k: float(v) for k, v in jmetrics.items()},
        metrics={k: float(v) for k, v in metrics.items()},
        jgrads={k: v / 0.1 for k, v in _named(j1.opt_state[0].mu).items()},
        grads={k: p.grad.clone() for k, p in state.params.items()},
        jparams=_named(j1.params), state=state, trainer=trainer,
        jstats=_named({"batch_stats": j1.batch_stats}) if stats else {},
        stats_before=_named({"batch_stats": stats}) if stats else {},
        jdecay={k for k, v in _named(mask_tree).items() if bool(v.all())})


def test_train_step_metrics_match_jax(step_run):
    # one loss on both sides: 1e-6 relative
    ref, out = step_run["jmetrics"], step_run["metrics"]
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert np.isfinite(out[k]), k
        assert out[k] == pytest.approx(r, rel=1e-6), k


def test_train_step_gradients_match_jax(step_run):
    # per leaf, before AdamW (the JAX one out of its first moment): every
    # element within 1e-5 of its leaf's max|g|
    ref, out = step_run["jgrads"], step_run["grads"]
    assert set(out) == set(ref) and len(out) > 20
    top = max(float(r.abs().max()) for r in ref.values())
    worst = {}
    for k, r in ref.items():
        scale = float(r.abs().max())
        if scale < 1e-10 * top:
            # analytically zero: a bias whose shift the train-mode
            # BatchNorm after the next linear map takes out again; both
            # sides hold rounding only
            assert float(out[k].abs().max()) < 1e-10 * top, k
            continue
        worst[k] = float((out[k] - r.reshape(out[k].shape)).abs().max()
                         ) / scale
    assert max(worst.values()) <= 1e-5, sorted(
        worst.items(), key=lambda kv: -kv[1])[:3]


def test_batchnorm_running_statistics_match_jax(step_run):
    # flax's momentum and biased batch variance; the transformer pair has
    # no BatchNorm at all, on either side
    stats = ts1.batch_stats(step_run["trainer"].model)
    ref, before = step_run["jstats"], step_run["stats_before"]
    assert set(stats) == set(ref)
    for k, r in ref.items():
        torch.testing.assert_close(stats[k], r, rtol=1e-9, atol=1e-12)
        assert not torch.allclose(stats[k], before[k]), k


def test_adamw_update_and_decay_mask_match_jax(step_run):
    # AdamW at the schedule's first rate (5e-4) with the decay mask: every
    # element whose gradient is over 100·ε (1e-6) within
    # 1e-5·max(1, max|ref|) of the JAX update. Adam's first step is
    # lr·g/(|g| + ε): where |g| is near ε, the fp32 loss's rounding in g
    # moves it by up to lr; those elements are held to that. The decayed
    # leaves (free ViT parameters among them) are JAX's
    state, ref, grads = (step_run[k] for k in ("state", "jparams", "jgrads"))
    for k, r in ref.items():
        out = state.params[k].detach()
        delta = (out - r.reshape(out.shape)).abs() / max(
            1.0, float(r.abs().max()))
        steady = grads[k].reshape(out.shape).abs() > 1e-6
        assert float(torch.where(steady, delta, 0.0).max()) <= 1e-5, k
        assert float(delta.max()) <= 5e-4, k
    names = list(state.params)
    mask = ts1.decay_mask(names, list(state.params.values()))
    assert {n for n, m in zip(names, mask) if m} == step_run["jdecay"]


# ---- the reference-checkpoint walks ----------------------------------------------

class _Export(jconv._BNExportMapper):
    """The JAX walk's export direction, also over its Conv1d leaves."""

    def take(self, my_path, torch_key, tf):
        if tf is jconv._conv1d:
            self.out[self.prefix + torch_key] = np.asarray(
                jconv._get(self.params, my_path)).transpose(2, 1, 0)
            return
        super().take(my_path, torch_key, tf)

    def result(self):
        return self.out


def reference_state_dict(walk: str, variables: dict, extra=None, **kw):
    """The reference-layout state dict whose JAX walk gives ``variables``:
    the walk run with an exporting mapper in place of its reader."""
    exporter = _Export(variables)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_Mapper", "_BNMapper"):
            mp.setattr(jconv, name, lambda sd, prefix="": exporter)
        getattr(jconv, walk)(extra or {}, **kw)
    return {**exporter.out, **(extra or {})}


WALKS = {
    "x3d": (lambda: jx3d.X3D(jx3d.X3DConfig(**TINY["x3d"])),
            lambda: tx3d.X3D(tx3d.X3DConfig(**TINY["x3d"])), "video",
            dict(base_blocks=(1, 2, 1, 1), depth_factor=1.0)),
    "i3d": (lambda: jx3d.I3DResNet(jx3d.I3DConfig(**TINY["i3d"])),
            lambda: tx3d.I3DResNet(tx3d.I3DConfig(**TINY["i3d"])), "video",
            dict(stage_blocks=(1, 2, 1, 1))),
    "r2plus1d": (lambda: jr21.ResNet2Plus1d(jr21.R2Plus1dConfig(
        **TINY["r2plus1d"])), lambda: tr21.ResNet2Plus1d(
        tr21.R2Plus1dConfig(**TINY["r2plus1d"])), "video",
        dict(stage_blocks=(2, 1, 1, 1))),
    "spec_resnet50": (lambda: jspec.SpecResNet50(jspec.SpecResNetConfig(
        **TINY["resnet50"])), lambda: tspec.SpecResNet50(
        tspec.SpecResNetConfig(**TINY["resnet50"])), "spec_nhwc",
        dict(stage_blocks=(1, 1, 1, 1))),
    "spec_vit": (lambda: jspec.SpecViT(jspec.SpecViTConfig(
        **TINY["spec_vit"])), lambda: tspec.SpecViT(tspec.SpecViTConfig(
            **TINY["spec_vit"])), "spec", dict(layers=2)),
    "spec_vit_mean": (lambda: jspec.SpecViTMean(jspec.SpecViTConfig(
        **TINY["spec_vit"], cls_token=False)), lambda: tspec.SpecViTMean(
        tspec.SpecViTConfig(**TINY["spec_vit"])), "spec",
        dict(layers=2, cls_token=False)),
    "vivit": (lambda: jvivit.ViViT(jvivit.ViViTConfig(**TINY["vivit"])),
              lambda: tvivit.ViViT(tvivit.ViViTConfig(**TINY["vivit"])),
              "video", dict(spatial_depth=2, temporal_depth=1)),
    "vivit_mean": (lambda: jvivit.ViViTMean(jvivit.ViViTConfig(
        **TINY["vivit"])), lambda: tvivit.ViViTMean(tvivit.ViViTConfig(
            **TINY["vivit"])), "video",
        dict(spatial_depth=2, temporal_depth=1, temporal_cls=False)),
    "cnn10": (lambda: jcnn.Cnn10(embed_dim=24),
              lambda: tcnn.Cnn10(embed_dim=24), "cnn", {}),
}


@pytest.mark.parametrize("name", list(WALKS))
def test_reference_walk_matches_from_jax_params(name):
    make_j, make_t, kind, kw = WALKS[name]
    x = {"video": np.zeros((1, 6, 32, 32, 3), np.float32),
         "spec": np.zeros((1, 128, 256), np.float32),
         "spec_nhwc": np.zeros((1, 128, 256, 1), np.float32),
         "cnn": np.zeros((1, 64, 128, 1), np.float32)}[kind]
    variables = _variables(make_j(), x, seed=83)
    extra = None
    if name == "x3d":
        # the reference's lin_5 is a 1×1×1 conv, which the walk reads itself
        k = variables["params"]["lin_5"]["kernel"]
        extra = {"head.lin_5.weight": k.T[..., None, None, None]}
    walk = "convert_" + name.replace("vivit_mean", "vivit").replace(
        "spec_vit_mean", "spec_vit")
    sd = {k: torch.from_numpy(np.array(v)) for k, v in reference_state_dict(
        walk, variables, extra, **kw).items()}
    got = from_jax_params(getattr(tconv, walk)(sd, **kw))
    ref = from_jax_params(variables)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    make_t().load_state_dict(got, strict=True)
    # a key the model has no place for is refused
    with pytest.raises(ValueError, match="no place"):
        getattr(tconv, walk)({**sd, "stray.weight": torch.zeros(1)}, **kw)


# ---- spec_augment ---------------------------------------------------------------------

def _jax_draws(key, b, m, t, tw, tn, fw, fn):
    """The draws ``ops/spec_augment.py`` makes from ``key``, per axis."""
    k1, k2 = jax.random.split(key)
    out = {}
    for axis, k, width, n in (("time", k1, tw, tn), ("freq", k2, fw, fn)):
        ks = jax.random.split(k, 2)
        out[axis] = (np.asarray(jax.random.randint(ks[0], (b, n), 0, width)),
                     np.asarray(jax.random.uniform(ks[1], (b, n))))
    return out


@pytest.mark.parametrize("widths", [(64, 2, 8, 2), (16, 3, 40, 1),
                                    (400, 2, 200, 2)])
def test_spec_augment_replays_jax(widths):
    # PANN's defaults, narrow and many stripes, and widths over the axes
    spec = np.random.default_rng(84).standard_normal((3, 128, 256)).astype(
        np.float32)
    key = jax.random.PRNGKey(85)
    tw, tn, fw, fn = widths
    ref = jax_spec_augment(jnp.asarray(spec), key, time_drop_width=tw,
                           time_stripes=tn, freq_drop_width=fw,
                           freq_stripes=fn)
    draws = _jax_draws(key, 3, 128, 256, *widths)
    out = spec_augment(torch.from_numpy(spec), None, tw, tn, fw, fn,
                       draws=draws)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy() == 0).any()


def test_spec_augment_generator_and_degenerate_widths():
    spec = torch.from_numpy(np.random.default_rng(86).standard_normal(
        (2, 8, 16)).astype(np.float32))
    # a width or stripe count of 0 is a no-op, with no draw made
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    assert torch.equal(spec_augment(spec, g, 0, 2, 0, 2), spec)
    assert torch.equal(spec_augment(spec, g, 64, 0, 8, 0), spec)
    assert torch.equal(g.get_state(), state)
    # oversize widths: finite, each element kept or zeroed
    out = spec_augment(spec, g, 64, 2, 32, 2)
    assert torch.isfinite(out).all() and ((out == 0) | (out == spec)).all()
    # the draws come from the generator alone
    a = spec_augment(spec, torch.Generator().manual_seed(7), 8, 2, 4, 2)
    b = spec_augment(spec, torch.Generator().manual_seed(7), 8, 2, 4, 2)
    assert torch.equal(a, b)


# ---- the CLI -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return write_shards(tmp_path_factory.mktemp("tower_shards"))


@pytest.fixture(scope="module", params=PAIRS, ids="-".join)
def tower_logdir(request, shards, tmp_path_factory):
    """``cli.train_cavp --tiny`` on one tower pair: two steps of two
    videos × two clips over 16 frames of 16², the retrieval eval."""
    pair = request.param
    root = tmp_path_factory.mktemp("towers")
    pattern = shards[0].rsplit("/", 1)[0] + "/shard-{000000..000001}.tar"
    args = ["--train-shards", pattern, "--logdir", str(root / "log"),
            "--tiny", "--device", "cpu", "--batch-size", "2",
            "--clip-num", "2", "--steps-per-epoch", "2", "--epochs", "1",
            "--log-every", "1", "--warmup", "1", "--uint8-video",
            "--val-shards", pattern, "--val-frequency", "1",
            "--val-samples", "4", "--video-encode", pair[0],
            "--spec-encode", pair[1]]
    state = cavp_cli.main(args)
    return pair, str(root / "log"), state


def test_cavp_cli_trains_every_tower(tower_logdir):
    pair, log, state = tower_logdir
    assert state.step == state.opt.count == 2
    rows = [json.loads(line) for line in open(os.path.join(
        log, "metrics.jsonl"))]
    train = [r for r in rows if "train/total_loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert any("val/video_to_spec_R@1" in r for r in rows)
    for r in rows:
        assert np.isfinite(list(r.values())).all(), r
    assert all(r["train/logit_scale"] <= 100.0 + 1e-4 for r in train)
    # every BatchNorm statistic moved off its init (vivit and the ViTs
    # have none)
    stats = state.batch_stats
    assert bool(stats) == (pair != ("vivit", "spec_vit_mean"))
    for k, v in stats.items():
        init = 0.0 if k.endswith("mean") else 1.0
        assert not torch.all(v == init), k


def test_load_native_cavp_rebuilds_every_tower(tower_logdir):
    pair, log, state = tower_logdir
    model = ck.load_native_cavp(log)
    assert (model.cfg.video_arch, model.cfg.spec_arch) == pair
    sd = model.state_dict()
    for k, p in {**state.params, **state.batch_stats}.items():
        assert torch.equal(sd[k], p.detach()), k
    assert ck.native_cavp_ingest_size(log) == 16
    video = torch.rand(1, 16, 16, 16, 3)
    with torch.no_grad():
        feats = model.encode_video(video, normalize=True, pool=False)
    assert torch.allclose(feats.norm(dim=-1), torch.ones(1, 16), atol=1e-5)


def test_extract_features_cli_over_every_tower_logdir(tower_logdir,
                                                     tmp_path):
    # 16 frames at 4 FPS in one call: the 3-D towers' heads give their 16
    # frames, ViViT (which takes exactly its 16) one feature a frame
    _, log, _ = tower_logdir
    (tmp_path / "videos").mkdir()
    clip = write_clip(str(tmp_path / "videos" / "a.avi"), seconds=4.0,
                      size=24)
    names = ef_cli.main(["--video-dir", str(tmp_path / "videos"),
                         "--out-dir", str(tmp_path / "feats"),
                         "--cavp-ckpt", log, "--device", "cpu"])
    assert names == ["a.avi"]
    feat = np.load(tmp_path / "feats" / "a.npz")["feat"]
    ref = extract_cavp_features(clip, ck.load_native_cavp(log), size=16,
                                device="cpu")
    assert feat.shape == (16, 512) and np.array_equal(feat, ref)
    assert np.allclose(np.linalg.norm(feat, axis=-1), 1.0, atol=1e-5)


def test_cavp_cli_mixed_precision_takes_the_shipped_towers_only(shards,
                                                               tmp_path):
    pattern = shards[0]
    for video, spec in (("x3d", "cnn14"), ("slowonly", "spec_vit")):
        with pytest.raises(ValueError, match="only supported for the shipped"):
            cavp_cli.main(["--train-shards", pattern, "--tiny", "--device",
                           "cpu", "--mixed-precision", "--video-encode",
                           video, "--spec-encode", spec, "--logdir",
                           str(tmp_path / video)])
    for arch in ("vivit", "spec_vit_mean"):
        assert arch in cavp_cli.TINY_TOWERS
