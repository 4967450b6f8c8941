"""The port's stage-1 CAVP training against the JAX package's, on the CPU:
the five contrastive losses and the retrieval metrics; one train step on
the JAX tests' tiny towers (metrics, the gradients per leaf before AdamW,
the BatchNorm running statistics after it, the ``logit_scale`` clamp, the
weight-decay mask's leaves, the AdamW update); the feature-cache
accumulation against the full batch; the bf16 step; ``decode_sample`` and
``iter_shards`` bit for bit on shards the test writes; then
``cli.train_cavp --tiny`` with ``--resume`` and the retrieval eval,
``load_native_cavp``, ``cli.extract_features``,
``DiffFoley.from_native_checkpoints`` and ``cli.generate`` over three tiny
port logdirs; the C++ shard reader (``data/native_loader.py``) against
the JAX package's Python reader, and ``cli.train_cavp --native-loader``.

CNN14's dropout draws differ between the frameworks: the JAX step's
masks are recorded (an interceptor runs each flax ``Dropout`` once on
ones, the same single draw, and hands the mask out through
``jax.debug.callback``) and the port takes them through
``cnn14.dropout_keep``.
"""
import hashlib
import io
import os
import shutil
import tarfile

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.data import cavp_shards as jshards
from diff_foley_tpu.models.cavp import CAVPConfig as JCAVPConfig
from diff_foley_tpu.models.cavp import CAVPModel as JCAVPModel
from diff_foley_tpu.train import losses as jl
from diff_foley_tpu.train import stage1_cavp as js1
from diff_foley_tpu_torch.api import DiffFoley
from diff_foley_tpu_torch.cli import extract_features as ef_cli
from diff_foley_tpu_torch.cli import generate as generate_cli
from diff_foley_tpu_torch.cli import train_cavp as cavp_cli
from diff_foley_tpu_torch.cli import train_classifier as clf_cli
from diff_foley_tpu_torch.cli import train_stage2 as s2_cli
from diff_foley_tpu_torch.data import cavp_shards as tshards
from diff_foley_tpu_torch.models.cavp import CAVPConfig, CAVPModel
from diff_foley_tpu_torch.models.cavp import cnn14 as tcnn14
from diff_foley_tpu_torch.pipeline import GenerationConfig
from diff_foley_tpu_torch.train import losses as tl
from diff_foley_tpu_torch.train import stage1_cavp as ts1
from diff_foley_tpu_torch.utils import checkpoint as ck
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params, randomize_
from diff_foley_tpu_torch.utils.wav import write_wav
from diff_foley_tpu_torch.video.ingest import extract_cavp_features
from test_torch_stage2_cli import write_pairs
from test_torch_video import write_clip

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

# the JAX tests' tiny towers; 4 frames and 64 spec steps give one window
# each at pool_kernel 4
CAVP_KW = dict(video_stage_blocks=(1, 1, 1, 1), video_base_channels=8,
               spec_channels=(8, 8, 16, 16, 32, 32), pool_kernel=4)
B, CLIP, LR = 2, 2, 1e-3
VIDEO = (B, CLIP, 4, 32, 32, 3)
SPEC = (B, CLIP, 128, 64)
T = lambda a: torch.from_numpy(np.array(a))


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _losses(which: str, rng):
    """(JAX output, port output) of one loss at random unit features."""
    scale = np.float32(14.3)
    if which in ("clip", "intra", "retrieval"):
        v, s = _unit(rng, (12, 16)), _unit(rng, (12, 16))
        if which == "clip":
            return (jl.clip_loss(v, s, scale),
                    tl.clip_loss(T(v), T(s), T(scale)))
        if which == "retrieval":
            return (jl.retrieval_metrics(v, s),
                    tl.retrieval_metrics(T(v), T(s)))
        return (jl.intra_contrast_loss(v, s, scale, clip_num=3,
                                       intra_weight=0.7),
                tl.intra_contrast_loss(T(v), T(s), T(scale), clip_num=3,
                                       intra_weight=0.7))
    if which == "temporal_mean":
        args = [_unit(rng, (6, 16)) for _ in range(4)]
        return (jl.intra_contrast_temporal_mean_loss(*args, scale,
                                                     clip_num=3),
                tl.intra_contrast_temporal_mean_loss(
                    *map(T, args), T(scale), clip_num=3))
    vt, st = _unit(rng, (4, 8, 16)), _unit(rng, (4, 8, 16))
    vm, sm = _unit(rng, (4, 16)), _unit(rng, (4, 16))
    if which == "temporal":
        return (jl.temporal_semantic_loss(vm, sm, vt, st, scale, 0.6),
                tl.temporal_semantic_loss(*map(T, (vm, sm, vt, st)),
                                          T(scale), 0.6))
    # video late in rows 0 and 2, spec late in rows 1 and 3; overlaps of
    # 5, 6, 8 and 3 frames
    start = np.array([[2, 0], [0, 1], [0, 0], [5, 0]])
    end = start + np.array([[4], [5], [7], [2]])
    return (jl.temporal_semantic_bias_loss(vt, vm, st, sm, scale, start,
                                           end),
            tl.temporal_semantic_bias_loss(*map(T, (vt, vm, st, sm)),
                                           T(scale), T(start), T(end)))


@pytest.mark.parametrize("which", ["clip", "intra", "temporal", "bias",
                                   "temporal_mean", "retrieval"])
def test_losses_match_jax(which):
    # fp32 reductions over a few dozen logits: 1e-5 relative (reached:
    # ~1e-7); the retrieval ranks exactly
    ref, out = _losses(which, np.random.default_rng(40))
    if which == "clip":
        ref, out = {"loss": ref}, {"loss": out}
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert float(out[k]) == pytest.approx(float(r), rel=1e-5, abs=1e-6), k


# ---- one train step against the JAX step -------------------------------------

def _recording_interceptor(masks: dict, rate: float = 0.2):
    """Run each flax Dropout once on ones (its single draw), record the
    keep mask by the module's path, and apply it as flax would."""

    def interceptor(next_fun, args, kwargs, context):
        if not (isinstance(context.module, nn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = next_fun(jnp.ones_like(x), *args[1:], **kwargs) != 0
        name = "/".join(context.module.scope.path)
        jax.debug.callback(lambda k, n=name: masks.__setitem__(
            n, np.asarray(k)), keep)
        return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))

    return interceptor


def _replaying(masks: dict):
    """A ``cnn14.dropout_keep`` that hands out the recorded JAX masks in
    the forward's order, NHWC → NCHW."""
    order = sorted(masks, key=lambda n: int(n.rsplit("_", 1)[1]))
    queue = [torch.from_numpy(masks[n]).permute(0, 3, 1, 2).contiguous()
             for n in order]

    def keep(shape, keep_prob, generator, device):
        mask = queue.pop(0)
        assert tuple(mask.shape) == tuple(shape) and keep_prob == 0.8
        return mask

    return keep, queue


def _named(tree) -> dict:
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


class CAVPModel64(CAVPModel):
    """The towers computing in float64."""

    compute_dtype = torch.float64


def _float64_trainer(model: CAVPModel64, **kw):
    """A float64 trainer and state around ``model`` (the port's states
    hold float32 masters; the state is built here in float64)."""
    model.double().train()
    trainer = ts1.Stage1Trainer(model, ts1.Stage1TrainConfig(
        lr=LR, clip_num=CLIP, **kw))
    params = dict(model.named_parameters())
    return trainer, ts1.CAVPTrainState(0, params, ts1.make_optimizer(
        trainer.cfg, params), None, ts1.batch_stats(model))


@pytest.fixture(scope="module")
def step_run():
    """One train step with the towers in float64 on both sides (JAX under
    ``jax.enable_x64``): in fp32 a ReLU input within rounding of zero takes
    either branch by summation order (a 30% error in one gradient at the
    tiny maps with the port on one thread), so the fp32 steps are not
    comparable leaf by leaf. The contrastive loss runs on the features cast
    to fp32 on both sides (JAX then forms the logits in float64 with the
    float64 scale, the port in fp32): that sets the limits below."""
    jm = JCAVPModel(JCAVPConfig(**CAVP_KW))
    data = np.random.default_rng(41)
    batch = {"video": data.uniform(size=VIDEO),
             "spec": data.uniform(size=SPEC)}
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(VIDEO[1:]), jnp.zeros(SPEC[1:])))
    variables = {name: jax.tree_util.tree_map(
        lambda a: a.astype(np.float64), random_flax_params(tree, 42 + i))
        for i, (name, tree) in enumerate(shapes.items())}
    # the shipped initial scale, ln(1/0.07)
    variables["params"]["logit_scale"] = np.float64(np.log(1 / 0.07))
    cfg = js1.Stage1TrainConfig(lr=LR, warmup_steps=2, total_steps=10,
                                clip_num=CLIP)
    masks = {}
    with jax.enable_x64(True):
        tx = js1.make_optimizer(cfg)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        j0 = js1.CAVPTrainState(jnp.asarray(0, jnp.int32), params,
                                jax.tree_util.tree_map(
                                    jnp.asarray, variables["batch_stats"]),
                                tx.init(params))
        with nn.intercept_methods(_recording_interceptor(masks)):
            j1, jm_metrics = jax.jit(js1.make_train_step(jm, cfg, tx))(
                j0, batch, jax.random.PRNGKey(5))
            jax.block_until_ready(j1)
        mask_tree = jax.tree_util.tree_map(
            lambda p, m: np.full(np.shape(p), float(m)), params,
            js1._decay_mask(params))
    assert len(masks) == 6

    model = CAVPModel64(CAVPConfig(**CAVP_KW)).double()
    model.load_state_dict(from_jax_params(variables), strict=True)
    trainer, state = _float64_trainer(model, warmup_steps=2, total_steps=10)
    keep, queue = _replaying(masks)
    real, tcnn14.dropout_keep = tcnn14.dropout_keep, keep
    try:
        metrics = trainer.train_step(state, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    finally:
        tcnn14.dropout_keep = real
    assert not queue
    return dict(
        jmetrics={k: float(v) for k, v in jm_metrics.items()},
        metrics={k: float(v) for k, v in metrics.items()},
        jgrads={k: v / 0.1 for k, v in _named(j1.opt_state[0].mu).items()},
        grads={k: p.grad.clone() for k, p in state.params.items()},
        jparams=_named(j1.params), state=state, trainer=trainer,
        jstats=_named({"batch_stats": j1.batch_stats}),
        stats_before=_named({"batch_stats": variables["batch_stats"]}),
        jdecay={k for k, v in _named(mask_tree).items() if bool(v.all())})


@pytest.mark.parametrize("name", ["total_loss", "extra_contrast_loss",
                                  "intra_contrast_loss", "grad_norm",
                                  "logit_scale"])
def test_train_step_metrics_match_jax(step_run, name):
    # the fp32 loss of float64 towers: 1e-6 relative (reached: 1.0e-7)
    ref, out = step_run["jmetrics"][name], step_run["metrics"][name]
    assert np.isfinite(out) and out == pytest.approx(ref, rel=1e-6)


def test_train_step_gradients_match_jax(step_run):
    # per leaf, before AdamW (the JAX one out of its first moment): every
    # element within 1e-5 of its leaf's max|g| (reached: 1.5e-6, the fp32
    # loss's rounding)
    ref, out = step_run["jgrads"], step_run["grads"]
    assert set(out) == set(ref) and len(out) > 40
    worst = {}
    for k, r in ref.items():
        scale = float(r.abs().max())
        assert scale > 0.0, k
        worst[k] = float((out[k] - r.reshape(out[k].shape)).abs().max()
                         ) / scale
    assert max(worst.values()) <= 1e-5, sorted(
        worst.items(), key=lambda kv: -kv[1])[:3]


def test_batchnorm_running_statistics_match_jax(step_run):
    # flax's momentum 0.9 is torch's 0.1, and the variance that enters the
    # running one is the biased batch variance: every BatchNorm's running
    # mean and variance after one step within 1e-9 relative (reached:
    # 2e-11: float64 forwards); an unbiased update would be off by n/(n−1) − 1 ≥ 1/(4·32²)
    # at the largest map here, and by 1/7 at the 8-element CNN14 maps
    stats = ts1.batch_stats(step_run["trainer"].model)
    ref, before = step_run["jstats"], step_run["stats_before"]
    assert set(stats) == set(ref) and len(stats) > 20
    for k, r in ref.items():
        torch.testing.assert_close(stats[k], r, rtol=1e-9, atol=1e-12)
        assert not torch.allclose(stats[k], before[k]), k


def test_adamw_update_matches_jax(step_run):
    # AdamW at the schedule's first rate (5e-4) with the decay mask: every
    # element within 1e-5·max(1, max|ref|) of the JAX update (reached:
    # 8.2e-7, where a gradient near ε = 1e-8 carries the loss's rounding)
    state, ref = step_run["state"], step_run["jparams"]
    for k, r in ref.items():
        out = state.params[k].detach()
        delta = (out - r.reshape(out.shape)).abs() / max(
            1.0, float(r.abs().max()))
        assert float(delta.max()) <= 1e-5, k


def test_logit_scale_is_clamped_to_ln_100():
    trainer, state = _tiny_trainer(50)
    with torch.no_grad():
        trainer.model.logit_scale.fill_(4.7)
    metrics = trainer.train_step(state, _batch(51),
                                 torch.Generator().manual_seed(2))
    assert float(trainer.model.logit_scale) == np.float32(ts1.LOG_100)
    assert float(metrics["logit_scale"]) == pytest.approx(100.0, rel=1e-6)


def test_decay_mask_leaves_match_jax(step_run):
    names = list(step_run["state"].params)
    params = list(step_run["state"].params.values())
    mine = {n for n, m in zip(names, ts1.decay_mask(names, params)) if m}
    assert mine == step_run["jdecay"]
    assert "logit_scale" not in mine and all(
        ".bn" not in n and not n.endswith("bias") for n in mine)
    assert any(n.endswith("conv.weight") for n in mine)


# ---- the feature-cache accumulation and the bf16 step ------------------------

def _tiny_trainer(seed: int, **kw):
    model = CAVPModel(CAVPConfig(**CAVP_KW))
    trainer = ts1.Stage1Trainer(model, ts1.Stage1TrainConfig(
        lr=LR, warmup_steps=0, clip_num=CLIP, **kw))
    return trainer, trainer.init_train_state(seed, "cpu")


def _batch(seed: int, k=None):
    data = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    return {"video": torch.from_numpy(data.uniform(
                size=lead + VIDEO).astype(np.float32)),
            "spec": torch.from_numpy(data.uniform(
                size=lead + SPEC).astype(np.float32))}


def test_accum_step_gradient_equals_the_full_batch():
    # K = 2 micro-batches of 2 videos against one batch of 4, BatchNorm on
    # its running statistics (train=False), as tests/test_accum_freq.py,
    # in float64 (fp32 ReLU kinks would differ between the two orders of
    # summation): the summed tower gradients within 1e-9 of each leaf's
    # max|g| (reached: ~1e-14), logit_scale's sum divided by K
    trainer, state = _float64_trainer(randomize_(
        CAVPModel64(CAVPConfig(**CAVP_KW)), 43), warmup_steps=0)
    batches = _batch(44, k=2)
    trainer.model.eval()
    out = trainer._features({k: v.flatten(0, 1) for k, v in batches.items()},
                            None)
    loss = trainer._loss(out["video_features"], out["spec_features"],
                         out["logit_scale"])["total_loss"]
    ref = torch.autograd.grad(loss, list(state.params.values()))
    metrics = trainer.accum_train_step(state, batches, train=False)
    assert float(metrics["total_loss"]) == pytest.approx(float(loss),
                                                         rel=1e-12)
    for (k, p), r in zip(state.params.items(), ref):
        scale = max(float(r.abs().max()), 1e-30)
        assert float((p.grad - r).abs().max()) <= 1e-9 * scale, k


def test_accum_step_in_train_mode_moves_the_statistics_once():
    # pass 1 advances each BatchNorm once; pass 2 (the same dropout masks,
    # the generator rewound) leaves them as pass 1 left them
    trainer, state = _tiny_trainer(45)
    batches = _batch(46, k=2)
    before = {k: v.clone() for k, v in state.batch_stats.items()}
    expect = CAVPModel(CAVPConfig(**CAVP_KW))
    expect.load_state_dict(trainer.model.state_dict())
    expect.train()
    with torch.no_grad():
        gen = torch.Generator().manual_seed(7)
        for j in range(2):
            expect(*trainer._flat({k: v[j] for k, v in batches.items()}),
                   generator=gen)
    gen = torch.Generator().manual_seed(7)
    metrics = trainer.accum_train_step(state, batches, gen)
    assert np.isfinite(float(metrics["total_loss"])) and state.step == 1
    for k, v in ts1.batch_stats(expect).items():
        assert not torch.equal(v, before[k]), k
        torch.testing.assert_close(state.batch_stats[k], v, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("accum", [False, True])
def test_bf16_step_runs_on_float32_masters(accum):
    # bf16 towers against float32 masters, the loss in float32 (32×32
    # frames: at 16×16 the CPU's bf16 conv3d weight gradient of the 1×1
    # last stage reads NaN in this torch build)
    trainer, state = _tiny_trainer(47, compute_dtype="bfloat16")
    assert trainer.model.compute_dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(8)
    metrics = (trainer.accum_train_step(state, _batch(48, k=2), gen)
               if accum else trainer.train_step(state, _batch(48), gen))
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    for k, p in state.params.items():
        assert p.dtype == torch.float32 and torch.isfinite(p.grad).all(), k
    assert all(v.dtype == torch.float32 for v in state.batch_stats.values())


def test_sync_batchnorm_axis_name():
    # axis_name="data" names the data group a meshed trainer takes the
    # BatchNorm statistics over (two ranks against one process:
    # tests/test_torch_parallel.py); on the one-rank mesh of a process
    # without a group the step is the unmeshed step, bit for bit
    from diff_foley_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="'data' axis"):
        CAVPModel(CAVPConfig(**CAVP_KW, axis_name="model"))
    out = []
    for axis, mesh in ((None, None), ("data", make_mesh())):
        model = CAVPModel(CAVPConfig(**CAVP_KW, axis_name=axis))
        trainer = ts1.Stage1Trainer(model, ts1.Stage1TrainConfig(
            lr=LR, warmup_steps=0, clip_num=CLIP), mesh=mesh)
        state = trainer.init_train_state(49, "cpu")
        m = trainer.train_step(state, _batch(50),
                               torch.Generator().manual_seed(3))
        out.append((m, state.state_dict()))
    (m0, sd0), (m1, sd1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for k in sd0["params"]:
        assert torch.equal(sd0["params"][k], sd1["params"][k]), k
    for k in sd0["batch_stats"]:
        assert torch.equal(sd0["batch_stats"][k], sd1["batch_stats"][k]), k


# ---- shards ---------------------------------------------------------------------

def write_shards(root, n_shards=2, per_shard=4, frame=16, seed=0):
    """Seeded tar shards: ``<key>.spec.npy`` (128 × 640) and
    ``<key>.video.jpg`` (a strip of 40 frame × frame frames, cv2 JPEG)."""
    import cv2

    rng = np.random.default_rng(seed)
    paths = []
    for si in range(n_shards):
        path = root / f"shard-{si:06d}.tar"
        with tarfile.open(path, "w") as tf:
            for k in range(per_shard):
                buf = io.BytesIO()
                np.save(buf, rng.uniform(size=(128, 640)).astype(np.float32))
                info = tarfile.TarInfo(f"s{si}_{k}.spec.npy")
                info.size = buf.getbuffer().nbytes
                buf.seek(0)
                tf.addfile(info, buf)
                strip = (rng.uniform(size=(frame, frame * 40, 3)) * 255
                         ).astype(np.uint8)
                ok, enc = cv2.imencode(".jpg", strip)
                assert ok
                info = tarfile.TarInfo(f"s{si}_{k}.video.jpg")
                info.size = len(enc)
                tf.addfile(info, io.BytesIO(enc.tobytes()))
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return write_shards(tmp_path_factory.mktemp("cavp_shards"))


@pytest.mark.parametrize("uint8", [False, True])
def test_iter_shards_and_decode_sample_bit_for_bit(shards, uint8):
    jcfg = jshards.CAVPShardConfig(uint8_video=uint8)
    tcfg = tshards.CAVPShardConfig(uint8_video=uint8)
    kw = dict(seed=3, epoch=1, shuffle_buffer=3)
    ref = list(jshards.iter_shards(shards, cfg=jcfg, **kw))
    out = list(tshards.iter_shards(shards, cfg=tcfg, **kw))
    assert len(out) == len(ref) == 8
    for o, r in zip(out, ref):
        assert o["video"].dtype == r["video"].dtype
        assert o["video"].shape == r["video"].shape == (3, 16, 16, 16, 3)
        assert o["spec"].shape == (3, 128, 256)
        assert np.array_equal(o["video"], r["video"])
        assert np.array_equal(o["spec"], r["spec"])
    for seed in range(20):
        a = tshards.sample_temporal_index(np.random.default_rng(seed), tcfg)
        b = jshards.sample_temporal_index(np.random.default_rng(seed), jcfg)
        assert a == b and all(y - x >= tcfg.shift_lb
                              for x, y in zip(a, a[1:]))


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build native/shard_reader.cpp")


def test_native_loader_matches_the_python_reader(shards):
    """The C++ reader's member bytes equal tarfile's, and its samples (in
    another order: the reader threads deliver in none) equal the JAX
    package's Python reader's, bit for bit."""
    _need_gxx()
    from diff_foley_tpu_torch.data import native_loader as nl

    native = {}
    with nl.NativeShardReader(shards, n_threads=2) as reader:
        for key, spec, video in reader:
            native[key] = (spec, video)
    assert len(native) == 8
    for path in shards:
        with tarfile.open(path) as tf:
            for m in tf:
                key, _, kind = m.name.partition(".")
                assert native[key][kind == "video.jpg"] == \
                    tf.extractfile(m).read(), m.name
    lib = nl.library_path()
    assert lib.exists() and lib.parent.parts[-2:] == ("build", "native")
    digest = lambda s: hashlib.sha256(s["video"].tobytes()
                                      + s["spec"].tobytes()).hexdigest()
    for uint8 in (False, True):
        kw = dict(seed=3, epoch=1, shuffle_buffer=3)
        ref = list(jshards.iter_shards(
            shards, cfg=jshards.CAVPShardConfig(uint8_video=uint8), **kw))
        out = list(nl.iter_shards_native(
            shards, cfg=tshards.CAVPShardConfig(uint8_video=uint8), **kw))
        assert len(out) == len(ref) == 8
        assert sorted(map(digest, out)) == sorted(map(digest, ref))


# ---- the CLIs and the composition ------------------------------------------------

@pytest.fixture(scope="module")
def cavp_logdir(shards, tmp_path_factory):
    """``cli.train_cavp --tiny``: two steps (one an epoch), the feature
    cache at K 2, uint8 video, the retrieval eval every epoch; then a
    resume for two more."""
    root = tmp_path_factory.mktemp("cavp")
    pattern = shards[0].rsplit("/", 1)[0] + "/shard-{000000..000001}.tar"
    args = ["--train-shards", pattern, "--logdir", str(root / "log"),
            "--tiny", "--device", "cpu", "--batch-size", "2",
            "--clip-num", "2", "--accum-freq", "2", "--steps-per-epoch", "1",
            "--log-every", "1", "--save-every-epochs", "1", "--warmup", "1",
            "--uint8-video", "--val-shards", pattern, "--val-frequency",
            "1", "--val-samples", "4"]
    first = cavp_cli.main(args + ["--epochs", "2"])
    resumed = cavp_cli.main(args + ["--epochs", "2", "--resume"])
    return dict(root=root, log=str(root / "log"), first=first,
                resumed=resumed, pattern=pattern)


def test_cavp_cli_trains_evaluates_and_resumes(cavp_logdir):
    import json

    first, resumed = cavp_logdir["first"], cavp_logdir["resumed"]
    assert first.step == first.opt.count == 2
    assert resumed.step == resumed.opt.count == 4
    rows = [json.loads(line) for line in open(
        os.path.join(cavp_logdir["log"], "metrics.jsonl"))]
    train = [r for r in rows if "train/total_loss" in r]
    val = [r for r in rows if "val/video_to_spec_R@1" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert [r["step"] for r in val] == [1, 2, 3, 4]
    for r in rows:
        assert np.isfinite(list(r.values())).all(), r
    for r in train:
        assert r["train/logit_scale"] <= 100.0 + 1e-4
    assert 0.0 <= val[-1]["val/spec_to_video_R@1"] <= 1.0
    assert ck.native_cavp_ingest_size(cavp_logdir["log"]) == 16


def test_cavp_cli_refusals(cavp_logdir):
    base = ["--train-shards", cavp_logdir["pattern"], "--device", "cpu"]
    # every tower is ported; bf16 towers are the shipped ones only, and
    # another tower under --mixed-precision fails as the JAX CLI's does
    args = cavp_cli.parse_args(base + ["--native-loader", "--video-encode",
                                       "x3d", "--spec-encode", "resnet50"])
    assert (args.native_loader, args.video_encode) == (True, "x3d")
    with pytest.raises(ValueError, match="only supported for the shipped"):
        cavp_cli.main(base + ["--tiny", "--video-encode", "x3d",
                              "--mixed-precision", "--logdir",
                              str(cavp_logdir["root"] / "refused")])
    assert cavp_cli.parse_args(base[:2]).device == "cuda"


def test_load_native_cavp_round_trip(cavp_logdir):
    model = ck.load_native_cavp(cavp_logdir["log"])
    resumed = cavp_logdir["resumed"]
    assert not model.training
    sd = model.state_dict()
    for k, p in {**resumed.params, **resumed.batch_stats}.items():
        assert torch.equal(sd[k], p.detach()), k


def test_extract_features_cli_on_the_logdir(cavp_logdir, tmp_path):
    (tmp_path / "videos").mkdir()
    clip = write_clip(str(tmp_path / "videos" / "a.avi"), seconds=3.0,
                      size=24)
    names = ef_cli.main(["--video-dir", str(tmp_path / "videos"),
                         "--out-dir", str(tmp_path / "feats"),
                         "--cavp-ckpt", cavp_logdir["log"], "--device",
                         "cpu"])
    assert names == ["a.avi"]
    feat = np.load(tmp_path / "feats" / "a.npz")["feat"]
    # the logdir's frame size (16) by default
    ref = extract_cavp_features(clip, ck.load_native_cavp(
        cavp_logdir["log"]), size=16, device="cpu")
    assert feat.shape == (12, 512) and np.array_equal(feat, ref)
    assert np.allclose(np.linalg.norm(feat, axis=-1), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def native_logdirs(cavp_logdir, tmp_path_factory):
    """Tiny stage-2 and classifier logdirs beside the CAVP one."""
    root = tmp_path_factory.mktemp("native")
    write_pairs(root / "data", n=4, frames=40, feats=3)
    common = ["--data-dir", str(root / "data"), "--tiny", "--device", "cpu",
              "--batch-size", "2", "--max-steps", "1", "--data-duration",
              "1.0", "--data-truncate", "8192"]
    s2_cli.main(common + ["--logdir", str(root / "ldm"), "--use-ema",
                          "--warmup-steps", "0"])
    clf_cli.main(common + ["--logdir", str(root / "clf")])
    return dict(cavp=cavp_logdir["log"], ldm=str(root / "ldm"),
                clf=str(root / "clf"))


@pytest.mark.parametrize("context", ["raw", "encoded"])
def test_from_native_checkpoints_generates(native_logdirs, context):
    dirs = native_logdirs
    df = DiffFoley.from_native_checkpoints(
        dirs["cavp"], dirs["ldm"], classifier=dirs["clf"], bf16=False,
        classifier_context=context, device="cpu")
    assert df.frame_size == 16 and not df.cavp.training
    clf = df.pipe.classifier
    assert (type(clf).__name__ == "AlignmentClassifier") == (
        context == "encoded")
    feats = np.random.default_rng(49).standard_normal(
        (32, 512)).astype(np.float32)
    out = df.generate_from_features(feats, seed=1, gen=GenerationConfig(
        steps=3, sample_num=1, gl_iters=2, wav_dtype="int16"))
    assert out["wav"].dtype == np.int16 and out["wav"].shape == (1, 131072)
    assert np.isfinite(out["spec"]).all()
    with pytest.raises(ValueError, match="raw"):
        DiffFoley.from_native_checkpoints(
            dirs["cavp"], dirs["ldm"], classifier=dirs["clf"],
            classifier_context="other", device="cpu")


def test_cavp_cli_trains_with_the_native_loader(shards, tmp_path):
    _need_gxx()
    pattern = shards[0].rsplit("/", 1)[0] + "/shard-{000000..000001}.tar"
    state = cavp_cli.main([
        "--train-shards", pattern, "--logdir", str(tmp_path / "log"),
        "--tiny", "--device", "cpu", "--batch-size", "2", "--clip-num", "2",
        "--steps-per-epoch", "1", "--epochs", "1", "--log-every", "1",
        "--warmup", "1", "--uint8-video", "--native-loader"])
    assert state.step == state.opt.count == 1
    import json

    row = json.loads(open(tmp_path / "log" / "metrics.jsonl").readline())
    assert row["step"] == 1 and np.isfinite(list(row.values())).all()


def test_cli_generate_over_the_port_logdirs(native_logdirs, tmp_path):
    """``cli.generate`` over the stage-2, CAVP and classifier logdirs
    writes what ``from_native_checkpoints(classifier_context="raw")``
    generates from the same clip, seed and settings, bit for bit; a JAX
    package (orbax) logdir is still refused."""
    dirs = native_logdirs
    clip = write_clip(str(tmp_path / "clip.avi"), size=24)
    out = tmp_path / "out"
    args = ["--video", clip, "--ldm-ckpt", dirs["ldm"], "--cavp-ckpt",
            dirs["cavp"], "--classifier-ckpt", dirs["clf"], "--device",
            "cpu", "--steps", "2", "--sample-num", "1", "--seed", "4"]
    paths = generate_cli.main(args + ["--out", str(out)])
    df = DiffFoley.from_native_checkpoints(
        dirs["cavp"], dirs["ldm"], classifier=dirs["clf"], bf16=False,
        classifier_context="raw", device="cpu")
    ref = df.generate_for_video(clip, seed=4 + 5, gen=GenerationConfig(
        steps=2, sample_num=1))
    assert [os.path.basename(p) for p in paths] == ["clip_sample0.wav"]
    np.testing.assert_array_equal(np.load(out / "clip_sample0_spec.npy"),
                                  ref["spec"][0])
    write_wav(str(tmp_path / "ref.wav"), ref["wav"][0])
    assert open(paths[0], "rb").read() == (tmp_path / "ref.wav").read_bytes()
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "config.json").write_text("{}")
    for i, trainer in ((3, "stage-2"), (5, "CAVP"), (7, "classifier")):
        bad = args[:i] + [str(orbax)] + args[i + 1:]
        with pytest.raises(SystemExit, match=f"orbax.*{trainer} trainer"):
            generate_cli.main(bad)
