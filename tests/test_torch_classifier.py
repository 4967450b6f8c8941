"""The port's alignment classifier against the JAX package's, on the CPU:
one train step (metrics, the gradients per leaf before AdamW, the AdamW
update) on the spec branch and on the ``z_mu`` branch, the BCE at its
clip, ``make_align_acc_fn`` and ``alignment_accuracy`` with a ragged
masked batch, the "encoded" guidance route of
``DiffFoley.from_native_checkpoints`` against JAX's ``clf_apply``; then
the CLIs (``cli.train_classifier --tiny`` with ``--resume``,
``load_native_classifier``, ``cli.align_acc``) end to end.

Both sides start from the same seeded weights (``random_flax_params``: a
fresh flax init zeroes the head's conv, and every gradient behind it
would be zero), at the JAX CLI's ``--tiny`` geometry (head dim 16: the
plain attention runs here). One jitted JAX step serves both batch
branches; the port takes the posterior ε, t and noise that JAX's key
splits give (``fold_in(rng, step)`` → three-way split) through ``draws``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.eval import align_acc as jacc
from diff_foley_tpu.models.unet import UNetConfig as JUNetConfig
from diff_foley_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from diff_foley_tpu.models.vae import VAEConfig as JVAEConfig
from diff_foley_tpu.train import classifier as jclf
from diff_foley_tpu_torch.cli import align_acc as acc_cli
from diff_foley_tpu_torch.cli import train_classifier as clf_cli
from diff_foley_tpu_torch.eval import align_acc as tacc
from diff_foley_tpu_torch.models.unet import UNetConfig
from diff_foley_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diff_foley_tpu_torch.train import classifier as tclf
from diff_foley_tpu_torch.utils import checkpoint as ck
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params
from test_torch_stage2_cli import write_pairs

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

# the JAX CLI's --tiny system: head dim 16, the raw 512-d features as the
# cond encoder's input and the backbone's context, the ×8 VAE
BACKBONE_KW = dict(out_channels=1, model_channels=32, num_res_blocks=1,
                   channel_mult=(1, 2), attention_resolutions=(2,),
                   num_heads=4, context_dim=512)
VAE_KW = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
SEQ, B, LR = 40, 4, 5e-5
SPEC = (B, 64, 128, 3)
LATENT = (B, 8, 16, 4)
TOKENS = 32


def named(tree) -> dict:
    """{"backbone.*"/"cond.*": tensor} of a JAX {backbone, cond} tree."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return {f"{part}.{k}": v for part in ("backbone", "cond")
            for k, v in from_jax_params(tree[part]).items()}


def replay_draws(rng, step=0, latent=LATENT):
    """The JAX step's draws: fold_in → split (encode ε, t, noise)."""
    k_enc, k_t, k_noise = jax.random.split(jax.random.fold_in(rng, step), 3)
    as_t = lambda a: torch.from_numpy(np.array(a))
    return {"eps": as_t(jax.random.normal(k_enc, latent, jnp.float32)),
            "t": as_t(jax.random.randint(k_t, (latent[0],), 0, 1000)).long(),
            "noise": as_t(jax.random.normal(k_noise, latent, jnp.float32))}


def port_trainer(params, vae_params) -> tclf.ClassifierTrainer:
    trainer = tclf.ClassifierTrainer(
        UNetConfig(**BACKBONE_KW), AutoencoderKL(VAEConfig(**VAE_KW)),
        tclf.ClassifierTrainConfig(lr=LR), cond_seq_len=SEQ)
    trainer.model.load_state_dict(named(params), strict=True)
    trainer.vae.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, vae_params)), strict=True)
    return trainer


@pytest.fixture(scope="module")
def run():
    """One jitted JAX step on the spec batch and on the z_mu batch, from
    the same state, and the port's steps with the same draws."""
    jtrainer = jclf.ClassifierTrainer(
        backbone_cfg=JUNetConfig(**BACKBONE_KW),
        vae=JAutoencoderKL(JVAEConfig(**VAE_KW)),
        cfg=jclf.ClassifierTrainConfig(lr=LR), cond_seq_len=SEQ)
    shapes = jax.eval_shape(jtrainer.init_params, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    random_flax_params(shapes, seed=21))
    vae_shapes = jax.eval_shape(lambda k: jtrainer.vae.init(
        k, jnp.zeros((1, 64, 128, 3))), jax.random.PRNGKey(1))
    vae = jax.tree_util.tree_map(jnp.asarray,
                                 random_flax_params(vae_shapes, seed=22))
    data = np.random.default_rng(23)
    labels = np.array([1, 0, 1, 0])
    feat = data.standard_normal((B, TOKENS, 512)).astype(np.float32)
    batches = {
        "spec": {"spec": data.uniform(size=SPEC).astype(np.float32),
                 "video_feat": feat, "labels": labels},
        "z_mu": {"z_mu": data.standard_normal(LATENT).astype(np.float32),
                 "z_sigma": data.uniform(0.1, 0.5, LATENT).astype(
                     np.float32),
                 "video_feat": feat, "labels": labels}}
    rng = jax.random.PRNGKey(3)
    jstep = jax.jit(jtrainer.make_train_step(vae))
    out = {"jtrainer": jtrainer, "params": params, "vae": vae, "rng": rng}
    draws = replay_draws(rng)
    for branch, batch in batches.items():
        j0 = jclf.ClassifierTrainState(jnp.asarray(0, jnp.int32), params,
                                       jtrainer.tx.init(params))
        j1, jm = jstep(j0, batch, rng)
        trainer = port_trainer(params, vae)
        state = trainer.init_train_state(None, "cpu")
        m = trainer.train_step(state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()},
                               draws=draws)
        out[branch] = {
            "jmetrics": {k: float(v) for k, v in jm.items()},
            "metrics": {k: float(v) for k, v in m.items()},
            "jgrads": {k: v / 0.1 for k, v in named(
                j1.opt_state[0].mu).items()},
            "grads": {k: p.grad.clone() for k, p in state.params.items()},
            "jparams": named(j1.params),
            "params": {k: p.detach().clone()
                       for k, p in state.params.items()}}
    out["trainer"] = port_trainer(params, vae)
    return out


@pytest.mark.parametrize("branch", ["spec", "z_mu"])
@pytest.mark.parametrize("name", ["bce_loss", "acc"])
def test_train_step_metrics_match_jax(run, branch, name):
    # fp32 BCE of a tiny backbone: 1e-5 relative (reached: ~1e-7)
    ref, out = run[branch]["jmetrics"][name], run[branch]["metrics"][name]
    assert np.isfinite(out) and abs(out - ref) <= 1e-5 * max(abs(ref), 1e-3)


# Leaves whose gradient is analytically zero: the level-0 norms hold one
# channel a group (32 channels, 32 groups), so a per-channel shift in front
# of one is removed by it: the time embedding's and in_conv's bias in the
# level-0 ResBlock (before its out_norm). Their gradients are rounding
# noise on both sides.
ZERO_GRAD = {f"backbone.down_0_0_res.{leaf}" for leaf in (
    "emb_dense.weight", "emb_dense.bias", "in_conv.bias")}


def noise_leaves(grads: dict) -> set:
    """The leaves whose gradient is under 1e-5 of the largest leaf's."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {k for k, g in grads.items() if float(g.abs().max()) <= 1e-5 * top}


@pytest.mark.parametrize("branch", ["spec", "z_mu"])
def test_gradients_before_adamw_match_jax(run, branch):
    # the gradients per leaf, before AdamW (the JAX one out of optax's
    # first moment after one step, m = 0.1·g): every element within 1e-4
    # of its leaf's max|g| (reached: ~3e-6)
    ref, out = run[branch]["jgrads"], run[branch]["grads"]
    assert set(out) == set(ref) and len(out) > 40
    assert noise_leaves(ref) == noise_leaves(out) == ZERO_GRAD
    worst = {}
    for k, r in ref.items():
        assert out[k].dtype == torch.float32
        if k in ZERO_GRAD:
            continue
        scale = float(r.abs().max())
        assert scale > 0.0, k
        worst[k] = float((out[k] - r).abs().max()) / scale
    assert max(worst.values()) <= 1e-4, sorted(
        worst.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("branch", ["spec", "z_mu"])
def test_adamw_update_matches_jax(run, branch):
    # one AdamW step (lr 5e-5, weight decay 0.01): the first step is
    # ≈ lr·sign(g), so an element whose gradient lies within rounding of
    # zero may step the other way: within 1e-6·max(1, max|ref|) but for at
    # most 2, or 1 in 10³, of a leaf, and none beyond 2·lr
    ref, out = run[branch]["jparams"], run[branch]["params"]
    for k, r in ref.items():
        delta = (out[k] - r).abs() / max(1.0, float(r.abs().max()))
        assert float(delta.max()) <= 2 * LR * 1.01, k
        if k in ZERO_GRAD:   # noise in: held to the bound above only
            continue
        assert int((delta > 1e-6).sum()) <= max(2, 1e-3 * delta.numel()), k


@pytest.mark.parametrize("p", [0.0, 1e-9, 1e-7, 0.3, 1 - 1e-9, 1.0])
def test_bce_at_the_clip_is_the_jax_formula(p):
    # the JAX step's clip-then-formula, element for element (float32)
    probs = np.full((2, 1), p, np.float32)
    labels = np.array([1, 0])
    pc = jnp.clip(jnp.asarray(probs), 1e-7, 1 - 1e-7)
    lab = jnp.asarray(labels, jnp.float32)[:, None]
    ref = float(-(lab * jnp.log(pc) + (1 - lab) * jnp.log(1 - pc)).mean())
    ref_acc = float((jnp.round(pc) == lab).mean())
    bce, acc = tclf.bce_and_accuracy(torch.from_numpy(probs),
                                     torch.from_numpy(labels))
    assert float(bce) == pytest.approx(ref, rel=1e-6)
    assert float(acc) == ref_acc


def test_encoded_route_matches_jax_clf_apply(run):
    # the "encoded" guidance classifier: cond encoder, then the backbone,
    # logits; fp32, max|Δ| 1e-5 of rms (reached: ~1e-7)
    jt, params = run["jtrainer"], run["params"]
    data = np.random.default_rng(24)
    x = data.standard_normal((2, 16, 64, 4)).astype(np.float32)
    t = np.array([10.0, 700.0], np.float32)
    feat = data.standard_normal((2, TOKENS, 512)).astype(np.float32)

    def clf_apply(cp, x, t, feat):   # api.py's "encoded" clf_apply
        ctx = jt.cond_encoder.apply(cp["cond"], feat)
        return jt.backbone.apply(cp["backbone"], x, t, ctx,
                                 return_logits=True)

    ref = np.asarray(jax.jit(clf_apply)(params, x, t, feat))
    with torch.no_grad():
        out = run["trainer"].model(*(torch.from_numpy(a)
                                     for a in (x, t, feat)),
                                   return_logits=True).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-5 * np.sqrt(np.square(ref).mean())


def _eval_batches(n=5, seed=25):
    """{"spec": (n, 128, 520, 3), "video_feat": (n, 40, 512)}: specs longer
    than 512 frames, as the metric cuts them."""
    data = np.random.default_rng(seed)
    return {"spec": data.uniform(size=(n, 128, 520, 3)).astype(np.float32),
            "video_feat": data.standard_normal((n, SEQ, 512)).astype(
                np.float32)}


@pytest.fixture(scope="module")
def centred(run):
    """The JAX params and the port's classifier with the head's bias
    moved by the median logit over the eval specs: the probabilities
    then straddle 0.5, so the counts test the rounding, not a constant."""
    b = _eval_batches(n=7, seed=26)
    trainer = port_trainer(run["params"], run["vae"])
    with torch.no_grad():
        z = 0.18215 * trainer.vae.encode(
            torch.from_numpy(b["spec"][:, :, :512])).mode()
        logits = trainer.model(z, torch.zeros(7), torch.from_numpy(
            b["video_feat"]), return_logits=True)
        shift = float(logits.median())
        trainer.model.backbone.classifier.bias.sub_(shift)
    params = jax.tree_util.tree_map(np.array, run["params"])
    params["backbone"]["params"]["classifier"]["bias"] -= np.float32(shift)
    return params, trainer


def test_align_acc_fn_counts_match_jax_with_a_ragged_mask(run, centred):
    params, trainer = centred
    b = _eval_batches(n=7, seed=26)
    valid = np.array([1, 1, 1, 1, 1, 0, 0], np.int64)
    jfn = jacc.make_align_acc_fn(run["jtrainer"], run["jtrainer"].vae,
                                 run["vae"])
    jc, jt = jfn(params, b["spec"], b["video_feat"], valid.astype(np.int32))
    fn = tacc.make_align_acc_fn(trainer.model, trainer.vae)
    c, t = fn(*(torch.from_numpy(a) for a in (b["spec"], b["video_feat"],
                                               valid)))
    assert (int(c), int(t)) == (int(jc), int(jt)) and int(t) == 5
    assert 0 < int(c) < 5


def test_alignment_accuracy_matches_jax_over_a_ragged_stream(run, centred):
    params, trainer = centred
    b = _eval_batches(n=7, seed=26)
    stream = lambda: ({k: v[i:i + 3] for k, v in b.items()}
                      for i in range(0, 7, 3))
    ref = jacc.alignment_accuracy(stream(), run["jtrainer"], params,
                                  run["jtrainer"].vae, run["vae"])
    out = tacc.alignment_accuracy(stream(), trainer.model, trainer.vae,
                                  device="cpu")
    assert out == ref and 0.0 < out < 1.0
    # a mesh is taken (it used to raise): a process alone has the one-rank
    # mesh, whose counts need no sum (7 rows over two gloo ranks against
    # JAX's 2-device mesh: tests/test_torch_parallel_entries.py)
    from diff_foley_tpu_torch.parallel.mesh import make_mesh

    assert tacc.alignment_accuracy(stream(), trainer.model, trainer.vae,
                                   mesh=make_mesh(), device="cpu") == out


# ---- the CLIs ------------------------------------------------------------------

@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    """``cli.train_classifier --tiny``: two steps, then a resume to 3."""
    root = tmp_path_factory.mktemp("classifier")
    write_pairs(root / "data", n=4, frames=40, feats=3)
    args = ["--data-dir", str(root / "data"), "--logdir", str(root / "log"),
            "--tiny", "--device", "cpu", "--batch-size", "2",
            "--log-every", "1", "--data-duration", "1.0",
            "--data-truncate", "8192"]
    first = clf_cli.main(args + ["--max-steps", "2"])
    saved = torch.load(root / "log" / "ckpt" / "step_2.pt")
    resumed = clf_cli.main(args + ["--max-steps", "3", "--resume"])
    return dict(root=root, args=args, first=first, saved=saved,
                resumed=resumed)


def test_cli_trains_and_resumes(logdir):
    import json

    first, resumed, saved = (logdir["first"], logdir["resumed"],
                             logdir["saved"])
    assert first.step == 2 and first.opt.count == 2
    assert saved["state"]["step"] == 2 and saved["state"]["opt"]["count"] == 2
    assert resumed.step == 3 and resumed.opt.count == 3
    rows = [json.loads(line) for line in
            (logdir["root"] / "log" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for r in rows:
        assert set(r) >= {"train/bce_loss", "train/acc", "train/grad_norm"}
        assert np.isfinite(list(r.values())).all(), r
        assert 0.0 <= r["train/acc"] <= 1.0


def test_load_native_classifier_round_trip(logdir):
    log = str(logdir["root"] / "log")
    trainer, params, vae = ck.load_native_classifier(log)
    resumed = logdir["resumed"]
    assert set(params) == set(resumed.params)
    for k, p in resumed.params.items():
        assert torch.equal(params[k], p.detach()), k
    persisted = torch.load(os.path.join(log, "vae", "step_0.pt"))["vae"]
    assert vae is trainer.vae
    for k, v in vae.state_dict().items():
        assert torch.equal(v, persisted[k]), k
    assert trainer.model.backbone.cfg == UNetConfig(**BACKBONE_KW)
    assert trainer.vae.cfg == VAEConfig(**VAE_KW)


def test_align_acc_cli_on_the_logdir(logdir, tmp_path):
    # five spec files at batch 2: a ragged last batch of one
    data = np.random.default_rng(27)
    (tmp_path / "spec").mkdir()
    (tmp_path / "feat").mkdir()
    for i in range(5):
        np.save(tmp_path / "spec" / f"c{i}.npy",
                data.uniform(size=(128, 520)).astype(np.float32))
        np.savez(tmp_path / "feat" / f"c{i}.npz",
                 feat=data.standard_normal((44, 512)).astype(np.float32))
    batches = list(acc_cli.iter_batches(str(tmp_path / "spec"),
                                        str(tmp_path / "feat"), 2))
    assert [b["spec"].shape for b in batches] == [(2, 128, 512, 3)] * 2 + [
        (1, 128, 512, 3)]
    assert batches[0]["video_feat"].shape == (2, SEQ, 512)
    out = tmp_path / "results_metric.txt"
    acc = acc_cli.main(["--spec-dir", str(tmp_path / "spec"), "--feat-dir",
                        str(tmp_path / "feat"), "--classifier-ckpt",
                        str(logdir["root"] / "log"), "--batch-size", "2",
                        "--out", str(out), "--device", "cpu"])
    assert 0.0 <= acc <= 1.0 and acc * 5 == round(acc * 5)
    assert out.read_text() == f"align_acc: {acc:.6f}\n"
    # a JAX package logdir (no step_<n>.pt) is refused with a message
    (tmp_path / "jax_log").mkdir()
    (tmp_path / "jax_log" / "config.json").write_text("{}")
    with pytest.raises(SystemExit, match="orbax"):
        acc_cli.load_classifier(str(tmp_path / "jax_log"))


def test_cli_defaults_to_the_card_and_guards_a_small_dataset(logdir,
                                                             tmp_path):
    args = clf_cli.parse_args(["--data-dir", "d"])
    assert args.device == "cuda" and args.batch_size == 32
    assert acc_cli.parse_args(["--spec-dir", "s", "--feat-dir", "f"]
                              ).device == "cuda"
    with pytest.raises(SystemExit, match="global batch"):
        clf_cli.main(logdir["args"][:4] + ["--logdir", str(tmp_path / "l"),
                                           "--tiny", "--device", "cpu",
                                           "--batch-size", "64"])
