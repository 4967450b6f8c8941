"""The PyTorch port's first-stage VAE/GAN train step against the JAX
package's, and the port's trainer CLI, on the CPU.

One tiny VAE (ch 64, mult (1, 2), one res block: every GroupNorm group
holds two channels or more) and the PatchGAN discriminator start from the
JAX trainer's initial state, carried over with ``from_jax_params``. Both
sides take two train steps on the same batch with the same posterior
noise (``jax.random.normal(fold_in(rng, step), latent shape)`` handed to
the port as numpy). ``disc_start=1``: the first step runs with the GAN
term gated off, the second with it on.
"""
import json
import os

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diff_foley_tpu.models import vae as jv
from diff_foley_tpu.train import vae as jtv
from diff_foley_tpu.train import vae_losses as jvl
from diff_foley_tpu_torch.cli import train_vae as cli
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.train import vae as ttv
from diff_foley_tpu_torch.train import vae_losses as tvl
from diff_foley_tpu_torch.utils.convert import from_jax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

VAE_KW = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1)
LR, STEPS = 1e-4, 2
METRICS = ("nll_loss", "kl_loss", "g_loss", "d_weight", "total_loss",
           "disc_loss")
# Analytically zero gradient: the softmax does not see a shift of all the
# scores of a row, which is all the k projection's bias adds. Both sides
# get rounding noise there, and Adam turns noise into steps of ±lr.
ZERO_GRAD = ("encoder.mid_attn.k.bias", "decoder.mid_attn.k.bias")


@pytest.fixture(scope="module")
def two_steps():
    """Both sides' metrics per step, and their states before and after."""
    jtrainer = jtv.VAETrainer(
        jv.AutoencoderKL(jv.VAEConfig(**VAE_KW)),
        jtv.VAETrainConfig(lr=LR, loss=jvl.VAELossConfig(disc_start=1)))
    jstate = jax.jit(lambda key: jtrainer.init_train_state(
        key, (1, 32, 32, 3)))(jax.random.PRNGKey(0))
    trainer = ttv.VAETrainer(
        tv.VAEConfig(**VAE_KW),
        ttv.VAETrainConfig(lr=LR, loss=tvl.VAELossConfig(disc_start=1)))
    state = trainer.init_train_state(0, "cpu")
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    state.vae.load_state_dict(from_jax_params(tree.params), strict=True)
    state.disc.load_state_dict(from_jax_params(
        {"params": tree.disc_params, "batch_stats": tree.disc_stats}),
        strict=True)
    before = {"vae": {k: v.clone() for k, v in state.vae.state_dict().items()}}

    x = np.random.default_rng(30).uniform(size=(2, 32, 32, 3)).astype(
        np.float32)
    rng = jax.random.PRNGKey(2)
    jstep = jax.jit(jtrainer.make_train_step())
    jmetrics, metrics, jmu, grads = [], [], [], []
    for i in range(STEPS):
        noise = np.asarray(jax.random.normal(
            jax.random.fold_in(rng, i), (2, 16, 16, 4), dtype=jnp.float32))
        jstate, m = jstep(jstate, jnp.asarray(x), rng)
        jmetrics.append({k: float(v) for k, v in m.items()})
        m = trainer.train_step(state, torch.from_numpy(x),
                               noise=torch.from_numpy(noise))
        metrics.append({k: float(v) for k, v in m.items()})
        # Adam's first moments after the step, and the port's gradients
        jmu.append({
            "vae": from_jax_params(jax.tree_util.tree_map(
                np.asarray, jstate.opt_state[0].mu)),
            "disc": from_jax_params(jax.tree_util.tree_map(
                np.asarray, jstate.disc_opt_state[0].mu))})
        grads.append({
            name: {k: p.grad.clone() for k, p in module.named_parameters()}
            for name, module in (("vae", state.vae), ("disc", state.disc))})
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    ref = {"vae": from_jax_params(tree.params),
           "disc": from_jax_params({"params": tree.disc_params,
                                    "batch_stats": tree.disc_stats})}
    return dict(jmetrics=jmetrics, metrics=metrics, ref=ref, state=state,
                before=before, jstep=int(tree.step), jmu=jmu, grads=grads)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("name", METRICS)
def test_train_step_metrics_match_jax(two_steps, step, name):
    # fp32 sums over 2·32·32·3 pixels and a ratio of two gradient norms:
    # 1e-4 relative (reached: 3e-6 on d_weight, below 1e-6 elsewhere)
    ref = two_steps["jmetrics"][step][name]
    out = two_steps["metrics"][step][name]
    assert np.isfinite(out)
    assert abs(out - ref) <= 1e-4 * max(abs(ref), 1e-3), (name, step, out, ref)


def test_gan_term_is_gated_then_on(two_steps):
    m0, m1 = two_steps["metrics"]
    assert m0["disc_loss"] == 0.0 and m1["disc_loss"] > 0.0
    assert m0["total_loss"] == pytest.approx(
        m0["nll_loss"] + 1e-6 * m0["kl_loss"], rel=1e-6)
    assert 0.0 < m1["d_weight"] < 0.5e4   # the clip is not what is compared
    assert two_steps["state"].step == two_steps["jstep"] == STEPS


@pytest.mark.parametrize("model,step,tol", [
    ("vae", 0, 2e-5), ("vae", 1, 1e-3), ("disc", 0, 0.0), ("disc", 1, 1e-4)])
def test_train_step_gradients_match_jax(two_steps, model, step, tol):
    # Adam's update is nearly lr·sign(g) and blind to a factor on a leaf's
    # gradient, so the gradients themselves are compared, before Adam. The
    # JAX trainer's come out of its optimizer state: the first moment is
    # m ← 0.5·m + 0.5·g from zero, so g = 2·m − m_before. Every element
    # within tol of its leaf's max|g|. From equal parameters (the VAE's
    # first step) 2e-5 (reached: 5e-6); the discriminator's first gradient,
    # at step 1 on a reconstruction of the moved VAE, 1e-4 (reached:
    # 1.7e-5); the VAE's second step 1e-3 (reached: 1.7e-4, around the one
    # weight whose first Adam step took the other sign, 2·lr apart).
    mu = two_steps["jmu"][step][model]
    prev = two_steps["jmu"][step - 1][model] if step else None
    out = two_steps["grads"][step][model]
    assert set(out) == set(mu)
    if (model, step) == ("disc", 0):   # gated off: no gradient at all
        assert all(float(v.abs().max()) == 0.0 for v in mu.values())
        assert all(float(g.abs().max()) == 0.0 for g in out.values())
        return
    worst = 0.0
    for k, m in mu.items():
        ref = 2.0 * m - (prev[k] if prev else 0.0)
        scale = float(ref.abs().max())
        if k in ZERO_GRAD:   # noise on both sides, far below the kernel's
            scale = float(mu[k.replace(".bias", ".weight")].abs().max())
            assert float(ref.abs().max()) <= 1e-4 * scale, k
        assert scale > 0.0, k
        err = float((out[k] - ref).abs().max()) / scale
        assert err <= tol, (k, err)
        worst = max(worst, err)
    assert len(mu) > (60 if model == "vae" else 12) and worst > 0.0


def _leaf_errors(out: dict, ref: dict, tol: float, skip=()):
    """{leaf: max|Δ| / max(1, max|ref|)} over the elements that agree, and
    the count of those that do not (|Δ| above tol·scale). Adam's first step
    is lr·g/(|g| + ε), nearly lr·sign(g): an element whose first gradient
    is rounding noise around zero steps either way on either side. Such
    elements may be at most 2, or 1 in 10³, of a leaf (a wrong gradient
    would move most of a leaf) and differ by at most 2·lr a step."""
    assert set(out) == set(ref)
    worst, flipped = {}, 0
    for k, r in ref.items():
        if k in skip:
            continue
        o = out[k]
        assert o.shape == r.shape, k
        delta = (o - r).abs() / max(1.0, float(r.abs().max()))
        off = delta > tol
        n_off = int(off.sum())
        assert n_off <= max(2, 1e-3 * off.numel()), (k, n_off)
        assert float(delta.max()) <= 2 * STEPS * LR * 1.01, k
        flipped += n_off
        worst[k] = float(delta[~off].max())
    return worst, flipped


def test_updated_vae_leaves_match_jax(two_steps):
    # Two Adam steps at lr 1e-4 move a leaf by at most 2e-4; the port's
    # leaves stay within 2e-5·max(1, max|ref|) of the JAX trainer's
    # (reached: 5e-6), a tenth of the move, every leaf by name; one
    # element of 2.6 million took the other sign at its first step.
    out = two_steps["state"].vae.state_dict()
    worst, flipped = _leaf_errors(out, two_steps["ref"]["vae"], 2e-5,
                                  skip=ZERO_GRAD)
    assert len(worst) > 60 and flipped <= 30
    moved = [k for k, v in two_steps["before"]["vae"].items()
             if float((out[k] - v).abs().max()) > 0.5 * LR]
    assert len(moved) >= len(out) - len(ZERO_GRAD)
    for k in ZERO_GRAD:   # noise in, at most one lr a step out
        for side in (out, two_steps["ref"]["vae"]):
            assert float(side[k].abs().max()) <= STEPS * LR * 1.01


def test_updated_discriminator_and_batch_stats_match_jax(two_steps):
    # the discriminator's parameters as the VAE's (2e-5); its running
    # statistics took four batch updates (two calls a step) with momentum
    # 0.9 and the biased batch variance: 1e-5. Its first step with a
    # gradient is the second (the first is gated off) and as sign-like:
    # 25 of its 2.8 million elements took the other sign.
    out = two_steps["state"].disc.state_dict()
    worst, flipped = _leaf_errors(out, two_steps["ref"]["disc"], 2e-5)
    stats = {k: e for k, e in worst.items() if "running" in k}
    assert len(stats) == 6 and len(worst) == 19 and flipped <= 100
    assert max(stats.values()) <= 1e-5, stats


def test_trainer_state_defaults_to_the_card():
    # as the pipeline and the CLI: no device named means CUDA, and without
    # a card that raises instead of training on the CPU unnoticed
    trainer = ttv.VAETrainer(tv.VAEConfig(ch=32, ch_mult=(1,),
                                          num_res_blocks=1))
    if torch.cuda.is_available():
        state = trainer.init_train_state(0)
        assert next(state.vae.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer.init_train_state(0)
    state = trainer.init_train_state(0, "cpu")
    assert {p.device.type for m in (state.vae, state.disc)
            for p in m.parameters()} == {"cpu"}


def test_cli_trains_checkpoints_and_resumes_on_cpu(tmp_path):
    rng = np.random.default_rng(31)
    specs = tmp_path / "specs"
    specs.mkdir()
    for i in range(3):
        np.save(specs / f"clip{i}.npy",
                rng.uniform(size=(128, 40 + i)).astype(np.float32))
    args = ["--spec-dir", str(specs), "--logdir", str(tmp_path / "log"),
            "--tiny", "--device", "cpu", "--batch-size", "2", "--lr", "1e-4",
            "--disc-start", "0", "--log-every", "1", "--data-duration", "1.0",
            "--data-truncate", "8192"]
    state = cli.main(args + ["--max-steps", "2"])
    assert state.step == 2
    assert cli.latest_checkpoint(str(tmp_path / "log" / "ckpt"))[0] == 2
    resumed = cli.main(args + ["--max-steps", "3", "--resume"])
    assert resumed.step == 3
    saved = torch.load(tmp_path / "log" / "ckpt" / "step_2.pt")
    assert saved["step"] == 2 and saved["opt"]["state"][0]["step"] == 2
    rows = [json.loads(line) for line in
            (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(list(r.values())).all() for r in rows)
    assert all(r["train/disc_loss"] > 0 for r in rows)   # the GAN term is on
    with pytest.raises(SystemExit, match="--data-dir or --spec-dir"):
        cli.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="3 items < batch 64"):
        cli.main(args + ["--batch-size", "64"])
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--spec-dir", str(specs)])


def _kink_inputs():
    """An input with elements well away from zero, some within
    chip_smoke.KINK_MARGIN·rms of it, and exact zeros."""
    x = torch.as_tensor(np.random.default_rng(40).standard_normal((2, 8, 6, 5)),
                        dtype=torch.float32)
    rms = float(x.double().square().mean().sqrt())
    x[0, 0, 0, :3] = torch.tensor([0.3, -0.2, 0.5]) * chip_smoke.KINK_MARGIN * rms
    x[1, 2, 3, 0] = 0.0
    return x, float(x.double().square().mean().sqrt())


def test_kinked_leaky_relu_is_leaky_relu_on_its_own_branches():
    # value and gradient equal F.leaky_relu's when the branches are x > 0
    x, _ = _kink_inputs()
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    ya = chip_smoke.kinked_leaky_relu(a, 0.2, a.detach() > 0)
    yb = F.leaky_relu(b, 0.2)
    assert torch.equal(ya, yb)
    (ya * w).sum().backward()
    (yb * w).sum().backward()
    assert torch.equal(a.grad, b.grad)


def test_kink_replay_follows_the_record_within_the_margin():
    # recorded on one side, replayed on the other: inside the margin the
    # branch is the record's (value x or 0.2·x, gradient 1 or 0.2), every
    # other element F.leaky_relu's own; the flips are counted
    x, rms = _kink_inputs()
    other = x.clone()
    other[0, 0, 0, :3] = -other[0, 0, 0, :3]    # the other device's side
    other[0, 1] = -other[0, 1]                  # far from zero: not taken
    with chip_smoke.KinkSides() as record:
        F.leaky_relu(other, 0.2)
    assert len(record.inputs) == 1 and torch.equal(record.inputs[0], other)
    x.requires_grad_()
    with chip_smoke.KinkSides(record.inputs) as replay:
        y = F.leaky_relu(x, 0.2)
    y.sum().backward()
    near = x.detach().abs() <= chip_smoke.KINK_MARGIN * rms
    assert int(near.sum()) == 4   # three near the kink and the zero
    pos = torch.where(near, other > 0, x.detach() > 0)
    assert torch.equal(y.detach(), torch.where(pos, x.detach(), 0.2 * x.detach()))
    assert torch.equal(x.grad, torch.where(pos, 1.0, 0.2))
    assert torch.equal(y.detach()[~near], F.leaky_relu(x.detach(), 0.2)[~near])
    assert replay.flips == 3 and replay.gap == pytest.approx(
        float((x.detach() - other).abs().max()) / rms)
