"""``train/scan.py`` on the CPU, as tests/test_scan_train.py holds the JAX
one: K scanned classifier steps equal K sequential ``train_step`` calls
from the same state and generator (bit for bit: the same operations in
the same order), with the batches resident or gathered by ``index_fn``;
and the port's scan over JAX's draws against JAX's ``scan_train`` from the
same weights (tolerances below). The classifier is the JAX CLI's
``--tiny`` one (tests/test_torch_classifier.py), on the ``z_mu`` branch.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models.unet import UNetConfig as JUNetConfig
from diff_foley_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from diff_foley_tpu.models.vae import VAEConfig as JVAEConfig
from diff_foley_tpu.train import classifier as jclf
from diff_foley_tpu.train.scan import scan_train as j_scan_train
from diff_foley_tpu_torch.train.scan import jit_scan_train, scan_train
from diff_foley_tpu_torch.utils.init import random_flax_params
from test_torch_classifier import (BACKBONE_KW, LATENT, LR, SEQ, TOKENS,
                                   VAE_KW, ZERO_GRAD, named, port_trainer,
                                   replay_draws)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

K, B = 4, LATENT[0]


def jclf_trainer_kw() -> dict:
    return dict(backbone_cfg=JUNetConfig(**BACKBONE_KW),
                vae=JAutoencoderKL(JVAEConfig(**VAE_KW)),
                cfg=jclf.ClassifierTrainConfig(lr=LR), cond_seq_len=SEQ)


def random_weights():
    """Seeded random JAX weights of the classifier and its VAE (a fresh
    flax init zeroes the head's conv)."""
    jtrainer = jclf.ClassifierTrainer(**jclf_trainer_kw())
    shapes = jax.eval_shape(jtrainer.init_params, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    random_flax_params(shapes, seed=21))
    vae_shapes = jax.eval_shape(lambda k: jtrainer.vae.init(
        k, jnp.zeros((1, 64, 128, 3))), jax.random.PRNGKey(1))
    vae = jax.tree_util.tree_map(jnp.asarray,
                                 random_flax_params(vae_shapes, seed=22))
    return params, vae


def _batches(k: int, seed: int) -> dict:
    data = np.random.default_rng(seed)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return {"z_mu": as_t(data.standard_normal((k, *LATENT)).astype(
                np.float32)),
            "z_sigma": as_t(data.uniform(0.1, 0.5, (k, *LATENT)).astype(
                np.float32)),
            "video_feat": as_t(data.standard_normal((k, B, TOKENS, 512))
                               .astype(np.float32)),
            "labels": as_t(data.integers(0, 2, (k, B)))}


def _state(params, vae):
    trainer = port_trainer(params, vae)
    return trainer, trainer.init_train_state(None, "cpu")


def _same_state(a, b) -> None:
    assert a.step == b.step
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert a.opt.count == b.opt.count
    for m, n in zip(a.opt.mu + a.opt.nu, b.opt.mu + b.opt.nu):
        assert torch.equal(m, n)


@pytest.fixture(scope="module")
def weights():
    return random_weights()


def test_scan_train_equals_sequential_steps(weights):
    batches = _batches(K, 30)
    t_seq, s_seq = _state(*weights)
    gen = torch.Generator().manual_seed(5)
    seq = [t_seq.train_step(s_seq, {k: v[i] for k, v in batches.items()},
                            gen) for i in range(K)]
    t_scan, s_scan = _state(*weights)
    s_out, metrics = scan_train(t_scan.train_step, s_scan, batches,
                                torch.Generator().manual_seed(5))
    assert s_out is s_scan and s_scan.step == K
    assert set(metrics) == {"bce_loss", "acc", "grad_norm"}
    for name, stacked in metrics.items():
        assert stacked.shape == (K,)
        assert torch.equal(stacked, torch.stack([m[name] for m in seq]))
    _same_state(s_scan, s_seq)


def test_scan_train_index_fn_gather(weights):
    """index_fn gathers each step's batch from a resident dataset: the
    result equals feeding the gathered batches directly, bit for bit."""
    n = 6
    data = _batches(1, 31)
    rng = np.random.default_rng(32)
    mu = torch.from_numpy(rng.standard_normal((n, *LATENT[1:])).astype(
        np.float32))
    sg = torch.from_numpy(rng.uniform(0.1, 0.5, (n, *LATENT[1:])).astype(
        np.float32))
    feat = torch.from_numpy(rng.standard_normal((n, TOKENS, 512)).astype(
        np.float32))
    idx = torch.from_numpy(rng.integers(0, n, (3, B)))
    labels = torch.from_numpy(rng.integers(0, 2, (3, B)))
    steps = []

    def index_fn(xs, step):
        steps.append(step)
        return {"z_mu": mu[xs["i"]], "z_sigma": sg[xs["i"]],
                "video_feat": feat[xs["i"]], "labels": xs["l"]}

    t_a, s_a = _state(*weights)
    _, m_a = scan_train(t_a.train_step, s_a, {"i": idx, "l": labels},
                        torch.Generator().manual_seed(6), index_fn=index_fn)
    assert steps == [0, 1, 2]
    direct = {"z_mu": mu[idx], "z_sigma": sg[idx], "video_feat": feat[idx],
              "labels": labels}
    t_b, s_b = _state(*weights)
    _, m_b = scan_train(t_b.train_step, s_b, direct,
                        torch.Generator().manual_seed(6))
    for name in m_a:
        assert torch.equal(m_a[name], m_b[name])
    _same_state(s_a, s_b)
    assert data["labels"].shape == (1, B)


def test_jit_scan_train_is_the_eager_scan(weights):
    batches = _batches(2, 33)
    t_a, s_a = _state(*weights)
    _, m_a = jit_scan_train(t_a.train_step)(s_a, batches,
                                            torch.Generator().manual_seed(7))
    t_b, s_b = _state(*weights)
    _, m_b = scan_train(t_b.train_step, s_b, batches,
                        torch.Generator().manual_seed(7))
    for name in m_a:
        assert torch.equal(m_a[name], m_b[name])
    _same_state(s_a, s_b)


def test_scan_train_rejects_ragged_steps(weights):
    batches = _batches(2, 34)
    batches["labels"] = batches["labels"][:1]
    t, s = _state(*weights)
    with pytest.raises(ValueError, match="leading axes"):
        scan_train(t.train_step, s, batches, None)


def test_scan_train_matches_jax_scan(weights):
    """K = 3 steps of the JAX scan (one jitted program) and of the port's
    scan, which takes JAX's draws (fold_in(rng, step) → ε, t, noise)
    through its step's ``draws``. Per-step BCE and accuracy within 1e-5
    of JAX's (relative; one step reaches ~1e-7), and the parameters after
    the three AdamW steps: no element off by more than 2·lr a step, and
    the elements off by more than 1e-6 (AdamW's first steps are ≈
    lr·sign(g), so gradients within rounding of zero flip) at most 3, or
    3 in 10³, of a leaf; the leaves whose gradient is analytically zero
    (``ZERO_GRAD``: rounding noise on both sides) to the bound only, as
    tests/test_torch_classifier.py holds them."""
    params, vae = weights
    jtrainer = jclf.ClassifierTrainer(**jclf_trainer_kw())
    batches = _batches(3, 35)
    rng = jax.random.PRNGKey(11)
    state0 = jclf.ClassifierTrainState(jnp.asarray(0, jnp.int32), params,
                                       jtrainer.tx.init(params))
    jbatches = {k: jnp.asarray(v.numpy()) for k, v in batches.items()}
    step_fn = jtrainer.make_train_step(vae)
    j_state, j_metrics = jax.jit(lambda st, xs, key: j_scan_train(
        step_fn, st, xs, key))(state0, jbatches, rng)

    carrier = {"data": batches,
               "draws": [replay_draws(rng, k) for k in range(3)]}
    carrier["draws"] = {name: torch.stack([d[name] for d in carrier["draws"]])
                        for name in carrier["draws"][0]}
    trainer, state = _state(params, vae)
    step = lambda st, b, gen: trainer.train_step(st, b["data"], gen,
                                                 draws=b["draws"])
    _, metrics = scan_train(step, state, carrier, None)
    for name in ("bce_loss", "acc"):
        ref = np.asarray(j_metrics[name])
        out = metrics[name].numpy()
        assert np.all(np.abs(out - ref) <= 1e-5 * np.maximum(np.abs(ref),
                                                             1e-3)), name
    lr = trainer.cfg.lr
    for k, r in named(j_state.params).items():
        delta = (state.params[k].detach() - r).abs() / max(
            1.0, float(r.abs().max()))
        assert float(delta.max()) <= 3 * 2 * lr * 1.01, k
        if k in ZERO_GRAD:
            continue
        assert int((delta > 1e-6).sum()) <= max(3, 3e-3 * delta.numel()), k
