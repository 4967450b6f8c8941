"""The modules of the PyTorch port's first-stage VAE/GAN training against
their JAX counterparts, on the CPU: the posterior, the PatchGAN
discriminator and its BatchNorm, the losses, LPIPS/LPAPS, the mel-spec
dataset and the loader. Inputs come from a numpy seed and go to both sides
as numpy arrays; weights cross over with ``from_jax_params``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.data import ldm_dataset as jds
from diff_foley_tpu.data import loader as jloader
from diff_foley_tpu.models import vae as jv
from diff_foley_tpu.train import perceptual as jperc
from diff_foley_tpu.train import vae_losses as jvl
from diff_foley_tpu_torch.data import ldm_dataset as tds
from diff_foley_tpu_torch.data import loader as tloader
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.train import perceptual as tperc
from diff_foley_tpu_torch.train import vae_losses as tvl
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, tol, what=""):
    """max|Δ| ≤ tol · max(1, max|ref|)."""
    out = np.asarray(out.detach() if torch.is_tensor(out) else out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    scale = max(1.0, np.abs(ref).max())
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3e} > {tol:.1e}·{scale:.3g}"


def test_diagonal_gaussian_matches():
    # elementwise fp32 and sums over 2·4·8·4 elements: 1e-5; the
    # log-variance is clipped to [-30, 20] on both sides
    rng = np.random.default_rng(40)
    params = rng.standard_normal((2, 4, 8, 8)).astype(np.float32) * 3
    params[0, 0, 0, 4:] = (-50.0, 40.0, 0.0, 1.0)
    other = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    sample = rng.standard_normal((2, 4, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (2, 4, 8, 4), jnp.float32))
    pj, oj = jv.DiagonalGaussian(jnp.asarray(params)), jv.DiagonalGaussian(
        jnp.asarray(other))
    pt, ot = tv.DiagonalGaussian(_t(params)), tv.DiagonalGaussian(_t(other))
    _close(pt.sample(noise=_t(noise)), pj.sample(key), 1e-5, "sample")
    _close(pt.mode(), pj.mode(), 0.0, "mode")
    _close(pt.kl(), pj.kl(), 1e-5, "kl")
    _close(pt.kl(ot), pj.kl(oj), 1e-5, "kl(other)")
    _close(pt.nll(_t(sample)), pj.nll(jnp.asarray(sample)), 1e-5, "nll")
    g = torch.Generator().manual_seed(1)
    drawn = pt.sample(generator=g)
    assert drawn.shape == pt.mean.shape and not torch.equal(drawn, pt.mean)


def test_autoencoder_forward_matches_and_has_no_train_mode():
    # fp32 VAE forward with a posterior sample, 1e-4 as the VAE's own
    # encode/decode tests; train() and eval() give the same output
    cfg_kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    jm = jv.AutoencoderKL(jv.VAEConfig(**cfg_kw))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(key, jnp.zeros((1, 16, 16, 3))))
    params = {"params": random_flax_params(shapes["params"], 50)}
    rng = np.random.default_rng(41)
    x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    k2 = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(k2, (2, 8, 8, 4), jnp.float32))
    rec_j, post_mean_j = jax.jit(lambda p, x_: (lambda r, q: (r, q.mean))(
        *jm.apply(p, x_, key=k2, sample_posterior=True)))(
        params, jnp.asarray(x))
    tm = tv.AutoencoderKL(tv.VAEConfig(**cfg_kw))
    tm.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        rec, post = tm.train()(_t(x), noise=_t(noise), sample_posterior=True)
        rec_eval, _ = tm.eval()(_t(x), noise=_t(noise), sample_posterior=True)
        rec_mode, _ = tm(_t(x))
    _close(rec, rec_j, 1e-4, "reconstruction")
    _close(post.mean, post_mean_j, 1e-4, "posterior mean")
    assert torch.equal(rec, rec_eval)
    _close(rec_mode, jax.jit(lambda p, x_: jm.apply(p, x_)[0])(
        params, jnp.asarray(x)), 1e-4, "mode")


@pytest.fixture(scope="module")
def disc_pair():
    jm = jvl.NLayerDiscriminator()
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(42)
    stats = jax.tree_util.tree_map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
        shapes["batch_stats"])
    variables = {"params": random_flax_params(shapes["params"], 51),
                 "batch_stats": stats}
    tm = tvl.NLayerDiscriminator()
    tm.load_state_dict(from_jax_params(variables), strict=True)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    return jm, variables, tm, x


def test_discriminator_eval_matches(disc_pair):
    # running statistics, fp32: 1e-5
    jm, variables, tm, x = disc_pair
    ref = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = tm(_t(x))
    assert out.shape == (3, 2, 2, 1)
    _close(out, ref, 1e-5, "logits")


def test_discriminator_train_matches_with_running_statistics(disc_pair):
    # batch statistics, twice, the statistics of the first call carried
    # into the second (the discriminator step): logits 1e-4 (BatchNorm
    # over 3·2·2 values at the last layer amplifies rounding), running
    # mean and variance 1e-5. flax stores the biased batch variance.
    jm, variables, tm, x = disc_pair
    tm.load_state_dict(from_jax_params(variables), strict=True)
    x2 = np.random.default_rng(43).standard_normal(x.shape).astype(np.float32)
    l1, mut = jm.apply(variables, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    l2, mut = jm.apply({"params": variables["params"],
                        "batch_stats": mut["batch_stats"]}, jnp.asarray(x2),
                       train=True, mutable=["batch_stats"])
    with torch.no_grad():
        o1, o2 = tm(_t(x), train=True), tm(_t(x2), train=True)
    _close(o1, l1, 1e-4, "first call")
    _close(o2, l2, 1e-4, "second call")
    ref = from_jax_params({"params": variables["params"],
                           "batch_stats": mut["batch_stats"]})
    sd = tm.state_dict()
    assert set(sd) == set(ref)
    for k in sd:
        if "running" in k:
            _close(sd[k], ref[k], 1e-5, k)
    # train=False does not touch them
    with torch.no_grad():
        tm(_t(x))
    assert all(torch.equal(tm.state_dict()[k], sd[k]) for k in sd)


def test_discriminator_gradients_match(disc_pair):
    # ∇ of the hinge loss w.r.t. every discriminator parameter through
    # train-mode BatchNorm (the fast variance and its clamp included):
    # 1e-4 of the largest gradient of the leaf (of a thousandth of the
    # largest of all, where a leaf's gradient cancels to zero)
    jm, variables, tm, x = disc_pair
    tm.load_state_dict(from_jax_params(variables), strict=True)
    x2 = np.random.default_rng(44).standard_normal(x.shape).astype(np.float32)

    def loss(p):
        lr_, _ = jm.apply({"params": p, "batch_stats":
                           variables["batch_stats"]}, jnp.asarray(x),
                          train=True, mutable=["batch_stats"])
        lf, _ = jm.apply({"params": p, "batch_stats":
                          variables["batch_stats"]}, jnp.asarray(x2),
                         train=True, mutable=["batch_stats"])
        return jvl.hinge_d_loss(lr_, lf)

    ref = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(variables["params"])))
    tvl.hinge_d_loss(tm(_t(x), train=True), tm(_t(x2), train=True)).backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert set(grads) == set(ref)
    top = max(float(r.abs().max()) for r in ref.values())
    for k, g in grads.items():
        scale = max(float(ref[k].abs().max()), 1e-3 * top)
        assert float((g - ref[k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("kind", ["hinge", "vanilla"])
@pytest.mark.parametrize("step", [0, 5])
def test_generator_and_discriminator_loss_match(kind, step):
    # fp32 means and sums: 1e-5 relative; disc_start 3 gates step 0 off
    rng = np.random.default_rng(45)
    x, rec = (rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
              for _ in range(2))
    params = rng.standard_normal((2, 2, 2, 8)).astype(np.float32)
    lr_, lf = (rng.standard_normal((2, 2, 2, 1)).astype(np.float32)
               for _ in range(2))
    kw = dict(disc_start=3, disc_loss=kind, logvar_init=0.3, kl_weight=1e-3,
              perceptual_weight=0.5)
    jperc_fn = lambda a, b: jnp.mean((a - b) ** 2)
    tperc_fn = lambda a, b: torch.mean((a - b) ** 2)
    ref, rlogs = jvl.generator_loss(
        jnp.asarray(rec), jnp.asarray(x), jv.DiagonalGaussian(
            jnp.asarray(params)), jnp.asarray(lf), jnp.asarray(step),
        jvl.VAELossConfig(**kw), jnp.asarray(0.7), perceptual_fn=jperc_fn)
    out, logs = tvl.generator_loss(
        _t(rec), _t(x), tv.DiagonalGaussian(_t(params)), _t(lf), step,
        tvl.VAELossConfig(**kw), torch.tensor(0.7), perceptual_fn=tperc_fn)
    assert abs(float(out) - float(ref)) <= 1e-5 * abs(float(ref))
    assert set(logs) == set(rlogs)
    for k in logs:
        assert abs(float(logs[k]) - float(rlogs[k])) <= 1e-5 * max(
            abs(float(rlogs[k])), 1e-3), k
    dref = jvl.discriminator_loss(jnp.asarray(lr_), jnp.asarray(lf),
                                  jnp.asarray(step), jvl.VAELossConfig(**kw))
    dout = tvl.discriminator_loss(_t(lr_), _t(lf), step,
                                  tvl.VAELossConfig(**kw))
    assert abs(float(dout) - float(dref)) <= 1e-6
    assert (float(dout) == 0.0) == (step < 3)


def test_gan_and_feature_match_losses_match():
    rng = np.random.default_rng(46)
    a, b = (rng.standard_normal((4, 3, 3, 1)).astype(np.float32) * 2
            for _ in range(2))
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        ref = getattr(jvl, name)(jnp.asarray(a), jnp.asarray(b))
        assert abs(float(getattr(tvl, name)(_t(a), _t(b))) - float(ref)) <= 1e-6
    fr = [rng.standard_normal((2, 8)).astype(np.float32) for _ in range(3)]
    ff = [rng.standard_normal((2, 8)).astype(np.float32) for _ in range(3)]
    ref = jvl.feature_match_loss(list(map(jnp.asarray, fr)),
                                 list(map(jnp.asarray, ff)))
    assert abs(float(tvl.feature_match_loss(list(map(_t, fr)),
                                            list(map(_t, ff))))
               - float(ref)) <= 1e-6


def test_mel_spectrogram_loss_matches():
    # torch.fft against XLA's FFT, two mel configs, the log term included:
    # 1e-4 relative
    rng = np.random.default_rng(47)
    wav = rng.standard_normal((2, 4096)).astype(np.float32)
    hat = (0.5 * wav + 0.1 * rng.standard_normal((2, 4096))).astype(np.float32)
    from diff_foley_tpu.audio.transforms import MelSpec as JMel
    from diff_foley_tpu_torch.audio.transforms import MelSpec as TMel
    kws = [dict(), dict(n_fft=512, hop_length=128, n_mels=64, spec_power=2.0)]
    ref = jvl.mel_spectrogram_loss(jnp.asarray(hat), jnp.asarray(wav),
                                   cfgs=tuple(JMel(**k) for k in kws))
    out = tvl.mel_spectrogram_loss(_t(hat), _t(wav),
                                   cfgs=tuple(TMel(**k) for k in kws))
    assert abs(float(out) - float(ref)) <= 1e-4 * abs(float(ref))
    assert float(tvl.mel_spectrogram_loss(_t(wav), _t(wav))) < 1e-6


@pytest.mark.parametrize("kind", ["lpips", "lpaps"])
def test_perceptual_distance_matches(kind):
    # thirteen fp32 convolutions and five heads with seeded random weights
    # (positive heads, as trained LPIPS has): 1e-4 relative, on the
    # distance per sample and on the trainer hook's scalar
    rng = np.random.default_rng(48)
    if kind == "lpips":
        jm, tm = jperc.LPIPS(), tperc.LPIPS()
        x, y = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
                for _ in range(2))
    else:
        jm, tm = jperc.LPAPS(n_freq=32), tperc.LPAPS(n_freq=32)
        x, y = (rng.uniform(-1, 1, (2, 32, 48)).astype(np.float32)
                for _ in range(2))
    variables = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y)))
    params = random_flax_params(variables["params"], 52)
    for k in range(5):
        params[f"lin{k}"]["kernel"] = np.abs(params[f"lin{k}"]["kernel"])
    n = params["shift"].shape[0]
    params["shift"] = np.linspace(-0.1, 0.1, n, dtype=np.float32)
    params["scale"] = np.linspace(0.9, 1.1, n, dtype=np.float32)
    tm.load_state_dict(from_jax_params({"params": params}), strict=True)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                                       jnp.asarray(y)))
    with torch.no_grad():
        out = tm(_t(x), _t(y))
    assert out.shape == (2,) and (ref > 0).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)
    if kind == "lpips":
        gray = x[..., :1], y[..., :1]
        jfn, tfn = jperc.make_lpips_fn({"params": params}), \
            tperc.make_lpips_fn(tm)
    else:
        gray = x[..., None], y[..., None]
        jfn = jperc.make_lpaps_fn({"params": params}, n_freq=32)
        tfn = tperc.make_lpaps_fn(tm)
    with torch.no_grad():
        hook = float(tfn(*map(_t, gray)))
    assert abs(hook - float(jax.jit(jfn)(*map(jnp.asarray, gray)))) \
        <= 1e-4 * hook


def _write_specs(root, rng, lengths=(300, 700, 650, 900, 40)):
    for i, n in enumerate(lengths):
        np.save(root / f"clip{i}_mel.npy",
                rng.uniform(size=(128, n)).astype(np.float32))


@pytest.mark.parametrize("tile", [True, False])
def test_spec_dataset_gives_the_same_crops(tmp_path, tile):
    # same seed, epoch and index → the same tiled, cropped spec, exactly
    _write_specs(tmp_path, np.random.default_rng(49))
    jd = jds.SpecDataset.from_dir(
        str(tmp_path), jds.LDMDataConfig(tile_channels=tile), seed=5)
    td = tds.SpecDataset.from_dir(
        str(tmp_path), tds.LDMDataConfig(tile_channels=tile), seed=5)
    assert len(td) == len(jd) == 5 and td.spec_paths == jd.spec_paths
    for epoch in (0, 3):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        for i in range(len(td)):
            a, b = td[i]["spec"], jd[i]["spec"]
            assert a.dtype == np.float32
            assert a.shape == ((128, 512, 3) if tile else (128, 512))
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(td[1]["spec"], tds.SpecDataset.from_dir(
        str(tmp_path), seed=6)[1]["spec"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tds.SpecDataset.from_dir(str(tmp_path / "empty"))


def test_spec_dataset_split_file_layout(tmp_path):
    rng = np.random.default_rng(53)
    d = tmp_path / "Train" / "audio_npy_spec"
    d.mkdir(parents=True)
    for i in ("a", "b"):
        np.save(d / f"{i}_mel.npy", rng.uniform(size=(128, 640)).astype(
            np.float32))
    (tmp_path / "Train.txt").write_text("a\nb\n\n")
    td = tds.SpecDataset.from_split_file(str(tmp_path), "train")
    jd = jds.SpecDataset.from_split_file(str(tmp_path), "train")
    assert td.spec_paths == jd.spec_paths
    np.testing.assert_array_equal(td[1]["spec"], jd[1]["spec"])


def test_loader_gives_the_same_batches(tmp_path):
    # the same shuffle, sharding and order of batches as the JAX loader
    _write_specs(tmp_path, np.random.default_rng(54))
    for pc, pi in ((1, 0), (2, 1)):
        np.testing.assert_array_equal(
            tloader.shard_indices(11, 2, process_index=pi, process_count=pc,
                                  seed=3, epoch=2),
            jloader.shard_indices(11, 2, process_index=pi, process_count=pc,
                                  seed=3, epoch=2))
    td = tds.SpecDataset.from_dir(str(tmp_path), seed=1)
    jd = jds.SpecDataset.from_dir(str(tmp_path), seed=1)
    tl = tloader.PrefetchLoader(td, 2, num_workers=2, seed=9)
    jl = jloader.PrefetchLoader(jd, 2, num_workers=2, seed=9)
    assert len(tl) == len(jl) == 2
    for epoch in (0, 1):
        tb, jb = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(tb) == len(jb) == 2
        for a, b in zip(tb, jb):
            assert a["spec"].shape == (2, 128, 512, 3)
            np.testing.assert_array_equal(a["spec"], b["spec"])


def test_loader_surfaces_a_failing_item(tmp_path):
    _write_specs(tmp_path, np.random.default_rng(55), lengths=(600, 600))
    td = tds.SpecDataset.from_dir(str(tmp_path))
    td.spec_paths[1] = str(tmp_path / "missing.npy")
    with pytest.raises(RuntimeError, match="dataset worker failed"):
        list(tloader.PrefetchLoader(td, 2, num_workers=1).epoch(0))


def test_converter_carries_batch_stats_and_the_scaling_layer():
    tree = {"params": {"bn1": {"scale": np.ones(3, np.float32),
                               "bias": np.zeros(3, np.float32)},
                       "shift": np.zeros(3, np.float32),
                       "scale": np.ones(3, np.float32)},
            "batch_stats": {"bn1": {"mean": np.zeros(3, np.float32),
                                    "var": np.ones(3, np.float32)}}}
    assert set(from_jax_params(tree)) == {
        "bn1.weight", "bn1.bias", "bn1.running_mean", "bn1.running_var",
        "shift", "scale"}
    assert set(from_jax_params({"params": tree["params"]})) == {
        "bn1.weight", "bn1.bias", "shift", "scale"}
