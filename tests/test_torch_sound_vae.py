"""The port's waveform VAE and its GAN trainer against the JAX package's,
on the CPU: the STFT with ``win_length < n_fft`` and ``normalized``, the
sound VAE forward, the reference ``Sound_AutoencoderKL`` layout through
``convert_sound_vae``, the two GAN losses, ``STFTDiscriminator``, one
``SoundVAETrainer`` step's gradients per leaf before Adam, and
``cli.train_sound_vae`` with its resume and ``load_native_sound_vae``.

The JAX step is jitted once in a module fixture (two JAX steps share the
state and the batch). Its gradients are read from optax's first moment
after one step from zero: m = (1 − β₁)·g with β₁ 0.5, so g = 2m.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import sound_vae as jsv
from diff_foley_tpu.ops.stft import stft as jax_stft
from diff_foley_tpu.train import sound_gan as jsg
from diff_foley_tpu_torch.cli import train_sound_vae as cli
from diff_foley_tpu_torch.models import sound_vae as tsv
from diff_foley_tpu_torch.ops import stft as tstft
from diff_foley_tpu_torch.train import sound_gan as tsg
from diff_foley_tpu_torch.utils import checkpoint as ck
from diff_foley_tpu_torch.utils.convert import (convert_sound_vae,
                                                from_jax_params)
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

# the JAX package's own tiny GAN point (tests/test_sound_gan.py)
TINY = dict(mel_windows=(5, 7), stft_windows=(7, 8), n_fft=256,
            disc_start=0, lr=1e-3)
VAE = dict(channels=4, z_channels=8, enc_out_channels=16)
STEP_L = 8192   # the shortest crop whose STFT maps outlast the discriminator


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_err(got: torch.Tensor, ref) -> float:
    """max|Δ| over max|ref| (1 where ref is all zero)."""
    ref = torch.as_tensor(np.asarray(ref))
    scale = float(ref.abs().max()) or 1.0
    return float((got.detach() - ref).abs().max()) / scale


@pytest.mark.parametrize("n_fft,win,hop,normalized", [
    (256, 32, 8, True), (256, 128, 32, False), (256, 256, 64, True),
    (2048, 512, 128, True), (1024, None, 256, False)])
def test_stft_window_and_normalized_match_jax(n_fft, win, hop, normalized):
    x = np.random.default_rng(0).standard_normal((2, 4096)).astype(
        np.float32)
    ref = np.asarray(jax_stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop,
                               win_length=win, normalized=normalized,
                               rdft="fft"))
    got = tstft.stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop,
                     win_length=win, normalized=normalized)
    assert got.shape == ref.shape
    # fp32 FFTs of two libraries: 2e-6 of the spectrum's peak
    assert rel_err(torch.view_as_real(got), np.stack(
        [ref.real, ref.imag], -1)) < 2e-6


def test_stft_default_is_unchanged():
    # the mel pipeline's and Griffin-Lim's calls: bit for bit the window
    # they had before win_length and normalized existed
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8192)).astype(np.float32))
    old = torch.fft.rfft(torch.nn.functional.pad(
        x[:, None], (512, 512), mode="reflect")[:, 0].unfold(-1, 1024, 256)
        * tstft.hann_window(1024), n=1024, dim=-1).transpose(-1, -2)
    assert torch.equal(tstft.stft(x), old)
    assert torch.equal(tstft.stft(x, win_length=1024), old)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX trainer and a state of seeded random parameters in the
    shapes its init gives (``eval_shape``: compiling flax's init of the
    LSTM scans costs seconds more than the step itself)."""
    jtrainer = jsg.SoundVAETrainer(jsg.AudioGANConfig(**TINY),
                                   jsv.SoundVAEConfig(**VAE))
    shapes = jax.eval_shape(lambda k: jtrainer.init_train_state(
        k, n_samples=STEP_L), jax.random.PRNGKey(0))
    params = {"params": random_flax_params(shapes.params["params"], seed=0)}
    discs = tuple(random_flax_params(p, seed=1 + i)
                  for i, p in enumerate(shapes.disc_params))
    jstate = jsg.SoundGANState(
        step=jnp.asarray(0, jnp.int32), params=params, disc_params=discs,
        opt_state=jtrainer.tx.init(params),
        disc_opt_state=jtrainer.disc_tx.init(discs))
    return jtrainer, jstate


def test_sound_vae_forward_matches_jax(jax_init):
    model, variables = jax_init[0].vae, jax_init[1].params
    rng = np.random.default_rng(2)
    x = (0.3 * rng.standard_normal((2, 1024, 1))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    def apply(v, a, k):
        rec, post = model.apply(v, a, k)
        return rec, post.mean, post.logvar

    rec, mean, logvar = jax.jit(apply)(variables, jnp.asarray(x), key)
    eps = jax.random.normal(key, mean.shape, mean.dtype)
    port = tsv.SoundAutoencoderKL(tsv.SoundVAEConfig(**VAE))
    port.load_state_dict(from_jax_params(tree_np(variables)), strict=True)
    with torch.no_grad():
        got, p = port(torch.from_numpy(x),
                      noise=torch.from_numpy(np.asarray(eps)))
    assert got.shape == (2, 1024, 1) and p.mean.shape == (2, 32, 8)
    # fp32 convolutions and LSTMs of two libraries: 1e-5 of the peak
    assert rel_err(got, rec) < 1e-5
    assert rel_err(p.mean, mean) < 1e-5
    assert rel_err(p.logvar, logvar) < 1e-5
    # the ELU on the Gaussian parameters, and its absence under remove_act
    assert float(p.logvar.min()) >= -1.0
    bare = tsv.SoundAutoencoderKL(tsv.SoundVAEConfig(**VAE, remove_act=True))
    bare.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        h = bare.encoder(torch.from_numpy(x))
        assert float(h.min()) < 0.0   # where the ELU changes the value
        assert torch.equal(torch.nn.functional.elu(h),
                           port.encoder(torch.from_numpy(x)))


def reference_state_dict(port: tsv.SoundAutoencoderKL, seed: int) -> dict:
    """The reference Sound_AutoencoderKL's keys for ``port``'s weights,
    with a random ``bias_hh`` on every LSTM layer (the reference trains
    both biases) taken off its ``bias_ih``: the same function."""
    sd = port.state_dict()
    g = torch.Generator().manual_seed(seed)
    ref = {}

    def conv(mine, theirs):
        for leaf in ("weight", "bias"):
            ref[f"{theirs}.{leaf}"] = sd[f"{mine}.{leaf}"]

    def lstm(mine, theirs, layers=2):
        for n in range(layers):
            cell = f"{mine}.OptimizedLSTMCell_{n}"
            for leaf in ("weight_ih", "weight_hh"):
                ref[f"{theirs}.{leaf}_l{n}"] = sd[f"{cell}.{leaf}_l0"]
            hh = torch.randn(sd[f"{cell}.bias_ih_l0"].shape, generator=g)
            ref[f"{theirs}.bias_hh_l{n}"] = hh
            ref[f"{theirs}.bias_ih_l{n}"] = sd[f"{cell}.bias_ih_l0"] - hh

    conv("encoder.stem", "encoder.layers.0")
    for i in range(4):
        blk = f"encoder.layers.{2 + 2 * i}.layers"
        conv(f"encoder.block{i}_res.conv1", f"{blk}.0.layers.0")
        conv(f"encoder.block{i}_res.conv2", f"{blk}.0.layers.2")
        conv(f"encoder.block{i}_down", f"{blk}.2.layers.0")
    lstm("encoder.lstm", "encoder.lstm.0")
    conv("encoder.last_conv", "encoder.last_conv.1")
    conv("decoder.stem", "decoder.layers1.0")
    lstm("decoder.lstm", "decoder.lstm.0")
    for j in range(4):
        blk = f"decoder.layers2.{1 + 2 * j}.layers"
        conv(f"decoder.block{j}_res.conv1", f"{blk}.0.layers.0")
        conv(f"decoder.block{j}_res.conv2", f"{blk}.0.layers.2")
        conv(f"decoder.block{j}_up", f"{blk}.2.layers.0")
    conv("decoder.last_conv", "decoder.last_conv.0")
    return ref


def test_reference_layout_loads_through_convert_sound_vae():
    from diff_foley_tpu.utils.convert import \
        convert_sound_vae as jax_convert

    # full width: channels 32, z 128, LSTMs of 512
    port = tsv.SoundAutoencoderKL()
    tsg.init_weights_(port, torch.Generator().manual_seed(3))
    ref = reference_state_dict(port, 4)
    tree = convert_sound_vae(ref)
    jtree = jax_convert(ref)
    flat = lambda t: {"/".join(str(k.key) for k in path): np.asarray(v)
                      for path, v in jax.tree_util.tree_flatten_with_path(
                          t)[0]}
    mine, theirs = flat(tree), flat(jtree)
    assert mine.keys() == theirs.keys()
    for k in mine:   # the port's numpy walk is the JAX walk's, exactly
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    loaded = tsv.SoundAutoencoderKL()
    loaded.load_state_dict(from_jax_params(tree), strict=True)
    x = torch.from_numpy((0.3 * np.random.default_rng(5).standard_normal(
        (1, 256, 1))).astype(np.float32))
    with torch.no_grad():
        a = port(x, sample_posterior=False)[0]
        b = loaded(x, sample_posterior=False)[0]
        jmodel = jsv.SoundAutoencoderKL(jsv.SoundVAEConfig())
        c = jax.jit(lambda v, a: jmodel.apply(
            v, a, sample_posterior=False)[0])(jtree, jnp.asarray(x.numpy()))
    assert rel_err(b, a.numpy()) < 1e-5 and rel_err(b, c) < 1e-5
    ref["encoder.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="no place"):
        convert_sound_vae(ref)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((2, 4096)).astype(np.float32) * 0.2
    b = a + 0.05 * rng.standard_normal((2, 4096)).astype(np.float32)
    jcfg, tcfg = jsg.AudioGANConfig(**TINY), tsg.AudioGANConfig(**TINY)
    ref = float(jsg.multi_window_mel_loss(jnp.asarray(a), jnp.asarray(b),
                                          jcfg))
    got = float(tsg.multi_window_mel_loss(torch.from_numpy(a),
                                          torch.from_numpy(b), tcfg))
    assert abs(got - ref) <= 1e-5 * abs(ref)
    assert float(tsg.multi_window_mel_loss(torch.from_numpy(a),
                                           torch.from_numpy(a), tcfg)) < 1e-5
    jf = jsg.stft_feature_list(jnp.asarray(a), jcfg)
    tf = tsg.stft_feature_list(torch.from_numpy(a), tcfg)
    assert len(tf) == len(jf) == 2
    for t, j in zip(tf, jf):   # (B, 2, F, T) against JAX's (B, F, T, 2)
        assert rel_err(t, np.moveaxis(np.asarray(j), -1, 1)) < 2e-6


def test_stft_discriminator_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 129, 129, 2)).astype(np.float32)
    disc = jsg.STFTDiscriminator()
    params = jax.jit(disc.init)(jax.random.PRNGKey(8), jnp.asarray(x))
    ref = jax.jit(disc.apply)(params, jnp.asarray(x))
    port = tsg.STFTDiscriminator()
    port.load_state_dict(from_jax_params(tree_np(params)), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    assert len(got) == len(ref) == 5
    for t, j in zip(got, ref):
        assert rel_err(t, np.moveaxis(np.asarray(j), -1, 1)) < 1e-5


@pytest.fixture(scope="module")
def one_step(jax_init):
    """One JAX step (jitted once) and the port's from its initial state,
    on one batch with the JAX posterior noise."""
    jtrainer, jstate = jax_init
    wav = (0.1 * np.random.default_rng(9).standard_normal(
        (2, STEP_L, 1))).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    jafter, jlogs = jax.jit(jtrainer.make_train_step())(
        jstate, jnp.asarray(wav), rng)
    eps = jax.random.normal(jax.random.fold_in(rng, 0),
                            (2, STEP_L // 32, VAE["z_channels"]))

    trainer = tsg.SoundVAETrainer(tsg.AudioGANConfig(**TINY),
                                  tsv.SoundVAEConfig(**VAE))
    state = trainer.init_train_state(0, "cpu")
    before = tree_np(jstate)
    state.vae.load_state_dict(from_jax_params(before.params), strict=True)
    for d, p in zip(state.disc, before.disc_params):
        d.load_state_dict(from_jax_params(p), strict=True)
    logs = trainer.train_step(state, torch.from_numpy(wav),
                              noise=torch.from_numpy(np.asarray(eps)))
    after = tree_np(jafter)
    return dict(state=state, logs=logs, jlogs=tree_np(jlogs),
                grads=from_jax_params(jax.tree_util.tree_map(
                    lambda m: 2 * m, after.opt_state[0].mu)),
                disc_grads=[from_jax_params(jax.tree_util.tree_map(
                    lambda m: 2 * m, p)) for p in after.disc_opt_state[0].mu],
                after=after)


def test_trainer_step_matches_jax(one_step):
    logs, jlogs = one_step["logs"], one_step["jlogs"]
    assert set(logs) == set(jlogs)
    for k in logs:   # fp32 losses: 1e-5 relative
        assert abs(float(logs[k]) - float(jlogs[k])) <= \
            1e-5 * abs(float(jlogs[k])) + 1e-7, k
    assert one_step["state"].step == 1 and float(logs["d_loss"]) > 0


def test_trainer_step_gradients_match_jax(one_step):
    state = one_step["state"]
    # per leaf, before Adam: max|Δ| within 1e-4 of the leaf's largest
    # gradient (float32 through STFTs, an LSTM scan and the convolutions)
    checked = 0
    for name, p in state.vae.named_parameters():
        ref = one_step["grads"][name]
        if not p.requires_grad:   # the LSTM's zero bias_hh
            assert name.endswith("bias_hh_l0") and p.grad is None
            assert not ref.any()
            continue
        assert rel_err(p.grad, ref) < 1e-4, name
        checked += 1
    assert checked == len(one_step["grads"]) - 4
    # the discriminators' biases sum over whole STFT maps (up to 129 × 257
    # positions a row): against a float64 step, the JAX fp32 gradient is
    # 1.8e-4 of the leaf's max off at disc0.conv_out.bias and the port's
    # (torch's CPU convolution backward, one thread) 3.2e-4 at
    # disc0.conv0.bias; 1e-3 of the leaf's max
    for d, ref in zip(state.disc, one_step["disc_grads"]):
        for name, p in d.named_parameters():
            assert rel_err(p.grad, ref[name]) < 1e-3, name


def write_wavs(root, n=2, samples=70000, seed=0):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    root.mkdir()
    for i in range(n):
        wavfile.write(str(root / f"a{i}.wav"), 16000,
                      (rng.normal(size=samples) * 3000).astype(np.int16))


def test_cli_trains_resumes_and_loads(tmp_path):
    import json

    write_wavs(tmp_path / "wavs")
    # the shortest crop that the default STFT losses take: 73 frames at
    # hop 512 outlast the discriminator's convolutions
    args = ["--wav-dir", str(tmp_path / "wavs"), "--window", "36864",
            "--batch-size", "1", "--disc-start", "0", "--channels", "4",
            "--z-channels", "8", "--logdir", str(tmp_path / "log"),
            "--log-every", "1", "--save-every", "2", "--device", "cpu"]
    first = cli.main(args + ["--steps", "1"])
    resumed = cli.main(args + ["--steps", "2", "--resume"])
    assert first.step == 1 and resumed.step == 2
    assert resumed.opt.state_dict()["state"][0]["step"] == 2
    rows = [json.loads(line) for line in
            (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert np.isfinite([v for v in r.values()]).all(), r
        assert {"train/total_loss", "train/d_loss", "step_s",
                "time"} <= set(r)
    meta = json.loads((tmp_path / "log" / "config.json").read_text())
    assert meta["kind"] == "sound_vae" and meta["window"] == 36864
    vae = ck.load_native_sound_vae(str(tmp_path / "log"))
    for k, v in resumed.vae.state_dict().items():
        assert torch.equal(vae.state_dict()[k], v), k
    with torch.no_grad():
        rec, _ = vae(torch.zeros(1, 1024, 1), sample_posterior=False)
    assert rec.shape == (1, 1024, 1) and torch.isfinite(rec).all()


def test_cli_defaults_to_the_card(tmp_path):
    write_wavs(tmp_path / "wavs", n=1, samples=100)
    args = ["--wav-dir", str(tmp_path / "wavs")]
    assert cli.parse_args(args).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args + ["--logdir", str(tmp_path / "log")])
