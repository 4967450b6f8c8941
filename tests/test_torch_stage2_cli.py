"""The port's stage-2 trainer CLI on the CPU: ``cli.train_stage2 --tiny``
trains with validation, resumes, writes a logdir that
``load_native_ldm`` rebuilds into a model that generates, writes the
SoundLogger's listening samples, builds its model from a reference-format
YAML (``--base``), saves at the step boundary after a preemption signal,
refuses a batch its data cannot fill, and defaults to the card.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

from diff_foley_tpu_torch.cli import train_stage2 as cli
from diff_foley_tpu_torch.cli import train_vae
from diff_foley_tpu_torch.models.vae import SD_VAE
from diff_foley_tpu_torch.pipeline import (WINDOW_FEATS, DiffFoleyPipeline,
                                           GenerationConfig)
from diff_foley_tpu_torch.utils import checkpoint as ck

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)


def write_pairs(root, n=4, frames=40, feats=3, seed=0):
    """Seeded spec and CAVP feature files in the reference layout."""
    rng = np.random.default_rng(seed)
    for split in ("Train", "Test"):
        (root / split / "audio_npy_spec").mkdir(parents=True)
        (root / "CAVP_feat" / split).mkdir(parents=True)
        ids = [f"{split.lower()}{i}" for i in range(n)]
        (root / f"{split}.txt").write_text("\n".join(ids) + "\n")
        for i in ids:
            np.save(root / split / "audio_npy_spec" / f"{i}_mel.npy",
                    rng.uniform(size=(128, frames)).astype(np.float32))
            np.savez(root / "CAVP_feat" / split / f"{i}.npz",
                     feat=rng.standard_normal((feats, 512)).astype(
                         np.float32))


@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    """Three tiny steps with validation at step 3, then a resume to 4."""
    root = tmp_path_factory.mktemp("stage2")
    write_pairs(root / "data")
    args = ["--data-dir", str(root / "data"), "--logdir", str(root / "log"),
            "--tiny", "--device", "cpu", "--batch-size", "2",
            "--warmup-steps", "0", "--log-every", "1", "--val-every", "3",
            "--val-batches", "2", "--use-ema", "--data-duration", "1.0",
            "--data-truncate", "8192"]
    first = cli.main(args + ["--max-steps", "3"])
    saved = torch.load(root / "log" / "ckpt" / "step_3.pt")
    resumed = cli.main(args + ["--max-steps", "4", "--resume"])
    return dict(root=root, args=args, first=first, saved=saved,
                resumed=resumed)


def test_cli_trains_validates_and_resumes(logdir):
    root, first, resumed = logdir["root"], logdir["first"], logdir["resumed"]
    assert first.step == 3 and first.opt.count == 3
    assert first.ema.num_updates == 3
    saved = logdir["saved"]["state"]
    assert saved["step"] == 3 and saved["opt"]["count"] == 3
    assert saved["ema"]["num_updates"] == 3
    # the resume continued the optimizer, the EMA and the generator
    assert resumed.step == 4 and resumed.opt.count == 4
    assert resumed.ema.num_updates == 4
    rows = [json.loads(line) for line in
            (root / "log" / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in rows if "train/loss" in r]
    val = [r for r in rows if "val/loss_simple_ema" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert [r["step"] for r in val] == [3]
    for r in rows:
        assert np.isfinite([v for v in r.values()]).all(), r
    assert set(train[0]) >= {"train/loss", "train/loss_simple",
                             "train/loss_vlb", "train/t_mean",
                             "train/grad_norm", "step_s"}
    assert ck.latest_checkpoint(str(root / "log" / "ckpt"))[0] == 4
    assert sorted(os.listdir(root / "log" / "vae")) == ["step_0.pt"]
    config = json.loads((root / "log" / "config.json").read_text())
    assert config["kind"] == "stage2_ldm" and config["train"]["use_ema"]
    gen = torch.Generator().manual_seed(2)
    gen.set_state(logdir["saved"]["generators"]["train"])
    assert not torch.equal(gen.get_state(),
                           torch.Generator().manual_seed(2).get_state())


def test_load_native_ldm_prefers_ema_and_generates(logdir):
    log = str(logdir["root"] / "log")
    assert ck.is_port_logdir(log) and not ck.is_native_logdir(log)
    state = torch.load(os.path.join(log, "ckpt", "step_4.pt"))["state"]
    ema = ck.load_native_ldm(log)
    raw = ck.load_native_ldm(log, prefer_ema=False)
    key = "unet.in_conv.weight"
    assert torch.equal(ema.state_dict()[key], state["ema"]["params"][key])
    assert torch.equal(raw.state_dict()[key], state["params"][key])
    assert not torch.equal(ema.state_dict()[key], raw.state_dict()[key])
    vae = torch.load(os.path.join(log, "vae", "step_0.pt"))["vae"]
    assert all(torch.equal(ema.vae.state_dict()[k], v) for k, v in vae.items())
    assert ema.cfg.unet.model_channels == 32
    feats = np.random.default_rng(3).standard_normal(
        (WINDOW_FEATS, 512)).astype(np.float32)
    pipe = DiffFoleyPipeline(ema, device="cpu")
    out = pipe.generate(feats, seed=0, gen=GenerationConfig(
        steps=2, sample_num=1, gl_iters=2, classifier_scale=0.0))
    assert out["spec"].shape == (1, 128, 512)
    assert np.isfinite(out["spec"]).all() and np.isfinite(out["wav"]).all()


def test_load_native_vae_reads_a_train_vae_logdir(tmp_path):
    rng = np.random.default_rng(4)
    specs = tmp_path / "specs"
    specs.mkdir()
    for i in range(2):
        np.save(specs / f"c{i}.npy", rng.uniform(size=(128, 40)).astype(
            np.float32))
    state = train_vae.main([
        "--spec-dir", str(specs), "--logdir", str(tmp_path / "vae"),
        "--tiny", "--device", "cpu", "--batch-size", "2", "--max-steps", "1",
        "--disc-start", "10", "--data-duration", "1.0",
        "--data-truncate", "8192"])
    vae = ck.load_native_vae(str(tmp_path / "vae"))
    for k, v in state.vae.state_dict().items():
        assert torch.equal(vae.state_dict()[k], v), k
    with pytest.raises(ValueError, match="expected"):
        ck.load_native_vae(str(tmp_path / "vae"), expect_cfg=SD_VAE)


def test_cli_fsdp_runs(logdir):
    # --fsdp trains (it used to exit): in a process alone its mesh has one
    # rank, FSDP splits nothing and the run is the unsplit run's, metric
    # for metric and tensor for tensor (two gloo ranks against one:
    # tests/test_torch_parallel_entries.py)
    root = logdir["root"]
    args = [a for a in logdir["args"]]
    args[args.index(str(root / "log"))] = str(root / "fsdp")
    state = cli.main(args + ["--max-steps", "3", "--fsdp"])
    rows = lambda d: [json.loads(line) for line in (root / d / "metrics.jsonl")
                      .read_text().splitlines()]
    # the wall-clock columns differ from run to run
    drop = lambda r: {k: v for k, v in r.items()
                      if k not in ("step_s", "time")}
    assert [drop(r) for r in rows("fsdp")] == [drop(r) for r in
                                               rows("log")[:4]]
    saved = logdir["saved"]["state"]
    for k, v in state.params.items():
        assert torch.equal(v.detach(), saved["params"][k]), k
    assert ck.load_native_ldm(str(root / "fsdp")).cfg.unet.model_channels \
        == 32


@pytest.mark.parametrize("extra,message", [
    (["--batch-size", "64"], "4 items < global batch 64"),
])
def test_cli_refusals(logdir, extra, message):
    args = [a for a in logdir["args"]]
    args[args.index(str(logdir["root"] / "log"))] = str(
        logdir["root"] / "refused")
    with pytest.raises(SystemExit, match=message):
        cli.main(args + ["--max-steps", "1"] + extra)


def _args_into(logdir, name):
    args = [a for a in logdir["args"]]
    args[args.index(str(logdir["root"] / "log"))] = str(logdir["root"] / name)
    return args, logdir["root"] / name


def test_cli_sound_log_every_writes_the_step_folders(logdir):
    args, out = _args_into(logdir, "sound")
    cli.main(args + ["--max-steps", "2", "--sound-log-every", "2"])
    assert sorted(os.listdir(out / "sound")) == ["step_00000002"]
    step = out / "sound" / "step_00000002"
    names = {f"{k}_{i}.wav" for k in ("gt", "rec", "sample") for i in (0, 1)}
    names |= {f"{k}_spec.npy" for k in ("gt", "rec", "sample")}
    assert set(os.listdir(step)) == names
    for k in ("gt", "rec", "sample"):
        mel = np.load(step / f"{k}_spec.npy")
        assert mel.shape[:2] == (2, 128) and np.isfinite(mel).all()
        assert mel.min() >= 0.0 and mel.max() <= 1.0
    # the sample decodes the (16, 64) latent: 512 frames, 130816 samples
    assert np.load(step / "sample_spec.npy").shape == (2, 128, 512)
    assert (step / "sample_0.wav").stat().st_size == 44 + 2 * 511 * 256


def test_cli_sound_log_under_mixed_precision_runs_the_vae_in_fp32(
        logdir, monkeypatch):
    # the trainer holds the frozen VAE in bf16; the logger swaps in the
    # VAE's fp32 weights from before that cast, as the JAX logger
    # decodes with fp32 vae_params
    from diff_foley_tpu_torch.train import callbacks

    seen, log = [], callbacks.SoundLogger.log

    def spy(self, *a, **k):
        seen.append((next(self.ldm.vae.parameters()).dtype,
                     {v.dtype for v in self.vae_params.values()}))
        return log(self, *a, **k)

    monkeypatch.setattr(callbacks.SoundLogger, "log", spy)
    args, out = _args_into(logdir, "sound_bf16")
    cli.main(args + ["--max-steps", "1", "--sound-log-every", "1",
                     "--mixed-precision"])
    assert seen == [(torch.bfloat16, {torch.float32})]
    for k in ("gt", "rec", "sample"):
        mel = np.load(out / "sound" / "step_00000001" / f"{k}_spec.npy")
        assert mel.dtype == np.float32 and np.isfinite(mel).all()


TINY_YAML = """
model:
  target: diff_foley.models.diffusion.ddpm.LatentDiffusion
  params:
    linear_start: 0.001
    linear_end: 0.015
    timesteps: 500
    unet_config:
      target: adm.modules.diffusionmodules.openai_unetmodel.UNetModel
      params: {model_channels: 16, num_res_blocks: 1, channel_mult: [1, 2],
               attention_resolutions: [2], num_heads: 2, context_dim: 20}
    first_stage_config:
      target: diff_foley.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        ddconfig: {ch: 32, ch_mult: [1, 2, 4, 4], num_res_blocks: 1,
                   z_channels: 4, double_z: true, in_channels: 3, out_ch: 3,
                   dropout: 0.0}
    cond_stage_config:
      target: diff_foley.modules.cond_stage.video_feat_encoder.Video_Feat_Encoder_Posembed
      params: {origin_dim: 512, embed_dim: 20, seq_len: 8}
"""


def test_cli_base_trains_the_yaml_model(logdir, tmp_path):
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    args, out = _args_into(logdir, "base")
    args = [a for a in args if a != "--tiny"]
    state = cli.main(args + ["--max-steps", "1", "--base",
                             str(tmp_path / "tiny.yaml")])
    assert state.step == 1
    model = json.loads((out / "config.json").read_text())["model"]
    assert model["unet"]["model_channels"] == 16
    assert model["unet"]["num_heads"] == 2 and model["cond_seq_len"] == 8
    assert model["timesteps"] == 500 and model["linear_end"] == 0.015
    assert model["vae"]["ch"] == 32
    assert ck.load_native_ldm(str(out)).cfg.cond_embed_dim == 20


def test_cli_saves_at_the_step_after_a_preemption_signal(logdir,
                                                         monkeypatch):
    from diff_foley_tpu_torch.train.stage2_ldm import Stage2Trainer

    step = Stage2Trainer.train_step

    def signalled(self, state, *a, **k):
        if state.step == 1:   # the signal arrives during step 2
            os.kill(os.getpid(), signal.SIGUSR1)
        return step(self, state, *a, **k)

    monkeypatch.setattr(Stage2Trainer, "train_step", signalled)
    args, out = _args_into(logdir, "preempt")
    cli.main(args + ["--max-steps", "4", "--save-every", "1000"])
    assert sorted(os.listdir(out / "ckpt")) == ["step_2.pt", "step_4.pt"]
    saved = torch.load(out / "ckpt" / "step_2.pt")["state"]
    assert saved["step"] == 2 and saved["opt"]["count"] == 2
    # the CLI gives the handlers back
    assert signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL


def test_cli_defaults_to_the_card(logdir):
    # as the other entry points: no device named means CUDA, and without a
    # card that raises instead of training on the CPU unnoticed
    args = ["--data-dir", str(logdir["root"] / "data"), "--tiny"]
    assert cli.parse_args(args).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)
