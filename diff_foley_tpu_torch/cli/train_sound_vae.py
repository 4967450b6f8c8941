"""1-D waveform VAE-GAN training entry point
(``diff_foley_tpu/cli/train_sound_vae.py``): ``SoundAutoencoderKL`` with
the multi-scale STFT discriminators on random crops of 16-kHz wav files.

Usage:
  python -m diff_foley_tpu_torch.cli.train_sound_vae --wav-dir /data/wavs \\
      --window 65536 --batch-size 8 --steps 100000 --logdir ./logs/sound_vae

It runs on the first CUDA device unless ``--device cpu``. Under torchrun
(or SLURM) each process trains on ``cuda:LOCAL_RANK`` on its rows of the
global batch (``--batch-size`` per process, the crops drawn as one
process draws batch × processes of them), and rank 0 alone writes the
logdir: ``config.json`` (kind ``sound_vae``), ``ckpt/step_<n>.pt`` (both
models, both optimizers, the step and the noise generator's state) and
``metrics.jsonl``. ``--resume`` continues from the newest checkpoint;
``utils.checkpoint.load_native_sound_vae`` rebuilds the trained model.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--window", type=int, default=65536,
                   help="training crop (samples at 16 kHz)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--disc-start", type=int, default=50001)
    p.add_argument("--channels", type=int, default=32,
                   help="encoder base channels (model width)")
    p.add_argument("--z-channels", type=int, default=128)
    p.add_argument("--logdir", default="./logs/sound_vae")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--save-every", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; fails without a GPU) or 'cpu'")
    return p.parse_args(argv)


def iter_wav_batches(paths, window: int, batch_size: int, seed: int):
    """Seeded random crops of random files, (batch, window, 1) float32 in
    [-1, 1]: integer PCM scaled by its type's full range, stereo averaged,
    short files zero-padded."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    while True:
        batch = []
        while len(batch) < batch_size:
            path = paths[rng.integers(len(paths))]
            try:
                _, wav = wavfile.read(path)
            except Exception:
                continue
            src_dtype = wav.dtype
            if wav.ndim > 1:
                wav = wav.mean(axis=1)
            if np.issubdtype(src_dtype, np.integer):
                wav = wav.astype(np.float32) / (
                    float(np.iinfo(src_dtype).max) + 1.0)
            else:
                wav = wav.astype(np.float32)
            if len(wav) < window:
                wav = np.pad(wav, (0, window - len(wav)))
            start = rng.integers(max(len(wav) - window, 0) + 1)
            batch.append(wav[start:start + window, None])
        yield np.stack(batch)


def main(argv=None):
    args = parse_args(argv)
    from ..config import save_run_config
    from ..models.sound_vae import SoundVAEConfig
    from ..parallel.distributed import setup
    from ..train.sound_gan import AudioGANConfig, SoundVAETrainer
    from ..utils.checkpoint import latest_checkpoint, save_checkpoint
    from ..utils.logging import MetricsLogger, Stopwatch

    paths = sorted(glob.glob(os.path.join(args.wav_dir, "**", "*.wav"),
                             recursive=True))
    if not paths:
        raise SystemExit(f"no wavs under {args.wav_dir}")
    device, mesh, rank, world = setup(args.device)
    trainer = SoundVAETrainer(
        AudioGANConfig(lr=args.lr, disc_start=args.disc_start),
        SoundVAEConfig(channels=args.channels, z_channels=args.z_channels,
                       enc_out_channels=2 * args.z_channels), mesh=mesh)
    if rank == 0:
        save_run_config(args.logdir, "sound_vae", model=trainer.vae_cfg,
                        train=trainer.cfg, window=args.window)
    state = trainer.init_train_state(args.seed, device)
    noise_gen = torch.Generator(device).manual_seed(args.seed + 1)
    ckpt_dir = os.path.join(args.logdir, "ckpt")
    newest = latest_checkpoint(ckpt_dir) if args.resume else None
    if newest is not None:
        sd = torch.load(newest[1], map_location=device)
        state.load_state_dict(sd)
        noise_gen.set_state(sd["noise_gen"].cpu())
        print(f"resumed from step {state.step}")
    n_params = sum(p.numel() for p in state.vae.parameters())
    print(f"{len(paths)} wav files; SoundAutoencoderKL {n_params} "
          f"parameters on {device}, rank {rank} of {world}")

    def save():
        if rank == 0:
            save_checkpoint(ckpt_dir, state.step, {
                **state.state_dict(), "noise_gen": noise_gen.get_state()})

    logger = MetricsLogger(args.logdir if rank == 0 else None,
                           name="metrics", use_tensorboard=True)
    stream = iter_wav_batches(paths, args.window, args.batch_size * world,
                              args.seed)
    rows = slice(rank * args.batch_size, (rank + 1) * args.batch_size)
    watch, n_log = Stopwatch(), state.step
    while state.step < args.steps:
        wav = torch.from_numpy(next(stream)[rows]).to(device)
        metrics = trainer.train_step(state, wav, generator=noise_gen)
        step = state.step
        if step % args.log_every == 0:
            # reading the metrics waits for the device
            m = {f"train/{k}": float(v) for k, v in metrics.items()}
            m["step_s"] = watch.lap() / (step - n_log)
            n_log = step
            logger.log(step, m)
            print(f"step {step}: " + " ".join(
                f"{k}={v:.4f}" for k, v in m.items()))
        if step % args.save_every == 0:
            save()
    save()
    logger.close()
    print(f"done at step {state.step}; checkpoints in {ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
