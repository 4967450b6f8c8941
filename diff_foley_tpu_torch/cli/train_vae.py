"""First-stage (spectrogram) VAE training entry point
(``diff_foley_tpu/cli/train_vae.py``): alternating generator /
discriminator optimisation of ``AutoencoderKL`` on mel-spec images.

Usage:
  python -m diff_foley_tpu_torch.cli.train_vae --data-dir /data/vggsound \\
      --logdir ./logs/vae --batch-size 8 --max-steps 100000
  # or over a flat directory of mel .npy files:
  python -m diff_foley_tpu_torch.cli.train_vae --spec-dir specs/ --logdir ./logs/vae

It runs on the first CUDA device unless ``--device cpu``. Under torchrun (or SLURM) each process
trains on ``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device cpu``) on
its shard of the data, ``--batch-size`` per process; the step is the
one-process step on the global batch (batch × processes), and rank 0
alone writes the logdir. Checkpoints
(both models, both optimizers, the step and the noise generator's state)
are ``torch.save``d under ``<logdir>/ckpt/step_<n>.pt``; ``--resume``
continues from the newest. Metrics go to ``<logdir>/metrics.jsonl``
through ``utils.logging.MetricsLogger``, one JSON object per logged step.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..utils.checkpoint import latest_checkpoint
from ..utils.checkpoint import save_checkpoint as save_step_checkpoint
from ..utils.logging import MetricsLogger, Stopwatch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default=None,
                   help="reference layout (<dir>/Train/audio_npy_spec)")
    p.add_argument("--spec-dir", default=None,
                   help="flat directory of .npy mel specs")
    p.add_argument("--logdir", default="./logs/vae")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=4.5e-6)
    p.add_argument("--max-steps", type=int, default=100000)
    p.add_argument("--disc-start", type=int, default=50001)
    p.add_argument("--kl-weight", type=float, default=1e-6)
    p.add_argument("--save-every", type=int, default=2000)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model for smoke runs")
    p.add_argument("--data-duration", type=float, default=10.0)
    p.add_argument("--data-truncate", type=int, default=131072)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; fails without a GPU) or 'cpu'")
    return p.parse_args(argv)


def save_checkpoint(ckpt_dir: str, state, noise_gen: torch.Generator) -> str:
    return save_step_checkpoint(
        ckpt_dir, state.step,
        {**state.state_dict(), "noise_gen": noise_gen.get_state()})


def main(argv=None):
    args = parse_args(argv)
    if not (args.data_dir or args.spec_dir):
        raise SystemExit("provide --data-dir or --spec-dir")
    from ..config import save_run_config
    from ..data.ldm_dataset import LDMDataConfig, SpecDataset
    from ..data.loader import PrefetchLoader
    from ..models.vae import SD_VAE, VAEConfig
    from ..parallel.distributed import setup
    from ..train.vae import VAETrainConfig, VAETrainer
    from ..train.vae_losses import VAELossConfig

    device, mesh, rank, world = setup(args.device)
    vae_cfg = (VAEConfig(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
               if args.tiny else SD_VAE)
    tcfg = VAETrainConfig(
        lr=args.lr, loss=VAELossConfig(kl_weight=args.kl_weight,
                                       disc_start=args.disc_start))
    trainer = VAETrainer(vae_cfg, cfg=tcfg, mesh=mesh)

    dcfg = LDMDataConfig(duration=args.data_duration,
                         truncate=args.data_truncate)
    dataset = (SpecDataset.from_split_file(args.data_dir, "train", cfg=dcfg)
               if args.data_dir else
               SpecDataset.from_dir(args.spec_dir, cfg=dcfg))
    if len(dataset) < args.batch_size * world:
        raise SystemExit(
            f"dataset has {len(dataset)} items < batch "
            f"{args.batch_size * world} (the global batch, --batch-size × "
            "processes): the loader would yield no batch")
    loader = PrefetchLoader(dataset, args.batch_size, seed=args.seed,
                            process_index=rank, process_count=world)

    if rank == 0:
            save_run_config(args.logdir, "vae", model=vae_cfg, train=tcfg,
                        sample_shape=[1, 128,
                                      args.data_truncate // dcfg.hop_len, 3])

    state = trainer.init_train_state(args.seed, device)
    noise_gen = torch.Generator(device).manual_seed(args.seed + 1)
    ckpt_dir = os.path.join(args.logdir, "ckpt")
    newest = latest_checkpoint(ckpt_dir) if args.resume else None
    if newest is not None:
        sd = torch.load(newest[1], map_location=device)
        state.load_state_dict(sd)
        noise_gen.set_state(sd["noise_gen"].cpu())
        print(f"resumed from step {state.step}")

    epoch = 0
    watch, n_log = Stopwatch(), state.step
    save = lambda: rank == 0 and save_checkpoint(ckpt_dir, state, noise_gen)
    logger = MetricsLogger(args.logdir if rank == 0 else None,
                           name="metrics", use_tensorboard=True)
    while state.step < args.max_steps:
        for batch in loader.epoch(epoch):
            x = torch.from_numpy(batch["spec"]).to(device)
            metrics = trainer.train_step(state, x, generator=noise_gen)
            if state.step % args.log_every == 0:
                # reading the metrics waits for the device
                m = {f"train/{k}": float(v) for k, v in metrics.items()}
                m["step_s"] = watch.lap() / (state.step - n_log)
                n_log = state.step
                logger.log(state.step, m)
                print(f"step {state.step}: nll={m['train/nll_loss']:.4f}")
            if state.step % args.save_every == 0:
                save()
            if state.step >= args.max_steps:
                break
        epoch += 1
    logger.close()
    save()
    print(f"done at step {state.step}; checkpoints in {ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
