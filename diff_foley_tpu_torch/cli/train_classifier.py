"""Alignment-classifier training entry point
(``diff_foley_tpu/cli/train_classifier.py``): BCE on aligned and
misaligned (mel spec, CAVP feature) pairs against a frozen first-stage
VAE, in the reference's directory layout.

Usage:
  python -m diff_foley_tpu_torch.cli.train_classifier --data-dir /data/vggsound \\
      --logdir ./logs/classifier --batch-size 32 --max-steps 50000

It runs on the first CUDA device unless ``--device cpu``. Under torchrun (or SLURM) each process
trains on ``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device cpu``) on
its shard of the data, ``--batch-size`` per process; the step is the
one-process step on the global batch (batch × processes), and rank 0
alone writes the logdir. The logdir holds
``config.json`` (backbone, VAE and train configs, the cond encoder's
sequence length), ``vae/step_<n>.pt`` (the frozen VAE the run scored
latents with, written once per run: align-acc must encode with the same
one), ``ckpt/step_<n>.pt`` (step, parameters, AdamW state, the step
generator's state) and ``metrics.jsonl``. ``--resume`` continues from the
newest checkpoint; ``utils.checkpoint.load_native_classifier`` rebuilds
the trained classifier. ``--vae-ckpt`` takes a ``cli.train_vae`` logdir of
this package or a reference torch checkpoint; without it the VAE has
seeded random weights. ``--tiny`` keeps the JAX CLI's tiny geometry (head
dim 16): the CUDA attention kernels do not take it, so it runs on the CPU
only.
"""
from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--logdir", default="./logs/classifier")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--max-steps", type=int, default=50000)
    p.add_argument("--save-every", type=int, default=2000)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--vae-ckpt", default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model for smoke runs")
    p.add_argument("--data-duration", type=float, default=10.0)
    p.add_argument("--data-truncate", type=int, default=131072)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; fails without a GPU) or 'cpu'")
    return p.parse_args(argv)


def build_trainer(args, mesh=None):
    from ..models.unet import UNetConfig
    from ..models.vae import AutoencoderKL, VAEConfig
    from ..train.classifier import ClassifierTrainConfig, ClassifierTrainer

    cfg = ClassifierTrainConfig(lr=args.lr)
    if args.tiny:
        # the JAX CLI's tiny system: train_stage2 --tiny's VAE (the same ×8
        # latents) and the raw 512-d features as the backbone's context,
        # as guidance feeds it
        return ClassifierTrainer(
            backbone_cfg=UNetConfig(
                out_channels=1, model_channels=32, num_res_blocks=1,
                channel_mult=(1, 2), attention_resolutions=(2,),
                num_heads=4, context_dim=512),
            vae=AutoencoderKL(VAEConfig(ch=32, ch_mult=(1, 2, 4, 4),
                                        num_res_blocks=1)),
            cfg=cfg, mesh=mesh)
    return ClassifierTrainer(cfg=cfg, mesh=mesh)


def frozen_vae(args, vae, device) -> None:
    """Load or draw the frozen VAE in place on ``device``."""
    from ..models.layers import init_weights_
    from ..utils.checkpoint import (is_native_logdir, is_port_logdir,
                                    load_native_vae, load_vae_checkpoint)

    if is_port_logdir(args.vae_ckpt):
        vae.load_state_dict(load_native_vae(
            args.vae_ckpt, expect_cfg=vae.cfg).state_dict())
    elif is_native_logdir(args.vae_ckpt):
        raise SystemExit(f"{args.vae_ckpt} is a JAX package logdir (orbax "
                         "checkpoints), which the port does not read")
    elif args.vae_ckpt:
        load_vae_checkpoint(args.vae_ckpt, vae)
    vae.to(device)
    if not args.vae_ckpt:
        init_weights_(vae, torch.Generator(device).manual_seed(
            args.seed + 1))


def main(argv=None):
    args = parse_args(argv)
    from ..config import save_run_config
    from ..data.ldm_dataset import LDMDataConfig, SpecFeatDataset
    from ..data.loader import DevicePrefetcher, PrefetchLoader
    from ..parallel.distributed import setup
    from ..utils.checkpoint import latest_checkpoint, save_checkpoint
    from ..utils.logging import MetricsLogger, Stopwatch

    device, mesh, rank, world = setup(args.device)
    trainer = build_trainer(args, mesh)
    if rank == 0:
        save_run_config(args.logdir, "classifier",
                        backbone=trainer.model.backbone.cfg,
                        vae=trainer.vae.cfg, train=trainer.cfg,
                        cond_seq_len=trainer.model.cond.pos_emb.shape[0])
    dataset = SpecFeatDataset.from_split_file(
        args.data_dir, "train", alignment_labels=True,
        cfg=LDMDataConfig(duration=args.data_duration,
                          truncate=args.data_truncate))
    if len(dataset) < args.batch_size * world:
        raise SystemExit(
            f"dataset has {len(dataset)} items < global batch "
            f"{args.batch_size * world}: the loader would yield zero batches "
            "and the training loop would spin forever")
    loader = PrefetchLoader(dataset, args.batch_size, seed=args.seed,
                            process_index=rank, process_count=world)

    frozen_vae(args, trainer.vae, device)
    vae_dir = os.path.join(args.logdir, "vae")
    newest_vae = latest_checkpoint(vae_dir)
    if rank == 0 and (newest_vae is None or not args.resume):
        # a fresh run in a reused logdir writes its own VAE: a stale one
        # would score other latents than this run trained on
        save_checkpoint(vae_dir, 0 if newest_vae is None else
                        newest_vae[0] + 1, {"vae": trainer.vae.state_dict()},
                        keep=1)

    state = trainer.init_train_state(args.seed, device)
    gen = torch.Generator(device).manual_seed(args.seed + 2)
    ckpt_dir = os.path.join(args.logdir, "ckpt")
    newest = latest_checkpoint(ckpt_dir) if args.resume else None
    if newest is not None:
        sd = torch.load(newest[1], map_location=device)
        state.load_state_dict(sd["state"])
        gen.set_state(sd["generators"]["train"].cpu())
        print(f"resumed from step {state.step}")

    def save():
        if rank == 0:
            save_checkpoint(ckpt_dir, state.step, {
                "state": state.state_dict(),
                "generators": {"train": gen.get_state()}}, keep=3)

    epoch = 0
    watch, n_log = Stopwatch(), state.step
    logger = MetricsLogger(args.logdir if rank == 0 else None,
                           name="metrics", use_tensorboard=True)
    while state.step < args.max_steps:
        for batch in DevicePrefetcher(loader.epoch(epoch), device=device):
            metrics = trainer.train_step(state, batch, gen)
            step = state.step
            if step % args.log_every == 0:
                # reading the metrics waits for the device
                m = {f"train/{k}": float(v) for k, v in metrics.items()}
                m["step_s"] = watch.lap() / (step - n_log)
                n_log = step
                logger.log(step, m)
                print(f"step {step}: bce={m['train/bce_loss']:.4f} "
                      f"acc={m['train/acc']:.3f}")
            if step % args.save_every == 0:
                save()
            if step >= args.max_steps:
                break
        epoch += 1
    logger.close()
    save()
    print(f"done at step {state.step}; checkpoints in {ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
