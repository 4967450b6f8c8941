"""Stage-2 LDM training entry point (``diff_foley_tpu/cli/train_stage2.py``):
AdamW on the UNet and the cond encoder against a frozen first-stage VAE,
on (mel spec, CAVP feature) pairs in the reference's directory layout.

Usage:
  python -m diff_foley_tpu_torch.cli.train_stage2 --data-dir /data/vggsound \\
      --logdir ./logs/stage2 --batch-size 16 --max-steps 100000 \\
      --mixed-precision --use-ema

It runs on the first CUDA device unless ``--device cpu``. Under torchrun
(or SLURM) each process trains on ``cuda:LOCAL_RANK`` over NCCL (gloo with
``--device cpu``), on its shard of the data: ``--batch-size`` is per
process, the global batch is batch × processes, and the step is the
one-process step on the global batch. ``--fsdp`` splits the masters, AdamW's
moments and the EMA over the processes::

  torchrun --nproc-per-node 8 -m diff_foley_tpu_torch.cli.train_stage2 \\
      --data-dir /data/vggsound --batch-size 2 --mixed-precision --use-ema \\
      --fsdp

Rank 0 alone writes the logdir, whose checkpoints hold the whole state at
any world size, so ``--resume`` continues at another one. The logdir holds
``config.json`` (the model and train configs), ``vae/step_<n>.pt`` (the
frozen first stage, written once per run), ``ckpt/step_<n>.pt`` (the
train state: step, float32 masters, AdamW state, EMA, and the step
generator's state) and ``metrics.jsonl`` (one JSON object per logged step
or validation round). ``--resume`` continues from the newest checkpoint;
``utils.checkpoint.load_native_ldm`` rebuilds the trained model from the
logdir. ``--vae-ckpt`` takes a ``cli.train_vae`` logdir of this package or
a reference torch checkpoint; without it the VAE has seeded random
weights. ``--base`` builds the model from a reference-format YAML
(``configs/stage2_ldm.yaml``; ``--tiny`` is taken before it, as in the JAX
CLI). ``--sound-log-every N`` writes listening samples
(``train.callbacks.SoundLogger``) under ``<logdir>/sound/`` every N steps,
on rank 0 (its VAE in float32 under ``--mixed-precision``). SIGUSR1 or
SIGTERM saves a checkpoint at the next step boundary; with more than one
process, at the next log step, where the ranks agree on the signal
first. The last checkpoint is written at the end unless that step was
just saved.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", default=None,
                   help="model YAML (reference format)")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--logdir", default="./logs/stage2")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--base-lr", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--max-steps", type=int, default=100000)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--mixed-precision", action="store_true",
                   help="bf16 forward and backward against float32 masters")
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--save-every", type=int, default=2000)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--sound-log-every", type=int, default=0,
                   help="0 disables the SoundLogger callback")
    p.add_argument("--val-every", type=int, default=0,
                   help="validation every N steps (0 disables)")
    p.add_argument("--val-batches", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--vae-ckpt", default=None,
                   help="a cli.train_vae logdir or a reference torch "
                        "checkpoint for the frozen first stage")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model for smoke runs")
    p.add_argument("--data-duration", type=float, default=10.0)
    p.add_argument("--data-truncate", type=int, default=131072)
    p.add_argument("--fsdp", action="store_true",
                   help="split the masters, AdamW's moments and the EMA "
                        "over the processes")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; fails without a GPU) or 'cpu'")
    return p.parse_args(argv)


def build_ldm(args):
    from ..diffusion.latent_diffusion import LatentDiffusion, LDMConfig
    from ..models.unet import UNetConfig
    from ..models.vae import VAEConfig

    if args.tiny:
        return LatentDiffusion(LDMConfig(
            unet=UNetConfig(model_channels=32, num_res_blocks=1,
                            channel_mult=(1, 2), attention_resolutions=(2,),
                            num_heads=4, context_dim=24),
            vae=VAEConfig(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1),
            cond_embed_dim=24))
    if args.base:
        from ..config import load_ldm_from_yaml

        return load_ldm_from_yaml(args.base)
    return LatentDiffusion(LDMConfig())


def first_stage(args, ldm, device) -> None:
    """Load or draw the frozen VAE into ``ldm.vae`` on ``device``."""
    from ..models.layers import init_weights_
    from ..utils.checkpoint import (is_port_logdir, load_native_vae,
                                    load_vae_checkpoint)

    if is_port_logdir(args.vae_ckpt):
        ldm.vae.load_state_dict(load_native_vae(
            args.vae_ckpt, expect_cfg=ldm.cfg.vae).state_dict())
    elif args.vae_ckpt:
        load_vae_checkpoint(args.vae_ckpt, ldm.vae)
    ldm.vae.to(device)
    if not args.vae_ckpt:
        init_weights_(ldm.vae, torch.Generator(device).manual_seed(
            args.seed + 1))


def val_generator(device, seed: int, step: int, vi: int) -> torch.Generator:
    """Independent draws for each validation batch and round."""
    s = int(np.random.SeedSequence([seed, step, vi]).generate_state(1)[0])
    return torch.Generator(device).manual_seed(s)


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def main(argv=None):
    args = parse_args(argv)
    from ..config import save_run_config
    from ..data.ldm_dataset import LDMDataConfig, SpecFeatDataset
    from ..data.loader import DevicePrefetcher, PrefetchLoader
    from ..parallel.distributed import setup
    from ..train.callbacks import SoundLogger
    from ..train.stage2_ldm import Stage2TrainConfig, Stage2Trainer
    from ..utils.checkpoint import latest_checkpoint, save_checkpoint
    from ..utils.logging import MetricsLogger, Stopwatch
    from ..utils.profiling import count_params
    from ..utils.resilience import PreemptionCheckpointer

    device, mesh, rank, world = setup(args.device)
    ldm = build_ldm(args)
    tcfg = Stage2TrainConfig(
        base_lr=args.base_lr, warmup_steps=args.warmup_steps,
        use_ema=args.use_ema, accum_steps=args.accum_steps,
        compute_dtype="bfloat16" if args.mixed_precision else None)
    dcfg = LDMDataConfig(duration=args.data_duration,
                         truncate=args.data_truncate)
    dataset = SpecFeatDataset.from_split_file(args.data_dir, "train",
                                              cfg=dcfg)
    if len(dataset) < args.batch_size * world:
        raise SystemExit(
            f"dataset has {len(dataset)} items < global batch "
            f"{args.batch_size * world}: the loader would yield zero batches "
            "and the training loop would spin forever")
    shard = dict(process_index=rank, process_count=world)
    loader = PrefetchLoader(dataset, args.batch_size, seed=args.seed,
                            **shard)
    val_loader = None
    if args.val_every:
        try:
            val_ds = SpecFeatDataset.from_split_file(args.data_dir, "valid",
                                                     cfg=dcfg)
        except FileNotFoundError:
            val_ds = dataset   # no valid split: monitor on the train split
        val_loader = PrefetchLoader(val_ds, args.batch_size,
                                    seed=args.seed + 99, **shard)

    # a self-describing logdir: the configs and the frozen first stage,
    # so that load_native_ldm rebuilds the model from the logdir alone
    first_stage(args, ldm, device)
    if rank == 0:
        save_run_config(args.logdir, "stage2_ldm", model=ldm.cfg,
                        train=tcfg)
    vae_dir = os.path.join(args.logdir, "vae")
    newest_vae = latest_checkpoint(vae_dir)
    if rank == 0 and (newest_vae is None or not args.resume):
        # a fresh run in a reused logdir writes its own first stage: a
        # stale one would describe another run
        save_checkpoint(vae_dir, 0 if newest_vae is None else
                        newest_vae[0] + 1, {"vae": ldm.vae.state_dict()},
                        keep=1)

    # the SoundLogger's VAE computes in float32, as the JAX logger's: the
    # weights from before the trainer casts the frozen VAE to bf16
    sound_vae = ({k: p.detach().clone()
                  for k, p in ldm.vae.named_parameters()}
                 if args.sound_log_every and rank == 0
                 and args.mixed_precision else None)
    trainer = Stage2Trainer(ldm, tcfg, mesh=mesh, fsdp=args.fsdp)
    state = trainer.init_train_state(args.seed, device)
    n_params = count_params(trainer.full, verbose=True,
                            name="LatentDiffusion")
    print(f"LatentDiffusion: {n_params} trained parameters on {device}, "
          f"rank {rank} of {world}")
    if args.fsdp:
        split = sum(trainer.layout.dim(k) is not None for k in trainer.full)
        part = sum(p.numel() for p in state.params.values())
        print(f"FSDP: {split} of {len(trainer.full)} trained tensors split "
              f"over {world} ranks; rank {rank} holds {part} of "
              f"{n_params} parameters in its masters, moments and EMA")
    gen = torch.Generator(device).manual_seed(args.seed + 2)
    ckpt_dir = os.path.join(args.logdir, "ckpt")
    newest = latest_checkpoint(ckpt_dir) if args.resume else None
    if newest is not None:
        # mapped from the file on the host: each rank moves only its parts
        # to the card (the whole state is 13.8 GB at full width)
        sd = torch.load(newest[1], map_location="cpu", mmap=True)
        trainer.load_state_dict(state, sd["state"])
        gen.set_state(sd["generators"]["train"].cpu())
        print(f"resumed from step {state.step}")

    saved_step = None

    def save():   # the newest three stay, as the JAX package keeps them
        nonlocal saved_step
        whole = trainer.state_dict(state)   # every rank joins the gather
        if rank == 0:
            save_checkpoint(ckpt_dir, state.step, {
                "state": whole,
                "generators": {"train": gen.get_state()}}, keep=3)
        saved_step = state.step

    preempt = PreemptionCheckpointer()
    # the ranks agree on a signal before the (collective) save, over gloo
    # on the host (a device scalar read every step would wait for the
    # step), and only at log steps: there each rank has just waited for
    # its device, whose step joined the other ranks' collectives, so the
    # agreement adds no wait of its own
    flag_group = dist.new_group(backend="gloo") if world > 1 else None

    def preempted(step: int) -> bool:
        if flag_group is None:
            return preempt.should_checkpoint
        if step % args.log_every:
            return False
        flag = torch.tensor([float(preempt.should_checkpoint)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=flag_group)
        return bool(flag.item())

    logger = MetricsLogger(args.logdir if rank == 0 else None,
                           name="metrics", use_tensorboard=True)
    sound = (SoundLogger(os.path.join(args.logdir, "sound"), ldm,
                         every_n_steps=args.sound_log_every,
                         dtype=trainer.dtype, vae_params=sound_vae)
             if args.sound_log_every and rank == 0 else None)
    cast = torch.bfloat16 if args.mixed_precision else None
    val_name = "loss_simple_ema" if tcfg.use_ema else "loss_simple"
    epoch = 0
    watch, n_log = Stopwatch(), state.step
    try:
        while state.step < args.max_steps:
            for batch in DevicePrefetcher(loader.epoch(epoch), device=device,
                                          cast_dtype=cast):
                metrics = trainer.train_step(state, batch, gen)
                step = state.step
                if step % args.log_every == 0:
                    # reading the metrics waits for the device
                    m = {f"train/{k}": float(v) for k, v in metrics.items()}
                    m["step_s"] = watch.lap() / (step - n_log)
                    n_log = step
                    logger.log(step, m)
                    print(f"step {step}: loss={m['train/loss']:.4f}")
                if args.val_every and step % args.val_every == 0:
                    losses = []
                    for vi, vb in enumerate(
                            val_loader.epoch(step // args.val_every)):
                        vm = trainer.eval_step(
                            state, to_device(vb, device),
                            val_generator(device, args.seed + 2, step, vi))
                        losses.append(float(vm["loss_simple"]))
                        if len(losses) >= args.val_batches:
                            break
                    logger.log(step, {f"val/{val_name}": np.mean(losses)})
                    print(f"step {step}: val/{val_name}="
                          f"{np.mean(losses):.4f}")
                    watch.lap()   # kept out of step_s
                if preempted(step):
                    save()
                    preempt.clear()
                    print(f"step {step}: preemption signal, checkpoint "
                          "saved")
                elif step % args.save_every == 0:
                    save()
                if args.sound_log_every and step % args.sound_log_every \
                        == 0:
                    # the compute copy of the updated masters, whole on
                    # every rank (an FSDP gather: every rank joins)
                    trainer._gather_masters(state)
                if sound is not None and sound.maybe_log(
                        step, trainer.full, batch,
                        torch.Generator(device).manual_seed(step)):
                    watch.lap()   # kept out of step_s
                if step >= args.max_steps:
                    break
            epoch += 1
        if saved_step != state.step:
            save()
    finally:
        preempt.close()
        logger.close()
    print(f"done at step {state.step}; checkpoints in {ckpt_dir}")
    if device.type == "cuda":
        print(f"rank {rank}: peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    return state


if __name__ == "__main__":
    main()
