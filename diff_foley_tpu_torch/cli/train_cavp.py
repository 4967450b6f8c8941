"""Stage-1 CAVP contrastive training entry point
(``diff_foley_tpu/cli/train_cavp.py``; the reference's
``training.main_wds_intra_contrast``).

Usage:
  python -m diff_foley_tpu_torch.cli.train_cavp \\
      --train-shards '/data/shards/vggsound-{000000..000031}.tar' \\
      --batch-size 30 --clip-num 3 --lr 8e-4 --warmup 200 \\
      --logdir ./logs/cavp --mixed-precision --uint8-video

It runs on the first CUDA device unless ``--device cpu``. Under torchrun
(or SLURM) each process trains on ``cuda:LOCAL_RANK`` over NCCL (gloo with
``--device cpu``) on its shards (every process must hold as many samples
a step: ``--steps-per-epoch`` bounds an epoch), ``--batch-size`` videos
per process; the BatchNorms and the contrastive loss see the global batch
(batch × processes), and rank 0 alone writes the logdir. The shards are
read with Python's ``tarfile`` (``data/cavp_shards.py``), or with
``--native-loader`` by the C++ reader (``data/native_loader.py``, built
with ``g++`` at first use); decoding runs in the ``DevicePrefetcher``'s
feeder thread while the step runs. The logdir
holds ``config.json`` (model and train configs, the init shapes: the
frame size the towers train at), ``ckpt/step_<n>.pt`` (step, parameters,
AdamW state, BatchNorm statistics, the step generator's state) and
``metrics.jsonl``. ``--resume`` continues from the newest checkpoint;
``utils.checkpoint.load_native_cavp`` rebuilds the towers.
``--video-encode`` and ``--spec-encode`` choose the factory's towers at
their published widths; ``--mixed-precision`` takes the shipped towers
only (SlowOnly × CNN14/CNN10) and refuses the others as the JAX CLI
does, which train them in fp32.
"""
from __future__ import annotations

import argparse
import glob as globlib
import os
import re

import numpy as np
import torch

from ..models.cavp.cavp import SPEC_ARCHS, VIDEO_ARCHS


# --tiny's cut of the other towers (16 frames of 16², 256 spec steps)
TINY_TOWERS = {
    "x3d": dict(dim_c1=4, width_factor=1.0, depth_factor=1.0, dim_c5=16,
                base_blocks=(1, 1, 1, 1)),
    "i3d": dict(stage_blocks=(1, 1, 1, 1), width_per_group=4),
    "r2plus1d": dict(stage_blocks=(1, 1, 1, 1), base_channels=4),
    "vivit": dict(image_size=16, patch_size=8, dim=32, spatial_depth=1,
                  temporal_depth=1, heads=2, mlp_dim=64, dim_head=16),
    "cnn10": dict(channels=(8, 8, 8, 8, 8)),
    "resnet50": dict(stage_blocks=(1, 1, 1, 1), width=4),
    "spec_vit": dict(patch_size=64, width=32, layers=1, heads=2,
                     output_dim=32),
    "spec_vit_mean": dict(patch_size=64, width=32, layers=1, heads=2,
                          output_dim=32),
}


def expand_braces(pattern: str):
    """webdataset-style '{000000..000031}' brace expansion."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return sorted(globlib.glob(pattern)) or [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [pattern[:m.start()] + str(i).zfill(width) + pattern[m.end():]
            for i in range(int(lo), int(hi) + 1)]


def stack_micro_batches(samples, accum_freq: int, batch_size: int):
    """Stack buffered samples into a step batch: (B, …) normally, or
    (K, B, …) micro-batches when accum_freq > 1 (feature-cache mode)."""
    arr = np.stack(samples)
    if accum_freq > 1:
        arr = arr.reshape(accum_freq, batch_size, *arr.shape[1:])
    return arr


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train-shards", required=True)
    p.add_argument("--batch-size", type=int, default=30,
                   help="videos per step")
    p.add_argument("--clip-num", type=int, default=3)
    p.add_argument("--shift-lb", type=int, default=8)
    p.add_argument("--lr", type=float, default=8e-4)
    p.add_argument("--warmup", type=int, default=200)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--steps-per-epoch", type=int, default=0,
                   help="0 = full shards")
    p.add_argument("--intra-weight", type=float, default=1.0)
    p.add_argument("--accum-freq", type=int, default=1,
                   help="feature-cache gradient accumulation: K "
                        "micro-batches of --batch-size per optimizer step, "
                        "the full K·B contrastive batch")
    p.add_argument("--embed-dim", type=int, default=512)
    p.add_argument("--video-encode", default="slowonly",
                   choices=list(VIDEO_ARCHS),
                   help="video tower (the reference's --video_encode)")
    p.add_argument("--spec-encode", default="cnn14",
                   choices=list(SPEC_ARCHS),
                   help="audio tower (the reference's --spec_encode)")
    p.add_argument("--logdir", default="./logs/cavp")
    p.add_argument("--save-every-epochs", type=int, default=3)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mixed-precision", action="store_true",
                   help="bf16 tower compute against float32 masters")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--native-loader", action="store_true",
                   help="read the shards with the C++ reader "
                        "(native/shard_reader.cpp)")
    p.add_argument("--uint8-video", action="store_true",
                   help="ship video to the device as raw uint8 and divide "
                        "by 255 there")
    p.add_argument("--val-shards", default=None,
                   help="validation shards for the retrieval R@k eval")
    p.add_argument("--val-frequency", type=int, default=2,
                   help="run the retrieval eval every N epochs")
    p.add_argument("--val-samples", type=int, default=64)
    p.add_argument("--tiny", action="store_true",
                   help="smoke-geometry towers")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; fails without a GPU) or 'cpu'")
    return p.parse_args(argv)


@torch.no_grad()
def run_retrieval_eval(model, shards, cfg, n_samples: int, device) -> dict:
    """Pooled-feature retrieval metrics over the first clip of up to
    ``n_samples`` validation samples, the towers in eval mode
    (train_wds_intra_contrast.py:234-376)."""
    from ..data.cavp_shards import iter_shards
    from ..train.losses import retrieval_metrics

    was_training = model.training
    model.eval()
    vs, ss = [], []
    for sample in iter_shards(shards, seed=1234, epoch=0, cfg=cfg):
        video = torch.as_tensor(sample["video"][:1], device=device)
        if video.dtype == torch.uint8:
            video = video.float() / 255.0
        spec = torch.as_tensor(sample["spec"][:1], device=device)
        vs.append(model.encode_video(video, normalize=True).float())
        ss.append(model.encode_spec(spec, normalize=True).float())
        if len(vs) >= n_samples:
            break
    model.train(was_training)
    if len(vs) < 2:
        return {}
    return retrieval_metrics(torch.cat(vs), torch.cat(ss))


def main(argv=None):
    args = parse_args(argv)
    from ..config import save_run_config
    from ..data.cavp_shards import CAVPShardConfig, iter_shards
    from ..data.loader import DevicePrefetcher
    from ..models.cavp import CAVPConfig, CAVPModel
    from ..parallel.distributed import setup
    from ..train.stage1_cavp import Stage1TrainConfig, Stage1Trainer
    from ..utils.checkpoint import latest_checkpoint, save_checkpoint
    from ..utils.logging import MetricsLogger, Stopwatch

    device, mesh, rank, world = setup(args.device)
    shards = expand_braces(args.train_shards)
    print(f"{len(shards)} shards")
    scfg = CAVPShardConfig(clip_num=args.clip_num, shift_lb=args.shift_lb,
                           uint8_video=args.uint8_video)
    tiny_kw = dict(video_stage_blocks=(1, 1, 1, 1), video_base_channels=16,
                   spec_channels=(8, 8, 8, 8, 8, 8),
                   video_tower=TINY_TOWERS.get(args.video_encode),
                   spec_tower=TINY_TOWERS.get(args.spec_encode)
                   ) if args.tiny else {}
    model = CAVPModel(CAVPConfig(embed_dim=args.embed_dim,
                                 video_arch=args.video_encode,
                                 spec_arch=args.spec_encode, **tiny_kw))
    tcfg = Stage1TrainConfig(
        lr=args.lr, warmup_steps=args.warmup, clip_num=args.clip_num,
        intra_weight=args.intra_weight, accum_freq=args.accum_freq,
        compute_dtype="bfloat16" if args.mixed_precision else None)
    video_shape = (1, 16, 16, 16, 3) if args.tiny else (1, 16, 224, 224, 3)
    # a self-describing logdir: the frame size the towers train at is the
    # ingest size of every later user (native_cavp_ingest_size)
    if rank == 0:
        save_run_config(args.logdir, "stage1_cavp", model=model.cfg,
                        train=tcfg, init_video_shape=list(video_shape),
                        init_spec_shape=[1, 128, 256])
    trainer = Stage1Trainer(model, tcfg, mesh=mesh)
    state = trainer.init_train_state(args.seed, device)
    gen = torch.Generator(device).manual_seed(args.seed + 1)
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

    if args.native_loader:
        from ..data.native_loader import iter_shards_native as read_shards
    else:
        read_shards = iter_shards

    def step_batches(epoch):
        """Stacked step batches of one epoch's stream."""
        stream = read_shards(shards, seed=args.seed, epoch=epoch, cfg=scfg,
                             process_index=rank, process_count=world)
        per_step = args.batch_size * tcfg.accum_freq
        buf = []
        for sample in stream:
            buf.append(sample)
            if len(buf) == per_step:
                yield {k: stack_micro_batches([s[k] for s in buf],
                                              tcfg.accum_freq,
                                              args.batch_size)
                       for k in ("video", "spec")}
                buf = []

    cast = torch.bfloat16 if args.mixed_precision else None
    watch, n_log = Stopwatch(), state.step
    logger = MetricsLogger(args.logdir if rank == 0 else None,
                           name="metrics", use_tensorboard=True)
    for epoch in range(args.epochs):
        n_steps = 0
        for batch in DevicePrefetcher(step_batches(epoch), device=device,
                                      cast_dtype=cast):
            if tcfg.accum_freq > 1:
                metrics = trainer.accum_train_step(state, batch, gen)
            else:
                metrics = trainer.train_step(state, batch, gen)
            n_steps += 1
            step = state.step
            if step % args.log_every == 0:
                # reading the metrics waits for the device
                m = {f"train/{k}": float(v) for k, v in metrics.items()}
                m["step_s"] = watch.lap() / (step - n_log)
                n_log = step
                logger.log(step, m)
                print(f"epoch {epoch} step {step}: "
                      f"loss={m['train/total_loss']:.4f}")
            if args.steps_per_epoch and n_steps >= args.steps_per_epoch:
                break
        if args.val_shards and (epoch + 1) % args.val_frequency == 0:
            vm = run_retrieval_eval(model, expand_braces(args.val_shards),
                                    scfg, args.val_samples, device)
            if vm:
                logger.log(state.step, vm, prefix="val/")
                print(f"epoch {epoch} retrieval: v2s R@1="
                      f"{vm['video_to_spec_R@1']:.3f} s2v R@1="
                      f"{vm['spec_to_video_R@1']:.3f}")
            watch.lap()   # kept out of step_s
        if (epoch + 1) % args.save_every_epochs == 0:
            save()
    logger.close()
    save()
    print(f"done at step {state.step}; checkpoints in {ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
