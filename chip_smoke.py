"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # build, kernels, pipelines, trainer,
                                     # agreement
    python3 chip_smoke.py --profile  # also torch.profiler over two steps
                                     # of each sampler (the video run's
                                     # too) and of the trainers
    python3 chip_smoke.py --train-agreement 40   # build, then only the tiny
                                     # train-step agreement (phase 12) 40
                                     # times: failures / runs

1. Build the CUDA kernels from ``diff_foley_tpu_torch/csrc`` (in parallel);
   ``ptxas -v`` lines and the HMMA (tensor-core) instruction count of each
   kernel's SASS (``cuobjdump -sass``): the rebuilt attention kernels must
   hold some, and the GroupNorm apply kernel 128-bit global loads and
   stores (its instructions per element are logged).
2. Kernel phase: each kernel against its plain PyTorch version at every
   shape of the main paths, in bf16 and fp32, with times beside the
   plain version's, one PyTorch call for the same function (SDPA,
   F.group_norm then F.silu, torch.var_mean for the stats kernel: yardsticks
   the port never calls) and the
   card's bound; beside the event time of back-to-back calls, the device
   time of the kernel's own symbols (torch.profiler). Every planted fault
   of a kernel (two for each per-head kernel) must fail the same check.
   The fp32 per-head kernels and the fp32 packed backward sum on the
   tensor cores in another order than cuBLAS's fp32 products in their
   plain versions, whose own error may exceed the limit: they are held to
   the plain version on float64 copies of their operands, at the same
   limits. The fp32 packed forward is held to its plain version in fp32;
   the distances of both to float64 are printed beside.
   The apply kernel also at its edges: more than 65535 rows, the
   single-element route, an x off 16-byte alignment, each with a planted
   fault of its own.
3. ``DiffFoleyPipeline.generate`` at full width (the 860M LDM UNet and the
   alignment classifier in bf16, the SD VAE in bf16, seeded random
   weights), 2 windows × 2 samples, 25 DPM-Solver++ steps, CFG 4.5,
   classifier guidance 50, 32 Griffin-Lim iterations, int16 wav.
4. ``DiffFoleyPipeline.inpaint`` at the same point with 25 masked DDIM
   steps: the canvas is the generated spec, the first 256 frames of each
   window are kept. Stage times, the distance to the canvas's VAE
   roundtrip per region, and the contract check (a fully known canvas
   lands ten times closer to the roundtrip than free generation).
5. The video entry, ``DiffFoley.generate_for_video``: a seeded 8.5-s,
   30-fps, 224×224 MJPG clip (cv2), 1 window × 4 samples, the UNet and the
   VAE in bf16, the alignment classifier, the cond encoder and the CAVP
   towers (SlowOnly-R50, CNN14, seeded random weights and BatchNorm
   statistics) in fp32; first and warm seconds by stage (frame decode,
   CAVP, sampler, VAE decode, Griffin-Lim) around the main-path call,
   peak memory, the CAVP tower's device time, its features on the GPU
   against the CPU's. Then
   ``cli.generate --random-weights --bf16`` once on the same clip: four
   int16 16-kHz wavs of 131072 samples and four spec files.
   ``cli.transform_spec`` then takes 3's specs to the SpecVQGAN format
   (80 mels, 22.05 kHz) and back: shapes, range, the round trip's
   distance, seconds per file.
   Before each main-path run (3, 4, 5, 5's CLI run, 6, 7, 7b, 8 and its
   SoundLogger calls, 9, 10 and 11c–11f) the
   launch counts are reset; read just after, they must equal what the model
   structure predicts, by kernel and operand dtype.
6. Serving, ``BatchingEngine`` and ``FoleyServer``, at the same full width
   (the flagship's bf16 UNet, classifier and VAE; random CAVP towers for
   ``DiffFoley.extract_features``), 25 steps, one sample, int16: the
   warm-up over the bucket ladder 1/2/4/8/16, a warm request per bucket
   (the bucket-16 one is the main-path run), a 1-window request, eight
   concurrent ones of 1–3 windows (a batch of two or more must form, and
   its fan-out must equal a direct bucketed ``generate`` with its seed, bit
   for bit), a 20-window request (two bucket-16 chunks), and every HTTP
   route on 127.0.0.1 (``/generate_video`` over 5's clip; a malformed body
   answers 400). Warm seconds per bucket, windows per minute at bucket 16,
   the concurrent requests' p50 and max latency.
7. ``cli.train_vae`` at the full width of ``SD_VAE`` in float32: seeded mel
   ``.npy`` files in a temporary directory, batch 4, ``--disc-start 0`` (the
   GAN term, the adaptive weight and the discriminator step all run), a
   raised learning rate. Every metric finite, ``nll_loss`` falls,
   ``d_weight`` ≥ 0, launch counts as predicted (the per-head attention
   forward and backward twice a step each), the checkpoint resumes at the
   saved step. First-step and warm seconds per step, split generator /
   discriminator, peak memory, the plain GroupNorm backward's cost, and one
   step with the LPIPS hook on (random weights).
7b. ``cli.train_sound_vae`` at the CLI's own width (channels 32, z 128,
   65536-sample crops of seeded int16 wavs, batch 8, the multi-scale
   STFT losses' defaults), the GAN on from step 0: six steps, the resume
   to a seventh, every loss finite, no kernel of the TPU's launched, the
   warm step and peak memory; ``load_native_sound_vae`` then reconstructs
   a window on the card.
8. ``cli.train_stage2`` at the full width of ``LDM_UNET`` (and its cond
   encoder) against the frozen ``SD_VAE``: bf16 compute on fp32 masters,
   AdamW, EMA, batch 16, seeded random weights, 32 seeded (mel spec, CAVP
   feature) pairs in the reference layout; six steps and one validation
   batch (the main-path call), then ``--resume`` for a seventh. Every
   metric finite; the eval loss on a fixed batch and a fixed draw lower
   after the six steps than before; the EMA nearer the initial weights
   than the parameters; the resume continues the step, AdamW's count, the
   EMA and the generator; ``load_native_ldm`` reads the logdir and the
   model generates on the card. The CLI's step times, warm steps split
   into forward and backward, AdamW and EMA, and peak memory. The
   main-path call runs the SoundLogger every third step (two calls, each
   with its own launch counts: the UNet at the CFG batch 4 over 25
   DPM-Solver++ steps at CFG 6.5 with no classifier in bf16, the VAE
   encode and two decodes at batch 2 in fp32; its files finite), and a
   SIGUSR1 raised during the last step makes the CLI save at that step's
   boundary, the call's only save. ``--base configs/stage2_ldm.yaml``
   builds the flagship's config (where PyYAML imports).
9. ``cli.train_classifier`` at ``CLASSIFIER_BACKBONE`` in fp32 with its
   cond encoder (512 → 512, 40 positions) against the frozen full
   ``SD_VAE`` in fp32, batch 32, seeded random weights, 32 seeded pairs
   with alignment labels, the shipped rate; six steps, then ``--resume``
   for a seventh. Every metric finite; the first step replayed from the
   same state, batch and draws gives the CLI's metrics and lowers the BCE
   of that batch and draw; launches as predicted (the per-head attention
   backward never: the encoder is frozen under ``no_grad``). Warm steps
   split into the encode, forward + backward and AdamW; peak memory.
10. ``cli.align_acc`` on that logdir over 100 seeded spec and feature
   files at batch 64 (the last batch ragged, padded): the accuracy, its
   counts against the files, launches as predicted; then at batch 128
   (one padded batch), its counts equal to batch 64's, and its peak
   memory.
11. ``cli.train_cavp`` on the shipped towers (SlowOnly-R50, CNN14, 512-d)
    in bf16 on fp32 masters over seeded tar shards (cv2 JPEG strips of 40
    224² frames, npy specs), the CLI's 30 videos × 3 clips a step with
    uint8 video: three steps and the retrieval eval, then a resume for one
    step in three micro-batches (the feature cache). Losses finite,
    ``logit_scale`` ≤ 100, every BatchNorm statistic moved, no kernel of
    the TPU's launched; step times, peak memory. Then
    ``cli.extract_features`` on a seeded clip with the CAVP logdir, and
    ``DiffFoley.from_native_checkpoints`` over the stage-2, CAVP and
    classifier logdirs (the classifier's context encoded, then raw), each
    running ``generate_for_video`` on the clip: finite int16 wavs.
11b. ``cli.train_cavp`` on the factory's other towers at their published
    widths in fp32, four calls that cover every tower once (x3d × cnn10,
    i3d × resnet50, r2plus1d × spec_vit, vivit × spec_vit_mean) over 11's
    shards at a reduced batch (4 videos × 3 clips, a cut of depth, not of
    width): three steps and the retrieval eval each, every step logged
    and finite, ``logit_scale`` ≤ 100, every BatchNorm statistic moved,
    no kernel launched; peak memory and the warm step. Then
    ``cli.extract_features`` over the x3d logdir on the seeded clip.
11c. ``train/stage2_decode.py`` at ``DecodeConfig``'s defaults (decoder ch
    64, ch_mult (1, 1, 2, 2, 4), 8 out channels: 128 mel bins) on 11's
    frozen CNN14, spec (8, 128, 256) fp32: four MSE steps of
    ``DecoderWrapper`` and four of ``GANDecoderWrapper``. Losses finite,
    the discriminator's statistics moved; launches as predicted (one
    kernel-3 and one kernel-4 launch at (8, 1, 16, 256) and 26 GroupNorm
    forwards a step); the kernel phase's rows of this run (PERF.md's
    column r).
11d. The models beside the main paths, each in fp32 at its published
    widths with its launches held to the module structure's prediction
    (PERF.md's columns u, p and n): the 1-D audio UNet at
    ``AudioUNetConfig()`` over (4, 4096, 128) latents (one 8.192-s window
    of the sound VAE's 128-channel latents) and a (4, 32, 768) context, a
    forward and the gradient of Σ out² over the parameters and the input,
    twice (kernels 1 and 2 at head dims 48 and 96, the GroupNorm kernels
    over (B, C, 1, L) maps); the diffusion prior at ``PriorConfig()``,
    three ``p_losses`` steps at batch 64 with optax-style Adam, then two
    ``sample`` calls at batch 16, 50 steps, CFG 3 (kernels 3 and 4 at
    head dim 64); ``EncoderUNetModel`` at ``CLASSIFIER_BACKBONE`` with
    each of the four pools over (16, 16, 64, 4) latents, the forward and
    the gradient of the summed output over the input, twice a pool
    (kernels 1 and 2 at D 32, and the attention pool's kernels 3 and 4
    with one query against 65 keys). Outputs, losses, samples and
    gradients finite; seconds, peak memory.
11e. The other conditioning and first stages (PERF.md's columns o and
    f): run o, ``VideoFeatEncoderPosembedAR()`` at its defaults (8 heads
    of D 64) over stage 2's batch 16, a (16, 32, 512) feature and a (16,
    16, 64, 4) previous latent (1024 keys), forward and the gradient of Σ
    out² over inputs and parameters, twice in fp32 and twice in bf16;
    then the 860M UNet in bf16 at batch 2 through
    ``LatentDiffusion.apply_model``, twice in each mode, one model built
    on the card at a time: concat, hybrid, adm (309 classes), ResBlock
    positions (64) with the cond encoder's context, and crossattn over one
    ``ClassEmbedder`` token. Run f, fp32: ``LatentRescaler`` (×2, mid
    512: kernels 3 and 4 at L 4096, D 512), ``UpsampleDecoder`` and
    ``SimpleDecoder``, forward and the gradient of Σ out², twice each.
    Launches as predicted; outputs and gradients finite; seconds.
11f. The last missing modules (PERF.md's columns q, k and m). Run q:
    ``cli.profile.main(["--family", "all", "--time"])`` at batch 1 in fp32
    (the UNet and the classifier over 40 context tokens, the VAE encode
    and decode, CAVP), each family's parameters, flops, bytes, ms and
    TFLOP/s, its counts equal to the same call's on ``meta``; CAVP
    launches nothing. Run k: ``data.synthetic.write_ldm_data_dir`` writes a
    small world that ``SpecFeatDataset`` reads, the frozen SD VAE's
    posterior moments and the features resident on the card, and
    ``train.scan.scan_train`` runs 4 classifier steps at
    ``CLASSIFIER_BACKBONE`` fp32 batch 32 through an ``index_fn`` gather
    under ``torch.cuda.set_sync_debug_mode("error")``, against 4 sequential
    ``train_step`` calls from the same state and draws; per-step ms of
    both. Run m: one stage-2 step of ``LDM_UNET`` in bf16 on fp32 masters
    at batch 16 with dropout 0.1, its gradients without block recompute
    and under ``remat_policy`` "none", "dots" and "dots_no_batch" (the
    same draws; bit for bit, peak memory each), then the model through
    ``export_ldm_state_dict``, ``split_ldm_state_dict`` and the port's
    converters into a fresh model, strict, bit for bit.
12. Agreement: tiny ``generate``, ``inpaint``, ``DiffFoley.extract_features``
   plus ``generate_from_features``, two tiny VAE train steps, one tiny
   stage-2 train step, one tiny classifier train step (D 32, 40 keys) and
   one tiny CAVP train step, one on the other towers (i3d × resnet50),
   one tiny spec-decoder step (D 32), one tiny waveform-VAE step (against the
   CPU in float64), the tiny audio UNet (D 48 and 96), prior (D 64,
   ``p_losses`` and ``sample`` under shared draws) and EncoderUNetModel at
   each pool (D 32), the AR and plain video encoders (D 64), the UNet's
   five conditioning modes (D 32) and the three other first stages (D
   32), one call of each sampler family and the tiled pair
   (``agreement_sampler_phase``: shared x_T and step draws, the adaptive
   solver's model calls equal) in float32 on the GPU (kernels) against the
   same on the CPU (plain versions), shared noise, phase, draws and
   dropout masks. Each VAE train step starts from equal states, and the
   CPU takes the GPU's branch at every leaky_relu input within rounding of
   zero; the train steps' gradients are held per leaf before the
   optimizer (and the CAVP step's BatchNorm statistics after it), and a
   planted gradient fault must be caught.
13. Parallelism (run after 11, before 12): a real NCCL group of one rank
   (torchrun's environment for rank 0 of 1, ``init_distributed``; NCCL's
   version printed), then ``cli.train_stage2 --fsdp`` at 8's full width,
   data, seeds and arguments for two steps: its metrics against the
   unsplit call's first two steps, launches as predicted (8's per forward
   and per step), the warm step and peak memory beside the unsplit
   call's, its logdir through ``load_native_ldm``. Then, at tiny widths
   on CUDA tensors with every collective through NCCL, each meshed
   module against its unmeshed self: the VAE step (PatchGAN BatchNorm),
   the classifier step, the CAVP step and its accumulated step (the
   gathered contrastive loss, cross-rank BatchNorm), a TP-wrapped
   stage-2 step, align-acc, ``generate`` and ``inpaint``, and one batch
   served through the meshed engine's announcements, bit for bit against
   a meshed direct call. The group is destroyed at the end.

The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before it. With no GPU it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from diff_foley_tpu_torch.api import DiffFoley
from diff_foley_tpu_torch.audio.transforms import mel_to_wav
from diff_foley_tpu_torch.cli import align_acc as align_acc_cli
from diff_foley_tpu_torch.cli import extract_features as extract_features_cli
from diff_foley_tpu_torch.cli import generate as generate_cli
from diff_foley_tpu_torch.cli import profile as profile_cli
from diff_foley_tpu_torch.cli import train_cavp as train_cavp_cli
from diff_foley_tpu_torch.cli import train_classifier as train_classifier_cli
from diff_foley_tpu_torch.cli import train_sound_vae as train_sound_vae_cli
from diff_foley_tpu_torch.cli import train_stage2 as train_stage2_cli
from diff_foley_tpu_torch.cli import train_vae as train_vae_cli
from diff_foley_tpu_torch.cli import transform_spec as transform_spec_cli
from diff_foley_tpu_torch.data import synthetic
from diff_foley_tpu_torch.data.ldm_dataset import (LDMDataConfig, SpecDataset,
                                                   SpecFeatDataset)
from diff_foley_tpu_torch.data.loader import DevicePrefetcher, PrefetchLoader
from diff_foley_tpu_torch.diffusion import samplers as sampler_lib
from diff_foley_tpu_torch.diffusion.guidance import (GuidanceSpec,
                                                     make_guided_eps_fn)
from diff_foley_tpu_torch.diffusion.latent_diffusion import (LatentDiffusion,
                                                              LDMConfig)
from diff_foley_tpu_torch.diffusion.samplers import (ddim_decode,
                                                     ddim_stochastic_encode)
from diff_foley_tpu_torch.diffusion.schedule import make_ddim_timesteps
from diff_foley_tpu_torch.diffusion.tiled import SplitInputParams
from diff_foley_tpu_torch.eval.align_acc import (alignment_accuracy,
                                                 make_align_acc_fn)
from diff_foley_tpu_torch.models.attention import (SpatialTransformer,
                                                   SpatialTransformer1D)
from diff_foley_tpu_torch.models.audio_unet import (AudioUNetConfig,
                                                    AudioUNetModel,
                                                    Upsample1D)
from diff_foley_tpu_torch.models.cavp import CAVPConfig, CAVPModel
from diff_foley_tpu_torch.models.cavp import cnn14 as cnn14_module
from diff_foley_tpu_torch.models.cond_encoder import (
    VideoFeatEncoderMLP, VideoFeatEncoderPosembedAR, VideoFeatEncoderSimple)
from diff_foley_tpu_torch.models.cond_text import ClassEmbedder
from diff_foley_tpu_torch.models.sound_vae import SoundVAEConfig
from diff_foley_tpu_torch.models.layers import (Conv1d, Downsample,
                                                GroupNorm32, Upsample,
                                                init_weights_)
from diff_foley_tpu_torch.models.prior import DiffusionPrior, PriorConfig
from diff_foley_tpu_torch.models.unet import (CLASSIFIER_BACKBONE, LDM_UNET,
                                              POOLS, AttentionPool2d,
                                              ClassifierBackbone,
                                              EncoderUNetModel, UNetConfig,
                                              UNetModel)
from diff_foley_tpu_torch.models.vae import (SD_VAE, AutoencoderKL, Decoder,
                                             LatentRescaler, NearestResize,
                                             SimpleDecoder, UpsampleDecoder,
                                             VAEAttnBlock, VAEConfig,
                                             VAEDownsample, VAEUpsample)
from diff_foley_tpu_torch.ops import cuda_build
from diff_foley_tpu_torch.ops import hopper_attention as ha
from diff_foley_tpu_torch.ops import hopper_groupnorm as hg
from diff_foley_tpu_torch.parallel.distributed import init_distributed
from diff_foley_tpu_torch.parallel.mesh import make_mesh
from diff_foley_tpu_torch.parallel.sharding_rules import (ColumnParallelDense,
                                                          tensor_parallel_)
from diff_foley_tpu_torch.pipeline import (LATENT_HW, SPEC_HW, WINDOW_FEATS,
                                           WINDOW_SAMPLES, DiffFoleyPipeline,
                                           GenerationConfig,
                                           continuation_mask,
                                           spec_mask_to_latent,
                                           window_features)
from diff_foley_tpu_torch.serving import BatchingEngine, FoleyServer
from diff_foley_tpu_torch.train import callbacks as callbacks_module
from diff_foley_tpu_torch.train.classifier import (AlignmentClassifier,
                                                   ClassifierTrainer)
from diff_foley_tpu_torch.train.optim import TrainState, global_norm
from diff_foley_tpu_torch.train.perceptual import LPIPS, make_lpips_fn
from diff_foley_tpu_torch.train.sound_gan import (AudioGANConfig,
                                                  SoundVAETrainer)
from diff_foley_tpu_torch.train.stage1_cavp import (Stage1TrainConfig,
                                                    Stage1Trainer)
from diff_foley_tpu_torch.train.stage2_decode import (DecodeConfig,
                                                      DecoderWrapper,
                                                      GANDecoderWrapper,
                                                      _adam)
from diff_foley_tpu_torch.train.scan import scan_train
from diff_foley_tpu_torch.train.stage2_ldm import (Stage2TrainConfig,
                                                   Stage2Trainer,
                                                   init_ldm_weights_)
from diff_foley_tpu_torch.train.vae import VAETrainConfig, VAETrainer
from diff_foley_tpu_torch.train.vae_losses import VAELossConfig
from diff_foley_tpu_torch.utils import checkpoint as checkpoint_module
from diff_foley_tpu_torch.utils.checkpoint import (load_native_cavp,
                                                   load_native_ldm,
                                                   load_native_sound_vae)
from diff_foley_tpu_torch.utils.convert import (convert_cond_encoder,
                                                convert_unet, convert_vae,
                                                export_ldm_state_dict,
                                                from_jax_params,
                                                split_ldm_state_dict)
from diff_foley_tpu_torch.utils.ema import ema_update
from diff_foley_tpu_torch.utils.init import randomize_
from diff_foley_tpu_torch.utils.padding import pad_axis0
from diff_foley_tpu_torch.utils.wav import read_wav, write_wav
from diff_foley_tpu_torch.video.ingest import encode_frames, extract_frames

PEAK_BF16 = 989e12    # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12     # H100 SXM fp32 FLOP/s outside the tensor cores
# the fastest fp32-accurate product rate: 3xTF32, three TF32 tensor-core
# products (495 TFLOP/s dense) per fp32 product
PEAK_FP32_PRODUCTS = 495e12 / 3
HBM_BYTES_S = 3.35e12
WINDOWS, SAMPLES, STEPS = 2, 2, 25
# the video entry: one 8.192-s window of a 30-fps 224×224 clip, 4 samples;
# its latent batch equals generate's (2 windows × 2 samples), so the two
# runs share the kernel shapes of the UNet and the VAE decoder
VIDEO_SAMPLES, VIDEO_SECONDS, VIDEO_FPS, FRAME = 4, 8.5, 30.0, 224
assert VIDEO_SAMPLES == WINDOWS * SAMPLES
KEEP_FRAMES = 256     # inpaint keeps the first 256 frames of each window
# the trainer: batch, steps of the main-path call, and a learning rate
# raised from the shipped 4.5e-6 so that six steps show nll_loss falling
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 4, 6, 1e-4
# stage-2 training: the JAX CLI's default batch, the steps of the
# main-path call (which ends with one validation round on one batch: one
# more forward), a rate for six steps to show, and the seeded data items;
# an 8.192-s crop gives 32 condition tokens at 4 FPS
S2_BATCH, S2_STEPS, S2_LR, S2_ITEMS = 16, 6, 1e-4, 32
S2_FORWARDS = S2_STEPS + 1
S2_TOKENS = int(4.0 * 131072 / 16000)
# the alignment classifier's trainer: the CLI's default batch and rate, the
# steps of the main-path call; its data's 8.192-s crops give S2_TOKENS
# condition tokens. align-acc: the CLI's default batch over AA_FILES spec
# files (the last batch ragged, padded to AA_BATCH), features cut to 40
C_BATCH, C_STEPS, C_REPLAY = 32, 6, 3
AA_BATCH, AA_FILES, AA_TOKENS = 64, 100, 40
AA_CALLS = -(-AA_FILES // AA_BATCH)
# align-acc's second call: batch 128, one padded batch (other shapes,
# other cuDNN algorithms in fp32): every file must get the same decision
# as at batch 64
AA_BATCH_LARGE = 128
# serving: the engine's bucket ladder up to 16 windows of one sample; the
# main-path run is one warm request of 16 windows (one bucket-16 call:
# the UNet at the CFG batch 32, the classifier gradient at 16). Eight
# concurrent requests of SERVE_WINDOWS windows, then one of
# SERVE_OVERSIZE (two bucket-16 chunks, the last padded)
SERVE_BUCKET, SERVE_OVERSIZE = 16, 20
SERVE_WINDOWS = (1, 2, 3, 1, 2, 3, 2, 1)
# stage-1 CAVP: the CLI's default 30 videos × 3 clips a step (bf16 towers,
# uint8 video), CAVP_STEPS steps of one epoch over CAVP_SAMPLES samples;
# the resume takes one step in CAVP_ACCUM micro-batches of the same
# 30-video contrastive batch (the feature cache)
CAVP_BATCH, CAVP_CLIPS, CAVP_STEPS, CAVP_ACCUM = 30, 3, 3, 3
CAVP_SAMPLES = CAVP_BATCH * CAVP_STEPS + 6
# stage 1 on the factory's other towers: four CLI calls cover every tower
# once, at their published widths in fp32, at a reduced batch (a cut of
# depth: TOWER_BATCH videos × CAVP_CLIPS clips) over TOWER_STEPS steps
TOWER_PAIRS = (("x3d", "cnn10"), ("i3d", "resnet50"),
               ("r2plus1d", "spec_vit"), ("vivit", "spec_vit_mean"))
TOWER_BATCH, TOWER_STEPS = 4, 3
# the stage-2 spec decoder at DecodeConfig's defaults: DEC_STEPS MSE steps
# and DEC_STEPS GAN steps at batch DEC_BATCH over (128, DEC_T) specs
DEC_BATCH, DEC_STEPS, DEC_T = 8, 4, 256
# the 1-D audio UNet at AudioUNetConfig's published widths (run
# "audio_unet", fp32): the sound VAE's 128-channel latents of one 8.192-s,
# 131072-sample window at its 32× stride (AU_LEN steps), the cond
# encoder's AU_CTX tokens of 768 a window, batch AU_BATCH; a forward and
# the gradient of Σ out² over the parameters and the input, AU_CALLS times
# (the first call and a warm one)
AU_BATCH, AU_LEN, AU_CTX, AU_CALLS = 4, 131072 // 32, 32, 2
# the diffusion prior at PriorConfig() (run "prior", fp32): PR_STEPS
# p_losses steps at batch PR_BATCH with optax-style Adam, then
# PR_SAMPLE_CALLS sample calls at batch PR_SAMPLE_BATCH, PR_SAMPLE_STEPS
# strided steps at CFG PR_COND_SCALE (two network calls a step)
PR_BATCH, PR_STEPS, PR_LR = 64, 3, 1e-4
PR_SAMPLE_BATCH, PR_SAMPLE_STEPS, PR_COND_SCALE, PR_SAMPLE_CALLS = (
    16, 50, 3.0, 2)
# EncoderUNetModel at CLASSIFIER_BACKBONE's widths (run "encoder_unet",
# fp32) at each pool over EN_BATCH latents of LATENT_HW: the forward and
# the gradient of the summed output over the input, EN_CALLS times a pool
EN_BATCH, EN_CALLS = 16, 2
# the other conditioning (run "other_cond", column o): the AR cond encoder
# at its reference defaults (hidden 512, embed 768, depth 2, seq_len 215,
# 8 heads of D 64) over stage 2's training batch AR_BATCH, AR_TOKENS video
# features of 512 and the previous window's latent of LATENT_HW × 4: a
# forward and the gradient of Σ out² over the inputs and the parameters,
# AR_CALLS times in fp32, then as many in bf16. Then the 860M LDM_UNET in
# bf16 at batch OC_BATCH through LatentDiffusion.apply_model, OC_CALLS
# calls (the first and a warm one) of each variant, one UNet built at a
# time: {variant: (conditioning key, UNet config changes, context tokens;
# 0: none)}: concat (8 input channels, no context), hybrid (8 and the cond
# encoder's context), adm (OC_CLASSES classes, VGGSound's, no context),
# ResBlock positions over OC_POS latent steps with the cond encoder's
# context, and crossattn over one ClassEmbedder(768, OC_CLASSES) token
AR_BATCH, AR_TOKENS, AR_CALLS = 16, 32, 2
OC_BATCH, OC_CALLS, OC_CLASSES, OC_POS = 2, 2, 309, 64
OC_VARIANTS = {"concat": ("concat", dict(in_channels=8), 0),
               "hybrid": ("hybrid", dict(in_channels=8), WINDOW_FEATS),
               "adm": ("adm", dict(num_classes=OC_CLASSES), 0),
               "pos": ("crossattn", dict(pos_seq_len=OC_POS), WINDOW_FEATS),
               "class": ("crossattn", {}, 1)}
# the other first stages (run "first_stages", column f), fp32 at batch
# FS_BATCH: a forward and the gradient of Σ out² over the input and the
# parameters, FS_CALLS times each: (name, module, NHWC input shape)
FS_BATCH, FS_CALLS = 2, 2
FIRST_STAGES = (
    ("rescaler", lambda: LatentRescaler(2.0, 4, 512, 512, depth=2),
     (FS_BATCH, *LATENT_HW, 4)),
    ("upsample", lambda: UpsampleDecoder(512, 3, 128, 2, (2, 2)),
     (FS_BATCH, *LATENT_HW, 512)),
    ("simple", lambda: SimpleDecoder(128, 3), (FS_BATCH, 32, 128, 128)))
# cli.profile on the card (run "profile", column q): every family at batch
# Q_BATCH in fp32, the UNet's and the classifier's cross-attention over the
# JAX profiler's 40 tokens; each line's forward runs once under
# cost_analysis, once warm and TIME_ITERS times timed
Q_BATCH, Q_TOKENS = 1, 40
Q_CALLS = 2 + profile_cli.TIME_ITERS
# train/scan.py (run "scan", column k): the classifier's trainer at
# CLASSIFIER_BACKBONE in fp32 at the CLI's batch over data/synthetic.py's
# SC_ITEMS items (the frozen SD VAE's posterior moments and the features
# resident on the card, gathered by an index_fn): SC_K scanned steps and
# SC_K sequential steps from the same state and draws, with cuDNN
# deterministic and then with its defaults, then four timed loops of SC_K
# steps (SC_STEPS in all)
SC_BATCH, SC_K, SC_ITEMS = C_BATCH, 4, 64
SC_STEPS = 8 * SC_K
# stage 2 with dropout and block recompute (run "dropout_remat", column m):
# LDM_UNET in bf16 on fp32 masters at stage 2's batch and tokens, dropout
# DR_RATE, the gradients of one step without the recompute and under each
# of DR_POLICIES (the same draws), then AdamW once
DR_RATE, DR_POLICIES = 0.1, ("none", "dots", "dots_no_batch")
DR_CALLS = 1 + len(DR_POLICIES)
# the stage-2 CLI's SoundLogger: every SL_EVERY steps of the main-path
# call (SL_CALLS calls), SL_N items (the UNet at the CFG batch 2·SL_N,
# the VAE encoder once and the decoder twice at SL_N), the JAX logger's
# 25 DPM-Solver++ steps at CFG 6.5 with no classifier
SL_N, SL_EVERY = 2, 3
SL_CALLS = S2_STEPS // SL_EVERY
# the waveform VAE's trainer at the CLI's own width and crop: channels 32,
# z 128, 65536-sample crops, batch 8, AudioGANConfig's defaults; steps of
# the main-path call (a resume adds one)
SV_WINDOW, SV_BATCH, SV_STEPS = 65536, 8, 6
# the sampler library (``sampler_phase``): 1 window × SP_SAMPLES samples
# (the UNet at the CFG batch 4, the classifier gradient at 2, bf16), CFG
# 4.5 and classifier guidance 50; the DPM-Solver and DDIM calls take
# SP_STEPS steps (cut to fit the smoke's time limit), PLMS
# 25, the ancestral chains SP_CHAIN timesteps; img2img
# enters a 25-step DDIM run at index 12. The tiled calls run on a
# TILED_CANVAS latent: the decode at the JAX defaults (ks 16×16, stride
# 8×8, vqf 8: 15 tiles of 128×128 pixels a sample, TILED_TILES·2 rows in
# one decoder call), the UNet at ks (16, 64), stride (16, 32) (3 tiles
# at the trained window)
SP_SAMPLES, SP_STEPS, SP_CHAIN, SP_PLMS = 2, 6, 25, 25
SP_IMG2IMG = (25, 12)
TILED_CANVAS, TILED_TILES = (16, 128), 15
# the phase's work in the units its launches scale with: guided model
# calls (the bf16 UNet at the CFG batch 2·SP_SAMPLES, the bf16
# classifier's forward and gradient at SP_SAMPLES), UNet calls over the
# tiled canvas's 3·SP_SAMPLES tiles, tiled decodes, the ancestral
# inpaint's VAE encode (one window) and decode (SP_SAMPLES), and
# cli.generate's model calls and decodes at the video run's shapes
SP_UNITS = ("guided", "tiled_unet", "tiled_decode", "inpaint_vae",
            "video_nfe", "video_decode")
# the SoundLogger's UNet shapes are the guided call's
assert SL_N == SP_SAMPLES and S2_TOKENS == WINDOW_FEATS
SAMPLER_CALLS = (
    ("dpm-multistep-order1", "dpm", SP_STEPS, dict(order=1)),
    ("dpm-multistep-order3", "dpm", SP_STEPS, dict(order=3)),
    ("dpm-logSNR", "dpm", SP_STEPS, dict(skip_type="logSNR")),
    ("dpm-time_quadratic", "dpm", SP_STEPS,
     dict(skip_type="time_quadratic")),
    ("dpm-taylor", "dpm", SP_STEPS, dict(solver_type="taylor")),
    ("dpm-predict_eps", "dpm", SP_STEPS, dict(predict_x0=False)),
    ("dpm-thresholding", "dpm", SP_STEPS, dict(thresholding=True)),
    ("dpm-denoise_to_zero", "dpm", SP_STEPS, dict(denoise_to_zero=True)),
    ("dpm-model_x_start", "dpm", SP_STEPS, dict(model_type="x_start")),
    ("dpm-model_v", "dpm", SP_STEPS, dict(model_type="v")),
    ("dpm-singlestep-order3-logSNR", "dpm", SP_STEPS,
     dict(method="singlestep", order=3, skip_type="logSNR")),
    ("dpm-singlestep_fixed-order2", "dpm", SP_STEPS,
     dict(method="singlestep_fixed", order=2)),
    ("dpm-adaptive-order2", "dpm", SP_STEPS, dict(method="adaptive",
                                                  order=2)),
    ("dpm-adaptive-order3", "dpm", SP_STEPS, dict(method="adaptive",
                                                  order=3)),
    ("ddim-eta1-quad-dropout", "ddim", SP_STEPS,
     dict(eta=1.0, discr_method="quad", noise_dropout=0.1)),
    ("plms", "plms", SP_PLMS, {}),
    ("p_sample_loop", "ancestral", 0, dict(timesteps=SP_CHAIN)),
    ("progressive_denoising", "progressive", 0,
     dict(timesteps=SP_CHAIN, log_every_t=20)),
)
# Agreement with the plain version, per output tensor, against the size of
# the plain output: max|Δ| ≤ MAX_TOL·rms(plain) and rms(Δ) ≤ RMS_TOL·rms(plain).
# The max catches a local fault (a tile, an edge), the rms a small fault
# spread over every element. Each limit is a few times the largest ratio
# the kernels reach at the path's shapes; a planted fault per kernel must
# exceed them (see FAULTS). Kinds: packed forward and backward, per-head
# forward and backward, GroupNorm block, stream stats (fp32 partial sums)
# and apply.
BF16, FP32 = torch.bfloat16, torch.float32
# The apply kernel repeats the plain version's fp32 operations and roundings
# exactly (measured Δ 0); its limits allow one bf16 rounding step.
MAX_TOL = {("fwd", BF16): 0.06, ("fwd", FP32): 5e-6,
           ("bwd", BF16): 0.25, ("bwd", FP32): 1e-5,
           ("head", BF16): 0.06, ("head", FP32): 1.5e-5,
           ("head_bwd", BF16): 0.25, ("head_bwd", FP32): 2e-5,
           ("gn", BF16): 0.15, ("gn", FP32): 1e-5,
           ("stats", BF16): 1e-6, ("stats", FP32): 1e-6,
           ("apply", BF16): 0.02, ("apply", FP32): 1e-6}
RMS_TOL = {("fwd", BF16): 4e-4, ("fwd", FP32): 3e-7,
           ("bwd", BF16): 0.015, ("bwd", FP32): 5e-7,
           ("head", BF16): 4e-4, ("head", FP32): 1e-6,
           ("head_bwd", BF16): 0.015, ("head_bwd", FP32): 1.5e-6,
           ("gn", BF16): 2e-4, ("gn", FP32): 4e-7,
           ("stats", BF16): 3e-7, ("stats", FP32): 3e-7,
           ("apply", BF16): 1e-4, ("apply", FP32): 1e-7}
KERNELS = {
    "attn_packed_fwd": ("diff_foley_tpu_torch/csrc/attention_fwd.cu",
                        "diff_foley_tpu/ops/pallas_attention.py:294"),
    "attn_packed_bwd": ("diff_foley_tpu_torch/csrc/attention_bwd.cu",
                        "diff_foley_tpu/ops/pallas_attention.py:400"),
    "attn_fwd": ("diff_foley_tpu_torch/csrc/attention_head_fwd.cu",
                 "diff_foley_tpu/ops/pallas_attention.py:58"),
    "attn_bwd": ("diff_foley_tpu_torch/csrc/attention_head_bwd.cu",
                 "diff_foley_tpu/ops/pallas_attention.py:142"),
    "gn_block": ("diff_foley_tpu_torch/csrc/groupnorm.cu",
                 "diff_foley_tpu/ops/pallas_groupnorm.py:78"),
    "gn_stream_stats": ("diff_foley_tpu_torch/csrc/groupnorm.cu",
                        "diff_foley_tpu/ops/pallas_groupnorm.py:195"),
    "gn_stream_apply": ("diff_foley_tpu_torch/csrc/groupnorm.cu",
                        "diff_foley_tpu/ops/pallas_groupnorm.py:212"),
}
# the symbols of each kind's kernels, as the profiler names them
SYMBOLS = {"fwd": ("attn_packed_fwd",), "bwd": ("head_bwd_",),
           "head": ("head_fwd_",), "head_bwd": ("head_bwd_",),
           "gn": ("gn_block_kernel",), "stats": ("gn_stream_stats_kernel",),
           "apply": ("gn_stream_apply_kernel",)}
RUNS = ("generate", "inpaint", "train_vae", "video", "train_stage2",
        "train_classifier", "align_acc", "serve", "sound_log",
        "train_sound_vae", "samplers", "decode", "audio_unet", "prior",
        "encoder_unet", "other_cond", "first_stages", "profile", "scan",
        "dropout_remat")


def calls(generate: int = 0, inpaint: int = 0, train_vae: int = 0,
          video: int = 0, train_stage2: int = 0, train_classifier: int = 0,
          align_acc: int = 0, serve: int = 0, sound_log: int = 0,
          train_sound_vae: int = 0, samplers: int = 0,
          decode: int = 0, audio_unet: int = 0, prior: int = 0,
          encoder_unet: int = 0, other_cond: int = 0,
          first_stages: int = 0, profile: int = 0, scan: int = 0,
          dropout_remat: int = 0) -> dict:
    """Calls of one kernel shape in each main-path run."""
    return {"generate": generate, "inpaint": inpaint, "train_vae": train_vae,
            "video": video, "train_stage2": train_stage2,
            "train_classifier": train_classifier, "align_acc": align_acc,
            "serve": serve, "sound_log": sound_log,
            "train_sound_vae": train_sound_vae, "samplers": samplers,
            "decode": decode, "audio_unet": audio_unet, "prior": prior,
            "encoder_unet": encoder_unet, "other_cond": other_cond,
            "first_stages": first_stages, "profile": profile, "scan": scan,
            "dropout_remat": dropout_remat}


class Units(dict):
    """A count linear in the sampler phase's units, {unit: coefficient}.
    The kernel phase runs before the sampler phase, whose adaptive calls
    set the units, so its rows credit the phase such sums
    (``unit_sums``), and ``resolve_units`` turns them into counts."""

    def __mul__(self, k: int) -> "Units":
        return Units({u: c * k for u, c in self.items()})

    __rmul__ = __mul__

    def __add__(self, other) -> "Units":
        if isinstance(other, int) and other == 0:
            return self
        out = Units(self)
        for u, c in other.items():
            out[u] = out.get(u, 0) + c
        return out

    __radd__ = __add__


def unit_sums() -> dict:
    """Each of ``SP_UNITS`` as a ``Units`` of itself."""
    return {u: Units({u: 1}) for u in SP_UNITS}


def resolve_units(rows, sp: dict) -> None:
    """The sampler phase's credit of each kernel-phase row, from the
    ``Units`` sum it was given to the count that the units ``sp`` make."""
    for _, r in rows:
        n = r.get("calls", {}).get("samplers", 0)
        if isinstance(n, Units):
            r["calls"]["samplers"] = sum(c * sp[u] for u, c in n.items())


def sp_units(**units) -> dict:
    """The sampler phase's units (``SP_UNITS``), zero where not given."""
    if not set(units) <= set(SP_UNITS):
        raise KeyError(f"unknown sampler units {set(units) - set(SP_UNITS)}")
    return {u: units.get(u, 0) for u in SP_UNITS}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the H100's L2 holds 50 MB: ``device_ms`` reads a buffer of five times
# that before each call, so that no operand of the call is left there and
# the call reads its bytes from HBM, as its byte bound counts them
L2_FLUSH_BYTES = 256 * 2**20
_FLUSH_SYMBOLS = set()


def flush_l2(buf: torch.Tensor) -> torch.Tensor:
    # a read, not a write: written lines would go back to HBM while the
    # timed call runs
    return buf.sum(dtype=torch.int64)


def device_ms(fn, symbols=None, iters: int = 10, split: bool = False):
    """Device time per call of fn: torch.profiler's CUDA events over
    ``iters`` calls, each after ``flush_l2`` (whose kernels are left
    out), only those whose names hold one of ``symbols`` (all when None),
    summed and divided by the calls; with ``split`` also {kernel: ms per
    call} by kernel name. Some traces come back without any device event
    (the first row of a run), or with a count of the call's events that
    the calls do not divide (events lost): up to five are tried. A trace
    with device events but none of ``symbols`` fails; five with no device
    event at all raise ``ProfilerBlind``: the profiler cannot see the card
    in this process, and the script runs again in a new one. Five that
    lost events fall back to CUDA events around each call (``event_ms``):
    the call's whole time, other kernels of the call included, with no
    split; ``DEVICE_MS_FALLBACKS`` names them, and the caller labels the
    number so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    buf = torch.ones(L2_FLUSH_BYTES, dtype=torch.int8, device="cuda")
    for _ in range(0 if _FLUSH_SYMBOLS else 5):   # the flush's kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush_l2(buf)
            torch.cuda.synchronize()
        _FLUSH_SYMBOLS.update(e.name for e in prof.events()
                              if e.device_type == DeviceType.CUDA)
        if _FLUSH_SYMBOLS:
            break
    else:
        if not _FLUSH_SYMBOLS:
            raise ProfilerBlind("torch.profiler recorded no device event in "
                                "five traces of the L2 flush")
    fn()
    torch.cuda.synchronize()
    seen, lost = set(), 0   # device event names of every trace; lost count
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush_l2(buf)
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [e for e in events if e.name not in _FLUSH_SYMBOLS and (
            symbols is None or any(s in e.name for s in symbols))]
        seen.update(e.name[:60] for e in events)
        if len(mine) % iters:
            # every call launches the same kernels: a count that the calls
            # do not divide is a trace that lost events; tried again
            lost = len(mine)
            PROFILER_RETRIES.append(symbols)
            log(f"device_ms: {lost} events of {symbols or 'the call'} over "
                f"{iters} calls; tracing again")
            continue
        if mine:
            total = sum(e.time_range.elapsed_us() for e in mine) / 1e3 / iters
            if not split:
                return total
            by = collections.Counter()
            for e in mine:
                name = e.name.split("(")[0].split("<")[0].split("::")[-1]
                by[name] += e.time_range.elapsed_us() / 1e3 / iters
            return total, dict(by)
    if not seen:
        raise ProfilerBlind(f"torch.profiler recorded no device event in "
                            f"five traces of {symbols or 'any kernel'}")
    if not lost:
        raise AssertionError(f"torch.profiler shows no device time for "
                             f"{symbols or 'any kernel'} (device events: "
                             f"{sorted(seen)[:5]})")
    DEVICE_MS_FALLBACKS.append(symbols)
    total = event_ms(fn, buf, iters)
    log(f"device_ms: torch.profiler lost events of {symbols or 'the call'} "
        f"in five traces ({lost} events over {iters} calls); CUDA events "
        f"around each call give {total:.6f} ms")
    return (total, {}) if split else total


# the symbols of each trace that lost events, and of each ``device_ms``
# that fell back to ``event_ms``
PROFILER_RETRIES = []
DEVICE_MS_FALLBACKS = []


def event_ms(fn, buf: torch.Tensor, iters: int) -> float:
    """Mean device time of fn's calls, each after ``flush_l2``, each
    between two CUDA events on the current stream."""
    pairs = []
    for _ in range(iters):
        flush_l2(buf)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


class ProfilerBlind(AssertionError):
    """No trace of ``device_ms`` held a device event."""


def reset_counts():
    ha.reset_launch_counts()
    hg.reset_launch_counts()


def read_counts() -> dict:
    """{"kernel/dtype": launches} since the last reset."""
    both = {**ha.LAUNCHES_BY_DTYPE, **hg.LAUNCHES_BY_DTYPE}
    return {f"{k}/{dt}": n for (k, dt), n in sorted(both.items()) if n}


def saved_counts() -> list:
    return [(dict(m.LAUNCHES), collections.Counter(m.LAUNCHES_BY_DTYPE))
            for m in (ha, hg)]


def add_counts(saved: list) -> None:
    for m, (launches, by_dtype) in zip((ha, hg), saved):
        for k, n in launches.items():
            m.LAUNCHES[k] += n
        m.LAUNCHES_BY_DTYPE.update(by_dtype)


def by_kernel(counts: dict) -> dict:
    """{kernel: launches} of a ``read_counts`` dict, every kernel listed."""
    return {name: sum(n for key, n in counts.items()
                      if key.split("/")[0] == name) for name in KERNELS}


# ---- the path's shapes, from the model structure ----------------------------

def attention_sites(name: str, cfg: UNetConfig, batch: int, lk: int,
                    up: bool):
    """(tag, batch, Lq, Lk, H·D, heads, calls per forward) of the self and
    the cross attention of each SpatialTransformer level of a UNet (``up``)
    or the classifier's half UNet."""
    # transformers per attention level: down blocks, and the UNet's up
    blocks = cfg.num_res_blocks + (cfg.num_res_blocks + 1 if up else 0)
    sites = [(str(lv), lv, blocks) for lv in range(len(cfg.channel_mult))
             if 2**lv in cfg.attention_resolutions]
    sites.append(("mid", len(cfg.channel_mult) - 1, 1))
    out = []
    for tag, lv, n_blocks in sites:
        L = (LATENT_HW[0] >> lv) * (LATENT_HW[1] >> lv)
        hd = cfg.channel_mult[lv] * cfg.model_channels
        per = n_blocks * cfg.transformer_depth
        out.append((f"{name}-{tag}-self", batch, L, L, hd, cfg.num_heads,
                    per))
        out.append((f"{name}-{tag}-cross", batch, L, lk, hd, cfg.num_heads,
                    per))
    return out


def path_shapes(n: int, lk: int):
    """(tag, batch, Lq, Lk, H·D, heads, calls per sampler step) of every
    attention on the sampling paths: the UNet at the CFG batch, the
    classifier at the sample batch."""
    return (attention_sites("unet", LDM_UNET, 2 * n, lk, True)
            + attention_sites("clf", CLASSIFIER_BACKBONE, n, lk, False))


def module_maps(model, hw):
    """(module, h, w) of each module of ``model`` in registration order,
    with the map size it sees. The models register their children in the
    order the forward runs them; each Down/Upsample halves/doubles the
    map, a NearestResize takes it to its size."""
    h, w = hw
    for m in model.modules():
        if isinstance(m, (Downsample, VAEDownsample)):
            h, w = h // 2, w // 2
        elif isinstance(m, (Upsample, VAEUpsample)):
            h, w = 2 * h, 2 * w
        elif isinstance(m, NearestResize):
            h, w = m.out_hw(h, w)
        yield m, h, w


def gn_sites(model, hw):
    """(channels, h, w, eps, act) of each GroupNorm32 call of one
    forward."""
    return [(m.weight.shape[0], h, w, m.eps, m.act)
            for m, h, w in module_maps(model, hw)
            if isinstance(m, GroupNorm32)]


def gn_kernels(channels: int, h: int, w: int, itemsize: int):
    """The GroupNorm kernels one call at this map launches (the wrapper's
    size rule)."""
    if hg.uses_stream((1, channels, h, w), 32, itemsize):
        return ("gn_stream_stats", "gn_stream_apply")
    return ("gn_block",)


def decode_sites():
    """The spec decoder at ``DecodeConfig``'s defaults, built on the meta
    device: (the GroupNorm sites of one forward over its (1, DEC_T/16)
    canvas, as ``gn_sites``; the canvas steps, its mid attention's
    length; the mid attention's head dim)."""
    cfg = DecodeConfig()
    with torch.device("meta"):
        dec = Decoder(cfg.decoder, in_channels=cfg.feat_dim)
    t = DEC_T // 16   # CNN14 pools time 16-fold
    return gn_sites(dec, (1, t)), t, cfg.decoder.ch * cfg.decoder.ch_mult[-1]


def gn_path(pipe, n: int, steps: int, sp=None):
    """{(model, batch, channels, h, w, eps, act, dtype): {run: calls}} of
    every GroupNorm32 call in one generate, one inpaint, one train_vae,
    one video, one train_stage2, one train_classifier and one align_acc
    run. The trainer's VAE has the pipeline's structure, in float32, and so
    has the video run's classifier; only their forwards launch GroupNorm
    kernels. Stage 2 runs the UNet and the frozen VAE encoder in bf16 at
    its batch, once in each train and validation forward. The classifier's
    trainer and align-acc run the classifier and the frozen VAE encoder in
    float32 at their batches, once a step or a batch. The serving run (one
    bucket-16 call of one sample) runs the UNet, the classifier and the
    decoder as ``generate`` does, at the bucket's batches. The stage-2
    CLI's SoundLogger (``sound_log``) runs the UNet bf16 at the CFG batch
    2·SL_N each sampler step, the VAE encoder once and its decoder twice
    at SL_N a call in fp32 (the VAE's fp32 weights swapped in, as the JAX
    logger decodes). The waveform VAE's trainer runs no GroupNorm. The
    sampler phase (``samplers``) runs ``sp``'s units (``sp_units``): a
    guided call the UNet at the SoundLogger's batch and the classifier at
    SP_SAMPLES, a tiled UNet call the UNet at 3·SP_SAMPLES, a tiled decode
    the decoder on 16×16 tiles at TILED_TILES·SP_SAMPLES rows, the
    ancestral inpaint the encoder at one window and the decoder at
    SP_SAMPLES, and cli.generate the video run's models, all bf16 but the
    video run's classifier. Run k's (``scan``) steps are the classifier
    trainer's at its batch on posterior moments (no encode); run m's
    (``dropout_remat``) gradient calls run the UNet's forward at stage 2's
    batch, once each (the recomputed blocks hold no GroupNorm32). Run q's
    fp32 norms are ``profile_gn_sites``'."""
    vae = pipe.ldm.vae
    sp = sp_units(**(sp or {}))
    models = (("unet", pipe.ldm.unet, LATENT_HW, 2 * n, BF16,
               calls(steps, steps, video=steps, samplers=sp["video_nfe"])),
              ("clf", pipe.classifier, LATENT_HW, n, BF16, calls(steps, steps)),
              ("clf", pipe.classifier, LATENT_HW, n, FP32,
               calls(video=steps, samplers=sp["video_nfe"])),
              ("vae-dec", vae.decoder, LATENT_HW, n, BF16,
               calls(1, 1, video=1, samplers=sp["video_decode"])),
              ("vae-enc", vae.encoder, SPEC_HW, WINDOWS, BF16, calls(0, 1)),
              ("train-enc", vae.encoder, SPEC_HW, TRAIN_BATCH, FP32,
               calls(train_vae=TRAIN_STEPS)),
              ("train-dec", vae.decoder, LATENT_HW, TRAIN_BATCH, FP32,
               calls(train_vae=TRAIN_STEPS)),
              ("s2-unet", pipe.ldm.unet, LATENT_HW, S2_BATCH, BF16,
               calls(train_stage2=S2_FORWARDS, dropout_remat=DR_CALLS)),
              ("s2-enc", vae.encoder, SPEC_HW, S2_BATCH, BF16,
               calls(train_stage2=S2_FORWARDS)),
              ("c-clf", pipe.classifier, LATENT_HW, C_BATCH, FP32,
               calls(train_classifier=C_STEPS, scan=SC_STEPS)),
              ("c-enc", vae.encoder, SPEC_HW, C_BATCH, FP32,
               calls(train_classifier=C_STEPS)),
              ("a-clf", pipe.classifier, LATENT_HW, AA_BATCH, FP32,
               calls(align_acc=AA_CALLS)),
              ("a-enc", vae.encoder, SPEC_HW, AA_BATCH, FP32,
               calls(align_acc=AA_CALLS)),
              ("e-unet", pipe.ldm.unet, LATENT_HW, 2 * SERVE_BUCKET, BF16,
               calls(serve=steps)),
              ("e-clf", pipe.classifier, LATENT_HW, SERVE_BUCKET, BF16,
               calls(serve=steps)),
              ("e-dec", vae.decoder, LATENT_HW, SERVE_BUCKET, BF16,
               calls(serve=1)),
              ("sl-unet", pipe.ldm.unet, LATENT_HW, 2 * SL_N, BF16,
               calls(sound_log=SL_CALLS * steps, samplers=sp["guided"])),
              ("sl-enc", vae.encoder, SPEC_HW, SL_N, FP32,
               calls(sound_log=SL_CALLS)),
              ("sl-dec", vae.decoder, LATENT_HW, SL_N, FP32,
               calls(sound_log=2 * SL_CALLS)),
              ("d-clf", pipe.classifier, LATENT_HW, SP_SAMPLES, BF16,
               calls(samplers=sp["guided"])),
              ("dt-unet", pipe.ldm.unet, LATENT_HW, 3 * SP_SAMPLES, BF16,
               calls(samplers=sp["tiled_unet"])),
              ("dt-dec", vae.decoder, (16, 16), TILED_TILES * SP_SAMPLES,
               BF16, calls(samplers=sp["tiled_decode"])),
              ("d-enc", vae.encoder, SPEC_HW, 1, BF16,
               calls(samplers=sp["inpaint_vae"])),
              ("d-dec", vae.decoder, LATENT_HW, SP_SAMPLES, BF16,
               calls(samplers=sp["inpaint_vae"])))
    out = collections.defaultdict(calls)
    for name, model, hw, batch, dtype, per_run in models:
        for site in gn_sites(model, hw):
            total = out[(name, batch, *site, dtype)]
            for run in RUNS:
                total[run] += per_run[run]
    return out


def predicted_launches(pipe, steps: int, sp=None):
    """{run: {"kernel/dtype": launches}} from the module structure. The
    UNet and the VAE run bf16 in every sampling run; the classifier bf16 in
    generate, inpaint and serve, fp32 in the video run (as the JAX
    package's ``DiffFoley``). A launch serves the whole batch, so one
    bucket-16 serving call launches what one ``generate`` does. The classifier backward recomputes GroupNorm through
    the plain formula, so only its forward launches GroupNorm kernels; so
    does the UNet's in stage-2 training. The sampler phase's launches
    follow its units ``sp`` (``sp_units``)."""
    count = lambda m: sum(2 * x.depth for x in m.modules()
                          if isinstance(x, SpatialTransformer))
    unet, clf = count(pipe.ldm.unet), count(pipe.classifier)
    pred = {run: collections.Counter() for run in RUNS}
    clf_dtype = {"generate": "bfloat16", "inpaint": "bfloat16",
                 "video": "float32", "serve": "bfloat16"}
    for run, dt in clf_dtype.items():
        pred[run]["attn_packed_fwd/bfloat16"] += steps * unet
        pred[run][f"attn_packed_fwd/{dt}"] += steps * clf
        pred[run][f"attn_packed_bwd/{dt}"] += steps * clf
        # the VAE's mid attention: the decoder, and in inpaint the encoder
        pred[run]["attn_fwd/bfloat16"] += 2 if run == "inpaint" else 1
    # a train step: the encoder's and the decoder's mid attention, forward
    # and backward once each. The two autograd.grad probes of the adaptive
    # weight stop at the decoder's last kernel and add none.
    pred["train_vae"]["attn_fwd/float32"] = 2 * TRAIN_STEPS
    pred["train_vae"]["attn_bwd/float32"] = 2 * TRAIN_STEPS
    # stage 2 (mixed precision, no block recompute): the UNet's attention
    # forward in each train and validation forward, its backward in each
    # train step; the frozen encoder's mid attention once a forward, never
    # differentiated
    s2 = pred["train_stage2"]
    s2["attn_packed_fwd/bfloat16"] = S2_FORWARDS * unet
    s2["attn_packed_bwd/bfloat16"] = S2_STEPS * unet
    s2["attn_fwd/bfloat16"] = S2_FORWARDS
    # the classifier's trainer (fp32): its attention forward and backward
    # (the parameters' gradients) once a step; the frozen encoder's mid
    # attention once a step, never differentiated (kernel 4: 0). align-acc:
    # one forward of each a batch
    c = pred["train_classifier"]
    c["attn_packed_fwd/float32"] = C_STEPS * clf
    c["attn_packed_bwd/float32"] = C_STEPS * clf
    c["attn_fwd/float32"] = C_STEPS
    a = pred["align_acc"]
    a["attn_packed_fwd/float32"] = AA_CALLS * clf
    a["attn_fwd/float32"] = AA_CALLS
    # the SoundLogger: the UNet's attention forward each sampler step (no
    # classifier: no backward), the fp32 VAE's mid attention in the encode
    # and the two decodes; the waveform VAE's trainer: no kernel at all
    sl = pred["sound_log"]
    sl["attn_packed_fwd/bfloat16"] = SL_CALLS * steps * unet
    sl["attn_fwd/float32"] = 3 * SL_CALLS
    # the sampler phase: a guided call runs the UNet and the classifier's
    # forward and gradient, a tiled UNet call the UNet alone; the VAE's
    # mid attention once in each encode and decode
    sp = sp_units(**(sp or {}))
    d = pred["samplers"]
    d["attn_packed_fwd/bfloat16"] = (
        (sp["guided"] + sp["tiled_unet"] + sp["video_nfe"]) * unet
        + sp["guided"] * clf)
    d["attn_packed_bwd/bfloat16"] = sp["guided"] * clf
    d["attn_packed_fwd/float32"] = sp["video_nfe"] * clf
    d["attn_packed_bwd/float32"] = sp["video_nfe"] * clf
    d["attn_fwd/bfloat16"] = (2 * sp["inpaint_vae"] + sp["tiled_decode"]
                              + sp["video_decode"])
    for (_, _, c, h, w, _, _, dtype), per_run in gn_path(
            pipe, WINDOWS * SAMPLES, steps, sp).items():
        for k in gn_kernels(c, h, w, dtype.itemsize):
            for run in RUNS:
                pred[run][f"{k}/{str(dtype).split('.')[-1]}"] += per_run[run]
    # cli.profile (fp32): the UNet's and the classifier's attention forward
    # and the VAE's mid attention in the encode and the decode, Q_CALLS
    # times each; run k: the classifier trainer's steps; run m: the UNet's
    # attention forward in each gradient call and again in the backward
    # of each policy's recomputed blocks, its backward in each call
    q = pred["profile"]
    q["attn_packed_fwd/float32"] = Q_CALLS * (unet + clf)
    q["attn_fwd/float32"] = 2 * Q_CALLS
    for (c, h, w, _, _), n in profile_gn_sites(pipe).items():
        for k in gn_kernels(c, h, w, 4):
            q[f"{k}/float32"] += n
    k_run = pred["scan"]
    k_run["attn_packed_fwd/float32"] = SC_STEPS * clf
    k_run["attn_packed_bwd/float32"] = SC_STEPS * clf
    m = pred["dropout_remat"]
    m["attn_packed_fwd/bfloat16"] = (DR_CALLS + len(DR_POLICIES)) * unet
    m["attn_packed_bwd/bfloat16"] = DR_CALLS * unet
    pred["decode"].update(decode_launches())
    for run, c in other_launches().items():
        pred[run].update(c)
    for run, c in new_model_launches().items():
        pred[run].update(c)
    return {run: {k: n for k, n in sorted(c.items()) if n}
            for run, c in pred.items()}


def profile_gn_sites(pipe) -> collections.Counter:
    """{(channels, h, w, eps, act): calls} of run q's GroupNorm32 calls, all
    fp32 at Q_BATCH: the UNet and the classifier over the latent, the VAE
    encoder over the mel image and the decoder over the latent, each
    forward Q_CALLS times (the models the pipeline holds have cli.profile's
    structure)."""
    out = collections.Counter()
    for model, hw in ((pipe.ldm.unet, LATENT_HW), (pipe.classifier, LATENT_HW),
                      (pipe.ldm.vae.encoder, SPEC_HW),
                      (pipe.ldm.vae.decoder, LATENT_HW)):
        for site in gn_sites(model, hw):
            out[site] += Q_CALLS
    return out


def decode_launches() -> collections.Counter:
    """The spec decoder's run (fp32), MSE and GAN steps alike: one forward
    and one backward a step, so its mid attention forward and backward
    once each and every GroupNorm's forward once (the backward recomputes
    the plain formula); the frozen CNN14 and the PatchGAN launch
    nothing."""
    gns, _, _ = decode_sites()
    dec = collections.Counter()
    dec["attn_fwd/float32"] = dec["attn_bwd/float32"] = 2 * DEC_STEPS
    for c, h, w, _, _ in gns:
        for k in gn_kernels(c, h, w, 4):
            dec[f"{k}/float32"] += 2 * DEC_STEPS
    return dec


def audio_unet_sites(cfg: AudioUNetConfig = AudioUNetConfig(),
                     length: int = AU_LEN):
    """The audio UNet at ``cfg``, built on the meta device: (its GroupNorm32
    sites of one forward, (channels, length, eps, act); its attention
    sites, (tag, Lq, Lk, H·D, heads, calls per forward) of the self and the
    cross attention at each width). The model registers its children in
    the order the forward runs them, each stride-2 Conv1d halves the
    length and each Upsample1D doubles it."""
    with torch.device("meta"):
        model = AudioUNetModel(cfg)
    gns, attn, n = [], collections.Counter(), length
    for m in model.modules():
        if isinstance(m, Conv1d) and m.stride == 2:
            n //= 2
        elif isinstance(m, Upsample1D):
            n *= 2
        elif isinstance(m, GroupNorm32):
            gns.append((m.weight.shape[0], n, m.eps, m.act))
        elif isinstance(m, SpatialTransformer1D):
            attn[(n, m.proj_in.weight.shape[0])] += m.depth
    sites = []
    for (n, hd), per in attn.items():
        d = hd // cfg.num_heads
        sites.append((f"u-d{d}-self", n, n, hd, cfg.num_heads, per))
        sites.append((f"u-d{d}-cross", n, AU_CTX, hd, cfg.num_heads, per))
    return gns, sites


def encoder_unet_sites(pool: str, cfg: UNetConfig = CLASSIFIER_BACKBONE,
                       hw=LATENT_HW):
    """EncoderUNetModel at ``cfg`` with ``pool``, on the meta device: (its
    GroupNorm32 sites of one forward as ``gn_sites``, the spatial_v2
    head's over its (B, 2048, 1, 1) features; its SpatialTransformers'
    (Lq, H·D) with their attention calls per forward, self and cross
    alike: with no context the cross attention reads the tokens; the
    attention pool's (Lq, Lk, H·D), or None)."""
    with torch.device("meta"):
        model = EncoderUNetModel(cfg, pool, hw=hw)
    gns = gn_sites(model, hw)
    if pool == "spatial_v2":   # the head's norm, registered last
        gns[-1] = (gns[-1][0], 1, 1) + gns[-1][3:]
    h, w = hw
    attn = collections.Counter()
    for m in model.modules():
        if isinstance(m, Downsample):
            h, w = h // 2, w // 2
        elif isinstance(m, SpatialTransformer):
            attn[(h * w, m.proj_in.weight.shape[0])] += 2 * m.depth
    pool_site = None
    if pool == "attention":
        pos = model.attn_pool.pos_emb
        pool_site = (1, pos.shape[0], pos.shape[1])
    return gns, attn, pool_site


def new_model_launches() -> dict:
    """{run: Counter of "kernel/dtype" launches} of the three fp32 runs.
    The audio UNet: each call's forward launches kernel 1 at each
    attention and the GroupNorm kernels at each GroupNorm32, its backward
    kernel 2 at each attention (the GroupNorm backward is the plain
    formula). The prior: kernel 3 once a block in every network call
    (one a p_losses step, two a sampler step at CFG ≠ 1), kernel 4 once a
    block a p_losses step (sampling takes no gradient). EncoderUNetModel
    at each pool: kernels 1 and 2 at each attention of its trunk, the
    GroupNorm kernels at each GroupNorm32, the attention pool kernels 3
    and 4 once."""
    out = {run: collections.Counter()
           for run in ("audio_unet", "prior", "encoder_unet")}
    gns, sites = audio_unet_sites()
    u = out["audio_unet"]
    per = sum(site[-1] for site in sites)
    u["attn_packed_fwd/float32"] = u["attn_packed_bwd/float32"] = \
        AU_CALLS * per
    for c, n, _, _ in gns:
        for k in gn_kernels(c, 1, n, 4):
            u[f"{k}/float32"] += AU_CALLS
    depth = PriorConfig().depth
    p = out["prior"]
    p["attn_fwd/float32"] = depth * (
        PR_STEPS + PR_SAMPLE_CALLS * 2 * PR_SAMPLE_STEPS)
    p["attn_bwd/float32"] = depth * PR_STEPS
    e = out["encoder_unet"]
    for pool in POOLS:
        gns, attn, pool_site = encoder_unet_sites(pool)
        e["attn_packed_fwd/float32"] += EN_CALLS * sum(attn.values())
        e["attn_packed_bwd/float32"] += EN_CALLS * sum(attn.values())
        for c, h, w, _, _ in gns:
            for k in gn_kernels(c, h, w, 4):
                e[f"{k}/float32"] += EN_CALLS
        if pool_site is not None:
            e["attn_fwd/float32"] += EN_CALLS
            e["attn_bwd/float32"] += EN_CALLS
    return out


def ar_depth() -> int:
    with torch.device("meta"):
        return VideoFeatEncoderPosembedAR().fusion_net.fusion_module.depth


def ar_sites():
    """(tag, Lq, Lk) of the AR encoder's attentions, each once a block:
    self over the video tokens, cross over the latent's h·w tokens."""
    return (("ar-self", AR_TOKENS, AR_TOKENS),
            ("ar-cross", AR_TOKENS, LATENT_HW[0] * LATENT_HW[1]))


def oc_attention_sites() -> collections.Counter:
    """{(level, Lq, Lk, H·D): kernel-1 calls} over run o's UNet calls.
    With no context (concat, adm) each cross-attention reads the tokens:
    Lk = Lq, the self-attention's shape; the class token gives Lk 1."""
    out = collections.Counter()
    for key, _, lk in OC_VARIANTS.values():
        for tag, _, lq, lk_, hd, _, per in attention_sites(
                "o-unet", LDM_UNET, OC_BATCH, lk, True):
            if tag.endswith("cross") and lk == 0:
                lk_ = lq
            out[(tag.split("-")[2], lq, lk_, hd)] += OC_CALLS * per
    return out


def oc_gn_sites() -> collections.Counter:
    """{GroupNorm32 site: calls in one UNet forward}; the variants change
    the input conv, the time embedding and the ResBlocks' sums, not a
    norm."""
    with torch.device("meta"):
        unet = UNetModel(LDM_UNET)
    return collections.Counter(gn_sites(unet, LATENT_HW))


def first_stage_sites():
    """Run f's ({GroupNorm32 site: calls}, [(L, D) of each attention
    block, one per call]) over its FS_CALLS calls of each first stage."""
    gns, attn = collections.Counter(), []
    for _, build, shape in FIRST_STAGES:
        with torch.device("meta"):
            model = build()
        for m, h, w in module_maps(model, shape[1:3]):
            if isinstance(m, GroupNorm32):
                gns[(m.weight.shape[0], h, w, m.eps, m.act)] += FS_CALLS
            elif isinstance(m, VAEAttnBlock):
                attn += [(h * w, m.q.weight.shape[0])] * FS_CALLS
    return gns, attn


def other_launches() -> dict:
    """{run: Counter of "kernel/dtype" launches} of runs o and f. The AR
    encoder: kernels 1 and 2 at each attention of its blocks, each call, in
    each dtype (it has no GroupNorm). The UNets: kernel 1 at each attention
    and the GroupNorm kernels at each GroupNorm32 of each forward (no
    gradient). The first stages: the GroupNorm kernels at each forward's
    norms (the backward is the plain formula), kernels 3 and 4 once a call
    at the rescaler's attention."""
    o, f = collections.Counter(), collections.Counter()
    per = AR_CALLS * ar_depth() * len(ar_sites())
    for dt in ("float32", "bfloat16"):
        o[f"attn_packed_fwd/{dt}"] += per
        o[f"attn_packed_bwd/{dt}"] += per
    o["attn_packed_fwd/bfloat16"] += sum(oc_attention_sites().values())
    for (c, h, w, _, _), n in oc_gn_sites().items():
        for k in gn_kernels(c, h, w, 2):
            o[f"{k}/bfloat16"] += n * len(OC_VARIANTS) * OC_CALLS
    gns, attn = first_stage_sites()
    for (c, h, w, _, _), n in gns.items():
        for k in gn_kernels(c, h, w, 4):
            f[f"{k}/float32"] += n
    f["attn_fwd/float32"] = f["attn_bwd/float32"] = len(attn)
    return {"other_cond": o, "first_stages": f}


# ---- the kernel phase ---------------------------------------------------------

# kernels that must run on the tensor cores: their SASS holds HMMA
TENSOR_CORE_KERNELS = {"attention_fwd": ("attn_packed_fwd_mma_kernel",),
                       "attention_bwd": ("head_bwd_scores_kernel",
                                         "head_bwd_products_kernel"),
                       "attention_head_fwd": ("head_fwd_scores_kernel",
                                              "head_fwd_products_kernel"),
                       "attention_head_bwd": ("head_bwd_scores_kernel",
                                              "head_bwd_products_kernel")}


def sass_functions(path) -> dict:
    """{kernel symbol: [its SASS instructions]} of a built library
    (``cuobjdump -sass``)."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = []
        elif fn is not None:
            m = re.search(r"/\*[0-9a-f]+\*/\s+([^;]*);", line)
            if m:
                out[fn].append(m.group(1).strip())
    return out


def sass_hmma() -> dict:
    """{source: {kernel symbol: HMMA instructions}} from ``cuobjdump -sass``
    of each built library; fails unless every instantiation of the
    tensor-core kernels holds some."""
    out = {}
    for name in cuda_build.SOURCES:
        counts = {f: sum("HMMA" in i for i in ins) for f, ins in
                  sass_functions(cuda_build.library_path(name)).items()}
        out[name] = counts
        for kernel in TENSOR_CORE_KERNELS.get(name, ()):
            found = {f: n for f, n in counts.items() if kernel in f}
            if not found or not all(found.values()):
                raise AssertionError(f"{kernel}: no HMMA in its SASS {found}")
    return out


def _opcode(instruction: str) -> str:
    words = instruction.split()
    return words[1] if words[0].startswith("@") else words[0]


def sass_fast_path(ins: list) -> list:
    """The instructions one thread of an apply kernel issues on a full
    tile with SiLU, every division in the fast range: from the entry, each
    conditional branch falls through (a full tile, SiLU on) but the two
    that skip the slow division, a branch on two predicates (finish_unit's
    ``if (slow)``) and the one after ``FCHK`` (``__fdiv_rn``'s range
    check); unconditional branches are taken; it ends at ``EXIT``. Hopper
    encodes each instruction in 16 bytes, so a target address over 16 is
    its index. None where the walk finds no ``EXIT``: a code layout it
    does not know."""
    path, i, fchk = [], 0, False
    while i < len(ins) and len(path) < 100000:
        op = _opcode(ins[i])
        path.append(op)
        if op == "EXIT" and not ins[i].startswith("@"):
            return path
        if op.startswith("BRA") and (
                not ins[i].startswith("@") or fchk
                or re.match(r"@!?P\d BRA !?P\d", ins[i])):
            target = re.search(r"0x([0-9a-f]+)", ins[i])
            if target is None:
                return None
            i, fchk = int(target.group(1), 16) // 16, False
            continue
        fchk = op.startswith("FCHK") or (fchk and not op.startswith("BRA"))
        i += 1
    return None


def sass_apply() -> dict:
    """{"dtype/E/NV": counts} of each instantiation of
    ``gn_stream_apply_kernel`` (E elements a unit, NV units a thread) in
    the built GroupNorm library: all its instructions, its 128-bit global
    loads and stores, and on the fast path of a full tile
    (``sass_fast_path``, null where it finds none) the instructions, MUFU
    (two an element: the exponential and the reciprocal) and instructions
    per element. Fails unless every 16-byte-unit instantiation loads and
    stores 128 bits at a time."""
    funcs = sass_functions(cuda_build.library_path("groupnorm"))
    out = {}
    for fn, ins in funcs.items():
        m = re.search(r"gn_stream_apply_kernelI(f|13__nv_bfloat16)"
                      r"Li(\d+)ELi(\d+)E", fn)
        if not m:
            continue
        e, nv = int(m.group(2)), int(m.group(3))
        ops = [_opcode(i) for i in ins]
        wide = lambda op, kind: (op.split(".")[0] == kind
                                 and "128" in op.split("."))
        fast = sass_fast_path(ins)
        row = {"instructions": len(ops),
               "ldg_128": sum(wide(op, "LDG") for op in ops),
               "stg_128": sum(wide(op, "STG") for op in ops),
               "fast_path": fast and len(fast),
               "fast_path_mufu": fast and sum(op.startswith("MUFU")
                                              for op in fast),
               "per_element": fast and len(fast) / (nv * e)}
        out[f"{'float32' if m.group(1) == 'f' else 'bfloat16'}/E{e}/NV{nv}"] \
            = row
        if e > 1 and not (row["ldg_128"] and row["stg_128"]):
            raise AssertionError(f"gn_stream_apply_kernel {fn}: no 128-bit "
                                 f"global load or store in its SASS {row}")
    if not any(k.split("/")[1] != "E1" for k in out):
        raise AssertionError(f"no 16-byte-unit gn_stream_apply_kernel in the "
                             f"SASS: {sorted(out)}")
    return out


def attn_peak(dtype) -> float:
    """The product rate that bounds an attention kernel: the bf16 tensor
    cores, or for fp32 the fastest fp32-accurate products on the card,
    3xTF32 at 495/3 TFLOP/s (not the 67 TFLOP/s of fp32 FMAs, which a
    3xTF32 kernel can beat)."""
    return PEAK_BF16 if dtype == BF16 else PEAK_FP32_PRODUCTS


def bound_ms(kind: str, b, lq, lk, hd, itemsize: int, peak: float):
    """The attention bound: two products forward (4·B·Lq·Lk·H·D operations
    on (2·Lq + 2·Lk)·B·H·D elements), five backward (10·B·Lq·Lk·H·D on
    (3·Lq + 4·Lk)·B·H·D), operations at ``attn_peak``."""
    prods = 2 if kind == "fwd" else 5
    flops = prods * 2 * b * lq * lk * hd
    tensors = (2 * b * lq * hd + 2 * b * lk * hd if kind == "fwd"
               else 3 * b * lq * hd + 4 * b * lk * hd)
    t_ops = flops / peak * 1e3
    t_bytes = tensors * itemsize / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gn_bound_ms(kind: str, numel: int, itemsize: int):
    """Bytes over 3.35 TB/s (x read once, y written once: 2·N·itemsize for
    the block kernel and the apply, N·itemsize for the stats) against ~10,
    3 and 5 fp32 operations an element (normalise, affine, SiLU; sums;
    affine, SiLU) over the card's 67 TFLOP/s outside the tensor cores."""
    nbytes = {"gn": 2, "stats": 1, "apply": 2}[kind] * numel * itemsize
    ops = {"gn": 10, "stats": 3, "apply": 5}[kind] * numel
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def agreement(outs, refs, kind: str, dtype):
    """(ok, max|Δ|, max|Δ|/rms(plain), rms(Δ)/rms(plain)), the ratios the
    worst over the output tensors."""
    ok, err, max_r, rms_r = True, 0.0, 0.0, 0.0
    for a, r in zip(outs, refs):
        a, r = a.double(), r.double()
        delta = (a - r).abs()
        scale = float(r.square().mean().sqrt())
        e = float(delta.max())
        mr, rr = e / scale, float(delta.square().mean().sqrt()) / scale
        ok &= (bool(torch.isfinite(a).all()) and mr <= MAX_TOL[(kind, dtype)]
               and rr <= RMS_TOL[(kind, dtype)])
        err, max_r, rms_r = max(err, e), max(max_r, mr), max(rms_r, rr)
    return ok, err, max_r, rms_r


def fault_fwd_neighbour_head(q, k, v, scale, heads):
    """Planted fault: each head reads the V columns of the head before it,
    as a packed kernel with a wrong column offset would."""
    d = q.shape[-1] // heads
    return (ha.attention_packed_reference(q, k, v.roll(d, dims=-1), scale,
                                          heads),)


def fault_head_bwd_no_delta(q, k, v, g, scale):
    """Planted fault: the plain backward over (B, H, L, D) with
    dS = P∘(g·Vᵀ), the row term δ = Σ(g·Vᵀ∘P) left out."""
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q.float(),
                                   k.float()) * scale, dim=-1)
    gv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype), g)
    ds = (p * torch.einsum("bhqd,bhkd->bhqk", g, v).float()).to(q.dtype)
    gq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    gk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return gq, gk, gv


def _backward_dq_from(q, k, v, g, scale, keys):
    """The plain backward over (B, H, L, D), but dQ = dS·keys·scale."""
    _, gk, gv = ha.attention_backward_reference(q, k, v, g, scale)
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q.float(),
                                   k.float()) * scale, dim=-1)
    gp = torch.einsum("bhqd,bhkd->bhqk", g, v).float()
    ds = (p * (gp - (gp * p).sum(-1, keepdim=True))).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", ds, keys) * scale, gk, gv


def fault_tile(lk: int) -> int:
    """The rows a k-tile fault moves: the 64-row tile, or half the keys
    where they fill less than two tiles (the spec decoder's 16)."""
    return min(64, lk // 2)


def fault_head_bwd_shifted_key_tile(q, k, v, g, scale):
    """Planted fault: dQ = dS·K reads the keys of the second 64-row tile in
    place of the first (of the second half in place of the first, under
    two tiles), as a product kernel with a wrong k-tile offset would; dK
    and dV are right."""
    t = fault_tile(k.shape[2])
    shifted = k.clone()
    shifted[:, :, :t] = k[:, :, t:2 * t]
    return _backward_dq_from(q, k, v, g, scale, shifted)


def fault_bwd_no_delta(q, k, v, g, scale, heads):
    """The same fault on packed (B, L, H·D) operands."""
    return tuple(ha.merge_heads(t) for t in fault_head_bwd_no_delta(
        *(ha.split_heads(t, heads) for t in (q, k, v, g)), scale))


def fault_bwd_shifted_keys(q, k, v, g, scale, heads):
    """Planted fault on packed (B, L, H·D) operands: dQ = dS·K pairs each
    score with the next key's row, as a product kernel with a key offset
    one row off would (at every Lk of the path, 32 included); dK and dV
    are right."""
    qh, kh, vh, gh = (ha.split_heads(t, heads) for t in (q, k, v, g))
    return tuple(ha.merge_heads(t) for t in _backward_dq_from(
        qh, kh, vh, gh, scale, kh.roll(1, dims=2)))


def fault_head_shifted_keys(q, k, v, scale):
    """Planted fault: P pairs with the V rows of the next key, as a kernel
    with a wrong key offset would."""
    return (ha.attention_reference(q, k, v.roll(1, dims=2), scale),)


def fault_head_shifted_key_tile(q, k, v, scale):
    """Planted fault: P̃·V reads the V rows of the second 64-key tile in
    place of the first (of the second half in place of the first, under
    two tiles), as a product kernel with a wrong k-tile offset would."""
    t = fault_tile(k.shape[2])
    shifted = v.clone()
    shifted[:, :, :t] = v[:, :, t:2 * t]
    return (ha.attention_reference(q, k, shifted, scale),)


def fault_gn_neighbour_gamma(x, gamma, beta, eps, act):
    """Planted fault: each channel scaled by its neighbour's γ."""
    return (hg.group_norm_reference(x, gamma.roll(1), beta, 32, eps, act),)


def fault_stats_chunk_dropped(x):
    """Planted fault: the partial sums of each slab's first chunk lost."""
    partial = hg.stream_stats_reference(x, 32).clone()
    partial[:, :, 0] = 0.0
    return (partial,)


def fault_apply_neighbour_affine(x, a, b, act):
    """Planted fault: each channel gets its neighbour's folded affine."""
    return (hg.stream_apply_reference(x, a.roll(1, dims=1),
                                      b.roll(1, dims=1), act),)


def fault_apply_rows_past_65535(x, a, b, act):
    """Planted fault: the rows past 65535 left unwritten (zero), as a grid
    with the rows on its y dimension would leave them."""
    y = hg.stream_apply_reference(x, a, b, act)
    y.view(-1, y.shape[2] * y.shape[3])[65535:] = 0
    return (y,)


def fault_apply_row_tails(x, a, b, act):
    """Planted fault: the last hw mod 8 elements of each row left
    unwritten (zero), as 16-byte units of bf16 alone would leave them."""
    y = hg.stream_apply_reference(x, a, b, act)
    hw = y.shape[2] * y.shape[3]
    y.view(-1, hw)[:, hw - hw % 8:] = 0
    return (y,)


def fault_apply_last_unit(x, a, b, act):
    """Planted fault: the last 16 bytes of each row left unwritten (zero),
    as a 16-byte-unit tile short of a full one would leave its last unit."""
    y = hg.stream_apply_reference(x, a, b, act)
    y.view(-1, y.shape[2] * y.shape[3])[:, -16 // y.element_size():] = 0
    return (y,)


def fault_apply_aligned_base(x, a, b, act):
    """Planted fault: x read from one element earlier, its 16-byte-aligned
    base."""
    early = torch.as_strided(x, x.shape, x.stride(), x.storage_offset() - 1)
    return (hg.stream_apply_reference(early, a, b, act),)


FAULTS = {"fwd": (fault_fwd_neighbour_head,),
          "bwd": (fault_bwd_no_delta, fault_bwd_shifted_keys),
          "head": (fault_head_shifted_keys, fault_head_shifted_key_tile),
          "head_bwd": (fault_head_bwd_no_delta,
                       fault_head_bwd_shifted_key_tile),
          "gn": (fault_gn_neighbour_gamma,),
          "stats": (fault_stats_chunk_dropped,),
          "apply": (fault_apply_neighbour_affine,)}


def planted(kind: str, *args) -> dict:
    """{fault name: its outputs} of every planted fault of a kind."""
    return {f.__name__: f(*args) for f in FAULTS[kind]}


def run_check(kind, dtype, kern, plain, faults, lib, bound, exact=None):
    """Agreement of kern with plain, each planted fault's (every one must
    break the limits), and the three times; beside the kernel's event time,
    the device time of its own symbols (``device_ms``) and the library
    call's whole device time. With ``exact`` (the plain version on float64
    copies of the operands) the limits hold against it instead, and the
    ratios to the plain version in the operand type are recorded beside
    them."""
    tup = lambda x: x if isinstance(x, tuple) else (x,)
    outs, refs = tup(kern()), tup(plain() if exact is None else exact())
    torch.cuda.synchronize()
    ok, err, max_r, rms_r = agreement(outs, refs, kind, dtype)
    fault_ratios, caught = {}, True
    for name, faulty in faults.items():
        fault_ok, _, fault_max_r, fault_rms_r = agreement(faulty, refs, kind,
                                                          dtype)
        fault_ratios[name] = [fault_max_r, fault_rms_r]
        caught &= not fault_ok
    row = {"dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "max_ratio": max_r, "rms_ratio": rms_r,
           "tol": [MAX_TOL[(kind, dtype)], RMS_TOL[(kind, dtype)]],
           "ok": ok, "fault_ratios": fault_ratios,
           "fault_caught": caught, "kernel_ms": time_ms(kern),
           "plain_ms": time_ms(plain), "bound_ms": bound[0],
           "bound_by": bound[1]}
    fell_back = len(DEVICE_MS_FALLBACKS)
    row["device_ms"], by_kernel = device_ms(kern, SYMBOLS[kind], split=True)
    if len(DEVICE_MS_FALLBACKS) > fell_back:
        row["device_ms_from"] = "cuda events around the call"
    if len(by_kernel) > 1:   # the launches of a multi-launch kernel
        row["device_ms_by_kernel"] = by_kernel
    if exact is not None:
        # the kernel against the plain version in the operand type, and
        # that plain version's own error (against float64)
        plain_outs = tup(plain())
        row["reference"] = "plain in float64"
        row["plain_ratios"] = list(agreement(outs, plain_outs, kind,
                                             dtype)[2:])
        row["plain_error_ratios"] = list(agreement(plain_outs, refs, kind,
                                                   dtype)[2:])
    row["library_ms"] = row["library_device_ms"] = None
    if lib is not None:
        try:   # the yardstick only: the port never calls it
            row["library_ms"] = time_ms(lib)
            fell_back = len(DEVICE_MS_FALLBACKS)
            row["library_device_ms"] = device_ms(lib)
            if len(DEVICE_MS_FALLBACKS) > fell_back:
                row["library_device_ms_from"] = "cuda events around the call"
        except RuntimeError as e:
            row["library_ms"] = None
            row["library_error"] = str(e).splitlines()[0][:200]
    return row


def check_packed(kind: str, tag, b, lq, lk, hd, heads, dtype, gen):
    d = hd // heads
    scale = d**-0.5
    q = torch.randn((b, lq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, lk, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, lk, hd), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, lq, hd), generator=gen, device="cuda").to(dtype)
    qh, kh, vh = (ha.split_heads(t, heads) for t in (q, k, v))
    if kind == "fwd":
        kern = lambda: ha.attention_packed_fwd(q, k, v, scale, heads)
        plain = lambda: ha.attention_packed_reference(q, k, v, scale, heads)
        lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        faulty = planted(kind, q, k, v, scale, heads)
    else:
        kern = lambda: ha.attention_packed_bwd(q, k, v, g, scale, heads)
        plain = lambda: ha.attention_packed_backward_reference(
            q, k, v, g, scale, heads)
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (qh, kh, vh))
        o = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        gh = ha.split_heads(g, heads)
        lib = lambda: torch.autograd.grad(o, (ql, kl, vl), gh,
                                          retain_graph=True)
        faulty = planted(kind, q, k, v, g, scale, heads)
    # the fp32 backward sums on the tensor cores (3xTF32) in another order
    # than cuBLAS's fp32 products in its plain version: held, as the
    # per-head kernels, against the plain version on float64 copies
    exact = None if kind == "fwd" or dtype == BF16 else (
        lambda: ha.attention_packed_backward_reference(
            *(t.double() for t in (q, k, v, g)), scale, heads))
    peak = attn_peak(dtype)
    row = run_check(kind, dtype, kern, plain, faulty, lib,
                    bound_ms(kind, b, lq, lk, hd, q.element_size(), peak),
                    exact)
    if kind == "fwd" and dtype == FP32:
        # recorded beside, not held: the fp32 forward keeps the plain
        # version in fp32 as its yardstick. Against float64 the scores'
        # fp32 rounding alone puts any fp32 forward ~5e-6–1e-5 of rms off
        # at the classifier's shapes, the plain version too (8.2e-6 at
        # clf-1-self on an H100, over the 5e-6 limit)
        ref64 = ha.attention_packed_reference(
            *(t.double() for t in (q, k, v)), scale, heads)
        row["float64_ratios"] = list(agreement(
            (kern(),), (ref64,), kind, dtype)[2:])
        row["plain_float64_ratios"] = list(agreement(
            (plain(),), (ref64,), kind, dtype)[2:])
    return {"shape": tag, "B": b, "Lq": lq, "Lk": lk, "HD": hd, "D": d,
            **row}


def _check_per_head(kind: str, q, k, v, g=None):
    """Kernel 3 (``kind`` "head") or 4 ("head_bwd", output gradient g) on
    the given (B, H, L, D) operands. fp32 sums on the tensor cores run in
    another order than cuBLAS's fp32 products in the plain version, whose
    own error reaches 2.5e-5 of rms at the VAE's shape (max|Δ| to
    float64): fp32 is held against the plain version on float64 copies,
    at the same limits."""
    b, h, lq, d = q.shape
    scale = d**-0.5
    dtype = q.dtype
    bound = bound_ms("fwd" if kind == "head" else "bwd", b, lq, k.shape[2],
                     h * d, q.element_size(), attn_peak(dtype))
    if kind == "head":
        exact = None if dtype == BF16 else (
            lambda: ha.attention_reference(*(t.double() for t in (q, k, v)),
                                           scale))
        row = run_check(
            "head", dtype, lambda: ha.attention_fwd(q, k, v, scale),
            lambda: ha.attention_reference(q, k, v, scale),
            planted("head", q, k, v, scale),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            bound, exact)
    else:
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        exact = None if dtype == BF16 else (
            lambda: ha.attention_backward_reference(
                *(t.double() for t in (q, k, v, g)), scale))
        row = run_check(
            "head_bwd", dtype, lambda: ha.attention_bwd(q, k, v, g, scale),
            lambda: ha.attention_backward_reference(q, k, v, g, scale),
            planted("head_bwd", q, k, v, g, scale),
            lambda: torch.autograd.grad(o, (ql, kl, vl), g,
                                        retain_graph=True), bound, exact)
    return {"B": b, "Lq": lq, "Lk": k.shape[2], "HD": h * d, "D": d, **row}


def check_head(tag, b, lq, lk, d, dtype, gen):
    """The per-head kernel on the VAE's layout: the (B, 1, h·w, C) token
    view of NCHW projections."""
    q, k, v = (torch.randn((b, d, n), generator=gen, device="cuda")
               .to(dtype)[:, None].transpose(2, 3) for n in (lq, lk, lk))
    return {"shape": tag, **_check_per_head("head", q, k, v)}


def check_head_bwd(tag, b, lq, lk, d, dtype, gen):
    """The per-head backward on the VAE's layout: q, k, v and the output
    gradient as (B, 1, L, C) token views of NCHW maps."""
    q, k, v, g = (torch.randn((b, d, n), generator=gen, device="cuda")
                  .to(dtype)[:, None].transpose(2, 3)
                  for n in (lq, lk, lk, lq))
    return {"shape": tag, **_check_per_head("head_bwd", q, k, v, g)}


def check_head_rows(kind: str, tag, b, h, lq, lk, d, dtype, gen):
    """Kernel 3 (``kind`` "head") or 4 ("head_bwd") over row-major
    (B, H, L, D) operands, as the prior and the attention pool make
    them."""
    q = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, h, lk, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    g = (torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dtype)
         if kind == "head_bwd" else None)
    return {"shape": tag, "H": h, **_check_per_head(kind, q, k, v, g)}


def new_model_rows(gen) -> list:
    """The kernel rows of the three fp32 runs, each credited its calls:
    the audio UNet's packed attention (D 48 and 96) forward and backward
    and its GroupNorms over (B, C, 1, L) maps; the prior's per-head
    attention (D 64) in p_losses and in sample; EncoderUNetModel's packed
    attention (D 32) over all four pools, its GroupNorms, and the
    attention pool's one query against h·w + 1 keys, forward and
    backward. Then each new head dim once in bf16 at a ragged length."""
    rows = []
    gns, sites = audio_unet_sites()
    for tag, lq, lk, hd, heads, per in sites:
        for kind, name in (("fwd", "attn_packed_fwd"),
                           ("bwd", "attn_packed_bwd")):
            rows.append((name, {**check_packed(
                kind, tag, AU_BATCH, lq, lk, hd, heads, FP32, gen),
                "calls": calls(audio_unet=AU_CALLS * per)}))
    for (c, n, eps, act), k in collections.Counter(gns).items():
        for name, r in check_gn(f"u-{c}x1x{n}", AU_BATCH, c, 1, n, eps, act,
                                FP32, gen):
            rows.append((name, {**r, "calls": calls(
                audio_unet=AU_CALLS * k)}))
        torch.cuda.empty_cache()
    cfg = PriorConfig()
    d = cfg.dim // cfg.heads
    for tag, b, n in (("p-loss", PR_BATCH, PR_STEPS),
                      ("p-sample", PR_SAMPLE_BATCH,
                       PR_SAMPLE_CALLS * 2 * PR_SAMPLE_STEPS)):
        for kind, name in (("head", "attn_fwd"), ("head_bwd", "attn_bwd")):
            if kind == "head_bwd" and tag == "p-sample":
                continue   # sampling takes no gradient
            rows.append((name, {**check_head_rows(
                kind, tag, b, cfg.heads, cfg.seq_len, cfg.seq_len, d, FP32,
                gen), "calls": calls(prior=cfg.depth * n)}))
    attn, gn_all, pool_site = collections.Counter(), collections.Counter(), None
    for pool in POOLS:
        gns, sites, site = encoder_unet_sites(pool)
        attn.update(sites)
        gn_all.update(gns)
        pool_site = site or pool_site
    heads = CLASSIFIER_BACKBONE.num_heads
    for (n, hd), per in attn.items():
        for kind, name in (("fwd", "attn_packed_fwd"),
                           ("bwd", "attn_packed_bwd")):
            rows.append((name, {**check_packed(
                kind, f"n-{n}-self", EN_BATCH, n, n, hd, heads, FP32, gen),
                "calls": calls(encoder_unet=EN_CALLS * per)}))
    for (c, h, w, eps, act), k in gn_all.items():
        for name, r in check_gn(f"n-{c}x{h}x{w}", EN_BATCH, c, h, w, eps, act,
                                FP32, gen):
            rows.append((name, {**r, "calls": calls(
                encoder_unet=EN_CALLS * k)}))
    lq, lk, hd = pool_site
    for kind, name in (("head", "attn_fwd"), ("head_bwd", "attn_bwd")):
        rows.append((name, {**check_head_rows(
            kind, "n-pool", EN_BATCH, heads, lq, lk, hd // heads, FP32, gen),
            "calls": calls(encoder_unet=EN_CALLS)}))
    for dh in (48, 96):
        for kind, name in (("fwd", "attn_packed_fwd"),
                           ("bwd", "attn_packed_bwd")):
            rows.append((name, check_packed(kind, f"ragged-{dh}", 2, 1000,
                                            1000, 8 * dh, 8, BF16, gen)))
    for kind, name in (("head", "attn_fwd"), ("head_bwd", "attn_bwd")):
        rows.append((name, check_head_rows(kind, "ragged-64", 2, 8, 1000,
                                           1000, 64, BF16, gen)))
    return rows


def other_rows(gen) -> list:
    """The kernel rows of runs o and f, each credited its calls: the AR
    encoder's packed attention at D 64 (8 heads; 32 queries against
    themselves and against the latent's 1024 tokens), forward and
    backward in fp32 and bf16; the bf16 UNet's packed forward at batch
    OC_BATCH over the tokens themselves, 32 context tokens and one class
    token (Lk 1 once more in fp32), and its GroupNorms; the rescaler's
    per-head attention at L 4096, D 512 (fp32, and once more in bf16),
    forward and backward, and the first stages' fp32 GroupNorms."""
    rows = []
    depth, heads, hd = ar_depth(), 8, 512
    for dtype in (FP32, BF16):
        for tag, lq, lk in ar_sites():
            for kind, name in (("fwd", "attn_packed_fwd"),
                               ("bwd", "attn_packed_bwd")):
                rows.append((name, {**check_packed(
                    kind, f"o-{tag}", AR_BATCH, lq, lk, hd, heads, dtype,
                    gen), "calls": calls(other_cond=AR_CALLS * depth)}))
    for (level, lq, lk, hd), n in sorted(oc_attention_sites().items()):
        rows.append(("attn_packed_fwd", {**check_packed(
            "fwd", f"o-unet-{level}-lk{lk}", OC_BATCH, lq, lk, hd,
            LDM_UNET.num_heads, BF16, gen), "calls": calls(other_cond=n)}))
    rows.append(("attn_packed_fwd", check_packed(
        "fwd", "o-unet-0-lk1", OC_BATCH, LATENT_HW[0] * LATENT_HW[1], 1,
        LDM_UNET.model_channels, LDM_UNET.num_heads, FP32, gen)))
    for (c, h, w, eps, act), n in oc_gn_sites().items():
        for name, r in check_gn(f"o-unet-{c}x{h}x{w}", OC_BATCH, c, h, w,
                                eps, act, BF16, gen):
            rows.append((name, {**r, "calls": calls(
                other_cond=n * len(OC_VARIANTS) * OC_CALLS)}))
    gns, attn = first_stage_sites()
    for (l, d), n in collections.Counter(attn).items():
        for check, name in ((check_head, "attn_fwd"),
                            (check_head_bwd, "attn_bwd")):
            rows.append((name, {**check("f-rescaler-mid", FS_BATCH, l, l, d,
                                        FP32, gen),
                                "calls": calls(first_stages=n)}))
            rows.append((name, check("f-rescaler-mid", FS_BATCH, l, l, d,
                                     BF16, gen)))
            torch.cuda.empty_cache()
    for (c, h, w, eps, act), n in gns.items():
        for name, r in check_gn(f"f-{c}x{h}x{w}", FS_BATCH, c, h, w, eps,
                                act, FP32, gen):
            rows.append((name, {**r, "calls": calls(first_stages=n)}))
    return rows


def profile_rows(pipe, gen) -> list:
    """The kernel rows of run q (cli.profile, fp32 at Q_BATCH), each
    credited Q_CALLS calls a forward: the UNet's and the classifier's
    packed attention forward, self and over Q_TOKENS context tokens (a
    ragged key tile of 40), the VAE's mid attention (L 1024, D 512) in the
    encode and the decode, and every GroupNorm32 map of the four
    forwards."""
    rows = []
    for tag, b, lq, lk, hd, heads, per in (
            attention_sites("q-unet", LDM_UNET, Q_BATCH, Q_TOKENS, True)
            + attention_sites("q-clf", CLASSIFIER_BACKBONE, Q_BATCH,
                              Q_TOKENS, False)):
        rows.append(("attn_packed_fwd", {**check_packed(
            "fwd", tag, b, lq, lk, hd, heads, FP32, gen),
            "calls": calls(profile=Q_CALLS * per)}))
    d = SD_VAE.ch * SD_VAE.ch_mult[-1]
    l = LATENT_HW[0] * LATENT_HW[1]
    rows.append(("attn_fwd", {**check_head("q-vae-mid", Q_BATCH, l, l, d,
                                           FP32, gen),
                              "calls": calls(profile=2 * Q_CALLS)}))
    for (c, h, w, eps, act), n in profile_gn_sites(pipe).items():
        for name, r in check_gn(f"q-{c}x{h}x{w}", Q_BATCH, c, h, w, eps, act,
                                FP32, gen):
            rows.append((name, {**r, "calls": calls(profile=n)}))
    return rows


def check_gn(tag, b, c, h, w, eps, act, dtype, gen):
    """The GroupNorm kernels one call at this map launches: the block
    kernel, or the stats and apply pair (one row each)."""
    x = (torch.randn((b, c, h, w), generator=gen, device="cuda") * 2
         + 0.5).to(dtype)
    gamma = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    beta = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    lib = lambda: (F.silu(F.group_norm(x, 32, gamma, beta, eps))
                   if act == "silu" else F.group_norm(x, 32, gamma, beta, eps))
    info = {"shape": tag, "B": b, "C": c, "H": h, "W": w, "eps": eps,
            "act": act}
    n, itemsize = x.numel(), x.element_size()
    if not hg.uses_stream(x.shape, 32, itemsize):
        return [("gn_block", {**info, **run_check(
            "gn", dtype,
            lambda: hg.group_norm_block(x, gamma, beta, 32, eps, act),
            lambda: hg.group_norm_reference(x, gamma, beta, 32, eps, act),
            planted("gn", x, gamma, beta, eps, act), lib,
            gn_bound_ms("gn", n, itemsize))})]
    partial = hg.stream_stats_reference(x, 32)
    a, bb = hg.fold_stats(partial, gamma, beta, n // b // 32, eps)
    # F.group_norm (then F.silu) computes the pair's whole function: its
    # time stands on the apply row. No single call returns the stats
    # kernel's chunked Σx and Σx²; the nearest, torch.var_mean over the
    # same 32 groups, reads x once as the kernel does and stands on the
    # stats row
    return [
        ("gn_stream_stats", {**info, **run_check(
            "stats", dtype, lambda: hg.stream_stats(x, 32),
            lambda: hg.stream_stats_reference(x, 32),
            planted("stats", x),
            lambda: torch.var_mean(x.view(b, 32, -1), dim=-1, correction=0),
            gn_bound_ms("stats", n, itemsize))}),
        ("gn_stream_apply", {**info, **run_check(
            "apply", dtype, lambda: hg.stream_apply(x, a, bb, act),
            lambda: hg.stream_apply_reference(x, a, bb, act),
            planted("apply", x, a, bb, act), lib,
            gn_bound_ms("apply", n, itemsize))})]


# the apply kernel's edges, each with its own planted fault: (tag, shape,
# dtype, act, x's storage offset in elements, fault). B·C past 65535 rows
# (the VAE encoder's fp32 32×128 level at batch 130), the single-element
# route at an hw that is no multiple of 8, an x one element off its
# 16-byte alignment (a contiguous view) at the VAE's full-resolution map,
# and two 16-byte-unit rows that end short of a full tile: hw 4800 (600
# units, one tile of 256 threads) and hw 128 (16 units, 32 threads)
APPLY_EDGES = (
    ("rows-66560", (130, 512, 32, 128), FP32, "silu", 0,
     fault_apply_rows_past_65535),
    ("hw-127x511", (2, 128, 127, 511), BF16, None, 0, fault_apply_row_tails),
    ("offset-1", (4, 128, 128, 512), BF16, "silu", 1,
     fault_apply_aligned_base),
    ("hw-40x120", (2, 64, 40, 120), BF16, "silu", 0, fault_apply_last_unit),
    ("hw-8x16", (2, 64, 8, 16), BF16, None, 0, fault_apply_last_unit))


def check_apply_edge(tag, shape, dtype, act, offset, fault, gen):
    b, c, h, w = shape
    n = b * c * h * w
    flat = (torch.randn(n + offset, generator=gen, device="cuda") * 2
            + 0.5).to(dtype)
    x = flat[offset:].view(shape)
    gamma = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    beta = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    a, bb = hg.fold_stats(hg.stream_stats_reference(x, 32), gamma, beta,
                          n // b // 32, 1e-6)
    faults = {**planted("apply", x, a, bb, act),
              fault.__name__: fault(x, a, bb, act)}
    return ("gn_stream_apply", {
        "shape": tag, "B": b, "C": c, "H": h, "W": w, "act": act,
        "rows": b * c, "offset": offset, **run_check(
            "apply", dtype, lambda: hg.stream_apply(x, a, bb, act),
            lambda: hg.stream_apply_reference(x, a, bb, act), faults, None,
            gn_bound_ms("apply", n, x.element_size()))})


def kernel_phase(pipe, sp):
    """Every kernel at every shape of the main paths (bf16 in ``generate``,
    ``inpaint``, ``train_stage2``, ``serve``, ``sound_log``'s UNet and the
    sampler phase but its video-run calls, fp32 in ``train_vae`` and
    ``sound_log``'s VAE),
    with its calls per run (the sampler phase's as ``Units`` sums of its
    units ``sp``, which ``resolve_units`` counts once the phase has run);
    the kernels of the bf16 paths also once in
    fp32, the per-head backward also once in bf16, both per-head kernels
    at ragged lengths, and the apply kernel at its edges
    (``APPLY_EDGES``)."""
    n = WINDOWS * SAMPLES
    sp = sp_units(**sp)
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for tag, b, lq, lk, hd, heads, per_step in path_shapes(n, WINDOW_FEATS):
        calls_step = STEPS * per_step
        clf = tag.startswith("clf")
        # the classifier runs bf16 in generate and inpaint, fp32 in the
        # video run and the sampler phase's cli.generate; the UNet bf16 in
        # all of them
        cli = sp["video_nfe"] * per_step
        per_run = calls(calls_step, calls_step,
                        video=0 if clf else calls_step,
                        samplers=0 if clf else cli)
        rows.append(("attn_packed_fwd", {**check_packed(
            "fwd", tag, b, lq, lk, hd, heads, BF16, gen), "calls": per_run}))
        if clf:
            video = calls(video=calls_step, samplers=cli)
            rows.append(("attn_packed_bwd", {**check_packed(
                "bwd", tag, b, lq, lk, hd, heads, BF16, gen),
                "calls": per_run}))
            for kind, name in (("fwd", "attn_packed_fwd"),
                               ("bwd", "attn_packed_bwd")):
                rows.append((name, {**check_packed(
                    kind, tag, b, lq, lk, hd, heads, FP32, gen),
                    "calls": video}))
    d = SD_VAE.ch * SD_VAE.ch_mult[-1]
    l = LATENT_HW[0] * LATENT_HW[1]
    rows.append(("attn_fwd", {**check_head("vae-enc-mid", WINDOWS, l, l, d,
                                           BF16, gen),
                              "calls": calls(0, 1)}))
    rows.append(("attn_fwd", {**check_head(
        "vae-dec-mid", n, l, l, d, BF16, gen),
        "calls": calls(1, 1, video=1, samplers=sp["video_decode"])}))
    # serving's bucket-16 call of one sample: the UNet at the CFG batch 32,
    # the classifier's forward and gradient at 16, the decoder's mid
    # attention at 16, all bf16
    for tag, b, lq, lk, hd, heads, per_step in path_shapes(SERVE_BUCKET,
                                                           WINDOW_FEATS):
        per_run = calls(serve=STEPS * per_step)
        kinds = (("fwd", "attn_packed_fwd"), ("bwd", "attn_packed_bwd"))
        for kind, name in kinds[:2 if tag.startswith("clf") else 1]:
            rows.append((name, {**check_packed(
                kind, f"e-{tag}", b, lq, lk, hd, heads, BF16, gen),
                "calls": per_run}))
    rows.append(("attn_fwd", {**check_head("e-vae-dec-mid", SERVE_BUCKET, l,
                                           l, d, BF16, gen),
                              "calls": calls(serve=1)}))
    # the sampler phase (its video-run calls are credited above, its
    # guided UNet calls on the SoundLogger's rows below): the classifier's
    # forward and gradient at SP_SAMPLES, the tiled UNet call at
    # 3·SP_SAMPLES, the VAE's mid attention in the tiled decode (all the
    # tiles in one call) and in the ancestral inpaint's encode (one
    # window) and decode
    for tag, b, lq, lk, hd, heads, per in attention_sites(
            "d-clf", CLASSIFIER_BACKBONE, SP_SAMPLES, WINDOW_FEATS, False):
        for kind, name in (("fwd", "attn_packed_fwd"),
                           ("bwd", "attn_packed_bwd")):
            rows.append((name, {**check_packed(
                kind, tag, b, lq, lk, hd, heads, BF16, gen),
                "calls": calls(samplers=sp["guided"] * per)}))
    for tag, b, lq, lk, hd, heads, per in attention_sites(
            "dt-unet", LDM_UNET, 3 * SP_SAMPLES, WINDOW_FEATS, True):
        rows.append(("attn_packed_fwd", {**check_packed(
            "fwd", tag, b, lq, lk, hd, heads, BF16, gen),
            "calls": calls(samplers=sp["tiled_unet"] * per)}))
    rows.append(("attn_fwd", {**check_head(
        "dt-vae-dec-mid", TILED_TILES * SP_SAMPLES, 256, 256, d, BF16, gen),
        "calls": calls(samplers=sp["tiled_decode"])}))
    for tag, b in (("d-vae-enc-mid", 1), ("d-vae-dec-mid", SP_SAMPLES)):
        rows.append(("attn_fwd", {**check_head(tag, b, l, l, d, BF16, gen),
                                  "calls": calls(samplers=sp["inpaint_vae"])}))
    # the stage-2 CLI's SoundLogger: the UNet's attention forward at the
    # CFG batch 2·SL_N over the training crops' S2_TOKENS tokens, every
    # sampler step, bf16 (the sampler phase's guided calls too: one
    # shape); the VAE's mid attention at SL_N in the encode
    # and the two decodes (the encoder's and the decoder's are one shape),
    # fp32
    for tag, b, lq, lk, hd, heads, per in attention_sites(
            "sl-unet", LDM_UNET, 2 * SL_N, S2_TOKENS, True):
        rows.append(("attn_packed_fwd", {**check_packed(
            "fwd", tag, b, lq, lk, hd, heads, BF16, gen),
            "calls": calls(sound_log=SL_CALLS * STEPS * per,
                           samplers=sp["guided"] * per)}))
    rows.append(("attn_fwd", {**check_head("sl-vae-mid", SL_N, l, l, d, FP32,
                                           gen),
                              "calls": calls(sound_log=3 * SL_CALLS)}))
    # the train step's mid attention, encoder and decoder alike: forward
    # and backward in fp32 at the train batch
    both = calls(train_vae=2 * TRAIN_STEPS)
    rows.append(("attn_fwd", {**check_head("train-mid", TRAIN_BATCH, l, l, d,
                                           FP32, gen), "calls": both}))
    rows.append(("attn_bwd", {**check_head_bwd("train-mid", TRAIN_BATCH, l, l,
                                               d, FP32, gen), "calls": both}))
    rows.append(("attn_bwd", check_head_bwd("train-mid", TRAIN_BATCH, l, l, d,
                                            BF16, gen)))
    for dtype in (FP32, BF16):
        rows.append(("attn_fwd", check_head("ragged", 2, 1000, 936, d, dtype,
                                            gen)))
        rows.append(("attn_bwd", check_head_bwd("ragged", 2, 1000, 936, d,
                                                dtype, gen)))
    # the spec decoder's train steps (decode, fp32): its mid attention at
    # (DEC_BATCH, 1, 16, 256), forward and backward once a step, and every
    # GroupNorm of its forward; kernels 3 and 4 at D 256 once more at a
    # ragged length with tile edges, in fp32 and bf16. Their operands come
    # from a generator of their own, so every other row keeps the inputs
    # it had before these rows came
    gns, t_dec, d_dec = decode_sites()
    per = calls(decode=2 * DEC_STEPS)
    gen_r = torch.Generator("cuda").manual_seed(15)
    rows.append(("attn_fwd", {**check_head("r-dec-mid", DEC_BATCH, t_dec,
                                           t_dec, d_dec, FP32, gen_r),
                              "calls": per}))
    rows.append(("attn_bwd", {**check_head_bwd("r-dec-mid", DEC_BATCH, t_dec,
                                               t_dec, d_dec, FP32, gen_r),
                              "calls": per}))
    for dtype in (FP32, BF16):
        rows.append(("attn_fwd", check_head("ragged-256", 2, 1000, 1000,
                                            d_dec, dtype, gen_r)))
        rows.append(("attn_bwd", check_head_bwd("ragged-256", 2, 1000, 1000,
                                                d_dec, dtype, gen_r)))
    for (c, h, w, eps, act), sites in collections.Counter(gns).items():
        for name, r in check_gn(f"r-dec-{c}x{h}x{w}", DEC_BATCH, c, h, w,
                                eps, act, FP32, gen_r):
            rows.append((name, {**r, "calls": calls(
                decode=2 * DEC_STEPS * sites)}))
    for (model, b, c, h, w, eps, act, dtype), per_run in gn_path(
            pipe, n, STEPS, sp).items():
        tag = f"{model}-{c}x{h}x{w}"
        for name, r in check_gn(tag, b, c, h, w, eps, act, dtype, gen):
            rows.append((name, {**r, "calls": per_run}))
    # the bf16-only kernels once in fp32: the UNet's level-0 cross shape and
    # a UNet level-0 norm (the classifier's have the video run's fp32 rows,
    # the per-head forward and the VAE's norms the trainer's)
    rows.append(("attn_packed_fwd", check_packed(
        "fwd", "unet-0-cross", 2 * n, 1024, WINDOW_FEATS, 320, 8, FP32, gen)))
    # stage-2 training: the UNet's attention at the train batch in bf16,
    # forward in every train and validation forward, backward in each
    # train step; the frozen encoder's mid attention once a forward
    # (run m's gradient calls: the same shapes, the forward again in the
    # backward of each policy's recomputed blocks)
    for tag, b, lq, lk, hd, heads, per in attention_sites(
            "s2-unet", LDM_UNET, S2_BATCH, S2_TOKENS, True):
        rows.append(("attn_packed_fwd", {**check_packed(
            "fwd", tag, b, lq, lk, hd, heads, BF16, gen),
            "calls": calls(train_stage2=S2_FORWARDS * per, dropout_remat=(
                DR_CALLS + len(DR_POLICIES)) * per)}))
        rows.append(("attn_packed_bwd", {**check_packed(
            "bwd", tag, b, lq, lk, hd, heads, BF16, gen),
            "calls": calls(train_stage2=S2_STEPS * per,
                           dropout_remat=DR_CALLS * per)}))
    rows.append(("attn_fwd", {**check_head("s2-enc-mid", S2_BATCH, l, l, d,
                                           BF16, gen),
                              "calls": calls(train_stage2=S2_FORWARDS)}))
    # the classifier's trainer: fp32 forward and backward at batch 32 over
    # the crops' 32 tokens; align-acc: fp32 forward at batch 64 over 40
    # tokens (a ragged last key tile), and the backward held there too at
    # the trainer's batch. The frozen encoder's mid attention at both.
    # (run k's scanned and sequential steps: the same shapes)
    for tag, b, lq, lk, hd, heads, per in attention_sites(
            "c-clf", CLASSIFIER_BACKBONE, C_BATCH, S2_TOKENS, False):
        for kind, name in (("fwd", "attn_packed_fwd"),
                           ("bwd", "attn_packed_bwd")):
            rows.append((name, {**check_packed(
                kind, tag, b, lq, lk, hd, heads, FP32, gen),
                "calls": calls(train_classifier=C_STEPS * per,
                               scan=SC_STEPS * per)}))
    for tag, b, lq, lk, hd, heads, per in attention_sites(
            "a-clf", CLASSIFIER_BACKBONE, AA_BATCH, AA_TOKENS, False):
        rows.append(("attn_packed_fwd", {**check_packed(
            "fwd", tag, b, lq, lk, hd, heads, FP32, gen),
            "calls": calls(align_acc=AA_CALLS * per)}))
        if lk == AA_TOKENS:
            rows.append(("attn_packed_bwd", check_packed(
                "bwd", tag.replace("a-clf", "lk40"), C_BATCH, lq, lk, hd,
                heads, FP32, gen)))
    rows.append(("attn_fwd", {**check_head("c-enc-mid", C_BATCH, l, l, d,
                                           FP32, gen),
                              "calls": calls(train_classifier=C_STEPS)}))
    rows.append(("attn_fwd", {**check_head("a-enc-mid", AA_BATCH, l, l, d,
                                           FP32, gen),
                              "calls": calls(align_acc=AA_CALLS)}))
    rows += check_gn("unet-320x16x64", 2 * n, 320, 16, 64, 1e-5, "silu",
                     FP32, gen)
    for edge in APPLY_EDGES:
        rows.append(check_apply_edge(*edge, gen))
        torch.cuda.empty_cache()
    # the three fp32 runs of the audio UNet, the prior and EncoderUNetModel,
    # from a generator of their own: every row above keeps its inputs
    rows += new_model_rows(torch.Generator("cuda").manual_seed(16))
    torch.cuda.empty_cache()
    # runs o and f, from a generator of their own
    rows += other_rows(torch.Generator("cuda").manual_seed(17))
    torch.cuda.empty_cache()
    # run q, from a generator of its own
    rows += profile_rows(pipe, torch.Generator("cuda").manual_seed(18))
    torch.cuda.empty_cache()
    # the block kernel's branch-free SiLU division, bit for bit __fdiv_rn's
    # over every fp32 input in its range (the rest go through __fdiv_rn)
    off, taken = hg.silu_division_check("cuda")
    log(f"kernel gn_block SiLU division: {off} of {taken} fp32 inputs differ "
        f"from __fdiv_rn (of 2^32; the others take __fdiv_rn itself)")
    if off:
        raise AssertionError("the GroupNorm kernel's SiLU division is not "
                             "__fdiv_rn's")
    # reset after the comparisons: they are not the main paths' launches
    reset_counts()
    log("kernels " + json.dumps([dict(kernel=k, **r) for k, r in rows]))
    # the bound is the least time the card could take; a device time under
    # it (operands left in L2, or a bound that misses the work) is listed
    under = [(k, r["shape"], r["dtype"], r["device_ms"], r["bound_ms"])
             for k, r in rows if r["device_ms"] < r["bound_ms"]]
    log(f"kernel rows whose device time is under their bound: {len(under)} "
        f"of {len(rows)} {json.dumps(under)}")
    bad = [(k, r["shape"], r["dtype"], r["max_ratio"], r["rms_ratio"])
           for k, r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    missed = [(k, r["shape"], r["dtype"], r["fault_ratios"]) for k, r in rows
              if not r["fault_caught"]]
    if missed:
        raise AssertionError(f"the comparison passes a planted fault: {missed}")
    # per kernel and dtype: the worst agreement ratios, and for each planted
    # fault the least factor by which it breaks the limits
    worst = collections.defaultdict(lambda: [0.0, 0.0, {}])
    for k, r in rows:
        wr = worst[(k, r["dtype"])]
        wr[0] = max(wr[0], r["max_ratio"])
        wr[1] = max(wr[1], r["rms_ratio"])
        for name, (fm, fr) in r["fault_ratios"].items():
            wr[2][name] = min(wr[2].get(name, float("inf")),
                              max(fm / r["tol"][0], fr / r["tol"][1]))
    log("kernel worst ratios (max, rms, {fault: fault/limit}) " + json.dumps(
        {f"{k}/{dt}": v for (k, dt), v in worst.items()}))
    return rows


def row_calls(rows) -> dict:
    """{run: {"kernel/dtype": calls}} that the kernel phase's rows credit
    to each main-path run."""
    out = {run: collections.Counter() for run in RUNS}
    for k, r in rows:
        for run, n in r.get("calls", {}).items():
            out[run][f"{k}/{r['dtype']}"] += n
    return {run: {k: n for k, n in sorted(c.items()) if n}
            for run, c in out.items()}


def check_rows_cover(rows, launches):
    """Every launch of every main-path run stands on kernel-phase rows of
    its shape: the rows' calls equal the run's launches by kernel and
    dtype, so each run's device, bound, plain and library sums cover all
    of its launches."""
    credited = row_calls(rows)
    off = {run: {"rows": credited[run],
                 "launches": {k: n for k, n in launches[run].items() if n}}
           for run in RUNS}
    off = {run: v for run, v in off.items() if v["rows"] != v["launches"]}
    log(f"kernel rows cover every launch of the {len(RUNS)} runs: "
        f"{not off}")
    if off:
        raise AssertionError(f"kernel rows' calls differ from the launches: "
                             f"{json.dumps(off)}")


def summarize(rows, launches):
    """One entry per kernel: its path shapes summed over their calls in
    each main-path run of ``RUNS`` (ms, device_ms, plain_ms, library_ms,
    library_device_ms, bound_ms, each also per run), its
    largest error, and its launches in the main-path runs. A sum is null where nothing was measured: no call
    of the kernel in that run, or a shape without a library call."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        rs = [r for k, r in rows if k == name and "calls" in r]

        def total(key, runs=RUNS):
            used = [(r[key], sum(r["calls"][run] for run in runs))
                    for r in rs]
            used = [(v, n) for v, n in used if n]
            if not used or any(v is None for v, _ in used):
                return None
            return sum(v * n for v, n in used)

        t_ops = sum(r["bound_ms"] * sum(r["calls"].values()) for r in rs
                    if r["bound_by"] == "operations")
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_kernel(launches[run])[name] for run in RUNS),
            "max_abs_err": max(r["max_abs_err"] for k, r in rows if k == name),
            "ms": total("kernel_ms"), "device_ms": total("device_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if t_ops >= total("bound_ms") / 2
            else "bytes",
            "library_ms": total("library_ms"),
            "library_device_ms": total("library_device_ms"),
            **{f"launches_{run}": by_kernel(launches[run])[name]
               for run in RUNS},
            **{f"{key}_{run}": total(
                f"{'kernel_' if key == 'ms' else ''}{key}", (run,))
               for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                           "library_ms", "library_device_ms")
               for run in RUNS},
        })
    return out


# ---- the pipelines --------------------------------------------------------------

def build_flagship(seed: int = 0):
    ldm = LatentDiffusion(LDMConfig(
        unet=dataclasses.replace(LDM_UNET, dtype="bfloat16")))
    randomize_(ldm, seed)
    ldm.unet.to(torch.bfloat16)   # the cond encoder stays float32
    clf = randomize_(ClassifierBackbone(
        dataclasses.replace(CLASSIFIER_BACKBONE, dtype="bfloat16")), seed + 1)
    return DiffFoleyPipeline(ldm, clf.to(torch.bfloat16),
                             vae_dtype="bfloat16", device="cuda")


def check_launches(run: str, launches, expect):
    log(f"launches {run} {json.dumps(launches)} predicted "
        f"{json.dumps(expect)}")
    if launches != expect:
        raise AssertionError(f"{run} launch counts {launches} != {expect}")


def check_outputs(out, what: str, samples: int = SAMPLES,
                  windows: int = WINDOWS):
    wav, spec = out["wav"], out["spec"]
    if wav.shape != (samples, windows * WINDOW_SAMPLES) or wav.dtype != np.int16:
        raise AssertionError(f"{what} wav {wav.shape} {wav.dtype}")
    if spec.shape != (samples, 128, windows * 512) or not np.isfinite(spec).all():
        raise AssertionError(f"{what} spec {spec.shape} "
                             f"finite={np.isfinite(spec).all()}")
    if not (spec.min() >= 0.0 and spec.max() <= 1.0):
        raise AssertionError(f"{what} spec leaves [0, 1]")
    log(f"{what} spec finite in [0, 1] mean {float(spec.mean()):.6f}; wav "
        f"int16 |max| {int(np.abs(wav.astype(np.int32)).max())}")


def timed(stages: dict, name: str, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    stages[name] = time.perf_counter() - t
    return r


def generate_phase(pipe, feats, expect, profile: bool):
    gen = GenerationConfig(steps=STEPS, sample_num=SAMPLES, wav_dtype="int16")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe.generate(feats, seed=0, gen=gen)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_counts()
    log(f"generate {cold_s:.3f} s (first call) peak_mem_GiB "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    check_launches("generate", launches, expect)
    check_outputs(out, "generate")

    # a second, warm call split into its stages
    stages = {}
    feats_w = torch.as_tensor(feats.reshape(WINDOWS, WINDOW_FEATS, 512),
                              device="cuda")
    g = torch.Generator("cuda").manual_seed(1)
    with torch.no_grad():
        cond = feats_w.repeat_interleave(SAMPLES, dim=0)
        z = timed(stages, "sampler_s", lambda: pipe.ldm.sample(
            cond, generator=g, **pipe.sampler_kwargs(gen)))
        specs = timed(stages, "vae_decode_s", lambda: pipe.decode_specs(z))
        timed(stages, "griffin_lim_s", lambda: mel_to_wav(
            specs, n_iter=gen.gl_iters, length=WINDOW_SAMPLES, generator=g))
    stages["total_s"] = sum(stages.values())
    log("generate warm stages " + json.dumps(stages))
    if profile:
        profile_steps("dpm", lambda: pipe.ldm.sample(
            cond, generator=torch.Generator("cuda").manual_seed(2),
            **pipe.sampler_kwargs(dataclasses.replace(gen, steps=2))))
    return launches, {"first_call_s": cold_s, **stages}, out["spec"]


def canvas(spec: np.ndarray):
    """The inpaint inputs: the known canvas (sample 0 of a generated spec),
    its keep mask, and both per window on the card."""
    known = spec[0]
    mask = np.tile(continuation_mask(SPEC_HW[1], KEEP_FRAMES), (1, WINDOWS))
    to_w = lambda a: np.ascontiguousarray(
        a.reshape(SPEC_HW[0], WINDOWS, SPEC_HW[1]).transpose(1, 0, 2))
    return (known, mask, torch.as_tensor(to_w(known), device="cuda"),
            torch.as_tensor(spec_mask_to_latent(to_w(mask)), device="cuda"))


def inpaint_stages(pipe, feats_w, spec_w, mask_lat, gen, seed: int):
    """``inpaint``'s stages, each timed: encode, masked DDIM, decode,
    Griffin-Lim."""
    stages = {}
    s = gen.sample_num
    g = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        z0 = timed(stages, "encode_s", lambda: pipe.encode_canvas(
            spec_w).repeat_interleave(s, dim=0))
        mask = mask_lat.repeat_interleave(s, dim=0)
        z = timed(stages, "sampler_s", lambda: pipe.ldm.sample(
            feats_w.repeat_interleave(s, dim=0), generator=g, mask=mask,
            x0=z0, **pipe.sampler_kwargs(gen)))
        z = z0 * mask + (1.0 - mask) * z
        specs = timed(stages, "vae_decode_s", lambda: pipe.decode_specs(z))
        timed(stages, "griffin_lim_s", lambda: mel_to_wav(
            specs, n_iter=gen.gl_iters, length=WINDOW_SAMPLES, generator=g))
    stages["total_s"] = sum(stages.values())
    return stages, (z, z0, mask)


def region_errors(spec_out, rt, mask):
    """Mean |Δ| against the roundtrip on the kept and the generated region."""
    d = np.abs(spec_out - rt[None])
    keep = np.broadcast_to(mask[None] > 0, d.shape)
    return float(d[keep].mean()), float(d[~keep].mean())


def inpaint_phase(pipe, feats, spec, expect, profile: bool):
    gen = GenerationConfig(sampler="ddim", steps=STEPS, sample_num=SAMPLES,
                           wav_dtype="int16")
    known, mask, spec_w, mask_lat = canvas(spec)
    feats_w = torch.as_tensor(feats.reshape(WINDOWS, WINDOW_FEATS, 512),
                              device="cuda")
    first, _ = inpaint_stages(pipe, feats_w, spec_w, mask_lat, gen, 3)
    log("inpaint first stages " + json.dumps(first))

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe.inpaint(feats, known, mask, seed=0, gen=gen)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_counts()
    log(f"inpaint {call_s:.3f} s (main-path call) peak_mem_GiB "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    check_launches("inpaint", launches, expect)
    check_outputs(out, "inpaint")

    warm, (z, z0, mask_s) = inpaint_stages(pipe, feats_w, spec_w, mask_lat,
                                           gen, 4)
    log("inpaint warm stages " + json.dumps(warm))
    latent_kept = float(((z - z0) * mask_s).abs().max())
    log(f"inpaint latents max|Δ| to the canvas's on the kept cells "
        f"{latent_kept} (the final composite pins them)")
    if latent_kept != 0.0:
        raise AssertionError("the kept latents moved")
    rt = pipe.decode_specs(pipe.encode_canvas(spec_w)).cpu().numpy()
    rt = rt.transpose(1, 0, 2).reshape(SPEC_HW[0], -1)
    kept, generated = region_errors(out["spec"], rt, mask)
    log(f"inpaint mean |Δ| to decode(encode(canvas)): kept region {kept:.6f}"
        f" generated region {generated:.6f}")

    # the contract at full width (tests/test_pipeline_inpaint.py): 4 DDIM
    # steps, CFG 1, no classifier, a fully known canvas
    g4 = GenerationConfig(sampler="ddim", steps=4, sample_num=SAMPLES,
                          gl_iters=2, cfg_scale=1.0, classifier_scale=0.0,
                          wav_dtype="int16")
    full = np.ones_like(known)
    err_in = np.abs(pipe.inpaint(feats, known, full, seed=5, gen=g4)["spec"]
                    - rt[None]).mean()
    err_free = np.abs(pipe.generate(feats, seed=5, gen=g4)["spec"]
                      - rt[None]).mean()
    log(f"inpaint contract: fully known canvas mean |Δ| {err_in:.6f}, free "
        f"generation {err_free:.6f} (must be ≥ 10× apart)")
    if not err_in * 10 <= err_free:
        raise AssertionError(f"inpaint lands {err_in} from the roundtrip, "
                             f"free generation {err_free}")
    if profile:
        with torch.no_grad():
            cond = feats_w.repeat_interleave(SAMPLES, dim=0)
            profile_steps("ddim-masked", lambda: pipe.ldm.sample(
                cond, generator=torch.Generator("cuda").manual_seed(2),
                mask=mask_s, x0=z0,
                **pipe.sampler_kwargs(dataclasses.replace(gen, steps=2))))
    return launches, {"main_call_s": call_s,
                      **{f"first_{k}": v for k, v in first.items()},
                      **{f"warm_{k}": v for k, v in warm.items()},
                      "latent_kept_max_abs_delta": latent_kept,
                      "kept_mean_abs_delta": kept,
                      "generated_mean_abs_delta": generated,
                      "contract_inpaint": float(err_in),
                      "contract_free": float(err_free)}


# ---- the sampler library --------------------------------------------------------

class UNetCalls:
    """Counts the UNet's forward calls: one per guided model call (CFG
    runs both halves in one call)."""

    def __init__(self, unet):
        self.n = 0
        self.handle = unet.register_forward_hook(self._hook)

    def _hook(self, *_):
        self.n += 1


def expected_nfe(sampler: str, steps: int, opts: dict, num_timesteps: int):
    """The model calls a fixed-grid call makes (None: adaptive)."""
    if sampler == "dpm":
        method = opts.get("method", "multistep")
        if method == "adaptive":
            return None
        base = (steps if method == "multistep" else sum(
            sampler_lib.singlestep_orders(steps, opts.get("order", 2),
                                          method)))
        return base + bool(opts.get("denoise_to_zero"))
    if sampler in ("ancestral", "progressive"):
        return opts["timesteps"]
    n = len(make_ddim_timesteps(steps, num_timesteps,
                                opts.get("discr_method", "uniform")))
    return n + (sampler == "plms")


def sampler_call(name, pipe, units_of, counter, fn, nfe_expect):
    """One call of the phase, first then warm: seconds, model calls (the
    UNet's forward calls) against ``nfe_expect`` (None: the solver's own
    count in ``stats``), launches against ``predicted_launches`` of the
    call's units ``units_of(model calls)``, finite outputs. Returns the
    row, the launches and the units of both runs."""
    row = {"name": name}
    launches, units = collections.Counter(), collections.Counter()
    for run in ("first", "warm"):
        stats = {}
        reset_counts()
        counter.n = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn(stats)
        torch.cuda.synchronize()
        row[f"{run}_s"] = time.perf_counter() - t0
        got = read_counts()
        nfe = counter.n
        if nfe_expect is None:
            if stats.get("nfe") != nfe:
                raise AssertionError(f"{name}: the solver counted "
                                     f"{stats.get('nfe')} model calls, the "
                                     f"UNet ran {nfe}")
            row[f"{run}_host_syncs"] = stats["host_syncs"]
        elif nfe != nfe_expect:
            raise AssertionError(f"{name}: {nfe} model calls, expected "
                                 f"{nfe_expect}")
        row[f"{run}_nfe"] = nfe
        u = units_of(nfe)
        check_launches(f"samplers {name} ({run})", got,
                       predicted_launches(pipe, STEPS, u)["samplers"])
        launches.update(got)
        units.update(u)
        outs = out if isinstance(out, tuple) else (out,)
        for o in outs:
            if not torch.isfinite(o).all():
                raise AssertionError(f"{name}: non-finite output")
        if nfe:
            row[f"{run}_s_per_nfe"] = row[f"{run}_s"] / nfe
    log("samplers " + json.dumps(row))
    return row, launches, units


def sampler_phase(pipe, feats, spec, clip: str):
    """The sampler library at full width (SAMPLER_CALLS, then the ancestral
    inpaint, img2img, PLMS through ``cli.generate``, and the tiled pair):
    each call first and warm, its model calls, its launches held to the
    model structure's per-call prediction, finite outputs. Returns the
    launches of every counted run, their units (``SP_UNITS``) and the
    rows."""
    n = SP_SAMPLES
    dev = pipe.device
    feats_w = torch.as_tensor(feats[:WINDOW_FEATS], device=dev)[None]
    cond = feats_w.repeat_interleave(n, dim=0)
    x_T = torch.randn((n, *LATENT_HW, 4), generator=torch.Generator(
        dev).manual_seed(7), device=dev)
    gen = GenerationConfig(sample_num=n, wav_dtype="int16")
    guide = {k: v for k, v in pipe.sampler_kwargs(gen).items()
             if k not in ("sampler", "steps")}
    guided = lambda k: sp_units(guided=k)
    counter = UNetCalls(pipe.ldm.unet)
    total, units = collections.Counter(), collections.Counter()
    rows = []
    try:
        for name, sampler, steps, opts in SAMPLER_CALLS:
            def fn(stats, sampler=sampler, steps=steps, opts=opts):
                kw = dict(opts, stats=stats) if sampler == "dpm" else opts
                return pipe.ldm.sample(
                    cond, sampler=sampler, steps=steps, x_T=x_T,
                    generator=torch.Generator(dev).manual_seed(8), **guide,
                    **kw)
            row, got, u = sampler_call(
                name, pipe, guided, counter, fn,
                expected_nfe(sampler, steps, opts,
                             pipe.ldm.schedule.num_timesteps))
            rows.append(row)
            total.update(got)
            units.update(u)

        # the ancestral chain's inpaint: the canvas is window 0 of
        # generate's sample 0, the first KEEP_FRAMES frames kept
        known = spec[0][:, :SPEC_HW[1]]
        mask = continuation_mask(SPEC_HW[1], KEEP_FRAMES)
        spec_w = torch.as_tensor(known[None], device=dev)
        mask_lat = torch.as_tensor(spec_mask_to_latent(mask[None]),
                                   device=dev)
        gen_a = GenerationConfig(sampler="ancestral", sample_num=n,
                                 wav_dtype="int16",
                                 solver_opts=(("timesteps", SP_CHAIN),))
        first, _ = inpaint_stages(pipe, feats_w, spec_w, mask_lat, gen_a, 3)
        inpaint_units = sp_units(guided=SP_CHAIN, inpaint_vae=1)
        reset_counts()
        counter.n = 0
        t0 = time.perf_counter()
        out = pipe.inpaint(feats[:WINDOW_FEATS], known, mask, seed=0,
                           gen=gen_a)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        got = read_counts()
        if counter.n != SP_CHAIN:
            raise AssertionError(f"ancestral inpaint: {counter.n} model "
                                 f"calls, expected {SP_CHAIN}")
        check_launches("samplers inpaint-ancestral", got, predicted_launches(
            pipe, STEPS, inpaint_units)["samplers"])
        total.update(got)
        units.update(inpaint_units)
        check_outputs(out, "samplers inpaint-ancestral", n, 1)
        warm, (z, z0, mask_s) = inpaint_stages(pipe, feats_w, spec_w,
                                               mask_lat, gen_a, 4)
        kept = float(((z - z0) * mask_s).abs().max())
        log(f"samplers inpaint-ancestral latents max|Δ| to the canvas's on "
            f"the kept cells {kept} (the final composite pins them)")
        if kept != 0.0:
            raise AssertionError("the ancestral inpaint moved kept latents")
        rows.append({"name": "inpaint-ancestral", "main_call_s": call_s,
                     "nfe": SP_CHAIN,
                     **{f"first_{k}": v for k, v in first.items()},
                     **{f"warm_{k}": v for k, v in warm.items()}})
        log("samplers " + json.dumps(rows[-1]))

        # img2img: the canvas's latents diffused to index 12 of a 25-step
        # DDIM run, then decoded from there with the guided ε
        steps_i, t_index = SP_IMG2IMG
        z0 = pipe.encode_canvas(spec_w).repeat_interleave(n, dim=0)
        context = pipe.ldm.get_learned_conditioning(cond)
        eps = make_guided_eps_fn(
            pipe.ldm.apply_model, context, torch.zeros_like(context),
            GuidanceSpec(guide["cfg_scale"], guide["classifier_scale"]),
            lambda x, t, c: F.logsigmoid(pipe.classifier(
                x, t, c, return_logits=True)), cond)

        def img2img(stats):
            g = torch.Generator(dev).manual_seed(9)
            z = ddim_stochastic_encode(pipe.ldm.schedule, z0, t_index,
                                       steps=steps_i, generator=g)
            return ddim_decode(eps, pipe.ldm.schedule, z, t_index,
                               steps=steps_i)
        row, got, u = sampler_call("img2img-encode-decode", pipe, guided,
                                   counter, img2img, t_index)
        rows.append(row)
        total.update(got)
        units.update(u)

        # the tiled pair on a 16×128 latent canvas
        zc = torch.randn((n, *TILED_CANVAS, 4), generator=torch.Generator(
            dev).manual_seed(10), device=dev)
        def tiled_decode(stats):
            return pipe.ldm.decode_first_stage_tiled(
                zc.to(pipe.vae_compute), SplitInputParams())
        row, got, u = sampler_call(
            "decode_first_stage_tiled", pipe,
            lambda k: sp_units(tiled_decode=1), counter, tiled_decode, 0)
        rows.append(row)
        total.update(got)
        units.update(u)
        t_model = torch.full((n,), 500.0, device=dev)

        def tiled_unet(stats):
            return pipe.ldm.apply_model_tiled(
                zc, t_model, context,
                SplitInputParams(ks=(16, 64), stride=(16, 32)))
        # one UNet call of 3·n tiles, without guidance
        row, got, u = sampler_call(
            "apply_model_tiled", pipe, lambda k: sp_units(tiled_unet=k),
            counter, tiled_unet, 1)
        rows.append(row)
        total.update(got)
        units.update(u)
    finally:
        counter.handle.remove()

    # PLMS through the CLI, once: the video run's models and shapes at
    # 26 model calls (25 steps and the bootstrap's second call)
    if clip is None:
        log("samplers cli.generate --sampler plms: not run, it reads a "
            "video file (no cv2)")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts()
            t0 = time.perf_counter()
            paths = generate_cli.main(["--video", clip, "--random-weights",
                                       "--out", tmp, "--bf16", "--sampler",
                                       "plms"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            got = read_counts()
            cli_units = sp_units(video_nfe=SP_PLMS + 1, video_decode=1)
            check_launches("samplers cli.generate --sampler plms", got,
                           predicted_launches(pipe, STEPS,
                                              cli_units)["samplers"])
            total.update(got)
            units.update(cli_units)
            wavs = []
            for p in paths:
                with wave.open(p, "rb") as f:
                    wavs.append((f.getframerate(), 8 * f.getsampwidth(),
                                 f.getnframes()))
                    pcm = np.frombuffer(f.readframes(f.getnframes()),
                                        np.int16)
                if not np.isfinite(pcm.astype(np.float32)).all():
                    raise AssertionError("cli.generate --sampler plms wrote "
                                         "a non-finite wav")
            if wavs != [(16000, 16, WINDOW_SAMPLES)] * VIDEO_SAMPLES:
                raise AssertionError(f"cli.generate --sampler plms wrote "
                                     f"{wavs}")
            rows.append({"name": "cli-generate-plms", "cli_s": cli_s,
                         "nfe": SP_PLMS + 1, "wavs": wavs})
            log("samplers " + json.dumps(rows[-1]))
    return ({k: n for k, n in sorted(total.items()) if n},
            sp_units(**units), rows)


# ---- the video entry ---------------------------------------------------------

def have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def write_clip(path: str, seconds: float = VIDEO_SECONDS,
               fps: float = VIDEO_FPS, size: int = FRAME, seed: int = 0):
    """A seeded constant-rate MJPG clip: coarse random colour fields
    drifting from frame to frame, 8×8 blocks of random pixels, upscaled."""
    import cv2

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (size // 8, size // 8, 3), dtype=np.uint8)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                        (size, size))
    if not w.isOpened():
        raise AssertionError(f"cv2 cannot write MJPG to {path}")
    for i in range(int(round(seconds * fps))):
        frame = np.roll(base, i, axis=1) // 2 + rng.integers(
            0, 128, base.shape, dtype=np.uint8)
        w.write(cv2.resize(frame, (size, size),
                           interpolation=cv2.INTER_NEAREST))
    w.release()
    return path


def seeded_frames(n: int = WINDOW_FEATS, seed: int = 0) -> np.ndarray:
    """(n, FRAME, FRAME, 3) frames in [0, 1], for a card without cv2."""
    return np.random.default_rng(seed).uniform(
        size=(n, FRAME, FRAME, 3)).astype(np.float32)


def video_entry(pipe, seed: int = 5) -> DiffFoley:
    """The video entry at full width on the flagship's LDM (its UNet and
    VAE already bf16): the CAVP towers (SlowOnly-R50, CNN14) and the
    alignment classifier in fp32, seeded random weights and BatchNorm
    statistics (the classifier's weights are the flagship's before its
    bf16 cast)."""
    cavp = randomize_(CAVPModel(CAVPConfig()), seed)
    clf = randomize_(ClassifierBackbone(CLASSIFIER_BACKBONE), 1)
    return DiffFoley(pipe.ldm, cavp, clf, bf16=True, device="cuda")


def check_features(feats: np.ndarray, what: str):
    norms = np.linalg.norm(feats, axis=-1)
    if feats.shape != (WINDOW_FEATS, 512) or not np.isfinite(feats).all() \
            or np.abs(norms - 1.0).max() > 1e-4:
        raise AssertionError(f"{what} features {feats.shape}, |norm − 1| "
                             f"{np.abs(norms - 1.0).max()}")


def video_stages(df, read, gen, seed: int):
    """``generate_for_video``'s stages, each timed: frame decode, CAVP
    encode, sampler, VAE decode, Griffin-Lim. Returns them and the
    frames."""
    stages = {}
    frames = timed(stages, "decode_s", read)
    feats = timed(stages, "cavp_s", lambda: encode_frames(
        frames, df.cavp, device="cuda"))
    check_features(feats, "video")
    g = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        cond = torch.as_tensor(window_features(feats), device="cuda"
                               ).repeat_interleave(gen.sample_num, dim=0)
        z = timed(stages, "sampler_s", lambda: df.pipe.ldm.sample(
            cond, generator=g, **df.pipe.sampler_kwargs(gen)))
        specs = timed(stages, "vae_decode_s", lambda: df.pipe.decode_specs(z))
        timed(stages, "griffin_lim_s", lambda: mel_to_wav(
            specs, n_iter=gen.gl_iters, length=WINDOW_SAMPLES, generator=g))
    stages["total_s"] = sum(stages.values())
    return stages, frames


def video_phase(pipe, expect, tmp: str, profile: bool):
    """``DiffFoley.generate_for_video`` at full width: a first call split
    into its stages, the main-path call, a warm call split into its
    stages; the CAVP tower's time; its features against the CPU's; then
    ``cli.generate`` once."""
    df = video_entry(pipe)
    gen = GenerationConfig(steps=STEPS, sample_num=VIDEO_SAMPLES,
                           wav_dtype="int16")
    cv2_ok = have_cv2()
    path = None
    if cv2_ok:
        path = write_clip(os.path.join(tmp, "clip.avi"))
        log(f"ingest: cv2, {VIDEO_SECONDS} s {VIDEO_FPS:g}-fps "
            f"{FRAME}x{FRAME} MJPG clip")
        run = lambda: df.generate_for_video(path, seed=0, gen=gen)
        read = lambda: extract_frames(path, size=FRAME, truncate_second=8.2)
    else:
        log("ingest: frames (no cv2)")
        run = lambda: df.generate_from_features(
            encode_frames(seeded_frames(), df.cavp, device="cuda"), seed=0,
            gen=gen)
        read = seeded_frames
    first, _ = video_stages(df, read, gen, 3)
    log("video first stages " + json.dumps(first))

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"video {call_s:.3f} s (main-path call) peak_mem_GiB {peak:.3f}")
    check_launches("video", launches, expect)
    check_outputs(out, "video", VIDEO_SAMPLES, 1)

    warm, frames = video_stages(df, read, gen, 4)
    log("video warm stages " + json.dumps(warm))
    if profile:   # the sampler with the fp32 classifier
        with torch.no_grad():
            cond = torch.as_tensor(window_features(encode_frames(
                frames, df.cavp, device="cuda")), device="cuda"
            ).repeat_interleave(VIDEO_SAMPLES, dim=0)
        profile_steps("dpm-video", lambda: df.pipe.ldm.sample(
            cond, generator=torch.Generator("cuda").manual_seed(2),
            **df.pipe.sampler_kwargs(dataclasses.replace(gen, steps=2))))

    # the CAVP tower on the path's clip: its device time, and its features
    # against the CPU's (fp32, TF32 off) on the first four frames
    clip = torch.as_tensor(frames[None], device="cuda")
    with torch.no_grad():
        encode = lambda: df.cavp.encode_video(clip, normalize=True,
                                              pool=False)
        cavp_ms = time_ms(encode, iters=3, warmup=1)
        cavp_device_ms = device_ms(encode, iters=3)
        cpu = copy.deepcopy(df.cavp).cpu()
        ref = cpu.encode_video(torch.as_tensor(frames[None, :4]), True, False)
        gpu = df.cavp.encode_video(clip[:, :4], True, False).cpu()
    feat_ratio = float((gpu - ref).abs().max() / ref.square().mean().sqrt())
    log(f"video CAVP encode of {len(frames)} frames {cavp_ms:.3f} ms "
        f"(events), device {cavp_device_ms:.3f} ms; GPU against CPU "
        f"features on 4 frames max|Δ| {feat_ratio:.3e} of rms (tol 1e-3)")
    if not feat_ratio <= 1e-3:
        raise AssertionError("the CAVP towers on the GPU disagree with the "
                             "CPU's")
    del df, cpu

    cli = {}
    if not cv2_ok:
        log("video cli.generate: not run, it reads a video file (no cv2)")
    else:
        out_dir = os.path.join(tmp, "generated")
        reset_counts()
        t0 = time.perf_counter()
        paths = generate_cli.main(["--video", path, "--random-weights",
                                   "--out", out_dir, "--bf16"])
        torch.cuda.synchronize()
        cli["cli_s"] = time.perf_counter() - t0
        check_launches("video cli.generate", read_counts(), expect)
        wavs = []
        for p in paths:
            with wave.open(p, "rb") as f:
                wavs.append((f.getframerate(), 8 * f.getsampwidth(),
                             f.getnframes()))
        specs = [np.load(p[:-4] + "_spec.npy") for p in paths]
        log(f"video cli.generate {cli['cli_s']:.3f} s (models built with "
            f"random weights, then the call): wavs (Hz, bits, samples) "
            f"{wavs}, specs {[sp.shape for sp in specs]}")
        if wavs != [(16000, 16, WINDOW_SAMPLES)] * VIDEO_SAMPLES or any(
                sp.shape != (128, 512) or not np.isfinite(sp).all()
                for sp in specs):
            raise AssertionError("cli.generate did not write four int16 "
                                 "16-kHz wavs and four spec files")
    return launches, {"main_call_s": call_s, "peak_mem_GiB": peak,
                      "cv2": cv2_ok,
                      **{f"first_{k}": v for k, v in first.items()},
                      **{f"warm_{k}": v for k, v in warm.items()},
                      "cavp_ms": cavp_ms, "cavp_device_ms": cavp_device_ms,
                      "cavp_gpu_cpu_max_ratio": feat_ratio, **cli}


# ---- serving ------------------------------------------------------------------

def http(url: str, body=None, raw: bool = False):
    """(status, JSON reply) of a GET (no body) or a POST to the server."""
    data = None if body is None else body if raw else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def check_wav(wav: np.ndarray, windows: int, what: str):
    if wav.shape != (windows * WINDOW_SAMPLES,) or wav.dtype != np.int16:
        raise AssertionError(f"{what}: wav {wav.shape} {wav.dtype}, not "
                             f"{windows} windows of int16")


def serve_phase(pipe, expect, clip: str, card: str, profile: bool):
    """``BatchingEngine`` and ``FoleyServer`` at full width over the
    flagship's models (bf16 UNet, classifier and VAE), built from
    ``DiffFoley.pipe`` with random CAVP towers for ``extract_features``;
    25 steps, CFG 4.5, classifier guidance 50, 32 Griffin-Lim iterations,
    one sample, int16. The warm-up ladder, then a warm request per bucket
    (the bucket-16 one is the main-path run, its launches counted), one
    1-window request, eight concurrent ones (at least one batch of two or
    more requests), one of 20 windows (two bucket-16 chunks), the fan-out
    of the largest batch replayed by a direct bucketed ``generate`` with
    its seed (bit for bit), and each HTTP route on 127.0.0.1."""
    if not have_cv2():
        raise AssertionError("serving's /generate_video needs cv2")
    gen = GenerationConfig(steps=STEPS, sample_num=1, return_spec=False,
                           wav_dtype="int16")
    df = DiffFoley(pipe.ldm, randomize_(CAVPModel(CAVPConfig()), 5),
                   pipe.classifier, bf16=True, device="cuda")
    engine = BatchingEngine(df.pipe, gen, max_batch_windows=SERVE_BUCKET)
    server = None
    rng = np.random.default_rng(11)
    feats = lambda w: rng.standard_normal(
        (w * WINDOW_FEATS, 512)).astype(np.float32)
    try:
        ladder = engine.aot_warmup()
        log(f"serve warm-up, first call of each bucket (status, s) "
            f"{json.dumps(ladder)} ({card})")
        warm = {}
        for b in ladder:
            f = feats(b)
            if b == SERVE_BUCKET:
                reset_counts()
            t0 = time.perf_counter()
            wav = engine.submit(f, timeout=600)
            warm[b] = time.perf_counter() - t0
            if b == SERVE_BUCKET:
                launches = read_counts()
            check_wav(wav, b, f"serve bucket {b}")
        check_launches("serve", launches, expect)
        single = engine.submit(feats(1), timeout=600)
        check_wav(single, 1, "serve 1-window request")

        reqs, latency = [None] * len(SERVE_WINDOWS), [0.0] * len(SERVE_WINDOWS)
        start = threading.Barrier(len(SERVE_WINDOWS))
        inputs = [feats(w) for w in SERVE_WINDOWS]

        def client(i):
            start.wait()
            t0 = time.perf_counter()
            reqs[i] = engine.enqueue(inputs[i])
            reqs[i].event.wait(600)
            latency[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(SERVE_WINDOWS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batches = {}
        for r, w in zip(reqs, SERVE_WINDOWS):
            if r is None or r.error or r.result is None:
                raise AssertionError(f"serve concurrent request failed: "
                                     f"{r and r.error}")
            check_wav(r.result, w, "serve concurrent request")
            batches.setdefault(r.seed, []).append(r)
        batches = [sorted(b, key=lambda r: r.offset)
                   for b in batches.values()]
        formed = [{"bucket": b[0].bucket,
                   "windows": [r.feats.shape[0] for r in b]} for b in batches]
        log(f"serve concurrent requests of {list(SERVE_WINDOWS)} windows: "
            f"batches formed {json.dumps(formed)}")
        if max(len(b) for b in batches) < 2:
            raise AssertionError("the engine formed no batch of two or more "
                                 "requests")
        # the largest batch replayed by a direct bucketed generate
        batch = max(batches, key=len)
        ref = df.pipe.generate(
            np.concatenate([r.feats for r in batch]).reshape(-1, 512),
            batch[0].seed, gen, bucket_windows=batch[0].bucket)["wav"][0]
        fan_out = max(int(np.abs(r.result.astype(np.int32) - ref[
            r.offset * WINDOW_SAMPLES:(r.offset + r.feats.shape[0])
            * WINDOW_SAMPLES].astype(np.int32)).max()) for r in batch)
        log(f"serve fan-out of a batch of {len(batch)} requests against a "
            f"direct bucketed generate with its seed: max|Δ| {fan_out} "
            f"(must be 0)")
        if fan_out:
            raise AssertionError("the engine's fan-out differs from a direct "
                                 "bucketed generate")
        t0 = time.perf_counter()
        big = engine.submit(feats(SERVE_OVERSIZE), timeout=600)
        oversize_s = time.perf_counter() - t0
        check_wav(big, SERVE_OVERSIZE, "serve oversize request")

        server = FoleyServer(engine, port=0,
                             feature_fn=df.extract_features)
        server.start_background()
        base = f"http://127.0.0.1:{server.port}"
        routes = {}

        def route(name, expect_code, *args, **kw):
            t0 = time.perf_counter()
            code, body = http(base + name.split()[0], *args, **kw)
            routes[name] = {"status": code,
                            "s": time.perf_counter() - t0}
            if code != expect_code or (code == 200 and not (
                    body.get("num_samples") == len(body.get("wav", ()))
                    == WINDOW_SAMPLES and body["sr"] == 16000)):
                raise AssertionError(f"serve HTTP {name}: {code} "
                                     f"{str(body)[:200]}")
            return body

        code, body = http(base + "/healthz")
        routes["/healthz"] = {"status": code}
        if (code, body) != (200, {"status": "ok"}):
            raise AssertionError(f"serve HTTP /healthz: {code} {body}")
        route("/generate", 200, {"features": feats(1).tolist()})
        known = single[:4 * 16000].astype(np.float32) / 32767.0
        route("/continue", 200, {"features": feats(1).tolist(),
                                 "known_wav": known.tolist(),
                                 "known_seconds": 2.0})
        route("/generate_video", 200, open(clip, "rb").read(), raw=True)
        route("/generate malformed", 400, {"features": [[1.0, 2.0]]})
        log("serve HTTP routes " + json.dumps(routes))
        if profile:
            f16 = feats(SERVE_BUCKET)
            profile_steps("serve-bucket16", lambda: df.pipe.generate(
                f16, 0, gen, bucket_windows=SERVE_BUCKET), steps=1)
    finally:
        if server is not None:
            server.shutdown()
        engine.stop()
    times = {
        "first_call_s": {b: s for b, (_, s) in ladder.items()},
        "warm_s": warm,
        f"windows_per_min_bucket{SERVE_BUCKET}": 60.0 * SERVE_BUCKET / warm[SERVE_BUCKET],
        "concurrent_p50_s": statistics.median(latency),
        "concurrent_max_s": max(latency), "oversize_s": oversize_s,
        "batches": formed, "http": routes}
    log(f"serve {json.dumps(times)} ({card})")
    del df
    torch.cuda.empty_cache()
    return launches, times


def profile_steps(what: str, run, steps: int = 2, grad: bool = False):
    """torch.profiler over a warm run of two steps (of a sampler, or with
    ``grad`` of the trainer): device busy time per step (the union of the
    kernels' intervals), the idle share of the wall time, and the kernels
    that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.enable_grad() if grad else torch.no_grad():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name = {}
    for k in kernels:
        t = by_name.setdefault(k.name, [0.0, 0])
        t[0] += k.time_range.elapsed_us()
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    log(f"profile {what} " + json.dumps({
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "kernels_per_step": len(kernels) / steps,
        "top": [{"name": n[:90], "ms_per_step": t / 1e3 / steps,
                 "calls_per_step": c / steps} for n, (t, c) in top]}))


# ---- the trainer ------------------------------------------------------------------

def write_specs(root: str, n: int = 6, frames: int = 600, seed: int = 0):
    """Seeded mel specs (128, frames) in [0, 1], stationary in time (a
    smooth profile over the mel bins plus a little noise), so that the
    random crops of different steps are alike and nll_loss is comparable
    from step to step."""
    rng = np.random.default_rng(seed)
    mel = np.linspace(0.0, 1.0, 128, dtype=np.float32)[:, None]
    for i in range(n):
        profile = 0.5 + 0.3 * np.sin(2 * np.pi * (i + 1) * mel + i)
        spec = profile + 0.05 * rng.standard_normal((128, frames))
        np.save(os.path.join(root, f"clip{i}_mel.npy"),
                np.clip(spec, 0.0, 1.0).astype(np.float32))


def random_lpips(seed: int) -> LPIPS:
    """LPIPS with seeded random trunk weights, non-negative heads (as the
    trained ones) and the scaling layer's constants, frozen, on the card."""
    model = LPIPS()
    consts = {k: v.clone() for k, v in model.state_dict().items()
              if k in ("shift", "scale")}
    randomize_(model, seed)
    with torch.no_grad():
        for k in range(5):
            getattr(model, f"lin{k}").weight.abs_()
    model.load_state_dict(consts, strict=False)
    return model.to("cuda").requires_grad_(False)


def gn_backward_cost(pipe):
    """The plain GroupNorm backward (``FusedGroupNorm.backward`` recomputes
    the formula under autograd) at each of the VAE's maps at the train
    batch in fp32: ms per train step summed over the sites, beside the
    forward kernels', and the memory one backward takes at the largest map."""
    gen = torch.Generator("cuda").manual_seed(6)
    total_bwd = total_fwd = 0.0
    worst = (0, None, 0.0)
    for (model, b, c, h, w, eps, act, dtype), per_run in gn_path(
            pipe, WINDOWS * SAMPLES, STEPS).items():
        per_step = per_run["train_vae"] // TRAIN_STEPS
        if not per_step:
            continue
        x = torch.randn((b, c, h, w), generator=gen, device="cuda",
                        dtype=dtype).requires_grad_(True)
        gamma = torch.ones(c, device="cuda", requires_grad=True)
        beta = torch.zeros(c, device="cuda", requires_grad=True)
        y = hg.fused_group_norm(x, gamma, beta, 32, eps, act)
        g = torch.randn_like(y)
        bwd = lambda: torch.autograd.grad(y, (x, gamma, beta), g,
                                          retain_graph=True)
        total_bwd += per_step * time_ms(bwd, iters=3, warmup=1)
        with torch.no_grad():
            total_fwd += per_step * time_ms(lambda: hg.fused_group_norm(
                x, gamma, beta, 32, eps, act), iters=3, warmup=1)
        if x.numel() > worst[0]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            bwd()
            torch.cuda.synchronize()
            worst = (x.numel(), f"{model}-{c}x{h}x{w}",
                     (torch.cuda.max_memory_allocated() - base) / 2**30)
    reset_counts()
    return {"gn_backward_ms_per_step": total_bwd,
            "gn_forward_kernels_ms_per_step": total_fwd,
            "largest_map": worst[1],
            "largest_map_GiB": worst[0] * 4 / 2**30,
            "backward_extra_GiB_at_largest_map": worst[2]}


def train_phase(pipe, expect, profile: bool):
    """``cli.train_vae`` at SD_VAE's full width: the main-path call of
    TRAIN_STEPS steps, the resume, then warm steps split into the generator
    and the discriminator step, the GroupNorm backward's cost and one step
    with the LPIPS hook on."""
    with tempfile.TemporaryDirectory() as tmp:
        spec_dir, logdir = os.path.join(tmp, "specs"), os.path.join(tmp, "log")
        os.makedirs(spec_dir)
        write_specs(spec_dir)
        args = ["--spec-dir", spec_dir, "--logdir", logdir, "--batch-size",
                str(TRAIN_BATCH), "--lr", str(TRAIN_LR), "--disc-start", "0",
                "--log-every", "1", "--save-every", "1000000"]
        log(f"train_vae SD_VAE fp32 batch {TRAIN_BATCH} lr {TRAIN_LR} "
            f"{TRAIN_STEPS} steps, disc_start 0")
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_vae_cli.main(args + ["--max-steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        read_rows = lambda: [json.loads(line) for line in open(
            os.path.join(logdir, "metrics.jsonl"))]
        main_rows = rows = read_rows()
        log("train_vae metrics " + json.dumps(rows))
        log(f"train_vae {call_s:.3f} s (main-path call: set-up, "
            f"{TRAIN_STEPS} steps, checkpoint) peak_mem_GiB {peak:.3f}")
        check_launches("train_vae", launches, expect)
        if [r["step"] for r in rows] != list(range(1, TRAIN_STEPS + 1)):
            raise AssertionError("train_vae did not log every step")
        for r in rows:
            if not np.isfinite(list(r.values())).all():
                raise AssertionError(f"train_vae metrics not finite: {r}")
            if not (r["train/d_weight"] >= 0 and r["train/disc_loss"] > 0):
                raise AssertionError(f"the GAN term is off or negative: {r}")
        nll = [r["train/nll_loss"] for r in rows]
        if not nll[-1] < nll[0]:
            raise AssertionError(f"nll_loss did not fall: {nll}")
        n_params = sum(p.numel() for p in state.vae.parameters())
        del state

        # the checkpoint reloads and the run continues at the saved step
        resumed = train_vae_cli.main(
            args + ["--max-steps", str(TRAIN_STEPS + 1), "--resume"])
        rows = read_rows()
        adam_steps = int(next(iter(resumed.opt.state.values()))["step"])
        log(f"train_vae resume: step {resumed.step}, Adam step {adam_steps}, "
            f"nll {rows[-1]['train/nll_loss']:.4f}")
        if not (resumed.step == adam_steps == rows[-1]["step"]
                == TRAIN_STEPS + 1 and len(rows) == TRAIN_STEPS + 1
                and np.isfinite(rows[-1]["train/nll_loss"])):
            raise AssertionError("the resumed run did not continue at the "
                                 "saved step")

        data = SpecDataset.from_dir(spec_dir)
        x = torch.from_numpy(np.stack(
            [data[i]["spec"] for i in range(TRAIN_BATCH)])).to("cuda")
    state = resumed
    tcfg = VAETrainConfig(lr=TRAIN_LR, loss=VAELossConfig(disc_start=0))
    trainer = VAETrainer(SD_VAE, tcfg)
    gen = torch.Generator("cuda").manual_seed(9)
    warm = []
    for _ in range(3):
        stages = {}
        _, rec = timed(stages, "generator_s", lambda: trainer.generator_step(
            state, x, generator=gen))
        timed(stages, "discriminator_s",
              lambda: trainer.discriminator_step(state, x, rec))
        state.step += 1
        warm.append(stages)
    log("train_vae warm steps " + json.dumps(warm))
    gn_cost = gn_backward_cost(pipe)
    log("train_vae GroupNorm backward " + json.dumps(gn_cost))

    # one step with the LPIPS hook on: the perceptual branch of the
    # reconstruction term and of the adaptive weight's probe
    hooked = VAETrainer(SD_VAE, dataclasses.replace(
        tcfg, loss=VAELossConfig(disc_start=0, perceptual_weight=1.0)),
        perceptual_fn=make_lpips_fn(random_lpips(7)))
    stages = {}
    m = timed(stages, "lpips_step_s",
              lambda: hooked.train_step(state, x, generator=gen))
    m = {k: float(v) for k, v in m.items()}
    log(f"train_vae step with the LPIPS hook {stages['lpips_step_s']:.3f} s "
        + json.dumps(m))
    if not np.isfinite(list(m.values())).all():
        raise AssertionError(f"LPIPS step not finite: {m}")
    if profile:
        profile_steps("train_vae", lambda: [trainer.train_step(
            state, x, generator=gen) for _ in range(2)], grad=True)
    best = min(warm, key=lambda w: w["generator_s"] + w["discriminator_s"])
    return launches, {
        "batch": TRAIN_BATCH, "vae_params": n_params,
        "main_call_s": call_s, "first_step_s": main_rows[0]["step_s"],
        "cli_step_s": [r["step_s"] for r in main_rows],
        "warm_generator_s": best["generator_s"],
        "warm_discriminator_s": best["discriminator_s"],
        "warm_step_s": best["generator_s"] + best["discriminator_s"],
        "peak_mem_GiB": peak, "nll_first": nll[0], "nll_last": nll[-1],
        "lpips_step_s": stages["lpips_step_s"], **gn_cost}


# ---- the waveform VAE's trainer ---------------------------------------------------

def write_wavs(root: str, n: int = SV_BATCH,
               samples: int = SV_WINDOW + 16000, seed: int = 0):
    """Seeded int16 16-kHz wavs: a few tones with noise, 0.3 of full
    scale."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000.0
    for i in range(n):
        wav = sum(np.sin(2 * np.pi * f * t + ph) for f, ph in zip(
            rng.uniform(80, 4000, 4), rng.uniform(0, 2 * np.pi, 4)))
        wav = 0.3 * wav / 4 + 0.02 * rng.standard_normal(samples)
        write_wav(os.path.join(root, f"w{i}.wav"),
                  (wav * 32767).astype(np.int16))


def train_sound_vae_phase(expect):
    """``cli.train_sound_vae`` at the CLI's own width (channels 32, z 128,
    65536-sample crops, batch 8, AudioGANConfig's defaults: mel windows
    32–2048, STFT windows 512–2048, n_fft 2048) on seeded wavs, the GAN on
    from step 0: the main-path call of SV_STEPS steps, every loss finite,
    no TPU kernel launched; the resume to one step more; then
    ``load_native_sound_vae`` rebuilds the model, which reconstructs one
    window on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        wav_dir, logdir = os.path.join(tmp, "wavs"), os.path.join(tmp, "log")
        os.makedirs(wav_dir)
        write_wavs(wav_dir)
        args = ["--wav-dir", wav_dir, "--logdir", logdir, "--window",
                str(SV_WINDOW), "--batch-size", str(SV_BATCH),
                "--disc-start", "0", "--log-every", "1", "--save-every",
                "1000000"]
        log(f"train_sound_vae SoundAutoencoderKL channels 32 z 128, fp32, "
            f"window {SV_WINDOW}, batch {SV_BATCH}, {SV_STEPS} steps, "
            "disc_start 0")
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_sound_vae_cli.main(args + ["--steps", str(SV_STEPS)])
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        read_rows = lambda: [json.loads(line) for line in open(
            os.path.join(logdir, "metrics.jsonl"))]
        rows = read_rows()
        log("train_sound_vae metrics " + json.dumps(rows))
        check_launches("train_sound_vae", launches, expect)
        if [r["step"] for r in rows] != list(range(1, SV_STEPS + 1)):
            raise AssertionError("train_sound_vae did not log every step")
        for r in rows:
            if not (np.isfinite(list(r.values())).all()
                    and r["train/d_loss"] > 0):
                raise AssertionError(f"train_sound_vae metrics: {r}")
        warm = min(r["step_s"] for r in rows[1:])
        log(f"train_sound_vae {call_s:.3f} s (main-path call: set-up, "
            f"{SV_STEPS} steps, checkpoint); first step "
            f"{rows[0]['step_s']:.4f} s, warm step {warm:.4f} s, "
            f"peak_mem_GiB {peak:.3f}; total_loss "
            f"{rows[0]['train/total_loss']:.4f} → "
            f"{rows[-1]['train/total_loss']:.4f}")
        n_params = sum(p.numel() for p in state.vae.parameters())
        del state
        resumed = train_sound_vae_cli.main(
            args + ["--steps", str(SV_STEPS + 1), "--resume"])
        adam = resumed.opt.state_dict()["state"][0]["step"]
        last = read_rows()[-1]
        log(f"train_sound_vae resume: step {resumed.step}, Adam step "
            f"{int(adam)}, total_loss {last['train/total_loss']:.4f}")
        if not (resumed.step == int(adam) == last["step"] == SV_STEPS + 1
                and np.isfinite(last["train/total_loss"])):
            raise AssertionError("the resumed run did not continue at the "
                                 "saved step")
        del resumed
        vae = load_native_sound_vae(logdir).to("cuda")
        wav = next(train_sound_vae_cli.iter_wav_batches(
            [os.path.join(wav_dir, "w0.wav")], SV_WINDOW, 1, 0))
        x = torch.from_numpy(wav).to("cuda")
        with torch.no_grad():
            rec, post = vae(x, sample_posterior=False)
        l1 = float((rec - x).abs().mean())
        log(f"train_sound_vae load_native_sound_vae: reconstruction "
            f"{tuple(rec.shape)} of latent {tuple(post.mean.shape)}, "
            f"mean |rec − x| {l1:.4f} (mean |x| "
            f"{float(x.abs().mean()):.4f})")
        if rec.shape != x.shape or not torch.isfinite(rec).all():
            raise AssertionError("the rebuilt waveform VAE does not "
                                 "reconstruct")
    return launches, {
        "batch": SV_BATCH, "window": SV_WINDOW, "vae_params": n_params,
        "main_call_s": call_s, "first_step_s": rows[0]["step_s"],
        "cli_step_s": [r["step_s"] for r in rows], "warm_step_s": warm,
        "peak_mem_GiB": peak, "reconstruction_l1": l1,
        **{f"first_{k[6:]}": v for k, v in rows[0].items()
           if k.startswith("train/")},
        **{f"last_{k[6:]}": v for k, v in rows[-1].items()
           if k.startswith("train/")}}


def transform_spec_phase(spec: np.ndarray, tmp: str) -> dict:
    """``cli.transform_spec`` over ``generate``'s specs, one file per
    sample and window (128 × 512), to the SpecVQGAN format (twice: the
    first pass and a warm one) and back: the shapes, the [0, 1] range,
    the round trip's distance, seconds per file (host numpy and scipy)."""
    d_in, d_vq, d_back = (os.path.join(tmp, d) for d in ("in", "vq", "back"))
    os.makedirs(d_in)
    names = []
    for i in range(spec.shape[0]):
        for w in range(spec.shape[-1] // SPEC_HW[1]):
            names.append(f"s{i}_w{w}.npy")
            np.save(os.path.join(d_in, names[-1]),
                    spec[i, :, w * SPEC_HW[1]:(w + 1) * SPEC_HW[1]])
    out = {}
    # the first pass pays scipy's import and the mel bases; the second is
    # what each further file costs
    for run, src, dst, direction in (
            ("first", d_in, d_vq, "to_specvqgan"),
            ("warm", d_in, d_vq, "to_specvqgan"),
            ("warm", d_vq, d_back, "to_native")):
        t0 = time.perf_counter()
        rc = transform_spec_cli.main(["--input", src, "--output", dst,
                                      "--direction", direction])
        out[f"{run}_{direction}_s_per_file"] = (time.perf_counter() - t0) \
            / len(names)
        if rc:
            raise AssertionError(f"transform_spec {direction} failed")
    dist = []
    for n in names:
        vq, back = (np.load(os.path.join(d, n)) for d in (d_vq, d_back))
        orig = np.load(os.path.join(d_in, n))
        if vq.shape != (80, 706) or back.shape != (128, 513) or not all(
                np.isfinite(a).all() and a.min() >= 0.0 and a.max() <= 1.0
                for a in (vq, back)):
            raise AssertionError(f"transform_spec {n}: {vq.shape} "
                                 f"{back.shape}")
        dist.append(float(np.abs(back[:, :SPEC_HW[1]] - orig).mean()))
    out["round_trip_mean_abs"] = dist
    log(f"transform_spec {len(names)} files (128, 512) → (80, 706) → "
        f"(128, 513), all in [0, 1]; round trip mean |Δ| per file "
        f"{[round(d, 6) for d in dist]}; s/file to_specvqgan "
        f"{out['first_to_specvqgan_s_per_file']:.4f} first pass, "
        f"{out['warm_to_specvqgan_s_per_file']:.4f} warm; to_native "
        f"{out['warm_to_native_s_per_file']:.4f} warm")
    return out


# ---- stage-2 training -----------------------------------------------------------

def write_pairs(root: str, n: int = S2_ITEMS, frames: int = 600,
                feats: int = 40, seed: int = 0):
    """Seeded (mel spec, CAVP feature) pairs in the reference layout:
    ``Train.txt``, ``Train/audio_npy_spec/<id>_mel.npy`` (128 × frames in
    [0, 1], stationary in time as ``write_specs``'s) and
    ``CAVP_feat/Train/<id>.npz`` (feats × 512, N(0, 1))."""
    rng = np.random.default_rng(seed)
    spec_dir = os.path.join(root, "Train", "audio_npy_spec")
    feat_dir = os.path.join(root, "CAVP_feat", "Train")
    os.makedirs(spec_dir)
    os.makedirs(feat_dir)
    write_specs(spec_dir, n, frames, seed)
    ids = [f"clip{i}" for i in range(n)]
    with open(os.path.join(root, "Train.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    for i in ids:
        np.savez(os.path.join(feat_dir, f"{i}.npz"),
                 feat=rng.standard_normal((feats, 512)).astype(np.float32))


def trained(ldm) -> dict:
    """The stage-2 trainer's leaves of a LatentDiffusion."""
    return {k: p for k, p in ldm.named_parameters()
            if k.startswith(("unet.", "cond."))}


def leaf_distance(a: dict, b: dict) -> float:
    """‖a − b‖₂ over all leaves."""
    return float(global_norm([(a[k] - b[k]).float() for k in a]))


def prefetch_check(batches: int = 8):
    """``DevicePrefetcher`` on the card: batches of 16 MiB staged while the
    consumer's stream is busy with products between them must arrive
    whole, equal to their host arrays after the cast (a missing event wait
    or ``record_stream`` would hand out a half-copied or reused buffer)."""
    rng = np.random.default_rng(4)
    host = [{"x": rng.standard_normal((1024, 4096)).astype(np.float32),
             "i": np.full(3, k, np.int64)} for k in range(batches)]
    a = torch.randn((4096, 4096), device="cuda")
    seen = []
    for k, batch in enumerate(DevicePrefetcher(iter(host), device="cuda",
                                               cast_dtype=BF16)):
        for _ in range(8):   # keep the consumer's stream busy
            a = (a @ a).clamp_(-1, 1)
        ok = (batch["x"].dtype == BF16 and int(batch["i"][0]) == k
              and torch.equal(batch["x"].cpu(),
                              torch.from_numpy(host[k]["x"]).to(BF16)))
        seen.append(ok)
    log(f"DevicePrefetcher on the card: {sum(seen)} of {batches} batches "
        f"arrived whole and in order")
    if not (all(seen) and len(seen) == batches):
        raise AssertionError("DevicePrefetcher handed out a wrong batch")


def s2_args(data: str, logdir: str) -> list:
    """The stage-2 CLI's arguments of the main-path call (and of the
    parallel phase's, which adds --fsdp and fewer steps)."""
    return ["--data-dir", data, "--logdir", logdir, "--batch-size",
            str(S2_BATCH), "--base-lr", str(S2_LR), "--warmup-steps", "0",
            "--mixed-precision", "--use-ema", "--log-every", "1",
            "--save-every", "1000000", "--val-every", str(S2_STEPS),
            "--val-batches", "1"]


@contextlib.contextmanager
def stage2_probes(events: list):
    """While the stage-2 CLI runs: each ``SoundLogger.log`` call runs with
    the launch counts set to 0 and read just after (the CLI run's counts
    then put back), timed; a SIGUSR1 is raised while step S2_STEPS runs;
    and ``events`` records, in order, the signal, each train checkpoint
    saved and each logger call."""
    log_fn = callbacks_module.SoundLogger.log
    save_fn = checkpoint_module.save_checkpoint
    step_fn = Stage2Trainer.train_step

    def sound_log(self, step, *a, **k):
        saved = saved_counts()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = log_fn(self, step, *a, **k)
        torch.cuda.synchronize()
        events.append(("sound", step, time.perf_counter() - t0,
                       read_counts(), out))
        reset_counts()
        add_counts(saved)
        return out

    def save_checkpoint(ckpt_dir, step, payload, keep=None):
        if os.path.basename(ckpt_dir) == "ckpt":
            events.append(("save", step))
        return save_fn(ckpt_dir, step, payload, keep)

    def train_step(self, state, *a, **k):
        if state.step == S2_STEPS - 1 and not any(
                e[0] == "signal" for e in events):
            events.append(("signal", S2_STEPS))
            os.kill(os.getpid(), signal.SIGUSR1)
        return step_fn(self, state, *a, **k)

    callbacks_module.SoundLogger.log = sound_log
    checkpoint_module.save_checkpoint = save_checkpoint
    Stage2Trainer.train_step = train_step
    try:
        yield
    finally:
        callbacks_module.SoundLogger.log = log_fn
        checkpoint_module.save_checkpoint = save_fn
        Stage2Trainer.train_step = step_fn


def check_sound_logs(events: list, expect: dict) -> dict:
    """The SoundLogger's calls of the stage-2 run: at every SL_EVERY-th
    step, their launches summed against the prediction, their files
    (three clipped mel ``.npy`` of SL_N items and SL_N int16 wavs of each)
    finite, in [0, 1] and of the path's shapes."""
    logs = [e for e in events if e[0] == "sound"]
    if [e[1] for e in logs] != list(range(SL_EVERY, S2_STEPS + 1,
                                          SL_EVERY)):
        raise AssertionError(f"SoundLogger calls at {[e[1] for e in logs]}")
    total = collections.Counter()
    for _, step, seconds, launches, out in logs:
        total.update(launches)
        for name in ("gt", "rec", "sample"):
            mel = np.load(os.path.join(out, f"{name}_spec.npy"))
            if mel.shape != (SL_N, *SPEC_HW) or not (
                    np.isfinite(mel).all() and mel.min() >= 0.0
                    and mel.max() <= 1.0):
                raise AssertionError(f"SoundLogger {name} spec {mel.shape}")
            for i in range(SL_N):
                wav, sr = read_wav(os.path.join(out, f"{name}_{i}.wav"))
                if sr != 16000 or wav.shape != (511 * 256,) \
                        or not np.isfinite(wav).all():
                    raise AssertionError(f"SoundLogger {name}_{i}.wav "
                                         f"{wav.shape} at {sr} Hz")
        log(f"train_stage2 SoundLogger step {step}: {seconds:.3f} s, "
            f"launches {json.dumps(launches)}; gt/rec/sample specs "
            f"({SL_N}, {SPEC_HW[0]}, {SPEC_HW[1]}) finite in [0, 1], "
            f"{3 * SL_N} wavs of {511 * 256} samples")
    check_launches("sound_log", dict(sorted(total.items())), expect)
    return {"sound_log_s": [e[2] for e in logs]}


def check_preemption(events: list, ckpt_dir: str) -> None:
    """The SIGUSR1 raised during step S2_STEPS made the CLI save at that
    step's boundary (before the step's logger call), and that save was
    the run's only one: the last step needs no second."""
    order = [e[:2] for e in events]
    log(f"train_stage2 preemption: events {order}")
    i = order.index(("signal", S2_STEPS))
    saves = [e for e in order if e[0] == "save"]
    if not (saves == [("save", S2_STEPS)]
            and order[i + 1:] == [("save", S2_STEPS), ("sound", S2_STEPS)]
            and os.path.exists(os.path.join(ckpt_dir,
                                            f"step_{S2_STEPS}.pt"))):
        raise AssertionError("the CLI did not save at the step boundary "
                             f"after SIGUSR1: {order}")


def yaml_base_check() -> dict:
    """``cli.train_stage2 --base configs/stage2_ldm.yaml`` builds the
    flagship (with the YAML's block recompute), on the meta device."""
    try:
        import yaml  # noqa: F401
    except ImportError:
        log("train_stage2 --base: PyYAML does not import on this machine; "
            "the case stays with the CPU tests")
        return {"base_yaml": "PyYAML absent"}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "stage2_ldm.yaml")
    args = train_stage2_cli.parse_args(["--data-dir", "-", "--base", path])
    with torch.device("meta"):
        ldm = train_stage2_cli.build_ldm(args)
    want = dataclasses.replace(LDMConfig(), unet=dataclasses.replace(
        LDM_UNET, use_checkpoint=True))
    log(f"train_stage2 --base {os.path.relpath(path)}: {ldm.cfg} "
        f"equals the flagship with use_checkpoint {ldm.cfg == want}")
    if ldm.cfg != want:
        raise AssertionError("--base configs/stage2_ldm.yaml is not the "
                             "flagship")
    return {"base_yaml": "flagship"}


def train_stage2_phase(expect, profile: bool, root: str):
    """``cli.train_stage2`` at the full width of LDM_UNET and SD_VAE,
    mixed precision with EMA, batch 16, on seeded random weights: the
    main-path call of S2_STEPS steps with one validation round at its last
    step, the SoundLogger every SL_EVERY steps (``sound_log``: its own
    launches) and a SIGUSR1 during the last step (its checkpoint is the
    call's one save), the ``--base`` YAML's model, the resume for one step
    more, the fixed-batch fixed-draw eval
    loss before and after, the EMA's distance, ``load_native_ldm`` then a
    short CFG-only ``generate``; then warm steps split into forward and
    backward, AdamW and EMA, and the step's profile."""
    prefetch_check()
    tcfg = Stage2TrainConfig(base_lr=S2_LR, warmup_steps=0, use_ema=True,
                             compute_dtype="bfloat16")
    out = {}
    data, logdir = os.path.join(root, "s2-data"), os.path.join(root, "s2")
    write_pairs(data)
    ds = SpecFeatDataset.from_split_file(data, "train")
    # the fixed eval batch, staged as DevicePrefetcher stages it
    fixed = {k: torch.from_numpy(np.stack(
        [ds[i][k] for i in range(S2_BATCH)])).to("cuda", BF16)
        for k in ("spec", "video_feat")}
    # the initial state the CLI draws (seed 0, its VAE seed 1): the
    # yardstick of the fixed-draw eval loss and of the EMA's distance
    t0 = time.perf_counter()
    ldm0 = LatentDiffusion(LDMConfig()).to("cuda")
    init_weights_(ldm0.vae, torch.Generator("cuda").manual_seed(1))
    init_ldm_weights_(ldm0, torch.Generator("cuda").manual_seed(0))
    evaluator = Stage2Trainer(ldm0, tcfg)
    init = {k: p.detach() for k, p in trained(ldm0).items()}
    torch.cuda.synchronize()
    log(f"train_stage2 full-width model and its init on the card "
        f"{time.perf_counter() - t0:.3f} s; "
        f"{sum(p.numel() for p in init.values())} trained parameters")

    def fixed_eval(params: dict) -> float:
        view = TrainState(0, params, None, None)
        m = evaluator.eval_step(view, fixed, torch.Generator(
            "cuda").manual_seed(1234))
        return float(m["loss_simple"])

    loss_before = fixed_eval(init)
    args = s2_args(data, logdir)
    log(f"train_stage2 LDM_UNET + cond encoder, SD_VAE frozen, bf16 on "
        f"fp32 masters, EMA, batch {S2_BATCH}, lr {S2_LR}, {S2_STEPS} "
        f"steps and one validation batch")
    events = []
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with stage2_probes(events):
        state = train_stage2_cli.main(args + [
            "--max-steps", str(S2_STEPS), "--sound-log-every",
            str(SL_EVERY)])
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_counts()
    out.update(check_sound_logs(events, expect["sound_log"]))
    out["sound_log_launches"] = dict(sorted(sum(
        (collections.Counter(e[3]) for e in events if e[0] == "sound"),
        collections.Counter()).items()))
    check_preemption(events, os.path.join(logdir, "ckpt"))
    out.update(yaml_base_check())
    peak = torch.cuda.max_memory_allocated() / 2**30
    peak_reserved = torch.cuda.max_memory_reserved() / 2**30
    read_rows = lambda: [json.loads(line) for line in open(
        os.path.join(logdir, "metrics.jsonl"))]
    rows = read_rows()
    log("train_stage2 metrics " + json.dumps(rows))
    log(f"train_stage2 {call_s:.3f} s (main-path call: set-up, "
        f"{S2_STEPS} steps, validation, {SL_CALLS} SoundLogger calls, "
        f"checkpoint) peak_mem_GiB {peak:.3f} reserved {peak_reserved:.3f}")
    check_launches("train_stage2", launches, expect["train_stage2"])
    train_rows = [r for r in rows if "train/loss" in r]
    val_rows = [r for r in rows if "val/loss_simple_ema" in r]
    if [r["step"] for r in train_rows] != list(range(1, S2_STEPS + 1)) \
            or [r["step"] for r in val_rows] != [S2_STEPS]:
        raise AssertionError("train_stage2 did not log every step and "
                             "the validation round")
    for r in rows:
        if not np.isfinite(list(r.values())).all():
            raise AssertionError(f"train_stage2 metrics not finite: {r}")
    loss_after = fixed_eval(state.params)
    loss_ema = fixed_eval(state.ema.params)
    d_params = leaf_distance(state.params, init)
    d_ema = leaf_distance(state.ema.params, init)
    d_ema_params = leaf_distance(state.ema.params, state.params)
    log(f"train_stage2 fixed-batch fixed-draw eval loss_simple: before "
        f"{loss_before:.6f}, after {S2_STEPS} steps {loss_after:.6f} "
        f"(EMA {loss_ema:.6f}); ‖params − init‖ {d_params:.6e}, ‖EMA − "
        f"init‖ {d_ema:.6e}, ‖EMA − params‖ {d_ema_params:.6e}")
    if not loss_after < loss_before:
        raise AssertionError("the fixed-draw eval loss did not fall")
    if not (d_ema_params > 0.0 and d_ema < d_params):
        raise AssertionError("the EMA does not trail the parameters")
    del state
    torch.cuda.empty_cache()

    # the resume: step S2_STEPS + 1 from the saved optimizer, EMA and
    # generator; the step's t draw must be the saved generator's
    saved = torch.load(os.path.join(logdir, "ckpt",
                                    f"step_{S2_STEPS}.pt"), mmap=True,
                       map_location="cpu")
    gen = torch.Generator("cuda")
    gen.set_state(saved["generators"]["train"])
    torch.randn((S2_BATCH, *LATENT_HW, 4), generator=gen, dtype=BF16,
                device="cuda")   # the posterior's ε
    t_expect = float(torch.randint(0, 1000, (S2_BATCH,), generator=gen,
                                   device="cuda").float().mean())
    del saved
    resumed = train_stage2_cli.main(
        args + ["--max-steps", str(S2_STEPS + 1), "--resume"])
    last = read_rows()[-1]
    log(f"train_stage2 resume: step {resumed.step}, AdamW count "
        f"{resumed.opt.count}, EMA updates {resumed.ema.num_updates}, "
        f"t_mean {last['train/t_mean']} (the saved generator's draw "
        f"{t_expect}), loss {last['train/loss']:.6f}")
    if not (resumed.step == resumed.opt.count == resumed.ema.num_updates
            == last["step"] == S2_STEPS + 1
            and last["train/t_mean"] == t_expect
            and np.isfinite(last["train/loss"])):
        raise AssertionError("the resumed run did not continue at the "
                             "saved step with the saved state")
    del resumed
    torch.cuda.empty_cache()
    # one 13.8-GB checkpoint stays for the composition phase: the newest
    ckpt_dir = os.path.join(logdir, "ckpt")
    for name in os.listdir(ckpt_dir):
        if name != f"step_{S2_STEPS + 1}.pt":
            os.remove(os.path.join(ckpt_dir, name))

    # the logdir alone rebuilds the model (EMA preferred), which
    # generates on the card: CFG only, a few DPM steps
    t0 = time.perf_counter()
    loaded = load_native_ldm(logdir)
    load_s = time.perf_counter() - t0
    pipe = DiffFoleyPipeline(loaded, vae_dtype="bfloat16", device="cuda")
    feats = np.random.default_rng(2).standard_normal(
        (WINDOW_FEATS, 512)).astype(np.float32)
    sample = pipe.generate(feats, seed=0, gen=GenerationConfig(
        steps=3, sample_num=2, gl_iters=4, classifier_scale=0.0,
        wav_dtype="int16"))
    check_outputs(sample, "train_stage2 load_native_ldm → generate",
                  samples=2, windows=1)
    log(f"train_stage2 load_native_ldm {load_s:.3f} s")
    del pipe, loaded
    torch.cuda.empty_cache()

    # warm steps on the evaluator's model, split: forward + backward,
    # AdamW, EMA
    state = evaluator.init_train_state(None, "cuda")
    gen = torch.Generator("cuda").manual_seed(5)
    warm = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(4):
        stages = {}
        timed(stages, "forward_backward_s",
              lambda: evaluator.gradients(state, fixed, gen))
        timed(stages, "adamw_s", lambda: state.opt.step(
            [p.grad for p in state.params.values()]))
        timed(stages, "ema_s", lambda: ema_update(state.ema, state.params,
                                                  tcfg.ema_decay))
        state.step += 1
        warm.append(stages)
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    log("train_stage2 warm steps " + json.dumps(warm))
    if profile:
        profile_steps("train_stage2", lambda: [evaluator.train_step(
            state, fixed, gen) for _ in range(2)], grad=True)
    best = min(warm[1:], key=lambda w: sum(w.values()))
    out.update({
        "batch": S2_BATCH, "main_call_s": call_s,
        "first_step_s": train_rows[0]["step_s"],
        "cli_step_s": [r["step_s"] for r in train_rows],
        "split_first_step_s": sum(warm[0].values()),
        **{f"warm_{k}": v for k, v in best.items()},
        "warm_step_s": sum(best.values()), "peak_mem_GiB": peak,
        "peak_reserved_GiB": peak_reserved, "step_peak_mem_GiB": step_peak,
        "eval_loss_before": loss_before, "eval_loss_after": loss_after,
        "eval_loss_ema": loss_ema, "load_native_ldm_s": load_s})
    del state, evaluator, ldm0, init
    torch.cuda.empty_cache()
    return launches, out, logdir


# ---- the alignment classifier: training and align-acc ---------------------------

def classifier_step_agreement(trainer, state, batch: dict) -> dict:
    """The gradient of one classifier step at full width on the GPU
    (kernels 1, 2 and 5 in fp32) against the same step on the CPU (plain
    versions), from ``state`` with ``batch``'s posterior moments (the frozen
    encode on the GPU, outside the count) and seeded draws: per leaf at
    GRAD_TOL, a planted 1% fault on C_FAULT_LEAF caught, and every q, k and
    v projection's gradient nonzero, so that kernel 2's dQ, dK and dV are
    held. From flax's init the head's out_conv and every proj_out are zero,
    so this says something only from the third step on."""
    with torch.no_grad():
        post = trainer.vae.encode(batch["spec"])
    g = torch.Generator("cuda").manual_seed(7)
    moments = {"z_mu": post.mean, "z_sigma": post.std,
               "video_feat": batch["video_feat"], "labels": batch["labels"]}
    draws = {"eps": torch.randn(post.mean.shape, generator=g, device="cuda"),
             "t": torch.randint(0, trainer.schedule.num_timesteps,
                                (len(post.mean),), generator=g,
                                device="cuda"),
             "noise": torch.randn(post.mean.shape, generator=g,
                                  device="cuda")}
    reset_counts()
    trainer.gradients(state, moments, draws=draws)
    launched = read_counts()
    grads = {"cuda": {k: p.grad.detach().cpu()
                      for k, p in state.params.items()}}
    cpu = copy.copy(trainer)
    cpu.model = copy.deepcopy(trainer.model).cpu()
    cpu_state = TrainState(0, dict(cpu.model.named_parameters()), None, None)
    t0 = time.perf_counter()
    cpu.gradients(cpu_state, {k: v.cpu() for k, v in moments.items()},
                  draws={k: v.cpu() for k, v in draws.items()})
    cpu_s = time.perf_counter() - t0
    grads["cpu"] = {k: p.grad.detach() for k, p in cpu_state.params.items()}
    del cpu, cpu_state
    silent = [k for k, v in grads["cpu"].items()
              if any(f".{w}." in k for w in ("to_q", "to_k", "to_v"))
              and _rms(v) == 0.0]
    zero = noise_gradients(grads["cpu"])
    worst = gradient_agreement(grads["cuda"], grads["cpu"], zero, *GRAD_TOL)
    caught = _planted_caught(grads["cuda"], grads["cpu"], zero, C_FAULT_LEAF)
    log(f"train_classifier step-3 gradient at full width, batch "
        f"{len(post.mean)}, gpu-vs-cpu from the step-2 state: worst (max|Δ|, "
        f"rms(Δ)) / rms(cpu) {list(worst)} (limits {list(GRAD_TOL)}) over "
        f"{len(grads['cpu'])} leaves, {len(zero)} zero-gradient biases noise "
        f"on both; q/k/v leaves with a zero gradient {silent}; planted fault "
        f"({C_FAULT_LEAF} ×1.01) caught {caught}; launches "
        f"{json.dumps(launched)}; the CPU's step {cpu_s:.1f} s")
    if silent:
        raise AssertionError("attention projections without a gradient: "
                             "kernel 2 is not held by this step")
    if not (launched.get("attn_packed_fwd/float32")
            and launched.get("attn_packed_bwd/float32")
            and launched.get("gn_block/float32")
            and "attn_bwd/float32" not in launched):
        raise AssertionError(f"full-width classifier step launches "
                             f"{launched}")
    if not caught:
        raise AssertionError("the full-width classifier gradient check "
                             "passes the planted fault")
    return {"step3_grad_worst_max": worst[0], "step3_grad_worst_rms": worst[1],
            "step3_grad_worst_leaf": worst[2], "step3_cpu_s": cpu_s}


def train_classifier_phase(expect, root: str, profile: bool):
    """``cli.train_classifier`` at CLASSIFIER_BACKBONE in fp32 with its
    cond encoder (512 → 512, 40 positions) against the frozen full SD_VAE,
    batch 32, the shipped rate, seeded random weights and stage 2's seeded
    pairs: the main-path call of C_STEPS steps and the resume for one more.
    Its first C_REPLAY steps are replayed from the same state with the
    same batches and draws; the gates: each replayed step's metrics are
    the CLI's; from the step-2 state, the step-3 gradient on the GPU holds
    the CPU's per leaf (``classifier_step_agreement``: the first step that
    moves the backbone and the attention); the first step lowers its
    batch's BCE at its draw, and so do the C_STEPS steps. Then warm steps
    split into the VAE encode, forward + backward and AdamW. Returns the
    logdir beside the launches and times."""
    data, logdir = os.path.join(root, "clf-data"), os.path.join(root, "clf")
    write_pairs(data)
    ds = SpecFeatDataset.from_split_file(data, "train", alignment_labels=True)
    # the CLI's first C_REPLAY batches (its loader's seed 0, epoch by
    # epoch) and its step generator (seed 2); the first batch and a fresh
    # seed-2 generator are the fixed batch and the fixed draw
    loader, batches, epoch = PrefetchLoader(ds, C_BATCH, seed=0), [], 0
    while len(batches) < C_REPLAY:
        batches += [{k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
                    for b in loader.epoch(epoch)]
        epoch += 1
    batches = batches[:C_REPLAY]
    first = batches[0]
    draw = lambda: torch.Generator("cuda").manual_seed(2)
    # the initial state the CLI draws (seed 0, its VAE seed 1)
    evaluator = ClassifierTrainer()
    init_weights_(evaluator.vae.to("cuda"),
                  torch.Generator("cuda").manual_seed(1))
    state = evaluator.init_train_state(0, "cuda")

    def fixed_bce() -> float:
        with torch.no_grad():
            return float(evaluator.loss(first, draw())[0])

    args = ["--data-dir", data, "--logdir", logdir, "--batch-size",
            str(C_BATCH), "--log-every", "1", "--save-every", "1000000"]
    log(f"train_classifier CLASSIFIER_BACKBONE + cond encoder fp32, SD_VAE "
        f"frozen fp32, batch {C_BATCH}, lr 5e-5, {C_STEPS} steps")
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trained = train_classifier_cli.main(args + ["--max-steps", str(C_STEPS)])
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    read_rows = lambda: [json.loads(line) for line in open(
        os.path.join(logdir, "metrics.jsonl"))]
    rows = read_rows()
    log("train_classifier metrics " + json.dumps(rows))
    log(f"train_classifier {call_s:.3f} s (main-path call: set-up, "
        f"{C_STEPS} steps, checkpoint) peak_mem_GiB {peak:.3f}")
    check_launches("train_classifier", launches, expect)
    if [r["step"] for r in rows] != list(range(1, C_STEPS + 1)):
        raise AssertionError("train_classifier did not log every step")
    for r in rows:
        if not (np.isfinite(list(r.values())).all()
                and 0.0 <= r["train/acc"] <= 1.0):
            raise AssertionError(f"train_classifier metrics: {r}")

    # the first C_REPLAY steps again, from the same state with the same
    # batches and draws: the CLI's metrics; before the last of them, the
    # full-width gradient against the CPU's
    bce_init = fixed_bce()
    gen = draw()
    replay_gap = 0.0
    for i, batch in enumerate(batches):
        if i == C_REPLAY - 1:
            held = classifier_step_agreement(evaluator, state, batch)
        m = evaluator.train_step(state, batch, gen)
        replay_gap = max([replay_gap] + [
            abs(float(m[k]) - rows[i][f"train/{k}"])
            for k in ("bce_loss", "acc", "grad_norm")])
        if i == 0:
            bce_step1 = fixed_bce()
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(trained.params[k])
    bce_after = fixed_bce()
    log(f"train_classifier fixed batch (the first step's) and draw: BCE "
        f"{bce_init:.6f} at the init, {bce_step1:.6f} after the first step, "
        f"{bce_after:.6f} after {C_STEPS} steps; the replayed first "
        f"{C_REPLAY} steps' metrics {replay_gap:.3e} from the CLI's")
    if not replay_gap <= 1e-5:
        raise AssertionError("the replayed steps are not the CLI's")
    if not (bce_step1 < bce_init and bce_after < bce_init):
        raise AssertionError("the steps did not lower the first batch's BCE")
    del trained

    resumed = train_classifier_cli.main(
        args + ["--max-steps", str(C_STEPS + 1), "--resume"])
    last = read_rows()[-1]
    log(f"train_classifier resume: step {resumed.step}, AdamW count "
        f"{resumed.opt.count}, bce {last['train/bce_loss']:.6f}")
    if not (resumed.step == resumed.opt.count == last["step"] == C_STEPS + 1
            and np.isfinite(last["train/bce_loss"])):
        raise AssertionError("the resumed classifier run did not continue "
                             "at the saved step")
    del resumed

    # warm steps on the evaluator, split: the frozen encode, forward +
    # backward (the posterior's moments in, so that the encode is not
    # repeated), AdamW
    gen = torch.Generator("cuda").manual_seed(5)
    warm = []
    for _ in range(4):
        stages = {}
        with torch.no_grad():
            post = timed(stages, "vae_encode_s",
                         lambda: evaluator.vae.encode(first["spec"]))
        moments = {"z_mu": post.mean, "z_sigma": post.std,
                   "video_feat": first["video_feat"],
                   "labels": first["labels"]}
        timed(stages, "forward_backward_s",
              lambda: evaluator.gradients(state, moments, gen))
        timed(stages, "adamw_s", lambda: state.opt.step(
            [p.grad for p in state.params.values()]))
        state.step += 1
        warm.append(stages)
    log("train_classifier warm steps " + json.dumps(warm))
    if profile:
        profile_steps("train_classifier", lambda: [evaluator.train_step(
            state, first, gen) for _ in range(2)], grad=True)
    best = min(warm[1:], key=lambda w: sum(w.values()))
    del evaluator, state, first
    torch.cuda.empty_cache()
    return launches, {
        "batch": C_BATCH, "main_call_s": call_s,
        "first_step_s": rows[0]["step_s"],
        "cli_step_s": [r["step_s"] for r in rows],
        **{f"warm_{k}": v for k, v in best.items()},
        "warm_step_s": sum(best.values()), "peak_mem_GiB": peak,
        "bce_init": bce_init, "bce_step1": bce_step1,
        "bce_after": bce_after, **held}, logdir


def align_acc_phase(expect, clf_logdir: str, root: str):
    """``cli.align_acc`` on the classifier's logdir over AA_FILES seeded
    spec and feature files at batch 64, the last batch ragged: the
    accuracy, and the counts against the files; then at batch 128 (one
    padded batch) over the same files, its counts equal to batch 64's and
    its peak memory."""
    spec_dir, feat_dir = (os.path.join(root, "aa-spec"),
                          os.path.join(root, "aa-feat"))
    os.makedirs(spec_dir)
    os.makedirs(feat_dir)
    rng = np.random.default_rng(8)
    for i in range(AA_FILES):
        loud = i % 2 == 0
        np.save(os.path.join(spec_dir, f"c{i:03d}.npy"), np.clip(
            (0.8 if loud else 0.2) + 0.05 * rng.standard_normal((128, 520)),
            0, 1).astype(np.float32))
        np.savez(os.path.join(feat_dir, f"c{i:03d}.npz"), feat=(
            (1.0 if i % 3 else -1.0) + 0.3 * rng.standard_normal(
                (44, 512))).astype(np.float32))
    out = os.path.join(root, "results_metric.txt")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    acc = align_acc_cli.main(["--spec-dir", spec_dir, "--feat-dir", feat_dir,
                              "--classifier-ckpt", clf_logdir,
                              "--batch-size", str(AA_BATCH), "--out", out])
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches("align_acc", launches, expect)
    # the counts, batch by batch, through the same function; and P(aligned)
    # of every file at both batches (other shapes, other cuDNN algorithms)
    model, vae = align_acc_cli.load_classifier(clf_logdir)
    model.cuda().eval()
    fn = make_align_acc_fn(model, vae.cuda().eval())
    correct = total = 0
    probs = {AA_BATCH: [], AA_BATCH_LARGE: []}
    for batch_size, p_files in probs.items():
        for b in align_acc_cli.iter_batches(spec_dir, feat_dir, batch_size):
            n = len(b["spec"])
            spec, feat = (torch.as_tensor(pad_axis0(b[k], batch_size),
                                          device="cuda")
                          for k in ("spec", "video_feat"))
            if batch_size == AA_BATCH:
                valid = torch.zeros(AA_BATCH, dtype=torch.long,
                                    device="cuda")
                valid[:n] = 1
                c, t = fn(spec, feat, valid)
                correct, total = correct + int(c), total + int(t)
            with torch.no_grad():
                z = 0.18215 * vae.encode(spec[:, :, :512]).mode()
                p_files.append(model(z, torch.zeros(batch_size,
                                                    device="cuda"),
                                     feat)[:n, 0].cpu().numpy())
    p64, p128 = (np.concatenate(probs[b]) for b in (AA_BATCH,
                                                    AA_BATCH_LARGE))
    # a file's decision flips between the batches only where |p − 0.5|
    # is under max|Δp|: both are printed
    margin = float(np.abs(p64 - 0.5).min())
    p_delta = float(np.abs(p128 - p64).max())
    flipped = int((np.round(p64) != np.round(p128)).sum())
    line = open(out).read().strip()
    log(f"align_acc {call_s:.3f} s (main-path call: load, {AA_CALLS} "
        f"batches of {AA_BATCH}) peak_mem_GiB {peak:.3f}: {line}; "
        f"{correct} of {total} files aligned, p in [{p64.min():.4f}, "
        f"{p64.max():.4f}], least |p − 0.5| {margin:.3e}; batch "
        f"{AA_BATCH_LARGE} against {AA_BATCH}: max|Δp| {p_delta:.3e}, "
        f"{flipped} decisions differ (must be 0)")
    if not (total == AA_FILES and 0.0 <= acc <= 1.0
            and correct == round(acc * AA_FILES)
            and line == f"align_acc: {acc:.6f}"):
        raise AssertionError("align_acc's counts or result disagree")
    if flipped:
        raise AssertionError(f"align_acc decides {flipped} files otherwise "
                             f"at batch {AA_BATCH_LARGE} than at "
                             f"{AA_BATCH}")
    del model, vae
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    acc_large = align_acc_cli.main([
        "--spec-dir", spec_dir, "--feat-dir", feat_dir, "--classifier-ckpt",
        clf_logdir, "--batch-size", str(AA_BATCH_LARGE), "--out",
        os.path.join(root, "results_metric_large.txt")])
    torch.cuda.synchronize()
    large_s = time.perf_counter() - t0
    peak_large = torch.cuda.max_memory_allocated() / 2**30
    log(f"align_acc at batch {AA_BATCH_LARGE} (one padded batch): "
        f"{large_s:.3f} s peak_mem_GiB {peak_large:.3f} reserved "
        f"{torch.cuda.max_memory_reserved() / 2**30:.3f}: "
        f"{round(acc_large * AA_FILES)} of {AA_FILES} aligned (batch "
        f"{AA_BATCH}: {correct})")
    if round(acc_large * AA_FILES) != correct:
        raise AssertionError(f"align_acc counts {acc_large * AA_FILES} at "
                             f"batch {AA_BATCH_LARGE}, {correct} at "
                             f"{AA_BATCH}")
    torch.cuda.empty_cache()
    return launches, {"main_call_s": call_s, "peak_mem_GiB": peak,
                      "align_acc": acc, "files": total,
                      "least_margin": margin,
                      "p_delta_batch128": p_delta,
                      f"batch{AA_BATCH_LARGE}_s": large_s,
                      f"batch{AA_BATCH_LARGE}_peak_mem_GiB": peak_large}


# ---- stage-1 CAVP --------------------------------------------------------------

def write_cavp_shards(root: str, n_shards: int = 3,
                      samples: int = CAVP_SAMPLES, frame: int = FRAME,
                      seed: int = 9):
    """Seeded tar shards in the stage-1 layout: ``<key>.spec.npy`` (128 ×
    640 mel frames) and ``<key>.video.jpg`` (a cv2 JPEG strip of 40
    frame × frame frames: coarse colour fields drifting from frame to
    frame)."""
    import cv2
    import io
    import tarfile

    rng = np.random.default_rng(seed)
    os.makedirs(root)
    per = -(-samples // n_shards)
    paths = []
    for si in range(n_shards):
        path = os.path.join(root, f"shard-{si:06d}.tar")
        with tarfile.open(path, "w") as tf:
            for k in range(per):
                buf = io.BytesIO()
                np.save(buf, rng.uniform(size=(128, 640)).astype(np.float32))
                info = tarfile.TarInfo(f"s{si}_{k}.spec.npy")
                info.size = buf.getbuffer().nbytes
                buf.seek(0)
                tf.addfile(info, buf)
                base = rng.integers(0, 256, (frame // 8, frame // 8, 3),
                                    dtype=np.uint8)
                strip = np.concatenate([cv2.resize(
                    np.roll(base, i, axis=1), (frame, frame),
                    interpolation=cv2.INTER_NEAREST) for i in range(40)],
                    axis=1)
                ok, enc = cv2.imencode(".jpg", strip)
                if not ok:
                    raise AssertionError("cv2 cannot encode a JPEG strip")
                info = tarfile.TarInfo(f"s{si}_{k}.video.jpg")
                info.size = len(enc)
                tf.addfile(info, io.BytesIO(enc.tobytes()))
        paths.append(path)
    return paths


def train_cavp_phase(root: str):
    """``cli.train_cavp`` on the shipped towers (SlowOnly-R50, CNN14,
    512-d), bf16 on fp32 masters, uint8 video, the CLI's default 30 videos
    × 3 clips a step: the main-path call of CAVP_STEPS steps and the
    retrieval eval, then a resume for one step in CAVP_ACCUM micro-batches
    (the feature cache). No TPU kernel runs: every launch count must stay
    0. Returns the logdir beside the times."""
    t0 = time.perf_counter()
    shards = write_cavp_shards(os.path.join(root, "shards"))
    write_s = time.perf_counter() - t0
    logdir = os.path.join(root, "cavp")
    pattern = os.path.join(root, "shards", "shard-{000000..%06d}.tar"
                           % (len(shards) - 1))
    args = ["--train-shards", pattern, "--logdir", logdir, "--clip-num",
            str(CAVP_CLIPS), "--mixed-precision", "--uint8-video",
            "--epochs", "1", "--log-every", "1", "--save-every-epochs", "1",
            "--val-shards", shards[0], "--val-frequency", "1",
            "--val-samples", "16"]
    log(f"train_cavp SlowOnly-R50 + CNN14 bf16 on fp32 masters, "
        f"{CAVP_BATCH} videos × {CAVP_CLIPS} clips of 16×{FRAME}² a step, "
        f"{CAVP_STEPS} steps; {len(shards)} shards of {CAVP_SAMPLES} "
        f"samples written in {write_s:.3f} s")
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_cavp_cli.main(args + [
        "--batch-size", str(CAVP_BATCH), "--steps-per-epoch",
        str(CAVP_STEPS)])
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    peak_reserved = torch.cuda.max_memory_reserved() / 2**30
    rows = [json.loads(line) for line in open(os.path.join(logdir,
                                                           "metrics.jsonl"))]
    log("train_cavp metrics " + json.dumps(rows))
    log(f"train_cavp {call_s:.3f} s (main-path call: set-up, {CAVP_STEPS} "
        f"steps, retrieval eval, checkpoint) peak_mem_GiB {peak:.3f} "
        f"reserved {peak_reserved:.3f}; launches {json.dumps(launches)}")
    if launches:
        raise AssertionError("stage-1 CAVP launched a TPU kernel's port")
    train = [r for r in rows if "train/total_loss" in r]
    val = [r for r in rows if "val/video_to_spec_R@1" in r]
    if [r["step"] for r in train] != list(range(1, CAVP_STEPS + 1)) or \
            len(val) != 1:
        raise AssertionError("train_cavp did not log every step and the "
                             "retrieval eval")
    for r in rows:
        if not np.isfinite(list(r.values())).all():
            raise AssertionError(f"train_cavp metrics not finite: {r}")
    if not all(r["train/logit_scale"] <= 100.0 * (1 + 1e-6) for r in train):
        raise AssertionError("logit_scale left [0, ln 100]")
    stats = state.batch_stats
    moved = sum(not (torch.all(v == 0.0) if k.endswith("mean")
                     else torch.all(v == 1.0)) for k, v in stats.items())
    log(f"train_cavp BatchNorm running statistics moved from the init: "
        f"{moved} of {len(stats)}")
    if moved != len(stats):
        raise AssertionError("some BatchNorm statistics did not move")
    del state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    resumed = train_cavp_cli.main(args + [
        "--batch-size", str(CAVP_BATCH // CAVP_ACCUM), "--accum-freq",
        str(CAVP_ACCUM), "--steps-per-epoch", "1", "--resume"])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    last = [json.loads(line) for line in open(os.path.join(
        logdir, "metrics.jsonl"))]
    last = [r for r in last if "train/total_loss" in r][-1]
    log(f"train_cavp resume in {CAVP_ACCUM} micro-batches of "
        f"{CAVP_BATCH // CAVP_ACCUM} videos: step {resumed.step}, AdamW "
        f"count {resumed.opt.count}, loss {last['train/total_loss']:.6f}, "
        f"{resume_s:.3f} s, peak_mem_GiB "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    if not (resumed.step == resumed.opt.count == last["step"]
            == CAVP_STEPS + 1 and np.isfinite(last["train/total_loss"])):
        raise AssertionError("the resumed CAVP run did not continue at the "
                             "saved step")
    del resumed
    torch.cuda.empty_cache()
    return {"main_call_s": call_s, "first_step_s": train[0]["step_s"],
            "cli_step_s": [r["step_s"] for r in train],
            "warm_step_s": min(r["step_s"] for r in train[1:]),
            "peak_mem_GiB": peak, "peak_reserved_GiB": peak_reserved,
            "resume_accum_s": resume_s, "shards_write_s": write_s,
            "retrieval": {k: v for k, v in val[0].items() if k != "step"}
            }, logdir


def extract_features_phase(clip: str, cavp_logdir: str, root: str,
                           frames_per_call: int = 0):
    """``cli.extract_features`` on the seeded clip with the CAVP logdir:
    one (T, 512) file of unit-norm features at the logdir's frame size.
    ``frames_per_call``: a tower whose head pools each call's frames to
    that many (x3d, i3d, r2plus1d: 16), so each batch of 40 frames gives
    16 features, as the JAX package's extraction does."""
    video_dir, out_dir = os.path.join(root, "videos"), os.path.join(
        root, "feats")
    os.makedirs(video_dir)
    os.link(clip, os.path.join(video_dir, "clip.avi"))
    t0 = time.perf_counter()
    names = extract_features_cli.main(["--video-dir", video_dir, "--out-dir",
                                       out_dir, "--cavp-ckpt", cavp_logdir])
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    feat = np.load(os.path.join(out_dir, "clip.npz"))["feat"]
    norms = np.linalg.norm(feat, axis=-1)
    log(f"extract_features {call_s:.3f} s: {names} → {feat.shape}, norms "
        f"{norms.min():.6f}–{norms.max():.6f}")
    frames = len(extract_frames(clip, size=FRAME))
    if frames_per_call:   # each batch of the CLI's 40 frames, the ragged
        frames = frames_per_call * -(-frames // 40)   # tail's too
    if not (names == ["clip.avi"] and feat.shape == (frames, 512)
            and np.isfinite(feat).all()
            and np.abs(norms - 1).max() < 1e-3):
        raise AssertionError("extract_features did not write unit-norm "
                             "per-frame features")
    return {"call_s": call_s, "frames": feat.shape[0]}


def cavp_towers_phase(root: str, clip: str):
    """``cli.train_cavp`` on the factory's other towers (TOWER_PAIRS: every
    tower once) at their published widths (``X3DConfig``, ``I3DConfig``,
    ``R2Plus1dConfig``, ``ViViTConfig``, CNN10, ``SpecResNetConfig``,
    ``SpecViTConfig`` defaults; 512-d) in fp32, over ``train_cavp_phase``'s
    shards of 16×224² frames: TOWER_STEPS steps of TOWER_BATCH videos ×
    CAVP_CLIPS clips each — the reduced batch is a cut of depth, not of
    width — and the retrieval eval. Each call: every step logged and
    finite, ``logit_scale`` ≤ 100, every BatchNorm statistic moved off its
    init, no kernel launched; its peak memory and warm step. Then
    ``cli.extract_features`` over the x3d logdir on the seeded clip."""
    shards = sorted(os.path.join(root, "shards", f) for f in os.listdir(
        os.path.join(root, "shards")))
    pattern = os.path.join(root, "shards", "shard-{000000..%06d}.tar"
                           % (len(shards) - 1))
    out, logdirs = {}, {}
    for video, spec in TOWER_PAIRS:
        name = f"{video}-{spec}"
        logdir = os.path.join(root, f"cavp-{name}")
        torch.cuda.empty_cache()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_cavp_cli.main([
            "--train-shards", pattern, "--logdir", logdir, "--clip-num",
            str(CAVP_CLIPS), "--uint8-video", "--epochs", "1", "--log-every",
            "1", "--save-every-epochs", "1", "--val-shards", shards[0],
            "--val-frequency", "1", "--val-samples", "8", "--batch-size",
            str(TOWER_BATCH), "--steps-per-epoch", str(TOWER_STEPS),
            "--video-encode", video, "--spec-encode", spec])
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows = [json.loads(line) for line in open(os.path.join(
            logdir, "metrics.jsonl"))]
        train = [r for r in rows if "train/total_loss" in r]
        val = [r for r in rows if "val/video_to_spec_R@1" in r]
        stats = state.batch_stats
        moved = sum(not (torch.all(v == 0.0) if k.endswith("mean")
                         else torch.all(v == 1.0)) for k, v in stats.items())
        params = sum(p.numel() for p in state.params.values())
        log(f"cavp_towers {name} fp32, {params} parameters, {TOWER_BATCH} "
            f"videos × {CAVP_CLIPS} clips of 16×{FRAME}² a step: "
            f"{call_s:.3f} s (set-up, {TOWER_STEPS} steps, eval, "
            f"checkpoint), peak_mem_GiB {peak:.3f}, BatchNorm statistics "
            f"moved {moved} of {len(stats)}, launches {json.dumps(launches)};"
            f" metrics {json.dumps(rows)}")
        if launches:
            raise AssertionError(f"{name} launched a TPU kernel's port")
        if [r["step"] for r in train] != list(range(1, TOWER_STEPS + 1)) \
                or len(val) != 1:
            raise AssertionError(f"{name} did not log every step and the "
                                 "retrieval eval")
        for r in rows:
            if not np.isfinite(list(r.values())).all():
                raise AssertionError(f"{name} metrics not finite: {r}")
        if not all(r["train/logit_scale"] <= 100.0 * (1 + 1e-6)
                   for r in train):
            raise AssertionError(f"{name}: logit_scale left [0, ln 100]")
        if moved != len(stats):
            raise AssertionError(f"{name}: some BatchNorm statistics did "
                                 "not move")
        out[name] = {"call_s": call_s, "peak_mem_GiB": peak,
                     "parameters": params,
                     "first_step_s": train[0]["step_s"],
                     "warm_step_s": min(r["step_s"] for r in train[1:]),
                     "batchnorm_statistics": len(stats)}
        logdirs[video] = logdir
        del state
    out["extract_features_x3d"] = extract_features_phase(
        clip, logdirs["x3d"], os.path.join(root, "x3d-features"),
        frames_per_call=16)
    torch.cuda.empty_cache()
    return out


def stage2_decode_phase(cavp_logdir: str, expect: dict):
    """``train/stage2_decode.py`` at ``DecodeConfig``'s defaults on
    ``train_cavp_phase``'s CNN14, frozen: DEC_STEPS MSE steps of
    ``DecoderWrapper``, then DEC_STEPS steps of ``GANDecoderWrapper``
    (without a perceptual term: the repository holds no LPIPS weights),
    at batch DEC_BATCH over seeded (128, DEC_T) specs in fp32, the launch
    counts reset before and read after both: they must equal the
    prediction. Losses finite; the discriminator's statistics moved."""
    cfg = DecodeConfig()
    cavp = load_native_cavp(cavp_logdir)
    spec = torch.as_tensor(np.random.default_rng(31).uniform(
        size=(DEC_BATCH, cfg.mel_bins, DEC_T)), dtype=FP32, device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logs, step_s = {"mse": [], "gan": []}, {"mse": [], "gan": []}
    for kind, cls in (("mse", DecoderWrapper), ("gan", GANDecoderWrapper)):
        wrapper = cls(cfg, cavp)
        state = wrapper.init_train_state(seed=3)
        if kind == "gan":
            before = {k: v.clone() for k, v in wrapper.disc.state_dict(
            ).items() if "running" in k}
        for _ in range(DEC_STEPS):
            t1 = time.perf_counter()
            m = {k: float(v) for k, v in wrapper.train_step(state,
                                                           spec).items()}
            step_s[kind].append(time.perf_counter() - t1)
            logs[kind].append(m)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = wrapper.disc.state_dict()
    moved = sum(not torch.equal(after[k], v) for k, v in before.items())
    params = sum(p.numel() for p in wrapper.decoder.parameters())
    log(f"stage2_decode DecodeConfig() (decoder {params} parameters, mid "
        f"attention ({DEC_BATCH}, 1, 16, 256)) on the frozen CNN14, "
        f"spec ({DEC_BATCH}, {cfg.mel_bins}, {DEC_T}) fp32: {call_s:.3f} s "
        f"for {DEC_STEPS} MSE + {DEC_STEPS} GAN steps, peak_mem_GiB "
        f"{peak:.3f}; discriminator statistics moved {moved} of "
        f"{len(before)}; losses {json.dumps(logs)}; step_s "
        f"{json.dumps(step_s)}")
    check_launches("decode", launches, expect)
    for kind in logs:
        for m in logs[kind]:
            if not np.isfinite(list(m.values())).all():
                raise AssertionError(f"decode {kind} losses not finite: {m}")
    if moved != len(before) or not before:
        raise AssertionError("the discriminator's statistics did not move")
    return launches, {"call_s": call_s, "peak_mem_GiB": peak,
                      "mse_warm_step_s": min(step_s["mse"][1:]),
                      "gan_warm_step_s": min(step_s["gan"][1:]),
                      "first_step_s": [step_s["mse"][0], step_s["gan"][0]]}


def finite_grads(what: str, grads) -> None:
    bad = [i for i, g in enumerate(grads) if not bool(torch.isfinite(g).all())]
    if bad:
        raise AssertionError(f"{what}: gradients not finite at {bad[:5]}")


def audio_unet_phase(expect: dict):
    """``AudioUNetModel(AudioUNetConfig())`` at its published widths in
    fp32 with seeded random weights: AU_CALLS calls of a forward over
    (AU_BATCH, AU_LEN, 128) latents, (AU_BATCH,) times and an (AU_BATCH,
    AU_CTX, 768) context, then the gradient of Σ out² over the parameters
    and the input, the launch counts reset before the first call and read
    after the last: they must equal the prediction. The output and every
    gradient finite; first and warm seconds, peak memory."""
    model = randomize_(AudioUNetModel(AudioUNetConfig()), 41).cuda()
    params = list(model.parameters())
    rng = np.random.default_rng(42)
    x = torch.as_tensor(rng.standard_normal((AU_BATCH, AU_LEN, 128)),
                        dtype=FP32, device="cuda").requires_grad_(True)
    t = torch.as_tensor(rng.integers(0, 1000, AU_BATCH), dtype=FP32,
                        device="cuda")
    ctx = torch.as_tensor(rng.standard_normal((AU_BATCH, AU_CTX, 768)),
                          dtype=FP32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    call_s = []
    for _ in range(AU_CALLS):
        t0 = time.perf_counter()
        out = model(x, t, ctx)
        grads = torch.autograd.grad(out.square().sum(), [x] + params)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"audio_unet AudioUNetConfig() ({sum(p.numel() for p in params)} "
        f"parameters) fp32, x {tuple(x.shape)}, context {tuple(ctx.shape)}: "
        f"forward + gradient s {call_s}, peak_mem_GiB {peak:.3f}, out rms "
        f"{float(out.detach().square().mean().sqrt()):.4e}")
    check_launches("audio_unet", launches, expect)
    if out.shape != x.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"audio UNet output {tuple(out.shape)} not "
                             f"finite or of x's shape")
    finite_grads("audio_unet", grads)
    return launches, {"first_call_s": call_s[0],
                      "warm_call_s": min(call_s[1:]), "peak_mem_GiB": peak}


def prior_phase(expect: dict):
    """``DiffusionPrior(PriorConfig())`` in fp32 with flax's seeded
    initialisation on the card: PR_STEPS ``p_losses`` steps at batch
    PR_BATCH over seeded (video, spec) features, each gradient applied by
    optax-style Adam (``train/stage2_decode.py::_adam``), then
    PR_SAMPLE_CALLS ``sample`` calls at batch PR_SAMPLE_BATCH,
    PR_SAMPLE_STEPS steps at CFG PR_COND_SCALE; the launch counts reset
    before the first step and read after the last call. Losses and
    samples finite; seconds a step and a sample call."""
    cfg = PriorConfig()
    prior = DiffusionPrior(cfg).init_params(seed=43)
    params = list(prior.net.parameters())
    opt = _adam(params, PR_LR)
    rng = np.random.default_rng(44)
    video, spec = (torch.as_tensor(rng.standard_normal(
        (PR_BATCH, cfg.seq_len, cfg.dim)), dtype=FP32, device="cuda")
        for _ in range(2))
    gen = torch.Generator("cuda").manual_seed(45)
    torch.cuda.synchronize()
    reset_counts()
    losses, step_s, sample_s = [], [], []
    for _ in range(PR_STEPS):
        t0 = time.perf_counter()
        loss = prior.p_losses(video, spec, generator=gen)
        opt.step(torch.autograd.grad(loss, params))
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    for _ in range(PR_SAMPLE_CALLS):
        t0 = time.perf_counter()
        x = prior.sample(video[:PR_SAMPLE_BATCH], generator=gen,
                         steps=PR_SAMPLE_STEPS, cond_scale=PR_COND_SCALE)
        torch.cuda.synchronize()
        sample_s.append(time.perf_counter() - t0)
    launches = read_counts()
    log(f"prior PriorConfig() ({sum(p.numel() for p in params)} parameters)"
        f" fp32: p_losses at batch {PR_BATCH} losses {losses} step s "
        f"{step_s}; sample ({PR_SAMPLE_BATCH}, {PR_SAMPLE_STEPS} steps, CFG "
        f"{PR_COND_SCALE}: {2 * PR_SAMPLE_STEPS} network calls) s "
        f"{sample_s}, sample rms {float(x.square().mean().sqrt()):.4e}")
    check_launches("prior", launches, expect)
    if not np.isfinite(losses).all():
        raise AssertionError(f"prior losses not finite: {losses}")
    if not bool(torch.isfinite(x).all()):
        raise AssertionError("prior samples not finite")
    return launches, {"warm_step_s": min(step_s[1:]),
                      "first_step_s": step_s[0],
                      "first_sample_s": sample_s[0],
                      "warm_sample_s": min(sample_s[1:])}


def encoder_unet_phase(expect: dict):
    """``EncoderUNetModel(CLASSIFIER_BACKBONE, pool)`` in fp32 with seeded
    random weights at each pool: EN_CALLS calls of the forward over
    (EN_BATCH, 16, 64, 4) latents and (EN_BATCH,) times, then the gradient
    of the summed output over the input (guided diffusion's classifier
    gradient). The launch counts are reset before the first pool and read
    after the last; each pool's share is logged. Outputs and gradients
    finite; first and warm seconds per pool."""
    rng = np.random.default_rng(46)
    x = torch.as_tensor(rng.standard_normal((EN_BATCH, *LATENT_HW, 4)),
                        dtype=FP32, device="cuda").requires_grad_(True)
    t = torch.as_tensor(rng.integers(0, 1000, EN_BATCH), dtype=FP32,
                        device="cuda")
    models = {pool: randomize_(EncoderUNetModel(CLASSIFIER_BACKBONE, pool),
                               47 + i).cuda()
              for i, pool in enumerate(POOLS)}
    torch.cuda.synchronize()
    reset_counts()
    times, shares, before = {}, {}, {}
    for pool, model in models.items():
        call_s = []
        for _ in range(EN_CALLS):
            t0 = time.perf_counter()
            out = model(x, t)
            (g,) = torch.autograd.grad(out.sum(), x)
            torch.cuda.synchronize()
            call_s.append(time.perf_counter() - t0)
        if out.shape != (EN_BATCH, CLASSIFIER_BACKBONE.out_channels) or not (
                bool(torch.isfinite(out).all())
                and bool(torch.isfinite(g).all())):
            raise AssertionError(f"EncoderUNetModel {pool}: output "
                                 f"{tuple(out.shape)} or gradient not finite")
        now = read_counts()
        shares[pool] = {k: n - before.get(k, 0) for k, n in now.items()
                        if n - before.get(k, 0)}
        before = now
        times[pool] = {"first_s": call_s[0], "warm_s": min(call_s[1:])}
    launches = read_counts()
    log(f"encoder_unet CLASSIFIER_BACKBONE fp32 x {tuple(x.shape)}: seconds "
        f"{json.dumps(times)}; launches by pool {json.dumps(shares)}")
    check_launches("encoder_unet", launches, expect)
    return launches, times


def oc_model(variant: str, seed: int):
    """Run o's LatentDiffusion for ``variant`` (``OC_VARIANTS``), built on
    the card with lecun-normal kernels and embedding tables drawn there
    (flax's scheme, without its zero-init layers), N(0, 1) cond
    positions, zero biases and unit scales; the UNet in bf16, the cond
    encoder in fp32."""
    key, changes, _ = OC_VARIANTS[variant]
    gen = torch.Generator("cuda").manual_seed(seed)
    with torch.device("cuda"):
        ldm = LatentDiffusion(LDMConfig(unet=dataclasses.replace(
            LDM_UNET, dtype="bfloat16", **changes), conditioning_key=key))
    # no zero-init output layers: every block's output reaches the result
    init_weights_(ldm, gen)
    with torch.no_grad():
        ldm.cond.pos_emb.normal_(generator=gen)
    ldm.unet.to(torch.bfloat16)
    return ldm


def other_cond_phase(expect: dict):
    """Run o. The AR cond encoder at its reference defaults with seeded
    random weights: AR_CALLS calls of a forward over (AR_BATCH, AR_TOKENS,
    512) features and the (AR_BATCH, 16, 64, 4) previous latent, then the
    gradient of Σ out² over both inputs and every parameter, in fp32, then
    as many in bf16 (a bf16 copy of the weights and the inputs). Then the
    860M UNet through ``LatentDiffusion.apply_model`` for each of
    OC_VARIANTS, OC_CALLS forwards at batch OC_BATCH in bf16, one model
    at a time (built, called, freed). The launch counts are reset before
    the first call and read after the last: they must equal the
    prediction. Outputs and gradients finite; first and warm seconds,
    peak memory."""
    rng = np.random.default_rng(60)
    model = randomize_(VideoFeatEncoderPosembedAR(), 61).cuda()
    video = torch.as_tensor(rng.standard_normal((AR_BATCH, AR_TOKENS, 512)),
                            dtype=FP32, device="cuda")
    prev = torch.as_tensor(rng.standard_normal((AR_BATCH, *LATENT_HW, 4)),
                           dtype=FP32, device="cuda")
    feats = torch.as_tensor(rng.standard_normal(
        (OC_BATCH, WINDOW_FEATS, 512)), dtype=FP32, device="cuda")
    x = torch.as_tensor(rng.standard_normal((OC_BATCH, *LATENT_HW, 4)),
                        dtype=FP32, device="cuda")
    c_concat = torch.as_tensor(rng.standard_normal(x.shape), dtype=FP32,
                               device="cuda")
    t = torch.as_tensor(rng.integers(0, 1000, OC_BATCH), dtype=FP32,
                        device="cuda")
    y = torch.as_tensor(rng.integers(0, OC_CLASSES, OC_BATCH),
                        device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = {}
    for dtype in (FP32, BF16):
        m = model if dtype == FP32 else copy.deepcopy(model).to(dtype)
        batch = {"video_feat": video.to(dtype).requires_grad_(True),
                 "spec_prev_z": prev.to(dtype).requires_grad_(True)}
        params = list(m.parameters())
        call_s = []
        for _ in range(AR_CALLS):
            t0 = time.perf_counter()
            out = m(batch)
            grads = torch.autograd.grad(out.float().square().sum(),
                                        list(batch.values()) + params)
            torch.cuda.synchronize()
            call_s.append(time.perf_counter() - t0)
        if out.shape != (AR_BATCH, AR_TOKENS, 768) or out.dtype != dtype or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"AR encoder {dtype}: output "
                                 f"{tuple(out.shape)} {out.dtype} not finite")
        finite_grads(f"AR encoder {dtype}", grads)
        times[f"ar_{str(dtype)[6:]}"] = {"first_s": call_s[0],
                                         "warm_s": min(call_s[1:])}
    ar_peak = torch.cuda.max_memory_allocated() / 2**30
    del model, m, grads, out
    shares, before = {}, read_counts()
    for i, (variant, (key, _, lk)) in enumerate(OC_VARIANTS.items()):
        t0 = time.perf_counter()
        ldm = oc_model(variant, 62 + i)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        with torch.no_grad():
            ctx = None
            if variant == "class":
                emb = init_weights_(ClassEmbedder(768, OC_CLASSES).cuda(),
                                    torch.Generator("cuda").manual_seed(70))
                ctx = emb(y)
            elif lk:
                ctx = ldm.get_learned_conditioning(feats)
            kw = {"c_concat": c_concat} if key in ("concat", "hybrid") \
                else {"y": y} if key == "adm" else {}
            call_s = []
            for _ in range(OC_CALLS):
                t0 = time.perf_counter()
                out = ldm.apply_model(x, t, ctx, **kw)
                torch.cuda.synchronize()
                call_s.append(time.perf_counter() - t0)
        if out.shape != x.shape or out.dtype != FP32 or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"UNet {variant}: output {tuple(out.shape)}"
                                 f" {out.dtype} not finite")
        if ctx is not None and tuple(ctx.shape) != (OC_BATCH, lk, 768):
            raise AssertionError(f"{variant} context {tuple(ctx.shape)}")
        now = read_counts()
        shares[variant] = {k: n - before.get(k, 0) for k, n in now.items()
                           if n - before.get(k, 0)}
        before = now
        times[variant] = {"build_s": build_s, "first_s": call_s[0],
                          "warm_s": min(call_s[1:]),
                          "out_rms": float(out.square().mean().sqrt())}
        del ldm, out
        torch.cuda.empty_cache()
    launches = read_counts()
    times["ar_peak_mem_GiB"] = ar_peak
    times["peak_mem_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"other_cond AR encoder x ({AR_BATCH}, {AR_TOKENS}, 512) latent "
        f"({AR_BATCH}, {LATENT_HW[0]}, {LATENT_HW[1]}, 4), LDM_UNET bf16 at "
        f"batch {OC_BATCH} per variant: {json.dumps(times)}; launches by "
        f"UNet variant {json.dumps(shares)}")
    check_launches("other_cond", launches, expect)
    return launches, times


def first_stages_phase(expect: dict):
    """Run f: each of FIRST_STAGES in fp32 with seeded random weights,
    FS_CALLS calls of a forward over its seeded NHWC input and the
    gradient of Σ out² over the input and every parameter; the launch
    counts reset before the first call and read after the last. Outputs
    and gradients finite; first and warm seconds, peak memory each."""
    rng = np.random.default_rng(80)
    torch.cuda.synchronize()
    reset_counts()
    times = {}
    for i, (name, build, shape) in enumerate(FIRST_STAGES):
        model = randomize_(build(), 81 + i).cuda()
        params = list(model.parameters())
        x = torch.as_tensor(rng.standard_normal(shape), dtype=FP32,
                            device="cuda").requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        call_s = []
        for _ in range(FS_CALLS):
            t0 = time.perf_counter()
            out = model(x)
            grads = torch.autograd.grad(out.square().sum(), [x] + params)
            torch.cuda.synchronize()
            call_s.append(time.perf_counter() - t0)
        if out.dim() != 4 or out.shape[0] != FS_BATCH or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: output {tuple(out.shape)} not "
                                 f"finite")
        finite_grads(name, grads)
        times[name] = {"x": list(shape), "out": list(out.shape),
                       "first_s": call_s[0], "warm_s": min(call_s[1:]),
                       "peak_mem_GiB":
                       torch.cuda.max_memory_allocated() / 2**30}
        del model, params, grads, out
        torch.cuda.empty_cache()
    launches = read_counts()
    log(f"first_stages fp32: {json.dumps(times)}")
    check_launches("first_stages", launches, expect)
    return launches, times


def profile_phase(expect: dict):
    """Run q: ``cli.profile.main(["--family", "all", "--time"])`` on the card
    at batch Q_BATCH (fp32, each family's construction weights), the launch
    counts reset before and read after the call; then the same call on
    ``meta``, whose counts (parameters, flops, bytes, transcendentals) must
    equal the card's, family by family: the kernels count by formula on
    both. CAVP launches no kernel of the port."""
    args = ["--family", "all", "--batch", str(Q_BATCH)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    card = profile_cli.main(args + ["--time"])
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_counts()
    meta = profile_cli.main(args + ["--device", "meta"])
    keys = ("params", "flops", "bytes_accessed", "transcendentals")
    off = {name: {k: (r[k], meta[name][k]) for k in keys
                  if r[k] != meta[name][k]} for name, r in card.items()}
    off = {name: v for name, v in off.items() if v}
    times = {name: {"params": r["params"], "gflops": r["flops"] / 1e9,
                    "mbytes": r["bytes_accessed"] / 1e6,
                    "transcendentals": r["transcendentals"],
                    "ms": r["seconds"] * 1e3,
                    "tflops_per_second": r["tflops_per_second"]}
             for name, r in card.items()}
    log(f"profile cli.profile --family all --batch {Q_BATCH} --time on the "
        f"card, {call_s:.3f} s: {json.dumps(times)}; counts on meta equal "
        f"the card's: {not off}")
    if list(card) != ["unet", "vae.encode", "vae.decode", "classifier",
                      "cavp"] or off:
        raise AssertionError(f"cli.profile lines {list(card)}; counts that "
                             f"differ from meta's {off}")
    check_launches("profile", launches, expect)
    return launches, {**times, "call_s": call_s}


def scan_without_waits(step_fn, state, plan, gen, index_fn):
    """``scan_train`` under ``torch.cuda.set_sync_debug_mode("error")``: a
    wait for the card inside the K steps raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return scan_train(step_fn, state, plan, gen, index_fn=index_fn)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def scan_phase(expect: dict, root: str):
    """Run k: ``data.synthetic.write_ldm_data_dir`` writes SC_ITEMS items
    (512 spec frames, S2_TOKENS features of 512) under ``root``; the port's
    ``SpecFeatDataset`` reads them (no mixing), the frozen SD VAE (fp32,
    seeded random weights) encodes every spec once, and the posterior
    moments and the features stay resident on the card. Two classifier
    trainers at CLASSIFIER_BACKBONE (fp32, the same seeded random weights)
    take SC_K steps at batch SC_BATCH, planned as scripts/quality_gate.py
    plans them (random items, random labels, a random other item's
    features for a negative) and gathered on the card by an ``index_fn``:
    trainer A through ``scan_train`` under the sync debug mode "error",
    trainer B as SC_K sequential ``train_step`` calls that read each step's
    loss, both from generators of one seed; twice. First with cuDNN
    deterministic: metrics and parameters equal bit for bit (the port's
    kernels use no atomics). Then with cuDNN's defaults, as the CLIs run
    (its convolution backward may sum in another order from call to
    call): bit for bit, or the metrics within 1e-5 and the parameters
    within ``leaf_agreement``'s step rule. Then per-step ms of each loop,
    SC_K steps at a time, timed in turns (sequential, scan, scan,
    sequential). The launch counts are reset before the first step and
    read after the last."""
    data = os.path.join(root, "scan-data")
    t0 = time.perf_counter()
    synthetic.write_ldm_data_dir(data, n_train=SC_ITEMS, n_test=2,
                                 spec_frames=512, feat_len=S2_TOKENS,
                                 seed=90)
    ds = SpecFeatDataset.from_split_file(data, "train",
                                         LDMDataConfig(mix_prob=0.0))
    items = [ds[i] for i in range(SC_ITEMS)]
    write_s = time.perf_counter() - t0
    vae = AutoencoderKL()
    init_weights_(vae.to("cuda"), torch.Generator("cuda").manual_seed(91))
    spec = torch.as_tensor(np.stack([it["spec"] for it in items]),
                           device="cuda")
    feat = torch.as_tensor(np.stack([it["video_feat"] for it in items]),
                           device="cuda")
    with torch.no_grad():
        posts = [vae.eval().encode(spec[i:i + 8])
                 for i in range(0, SC_ITEMS, 8)]
    mu = torch.cat([p.mean for p in posts])
    sigma = torch.cat([p.std for p in posts])
    del posts, spec
    rng = np.random.default_rng(92)

    def plan(k: int) -> dict:
        spec_idx = rng.integers(0, SC_ITEMS, (k, SC_BATCH))
        labels = rng.integers(0, 2, (k, SC_BATCH))
        swap = rng.integers(0, SC_ITEMS, (k, SC_BATCH))
        swap = np.where(swap == spec_idx, (swap + 1) % SC_ITEMS, swap)
        feat_idx = np.where(labels == 1, spec_idx, swap)
        return {k_: torch.as_tensor(v, device="cuda") for k_, v in (
            ("spec_idx", spec_idx), ("feat_idx", feat_idx),
            ("labels", labels))}

    def index_fn(xs, step):
        return {"z_mu": mu[xs["spec_idx"]], "z_sigma": sigma[xs["spec_idx"]],
                "video_feat": feat[xs["feat_idx"]], "labels": xs["labels"]}

    def trainer_state():
        trainer = ClassifierTrainer(vae=vae)
        randomize_(trainer.model, 93)
        return trainer, trainer.init_train_state(None, "cuda")

    (ta, sa), (tb, sb) = trainer_state(), trainer_state()
    deterministic = torch.backends.cudnn.deterministic
    passes = {}
    torch.cuda.synchronize()
    reset_counts()
    for seed, (mode, det) in enumerate((("cudnn_deterministic", True),
                                        ("cudnn_default", False)), 94):
        steps = plan(SC_K)
        torch.backends.cudnn.deterministic = det
        try:
            t0 = time.perf_counter()
            _, m_scan = scan_without_waits(
                ta.train_step, sa, steps,
                torch.Generator("cuda").manual_seed(seed), index_fn)
            torch.cuda.synchronize()
            scan_s = time.perf_counter() - t0
            gen_b = torch.Generator("cuda").manual_seed(seed)
            t0 = time.perf_counter()
            seq, losses = [], []
            for i in range(SC_K):
                seq.append(tb.train_step(sb, index_fn(
                    {k: v[i] for k, v in steps.items()}, sb.step), gen_b))
                losses.append(float(seq[-1]["bce_loss"]))
            seq_s = time.perf_counter() - t0
        finally:
            torch.backends.cudnn.deterministic = deterministic
        m_seq = {k: torch.stack([m[k] for m in seq]) for k in m_scan}
        exact = all(torch.equal(m_scan[k], m_seq[k]) for k in m_scan) and \
            all(torch.equal(sa.params[k], sb.params[k]) for k in sa.params)
        held = "bit for bit"
        if not exact:
            if det:
                raise AssertionError("with cuDNN deterministic the scanned "
                                     "steps differ from the sequential ones")
            gap = max(float((m_scan[k] - m_seq[k]).abs().max())
                      for k in m_scan)
            leaves = leaf_agreement(
                {k: p.detach() for k, p in sa.params.items()},
                {k: p.detach() for k, p in sb.params.items()}, set(),
                ta.cfg.lr, SC_K, 1e-6)
            held = (f"metrics within {gap:.3e} (limit 1e-5); leaf_agreement "
                    f"(elements off, compared, rms/(steps·lr), nearest) "
                    f"{list(leaves)}")
            if not gap <= 1e-5:
                raise AssertionError(f"scanned metrics off the sequential "
                                     f"by {gap}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"scan losses {losses}")
        passes[mode] = {"scan_ms_per_step": scan_s / SC_K * 1e3,
                        "sequential_ms_per_step": seq_s / SC_K * 1e3,
                        "held": held, "bce": losses}
    # timed in turns (sequential, scan, scan, sequential), cuDNN's
    # defaults: each loop's first steps after the checks above pay for
    # their own warm-up
    per_step = {"scan": [], "sequential": []}
    for seed, kind in enumerate(("sequential", "scan", "scan",
                                 "sequential"), 96):
        steps, gen = plan(SC_K), torch.Generator("cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "scan":
            _, m = scan_train(ta.train_step, sa, steps, gen,
                              index_fn=index_fn)
            float(m["bce_loss"][-1])
        else:
            for i in range(SC_K):
                float(tb.train_step(sb, index_fn(
                    {k: v[i] for k, v in steps.items()}, sb.step),
                    gen)["bce_loss"])
        per_step[kind].append((time.perf_counter() - t0) / SC_K * 1e3)
    launches = read_counts()
    times = {"write_and_load_s": write_s, **passes,
             "timed_in_turns_ms_per_step": per_step}
    log(f"scan CLASSIFIER_BACKBONE fp32 batch {SC_BATCH}, {SC_K} steps "
        f"scanned (no wait for the card inside them) against {SC_K} "
        f"sequential (a loss read a step) over {SC_ITEMS} synthetic items "
        f"resident on the card, twice: {json.dumps(times)}")
    check_launches("scan", launches, expect)
    del ta, tb, sa, sb, vae, mu, sigma, feat
    torch.cuda.empty_cache()
    return launches, times


def dropout_remat_phase(expect: dict):
    """Run m: LDM_UNET with dropout DR_RATE and block recompute, built on
    the card with seeded lecun-normal weights (no zero-init layer, so every
    block's gradient is live), under ``Stage2Trainer`` in bf16 on fp32
    masters, on a seeded batch of S2_BATCH posterior moments and
    S2_TOKENS-token features. The gradients of one step, with the same
    draws (t, noise, the CFG keep mask and the dropout masks from one seed),
    without the recompute and then under each of DR_POLICIES; cuDNN
    deterministic for the run. Each policy's gradients must equal the
    others' and the unrecomputed ones bit for bit (the dropout masks drawn
    again in the recompute). Each call's peak memory, absolute and over
    what was held before it. Then AdamW once, and
    the model exported with ``export_ldm_state_dict``, split back with
    ``split_ldm_state_dict`` and loaded through the port's converters into
    a fresh LatentDiffusion with strict=True: every tensor bit for bit the
    exported one's."""
    gen = torch.Generator("cuda").manual_seed(96)
    cfg = dataclasses.replace(LDM_UNET, dropout=DR_RATE, use_checkpoint=True)
    with torch.device("cuda"):
        ldm = LatentDiffusion(LDMConfig(unet=cfg))
    init_weights_(ldm, gen)
    with torch.no_grad():
        ldm.cond.pos_emb.normal_(generator=gen)
    trainer = Stage2Trainer(ldm, Stage2TrainConfig(
        base_lr=S2_LR, warmup_steps=1, compute_dtype="bfloat16"))
    state = trainer.init_train_state(None, "cuda")
    rng = np.random.default_rng(97)
    batch = {"z_mu": rng.standard_normal((S2_BATCH, *LATENT_HW, 4)),
             "z_sigma": rng.uniform(0.1, 0.5, (S2_BATCH, *LATENT_HW, 4)),
             "video_feat": rng.standard_normal((S2_BATCH, S2_TOKENS, 512))}
    batch = {k: torch.as_tensor(v, dtype=FP32, device="cuda")
             for k, v in batch.items()}
    blocks = [m for m in ldm.unet.modules()
              if isinstance(m, SpatialTransformer)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    grads, stats = {}, {}
    torch.cuda.synchronize()
    reset_counts()
    try:
        for policy in ("off",) + DR_POLICIES:
            for m in blocks:
                m.checkpoint = policy != "off"
                m.remat_policy = "none" if policy == "off" else policy
            for p in trainer.full.values():
                p.grad = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held_before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            metrics = trainer.gradients(
                state, batch, torch.Generator("cuda").manual_seed(98))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            # the call's own peak: over what was held before it (the
            # state, and the reference gradients kept for the comparison)
            stats[policy] = {
                "s": time.perf_counter() - t0,
                "peak_mem_GiB": peak / 2**30,
                "call_peak_GiB": (peak - held_before) / 2**30,
                "loss": float(metrics["loss"])}
            mine = {k: p.grad for k, p in trainer.full.items()}
            if policy in ("off", "none"):
                grads[policy] = {k: g.clone() for k, g in mine.items()}
            for ref in [r for r in ("off", "none") if r != policy]:
                if ref not in grads:
                    continue
                same = sum(torch.equal(mine[k], g)
                           for k, g in grads[ref].items())
                stats[policy][f"leaves_equal_to_{ref}"] = same
                if same != len(mine):
                    worst = max((float((mine[k] - g).abs().max()) / max(
                        _rms(g), 1e-30), k) for k, g in grads[ref].items())
                    raise AssertionError(
                        f"dropout_remat {policy}: {len(mine) - same} "
                        f"gradient leaves differ from {ref}'s; worst max|Δ|"
                        f"/rms {worst}")
        trainer.apply_gradients(state)
        state.step += 1
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    launches = read_counts()
    del grads
    log(f"dropout_remat LDM_UNET bf16 on fp32 masters, dropout {DR_RATE}, "
        f"batch {S2_BATCH}: {len(trainer.full)} gradient leaves equal bit for "
        f"bit without the recompute and under each policy; "
        f"{json.dumps(stats)}")
    check_launches("dropout_remat", launches, expect)
    # the export round trip of the stepped model
    t0 = time.perf_counter()
    sd = export_ldm_state_dict(state.params, ldm.vae, LDM_UNET, SD_VAE)
    u, v, c = split_ldm_state_dict(sd)
    with torch.device("cuda"):
        fresh = LatentDiffusion(LDMConfig())
    fresh.unet.load_state_dict(from_jax_params(convert_unet(u, LDM_UNET)),
                               strict=True)
    fresh.cond.load_state_dict(from_jax_params(convert_cond_encoder(c)),
                               strict=True)
    fresh.vae.load_state_dict(from_jax_params(convert_vae(v, SD_VAE)),
                              strict=True)
    theirs = {**{f"unet.{k}": t for k, t in ldm.unet.state_dict().items()},
              **{f"cond.{k}": t for k, t in ldm.cond.state_dict().items()},
              **{f"vae.{k}": t for k, t in ldm.vae.state_dict().items()}}
    theirs.update({k: p.detach() for k, p in state.params.items()})
    ours = {k: t for k, t in fresh.state_dict().items()
            if k.startswith(("unet.", "cond.", "vae."))}
    off = [k for k, t in ours.items()
           if not torch.equal(t, theirs[k].to(t.dtype))]
    export_s = time.perf_counter() - t0
    log(f"dropout_remat export_ldm_state_dict → split_ldm_state_dict → "
        f"convert_* → strict load: {len(sd)} reference keys, {len(ours)} "
        f"tensors, {len(off)} differ, {export_s:.3f} s")
    if off or set(ours) != set(theirs):
        raise AssertionError(f"export round trip: {off[:5]} differ")
    del ldm, fresh, trainer, state, sd, u, v, c
    torch.cuda.empty_cache()
    return launches, {**stats, "export_roundtrip_s": export_s}


def native_compose_phase(clip: str, ldm_logdir: str, cavp_logdir: str,
                         clf_logdir: str):
    """``DiffFoley.from_native_checkpoints`` over the port's own three
    logdirs (stage 2, stage-1 CAVP, classifier), with the classifier's
    context encoded and raw, each then ``generate_for_video`` on the
    seeded clip at a few steps: finite int16 wavs."""
    gen = GenerationConfig(steps=3, sample_num=2, gl_iters=4,
                           wav_dtype="int16")
    out = {}
    for context in ("encoded", "raw"):
        t0 = time.perf_counter()
        df = DiffFoley.from_native_checkpoints(
            cavp_logdir, ldm_logdir, classifier=clf_logdir,
            classifier_context=context)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        expect_type = ("AlignmentClassifier" if context == "encoded"
                       else "ClassifierBackbone")
        if type(df.pipe.classifier).__name__ != expect_type or \
                df.frame_size != FRAME:
            raise AssertionError(f"from_native_checkpoints {context}: "
                                 f"{type(df.pipe.classifier).__name__}, "
                                 f"frames {df.frame_size}")
        reset_counts()
        t0 = time.perf_counter()
        sample = df.generate_for_video(clip, seed=0, gen=gen)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        check_outputs(sample, f"from_native_checkpoints ({context}) → "
                      "generate_for_video", samples=2, windows=1)
        log(f"from_native_checkpoints {context}: load {load_s:.3f} s, "
            f"generate_for_video (3 steps) {call_s:.3f} s, launches "
            f"{json.dumps(read_counts())}")
        out[context] = {"load_s": load_s, "generate_s": call_s}
        del df
        torch.cuda.empty_cache()
    return out


# The planted faults of the classifier and CAVP agreements: these leaves'
# GPU gradients 1% off.
C_FAULT_LEAF = "backbone.in_conv.weight"
CAVP_FAULT_LEAF = "video_encoder.conv1.conv.weight"


def _planted_caught(grads: dict, ref: dict, zero: set, leaf: str) -> bool:
    faulty = dict(grads)
    faulty[leaf] = faulty[leaf] * 1.01
    try:
        gradient_agreement(faulty, ref, zero, *GRAD_TOL)
    except AssertionError:
        return True
    return False


def agreement_classifier_phase():
    """One fp32 classifier train step on the GPU (kernels) against the same
    step on the CPU (plain versions), from equal weights with the same
    batch and draws: the backbone at D 32 (4 heads of 128 channels at
    ds 2; 64 channels at level 0, so that no GroupNorm group holds one
    channel and removes a bias's gradient), cross attention over 40 tokens
    (a ragged last key tile), the VAE at ch 32 (the per-head kernel's
    D 32). The gradients per leaf before AdamW at
    GRAD_TOL, the metrics, and a planted 1% fault on C_FAULT_LEAF."""
    ccfg = UNetConfig(out_channels=1, model_channels=64, num_res_blocks=1,
                      channel_mult=(1, 2), attention_resolutions=(2,),
                      num_heads=4, context_dim=512)
    base = ClassifierTrainer(ccfg, AutoencoderKL(VAEConfig(
        ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)), cond_seq_len=40)
    randomize_(base.model, 11)
    randomize_(base.vae, 12)
    rng = np.random.default_rng(13)
    latent = (2, 8, 16, 4)
    batch = {"spec": torch.as_tensor(rng.uniform(size=(2, 64, 128, 3)),
                                     dtype=FP32),
             "video_feat": torch.as_tensor(rng.standard_normal((2, 40, 512)),
                                           dtype=FP32),
             "labels": torch.tensor([1, 0])}
    draws = {"t": torch.tensor([37, 811]),
             "noise": torch.as_tensor(rng.standard_normal(latent),
                                      dtype=FP32),
             "eps": torch.as_tensor(rng.standard_normal(latent), dtype=FP32)}
    grads, metrics = {}, {}
    reset_counts()
    for device in ("cuda", "cpu"):
        trainer = copy.deepcopy(base)
        state = trainer.init_train_state(None, device)
        m = trainer.train_step(
            state, {k: v.to(device) for k, v in batch.items()},
            draws={k: v.to(device) for k, v in draws.items()})
        metrics[device] = {k: float(v) for k, v in m.items()}
        grads[device] = {k: p.grad.detach().cpu()
                         for k, p in state.params.items()}
    launched = read_counts()
    if not all(launched.get(k) for k in (
            "attn_packed_fwd/float32", "attn_packed_bwd/float32",
            "attn_fwd/float32")) or "attn_bwd/float32" in launched:
        raise AssertionError(f"tiny classifier step launches {launched}")
    worst = max(abs(metrics["cuda"][k] - ref) / max(abs(ref), 1e-3)
                for k, ref in metrics["cpu"].items())
    zero = noise_gradients(grads["cpu"])
    grad_worst = gradient_agreement(grads["cuda"], grads["cpu"], zero,
                                    *GRAD_TOL)
    caught = _planted_caught(grads["cuda"], grads["cpu"], zero, C_FAULT_LEAF)
    log(f"agreement tiny fp32 train_classifier gpu-vs-cpu, one step from "
        f"equal weights: metrics worst relative Δ {worst:.3e} (tol 1e-4); "
        f"gradients per leaf, worst (max|Δ|, rms(Δ)) / rms(cpu) "
        f"{list(grad_worst)} (limits {list(GRAD_TOL)}) over "
        f"{len(grads['cpu'])} leaves, {len(zero)} zero-gradient biases noise "
        f"on both; planted fault ({C_FAULT_LEAF} ×1.01) caught {caught}; "
        f"launches {json.dumps(launched)}; cpu metrics "
        f"{json.dumps(metrics['cpu'])}")
    if not worst <= 1e-4:
        raise AssertionError("GPU classifier metrics disagree with the CPU's")
    if not caught:
        raise AssertionError("the classifier agreement passes the planted "
                             "fault")


def agreement_cavp_phase():
    """One fp32 stage-1 train step of tiny CAVP towers on the GPU against
    the same step on the CPU, from equal weights and BatchNorm statistics,
    with the same batch and the same dropout masks: the gradients per leaf
    before AdamW and the BatchNorm running statistics after the step at
    GRAD_TOL, the metrics, and a planted 1% fault on CAVP_FAULT_LEAF."""
    cfg = CAVPConfig(video_stage_blocks=(1, 1, 1, 1), video_base_channels=8,
                     spec_channels=(8, 8, 16, 16, 32, 32), pool_kernel=4)
    base = randomize_(CAVPModel(cfg), 14)
    rng = np.random.default_rng(15)
    batch = {"video": torch.as_tensor(rng.uniform(
                 size=(2, 2, 4, 32, 32, 3)), dtype=FP32),
             "spec": torch.as_tensor(rng.uniform(size=(2, 2, 128, 64)),
                                     dtype=FP32)}
    real = cnn14_module.dropout_keep
    grads, stats, metrics = {}, {}, {}
    try:
        for device in ("cuda", "cpu"):
            masks = np.random.default_rng(16)   # the same masks on both
            cnn14_module.dropout_keep = (
                lambda shape, p, g, dev: torch.as_tensor(
                    masks.uniform(size=tuple(shape)) < p, device=dev))
            trainer = Stage1Trainer(copy.deepcopy(base), Stage1TrainConfig(
                lr=1e-4, warmup_steps=0, clip_num=2))
            state = trainer.init_train_state(None, device)
            m = trainer.train_step(state, {k: v.to(device)
                                           for k, v in batch.items()})
            metrics[device] = {k: float(v) for k, v in m.items()}
            grads[device] = {k: p.grad.detach().cpu()
                             for k, p in state.params.items()}
            stats[device] = {k: v.detach().cpu()
                             for k, v in state.batch_stats.items()}
    finally:
        cnn14_module.dropout_keep = real
    worst = max(abs(metrics["cuda"][k] - ref) / max(abs(ref), 1e-3)
                for k, ref in metrics["cpu"].items())
    zero = noise_gradients(grads["cpu"])
    grad_worst = gradient_agreement(grads["cuda"], grads["cpu"], zero,
                                    *GRAD_TOL)
    stats_worst = gradient_agreement(stats["cuda"], stats["cpu"], set(),
                                     *GRAD_TOL)
    caught = _planted_caught(grads["cuda"], grads["cpu"], zero,
                             CAVP_FAULT_LEAF)
    log(f"agreement tiny fp32 train_cavp gpu-vs-cpu, one step from equal "
        f"states: metrics worst relative Δ {worst:.3e} (tol 1e-4); gradients "
        f"per leaf, worst (max|Δ|, rms(Δ)) / rms(cpu) {list(grad_worst)}, "
        f"BatchNorm statistics {list(stats_worst)} (limits "
        f"{list(GRAD_TOL)}) over {len(grads['cpu'])} leaves and "
        f"{len(stats['cpu'])} statistics; planted fault ({CAVP_FAULT_LEAF} "
        f"×1.01) caught {caught}; cpu metrics {json.dumps(metrics['cpu'])}")
    if not worst <= 1e-4:
        raise AssertionError("GPU CAVP metrics disagree with the CPU's")
    if not caught:
        raise AssertionError("the CAVP agreement passes the planted fault")


TOWER_FAULT_LEAF = "video_encoder.stem_conv.weight"


def agreement_cavp_towers_phase():
    """One fp32 stage-1 train step of the other towers, tiny (i3d ×
    resnet50 at ``cli.train_cavp``'s ``--tiny`` cut, 16 frames of 32²), on
    the GPU against the same step on the CPU from equal weights and
    BatchNorm statistics and the same batch: the gradients per leaf before
    AdamW and the BatchNorm running statistics after the step at
    GRAD_TOL, the metrics, and a planted 1% fault on TOWER_FAULT_LEAF."""
    tiny = train_cavp_cli.TINY_TOWERS
    cfg = CAVPConfig(video_arch="i3d", spec_arch="resnet50",
                     video_tower=tiny["i3d"], spec_tower=tiny["resnet50"])
    base = randomize_(CAVPModel(cfg), 24)
    rng = np.random.default_rng(25)
    batch = {"video": torch.as_tensor(rng.uniform(
                 size=(2, 2, 16, 32, 32, 3)), dtype=FP32),
             "spec": torch.as_tensor(rng.uniform(size=(2, 2, 128, 256)),
                                     dtype=FP32)}
    grads, stats, metrics = {}, {}, {}
    for device in ("cuda", "cpu"):
        trainer = Stage1Trainer(copy.deepcopy(base), Stage1TrainConfig(
            lr=1e-4, warmup_steps=0, clip_num=2))
        state = trainer.init_train_state(None, device)
        m = trainer.train_step(state, {k: v.to(device)
                                       for k, v in batch.items()})
        metrics[device] = {k: float(v) for k, v in m.items()}
        grads[device] = {k: p.grad.detach().cpu()
                         for k, p in state.params.items()}
        stats[device] = {k: v.detach().cpu()
                         for k, v in state.batch_stats.items()}
    worst = max(abs(metrics["cuda"][k] - ref) / max(abs(ref), 1e-3)
                for k, ref in metrics["cpu"].items())
    zero = noise_gradients(grads["cpu"])
    grad_worst = gradient_agreement(grads["cuda"], grads["cpu"], zero,
                                    *GRAD_TOL)
    stats_worst = gradient_agreement(stats["cuda"], stats["cpu"], set(),
                                     *GRAD_TOL)
    caught = _planted_caught(grads["cuda"], grads["cpu"], zero,
                             TOWER_FAULT_LEAF)
    log(f"agreement tiny fp32 train_cavp i3d × resnet50 gpu-vs-cpu, one "
        f"step from equal states: metrics worst relative Δ {worst:.3e} (tol "
        f"1e-4); gradients per leaf, worst (max|Δ|, rms(Δ)) / rms(cpu) "
        f"{list(grad_worst)}, BatchNorm statistics {list(stats_worst)} "
        f"(limits {list(GRAD_TOL)}) over {len(grads['cpu'])} leaves and "
        f"{len(stats['cpu'])} statistics; planted fault ({TOWER_FAULT_LEAF} "
        f"×1.01) caught {caught}")
    if not worst <= 1e-4:
        raise AssertionError("GPU tower metrics disagree with the CPU's")
    if not caught:
        raise AssertionError("the tower agreement passes the planted fault")


DEC_FAULT_LEAF = "conv_in.weight"


def agreement_decode_phase():
    """One fp32 MSE step of a tiny spec decoder (ch 32, ch_mult (1, 1): its
    mid attention at D 32, inside the per-head kernels' head dims, and
    one-channel GroupNorm groups) on the GPU (kernels 3, 4 and 5) against
    the CPU (plain versions) from equal weights: the loss, the gradients
    per leaf out of Adam's first moment at GRAD_TOL, and a planted 1%
    fault on DEC_FAULT_LEAF. The decoder reads seeded N(0, 1) features in
    place of the frozen tower's: a tiny random CNN14 gives nearly the same
    features at every step of a noise spec, so the first GroupNorm's
    one-step-wide groups divide by a σ far under their mean, and fp32
    itself misses float64 by 2.7e-3 of rms there (conv_in's gradient,
    on the CPU); on N(0, 1) features 1.5e-5."""
    cfg = DecodeConfig(feat_dim=16, decoder=VAEConfig(
        ch=32, ch_mult=(1, 1), num_res_blocks=1, out_channels=64), lr=1e-4)
    cavp = CAVPModel(CAVPConfig(
        embed_dim=16, video_stage_blocks=(1, 1, 1, 1), video_base_channels=8,
        spec_channels=(8, 8, 16, 16, 32, 32)))
    decoder = randomize_(Decoder(cfg.decoder, in_channels=cfg.feat_dim), 27)
    rng = np.random.default_rng(28)
    spec = torch.as_tensor(rng.uniform(size=(2, cfg.mel_bins, 256)),
                           dtype=FP32)
    feats = torch.as_tensor(rng.standard_normal((2, 16, cfg.feat_dim)),
                            dtype=FP32)
    grads, losses = {}, {}
    for device in ("cuda", "cpu"):
        w = DecoderWrapper(cfg, copy.deepcopy(cavp))
        w.encode_spec = lambda s: feats.to(s.device)
        w.decoder.load_state_dict(decoder.state_dict())
        state = w.init_train_state(None, device)
        losses[device] = float(w.train_step(state, spec.to(device))[
            "l2_loss"])
        # Adam's first moment after one step: (1 − β1)·g, β1 0.5
        grads[device] = {k: m.detach().cpu() / 0.5 for (k, _), m in zip(
            w.decoder.named_parameters(), state.opt.mu)}
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    zero = noise_gradients(grads["cpu"])
    grad_worst = gradient_agreement(grads["cuda"], grads["cpu"], zero,
                                    *GRAD_TOL)
    caught = _planted_caught(grads["cuda"], grads["cpu"], zero,
                             DEC_FAULT_LEAF)
    log(f"agreement tiny fp32 spec-decoder MSE step gpu-vs-cpu: loss "
        f"relative Δ {rel:.3e} (tol 1e-5); gradients per leaf, worst "
        f"(max|Δ|, rms(Δ)) / rms(cpu) {list(grad_worst)} (limits "
        f"{list(GRAD_TOL)}) over {len(grads['cpu'])} leaves, "
        f"{len(zero)} analytically zero; planted fault ({DEC_FAULT_LEAF} "
        f"×1.01) caught {caught}")
    if not rel <= 1e-5:
        raise AssertionError("GPU spec-decoder loss disagrees with the CPU's")
    if not caught:
        raise AssertionError("the decoder agreement passes the planted fault")


def agreement_new_models_phase():
    """The three new models at tiny fp32 widths whose head dims the kernels
    take, on the GPU (kernels) against the CPU (plain versions) from equal
    seeded weights and inputs; each output and gradient held per tensor at
    GRAD_TOL (max|Δ| and rms(Δ) against rms(cpu)):

    - the audio UNet (96 base channels, mult (1, 2), 2 heads: D 48 at the
      attention of resolution 1, D 96 at resolution 2 and in the middle,
      a 6-token context): the output, and the gradient of Σ out² over
      every parameter and the input;
    - the prior (dim 128, 8 tokens, depth 2, 2 heads: D 64): the
      ``p_losses`` gradient under shared draws, and 10 ``sample`` steps at
      CFG 3 under shared x_T and step noise, held at SAMPLER_AGREE_TOL of
      max(1, max|x_cpu|);
    - EncoderUNetModel (64 base channels, mult (1, 1), 2 heads: D 32,
      attention pool over 32 + 1 keys) at each pool: the output and the
      gradient of its sum over the input."""
    report = {}

    def held(what, gpu: dict, cpu: dict):
        report[what] = list(gradient_agreement(gpu, cpu, noise_gradients(cpu),
                                               *GRAD_TOL))

    ucfg = AudioUNetConfig(in_channels=8, out_channels=8, model_channels=96,
                           num_res_blocks=1, attention_resolutions=(1, 2),
                           channel_mult=(1, 2), num_heads=2, context_dim=32)
    unet = randomize_(AudioUNetModel(ucfg), 51)
    rng = np.random.default_rng(52)
    ux = torch.as_tensor(rng.standard_normal((2, 64, 8)), dtype=FP32)
    ut = torch.as_tensor([3.0, 710.0])
    uc = torch.as_tensor(rng.standard_normal((2, 6, 32)), dtype=FP32)
    pcfg = PriorConfig(dim=128, seq_len=8, depth=2, heads=2,
                       num_timesteps=100)
    prior = DiffusionPrior(pcfg).init_params(53, "cpu")
    pv, ps = (torch.as_tensor(rng.standard_normal((3, 8, 128)), dtype=FP32)
              for _ in range(2))
    draws = {"t": torch.as_tensor([5, 50, 99]),
             "noise": torch.as_tensor(rng.standard_normal((3, 8, 128)),
                                      dtype=FP32),
             "video_keep": torch.as_tensor([True, False, True]),
             "spec_keep": torch.as_tensor([True, True, False])}
    sdraws = {"x_T": torch.as_tensor(rng.standard_normal((3, 8, 128)),
                                     dtype=FP32),
              "noise": torch.as_tensor(rng.standard_normal((10, 3, 8, 128)),
                                       dtype=FP32)}
    ecfg = UNetConfig(in_channels=4, out_channels=3, model_channels=64,
                      num_res_blocks=1, attention_resolutions=(2,),
                      channel_mult=(1, 1), num_heads=2)
    encoders = {pool: randomize_(EncoderUNetModel(ecfg, pool, hw=(8, 16)),
                                 54 + i) for i, pool in enumerate(POOLS)}
    ex = torch.as_tensor(rng.standard_normal((2, 8, 16, 4)), dtype=FP32)
    et = torch.as_tensor([0.0, 500.0])
    runs = {}
    samples = {}
    for device in ("cuda", "cpu"):
        out = {}
        m = copy.deepcopy(unet).to(device)
        x = ux.to(device).requires_grad_(True)
        y = m(x, ut.to(device), uc.to(device))
        names = ["x"] + [k for k, _ in m.named_parameters()]
        grads = torch.autograd.grad(y.square().sum(),
                                    [x] + list(m.parameters()))
        out["audio_unet"] = {"out": y.detach().cpu(), **{
            n: g.cpu() for n, g in zip(names, grads)}}
        p = copy.deepcopy(prior).to(device)
        loss = p.p_losses(pv.to(device), ps.to(device), draws=draws)
        grads = torch.autograd.grad(loss, list(p.net.parameters()))
        out["prior_p_losses"] = {"loss": loss.detach().cpu()[None], **{
            k: g.cpu() for (k, _), g in zip(p.net.named_parameters(), grads)}}
        samples[device] = p.sample(pv.to(device), steps=10, cond_scale=3.0,
                                   draws=sdraws).cpu()
        for pool, model in encoders.items():
            m = copy.deepcopy(model).to(device)
            x = ex.to(device).requires_grad_(True)
            y = m(x, et.to(device))
            (g,) = torch.autograd.grad(y.sum(), x)
            out[f"encoder_{pool}"] = {"out": y.detach().cpu(), "x": g.cpu()}
        runs[device] = out
    for what in runs["cpu"]:
        held(what, runs["cuda"][what], runs["cpu"][what])
    d_sample = float((samples["cuda"] - samples["cpu"]).abs().max()) / max(
        1.0, float(samples["cpu"].abs().max()))
    report["prior_sample"] = d_sample
    log(f"agreement tiny fp32 audio UNet / prior / EncoderUNetModel "
        f"gpu-vs-cpu, worst (max|Δ|, rms(Δ)) / rms(cpu) and tensor: "
        f"{json.dumps(report)} (limits {list(GRAD_TOL)}; prior sample "
        f"max|Δ| / max(1, max|x|) limit {SAMPLER_AGREE_TOL})")
    if not d_sample <= SAMPLER_AGREE_TOL:
        raise AssertionError("GPU prior samples disagree with the CPU's")


def agreement_other_phase():
    """Runs o and f at tiny fp32 widths whose head dims the kernels take,
    on the GPU (kernels) against the CPU (plain versions) from equal
    seeded weights and inputs; each output and gradient held per tensor
    at GRAD_TOL (max|Δ| and rms(Δ) against rms(cpu)):

    - the AR encoder (hidden 128, 2 heads of D 64, depth 1, a (2, 4, 8, 4)
      latent: 32 keys): the output, and the gradient of Σ out² over both
      inputs and every parameter; the MLP and the one-Linear video
      encoders likewise (no kernel);
    - ``LatentDiffusion.apply_model`` of a UNet of 64 base channels, mult
      (1, 1), 2 heads (D 32), for concat, hybrid, adm (10 classes),
      ResBlock positions (16) and crossattn over a ClassEmbedder token:
      the output;
    - ``LatentRescaler`` (factor 1.5, mid 32: the per-head kernels at D
      32), ``UpsampleDecoder`` and ``SimpleDecoder`` at ch 32: the output
      and the gradient of Σ out² over the input and every parameter."""
    report = {}
    rng = np.random.default_rng(90)
    arr = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                         dtype=FP32)
    ar = randomize_(VideoFeatEncoderPosembedAR(
        origin_dim=24, hidden_dim=128, embed_dim=32, depth=1, seq_len=16,
        heads=2, dim_head=64), 91)
    ar_in = {"video_feat": arr(2, 8, 24), "spec_prev_z": arr(2, 4, 8, 4)}
    plain_encoders = {"mlp_encoder": randomize_(VideoFeatEncoderMLP(24, 32),
                                                99),
                      "simple_encoder": randomize_(
                          VideoFeatEncoderSimple(24, 32), 100)}
    base = dict(model_channels=64, num_res_blocks=1,
                attention_resolutions=(2,), channel_mult=(1, 1), num_heads=2,
                context_dim=32)
    tiny_vae = VAEConfig(ch=32, ch_mult=(1,), num_res_blocks=1)
    variants = {"concat": ("concat", dict(in_channels=8)),
                "hybrid": ("hybrid", dict(in_channels=8)),
                "adm": ("adm", dict(num_classes=10)),
                "pos": ("crossattn", dict(pos_seq_len=16)),
                "class": ("crossattn", {})}
    ldms = {v: randomize_(LatentDiffusion(LDMConfig(
        unet=UNetConfig(**base, **changes), vae=tiny_vae, cond_origin_dim=24,
        cond_embed_dim=32, cond_seq_len=8, conditioning_key=key)), 92 + i)
        for i, (v, (key, changes)) in enumerate(variants.items())}
    emb = randomize_(ClassEmbedder(32, 10), 97)
    ux, ucat, uf = arr(2, 8, 16, 4), arr(2, 8, 16, 4), arr(2, 6, 24)
    ut, uy = torch.as_tensor([3.0, 710.0]), torch.as_tensor([1, 7])
    stages = {"rescaler": (LatentRescaler(1.5, 4, 32, 8, depth=1),
                           (2, 5, 7, 4)),
              "upsample": (UpsampleDecoder(64, 3, 32, 1, (1, 1)),
                           (2, 4, 8, 64)),
              "simple": (SimpleDecoder(32, 3), (2, 4, 8, 32))}
    stages = {k: (randomize_(m, 98 + i), arr(*shape))
              for i, (k, (m, shape)) in enumerate(stages.items())}

    def with_grads(m, inputs: dict, out):
        names = list(inputs) + [k for k, _ in m.named_parameters()]
        grads = torch.autograd.grad(out.square().sum(), list(
            inputs.values()) + list(m.parameters()))
        return {"out": out.detach().cpu(),
                **{n: g.cpu() for n, g in zip(names, grads)}}

    runs = {}
    for device in ("cuda", "cpu"):
        out = {}
        m = copy.deepcopy(ar).to(device)
        inputs = {k: v.to(device).requires_grad_(True)
                  for k, v in ar_in.items()}
        out["ar_encoder"] = with_grads(m, inputs, m(inputs))
        for name, enc in plain_encoders.items():
            m = copy.deepcopy(enc).to(device)
            xx = ar_in["video_feat"].to(device).requires_grad_(True)
            out[name] = with_grads(m, {"x": xx}, m(xx))
        e = copy.deepcopy(emb).to(device)
        with torch.no_grad():
            for v, ldm in ldms.items():
                m = copy.deepcopy(ldm).to(device)
                key = m.cfg.conditioning_key
                ctx = (e(uy.to(device)) if v == "class"
                       else m.get_learned_conditioning(uf.to(device)))
                kw = ({"c_concat": ucat.to(device)}
                      if key in ("concat", "hybrid") else
                      {"y": uy.to(device)} if key == "adm" else {})
                out[f"unet_{v}"] = {"out": m.apply_model(
                    ux.to(device), ut.to(device), ctx, **kw).cpu()}
        for name, (stage, x) in stages.items():
            m = copy.deepcopy(stage).to(device)
            xx = x.to(device).requires_grad_(True)
            out[name] = with_grads(m, {"x": xx}, m(xx))
        runs[device] = out
    for what in runs["cpu"]:
        report[what] = list(gradient_agreement(
            runs["cuda"][what], runs["cpu"][what],
            noise_gradients(runs["cpu"][what]), *GRAD_TOL))
    log(f"agreement tiny fp32 AR encoder / UNet conditioning modes / first "
        f"stages gpu-vs-cpu, worst (max|Δ|, rms(Δ)) / rms(cpu) and tensor: "
        f"{json.dumps(report)} (limits {list(GRAD_TOL)})")


# The planted fault of the stage-2 agreement: this leaf's GPU gradient 1%
# off.
S2_FAULT_LEAF = "unet.in_conv.weight"


def agreement_stage2_phase():
    """One fp32 stage-2 train step of a tiny LDM on the GPU (kernels)
    against the same step on the CPU (plain versions), from equal states,
    with the same batch and draws (t, noise, keep mask, posterior ε): the
    UNet at the agreement phase's widths (head dims 40 and 80: the kernels
    take the path's head dims only, which ``--tiny``'s 16 is not), the VAE
    at ch 32 (the per-head kernel's D 32). The gradients per leaf before
    AdamW at ``GRAD_TOL``, the metrics, and a planted 1% fault on
    ``S2_FAULT_LEAF``'s GPU gradient that must be caught."""
    ucfg = UNetConfig(model_channels=160, num_res_blocks=1,
                      channel_mult=(1, 2), attention_resolutions=(1, 2),
                      num_heads=4, context_dim=64)
    ldm = randomize_(LatentDiffusion(LDMConfig(
        unet=ucfg, vae=VAEConfig(ch=32, ch_mult=(1, 1, 1, 1),
                                 num_res_blocks=1), cond_embed_dim=64)), 9)
    rng = np.random.default_rng(10)
    latent = (2, 8, 16, 4)
    batch = {"spec": torch.as_tensor(rng.uniform(size=(2, 64, 128, 3)),
                                     dtype=FP32),
             "video_feat": torch.as_tensor(rng.standard_normal((2, 8, 512)),
                                           dtype=FP32)}
    draws = {"t": torch.tensor([37, 811]),
             "noise": torch.as_tensor(rng.standard_normal(latent),
                                      dtype=FP32),
             "keep": torch.tensor([True, False]).view(2, 1, 1),
             "eps": torch.as_tensor(rng.standard_normal(latent), dtype=FP32)}
    tcfg = Stage2TrainConfig(base_lr=1e-4, warmup_steps=0, use_ema=True)
    grads, metrics = {}, {}
    reset_counts()
    for device in ("cuda", "cpu"):
        trainer = Stage2Trainer(copy.deepcopy(ldm), tcfg)
        state = trainer.init_train_state(None, device)
        m = trainer.train_step(
            state, {k: v.to(device) for k, v in batch.items()},
            draws={k: v.to(device) for k, v in draws.items()})
        metrics[device] = {k: float(v) for k, v in m.items()}
        grads[device] = {k: p.grad.detach().cpu()
                         for k, p in state.params.items()}
    if not all(ha.LAUNCHES[k] for k in ("attn_packed_fwd", "attn_packed_bwd",
                                        "attn_fwd")):
        raise AssertionError(f"tiny stage-2 step launches {ha.LAUNCHES}")
    worst = max(abs(metrics["cuda"][k] - ref) / max(abs(ref), 1e-3)
                for k, ref in metrics["cpu"].items())
    zero = noise_gradients(grads["cpu"])
    grad_worst = gradient_agreement(grads["cuda"], grads["cpu"], zero,
                                    *GRAD_TOL)
    faulty = dict(grads["cuda"])
    faulty[S2_FAULT_LEAF] = faulty[S2_FAULT_LEAF] * 1.01
    try:
        gradient_agreement(faulty, grads["cpu"], zero, *GRAD_TOL)
        caught = False
    except AssertionError:
        caught = True
    log(f"agreement tiny fp32 train_stage2 gpu-vs-cpu, one step from equal "
        f"states: metrics worst relative Δ {worst:.3e} (tol 1e-4); gradients "
        f"per leaf, worst (max|Δ|, rms(Δ)) / rms(cpu) {list(grad_worst)} "
        f"(limits {list(GRAD_TOL)}) over {len(grads['cpu'])} leaves, "
        f"{len(zero)} zero-gradient biases noise on both; planted fault "
        f"({S2_FAULT_LEAF} ×1.01) caught {caught}; cpu metrics "
        f"{json.dumps(metrics['cpu'])}")
    if not worst <= 1e-4:
        raise AssertionError("GPU stage-2 metrics disagree with the CPU's")
    if not caught:
        raise AssertionError("the stage-2 agreement passes the planted "
                             "fault")


# The tiny waveform VAE step, GPU fp32 against the CPU in float64, per
# leaf against rms(float64): (max|Δ|, rms(Δ)). The discriminators' biases
# sum over whole STFT maps: on the CPU, fp32 lands up to 3.2e-4 of a
# leaf's max from float64 there (tests/test_torch_sound_vae.py). A
# gradient wrong by 1% of a leaf is ten times the max limit.
SV_GRAD_TOL = (3e-3, 1e-3)
SV_FAULT_LEAF = "vae.decoder.block3_up.weight"


def agreement_sound_vae_phase():
    """One ``SoundVAETrainer`` step of a tiny waveform VAE (channels 4, z 8,
    8192 samples, batch 2; the JAX package's tiny GAN point: n_fft 256,
    mel windows 32 and 128, STFT windows 128 and 256) on the GPU in fp32
    (cuDNN's convolutions and LSTM, cuFFT) against the same step on the
    CPU in float64, from equal states, with the same batch and posterior
    noise: the metrics, the gradients per leaf before Adam at
    ``SV_GRAD_TOL`` (the CPU's own fp32 step printed beside), and a
    planted 1% fault on ``SV_FAULT_LEAF`` that must be caught."""
    cfg = AudioGANConfig(mel_windows=(5, 7), stft_windows=(7, 8), n_fft=256,
                         disc_start=0, lr=1e-3)
    trainer = SoundVAETrainer(cfg, SoundVAEConfig(channels=4, z_channels=8,
                                                  enc_out_channels=16))
    rng = np.random.default_rng(11)
    wav = torch.as_tensor(0.1 * rng.standard_normal((2, 8192, 1)),
                          dtype=FP32)
    noise = torch.as_tensor(rng.standard_normal((2, 256, 8)), dtype=FP32)
    grads, metrics = {}, {}
    for run, device, dtype in (("gpu", "cuda", FP32), ("cpu", "cpu", FP32),
                               ("cpu64", "cpu", torch.float64)):
        state = trainer.init_train_state(0, device)
        state.vae.to(dtype)
        state.disc.to(dtype)
        m = trainer.train_step(state, wav.to(device, dtype),
                               noise=noise.to(device, dtype))
        metrics[run] = {k: float(v) for k, v in m.items()}
        grads[run] = {f"{part}.{k}": p.grad.detach().cpu()
                      for part, mod in (("vae", state.vae),
                                        ("disc", state.disc))
                      for k, p in mod.named_parameters()
                      if p.grad is not None}
    worst = max(abs(metrics["gpu"][k] - ref) / max(abs(ref), 1e-3)
                for k, ref in metrics["cpu64"].items())
    zero = noise_gradients(grads["cpu64"])
    grad_worst = gradient_agreement(grads["gpu"], grads["cpu64"], zero,
                                    *SV_GRAD_TOL)
    cpu_worst = gradient_agreement(grads["cpu"], grads["cpu64"], zero,
                                   1.0, 1.0)
    faulty = dict(grads["gpu"])
    faulty[SV_FAULT_LEAF] = faulty[SV_FAULT_LEAF] * 1.01
    try:
        gradient_agreement(faulty, grads["cpu64"], zero, *SV_GRAD_TOL)
        caught = False
    except AssertionError:
        caught = True
    log(f"agreement tiny train_sound_vae gpu fp32 vs cpu float64, one step "
        f"from equal states: metrics worst relative Δ {worst:.3e} (tol "
        f"1e-4); gradients per leaf, worst (max|Δ|, rms(Δ)) / rms(ref) "
        f"{list(grad_worst)} (limits {list(SV_GRAD_TOL)}; the CPU's fp32 "
        f"step {list(cpu_worst)}) over {len(grads['cpu64'])} leaves; "
        f"planted fault ({SV_FAULT_LEAF} ×1.01) caught {caught}; metrics "
        f"{json.dumps(metrics['cpu64'])}")
    if not worst <= 1e-4:
        raise AssertionError("GPU waveform VAE metrics disagree with the "
                             "CPU's")
    if not caught:
        raise AssertionError("the waveform VAE agreement passes the planted "
                             "fault")


def _rms(t: torch.Tensor) -> float:
    return float(t.double().square().mean().sqrt())


def noise_gradients(grads: dict) -> set:
    """The biases whose gradient is analytically zero, picked out on the
    reference gradients: rms below 1e-4 of the sibling weight's. A bias in
    front of a GroupNorm whose groups hold one channel (every norm of a
    ch 32 VAE) is removed with the group's mean, and the softmax does not
    see the k projection's bias: in fp32 such a gradient is rounding noise,
    1e-6 of the weight's or less, where every other bias has 1e-2 or more."""
    return {k for k, g in grads.items()
            if k.endswith(".bias") and f"{k[:-5]}.weight" in grads
            and _rms(g) <= 1e-4 * _rms(grads[f"{k[:-5]}.weight"]) > 0.0}


def gradient_agreement(out: dict, ref: dict, noise: set, max_tol: float,
                       rms_tol: float):
    """The gradients of one train step, leaf by leaf as the kernel phase
    holds a kernel: max|Δ| ≤ max_tol·rms(ref) and rms(Δ) ≤ rms_tol·rms(ref).
    A leaf in ``noise`` must be noise here too (under 1e-4 of its weight's
    gradient). Returns the worst (max ratio, rms ratio, leaf)."""
    worst = (0.0, 0.0, "")
    for k, r in ref.items():
        o, r = out[k].double().cpu(), r.double().cpu()
        if k in noise:
            if _rms(o) > 1e-4 * _rms(out[f"{k[:-5]}.weight"]):
                raise AssertionError(f"{k}: a zero gradient came out as "
                                     f"rms {_rms(o)}")
            continue
        rms = _rms(r)
        if rms == 0.0:   # the discriminator while its loss is gated off
            if _rms(o) != 0.0:
                raise AssertionError(f"{k}: gradient of a gated loss")
            continue
        ratios = (float((o - r).abs().max()) / rms, _rms(o - r) / rms)
        if ratios[0] > max_tol or ratios[1] > rms_tol:
            raise AssertionError(f"{k}: gradient off by max {ratios[0]:.3e} "
                                 f"rms {ratios[1]:.3e} of rms(ref)")
        worst = max(worst, (*ratios, k))
    return worst


def leaf_agreement(out: dict, ref: dict, noise: set, lr: float, steps: int,
                   tol: float):
    """Updated leaves of two runs of the same train steps, element by
    element against tol·max(1, max|ref|). Adam's first step is
    lr·g/(|g| + ε), nearly lr·sign(g): an element whose gradient lies
    within rounding of zero steps either way on either device, and the two
    then differ by up to 2·lr a step, which bounds every leaf. The leaves
    in ``noise`` are held to that bound only. In any other leaf at most
    2 + 2·numel/10³ elements may be off (a wrong gradient would move most
    of a leaf; runs on an H100 gave at most 5 of a leaf of 9216 and 3 to
    66 of all 3.1 million). Returns (elements off, elements compared,
    rms(Δ) over them against steps·lr, the leaf nearest its limit)."""
    off_all, total, sq, nearest = 0, 0, 0.0, (0.0, "")
    for k, r in ref.items():
        o, r = out[k].float().cpu(), r.float().cpu()
        delta = (o - r).abs() / max(1.0, float(r.abs().max()))
        if float(delta.max()) > 2 * steps * lr * 1.01:
            raise AssertionError(f"{k}: max|Δ| {float(delta.max())}")
        if k in noise:
            continue
        off = int((delta > tol).sum())
        limit = 2 + 2e-3 * delta.numel()
        if off > limit:
            raise AssertionError(f"{k}: {off} of {delta.numel()} elements off")
        nearest = max(nearest, (off / limit, f"{k}: {off} of {delta.numel()}"))
        off_all, total = off_all + off, total + delta.numel()
        sq += float(delta.square().sum())
    return off_all, total, (sq / total) ** 0.5 / (steps * lr), nearest[1]


# Gradients of the tiny train step, GPU against CPU, per leaf against
# rms(CPU): (max|Δ|, rms(Δ)). Five runs on an H100 reached 1.05e-4 and
# 2.9e-5, at the first step (equal parameters) and the second alike; a
# gradient wrong by 1% of a leaf is a hundred times the rms limit.
GRAD_TOL = (5e-4, 1e-4)
# The planted fault of the train agreement: this leaf's GPU gradient 1% off
# (the leaf a kink of the discriminator moved most).
FAULT_LEAF = "vae.encoder.conv_in.weight"

# A leaky_relu input within KINK_MARGIN·rms(input) of zero lies within the
# rounding of its own computation: the two devices sum the convolutions in
# front of it (fan-in up to 4·4·256 = 4096 in the discriminator) in other
# orders, in fp32, from a reconstruction that already differs by the
# rounding of the whole VAE. The largest gap between the devices' inputs
# (``KinkSides.gap``, printed each run) read ~2.5e-5 of rms on an H100;
# the margin, 2⁻¹² ≈ 2.4e-4, is ten times that. Where the input is that
# close to zero the two devices may take different branches, with slopes
# 1 and 0.2, and the adaptive weight (~500) carries the difference into
# the generator's gradient. A wider margin does not hide a fault: it only
# lets the CPU take the GPU's branch where both inputs are near zero, and
# the values that differ still reach the gradients that are compared.
KINK_MARGIN = 2.0**-12


def kinked_leaky_relu(x, slope: float, positive):
    """F.leaky_relu(x, slope) on the given branches: x where ``positive``,
    slope·x elsewhere; its gradient is 1 or slope to match. With
    ``positive = x > 0`` it is F.leaky_relu, value and gradient."""
    return torch.where(positive, x, x * slope)


class KinkSides(torch.overrides.TorchFunctionMode):
    """``F.leaky_relu`` under this mode, in call order: recorded (each
    input, detached, kept on the CPU), or, given the record of the same
    calls on another device, replayed so that every input within
    ``KINK_MARGIN``·rms(input) of zero takes the recorded input's branch
    (``kinked_leaky_relu``); every other element takes its own, as in
    F.leaky_relu. ``flips`` counts the elements whose branch the record
    changed; ``gap`` is the largest |input − recorded| over the calls in
    units of the input's rms, the rounding the margin has to cover."""

    def __init__(self, recorded=None):
        super().__init__()
        self.recorded, self.inputs = recorded, []
        self.flips, self.gap = 0, 0.0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not F.leaky_relu:
            return func(*args, **kwargs)
        x = args[0]
        slope = args[1] if len(args) > 1 else kwargs.get("negative_slope",
                                                         0.01)
        if kwargs.get("inplace") or len(args) > 2:
            raise ValueError("KinkSides takes no in-place leaky_relu")
        if self.recorded is None:
            self.inputs.append(x.detach().to("cpu", copy=True))
            return func(*args, **kwargs)
        ref = self.recorded[len(self.inputs)].to(x.device)
        self.inputs.append(ref)
        if ref.shape != x.shape:
            raise AssertionError(f"leaky_relu call {len(self.inputs)}: "
                                 f"{tuple(x.shape)} against the record's "
                                 f"{tuple(ref.shape)}")
        with torch.no_grad():
            rms = x.double().square().mean().sqrt()
            near = x.abs() <= KINK_MARGIN * rms
            own, theirs = x > 0, ref > 0
            self.flips += int((near & (own != theirs)).sum())
            self.gap = max(self.gap, float((x - ref).abs().max() / rms))
        return kinked_leaky_relu(x, slope, torch.where(near, theirs, own))


def agreement_train_phase():
    """Two fp32 train steps of a tiny VAE (ch 32: the D 32 instance of the
    per-head kernels, 8·17 = 136 tokens, ragged against their tiles) and
    the discriminator on the GPU (kernels) against the same steps on the
    CPU (plain versions): shared initial state, batch and posterior noise;
    the GAN term gated off in the first step and on in the second.
    ``logvar_init`` 4 keeps the adaptive weight under its clip, so that the
    value of the two gradient probes is what the metrics compare. Held:
    the metrics, each step's gradients of both models before Adam sees
    them, and the updated leaves after each step.

    The comparison holds one function on both sides: each step starts from
    equal states (the GPU takes the CPU's parameters, Adam moments and
    BatchNorm statistics after the step before), and the GPU runs first,
    recording its leaky_relu inputs; the CPU then takes the GPU's branch
    wherever its input lies within rounding of zero (``KinkSides``). A
    planted fault, ``FAULT_LEAF``'s GPU gradient scaled by 1.01, must fail
    the gradient check at every step."""
    lr, steps = 1e-4, 2
    trainer = VAETrainer(
        VAEConfig(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1),
        VAETrainConfig(lr=lr, loss=VAELossConfig(disc_start=1,
                                                 logvar_init=4.0)))
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.uniform(size=(2, 64, 136, 3)), dtype=torch.float32)
    noise = torch.as_tensor(rng.standard_normal((steps, 2, 8, 17, 4)),
                            dtype=torch.float32)
    named = lambda state, what: {
        f"{m}.{k}": v.detach().clone()
        for m, module in (("vae", state.vae), ("disc", state.disc))
        for k, v in what(module)}
    devices = ("cuda", "cpu")
    states = {d: trainer.init_train_state(3, d) for d in devices}
    metrics, grads, leaves = ({d: [] for d in devices} for _ in range(3))
    kinks = []
    reset_counts()
    for i in range(steps):
        if i:
            states["cuda"].load_state_dict(
                copy.deepcopy(states["cpu"].state_dict()))
        record = KinkSides()
        replay = KinkSides(record.inputs)
        for device, mode in (("cuda", record), ("cpu", replay)):
            state = states[device]
            with mode:
                m = trainer.train_step(state, x.to(device),
                                       noise=noise[i].to(device))
            metrics[device].append({k: float(v) for k, v in m.items()})
            grads[device].append(named(state, lambda module: (
                (k, p.grad) for k, p in module.named_parameters())))
            leaves[device].append(named(
                state, lambda module: module.state_dict().items()))
        if len(replay.inputs) != len(record.inputs):
            raise AssertionError(f"leaky_relu calls: cpu {len(replay.inputs)}"
                                 f", gpu {len(record.inputs)}")
        kinks.append({"calls": len(record.inputs), "flipped": replay.flips,
                      "max_gap_of_rms": replay.gap})
    if not (ha.LAUNCHES["attn_bwd"] == 2 * steps
            and ha.LAUNCHES["attn_fwd"] == 2 * steps):
        raise AssertionError(f"tiny train step launches {ha.LAUNCHES}")
    worst = 0.0
    for cpu, gpu in zip(metrics["cpu"], metrics["cuda"]):
        for k, ref in cpu.items():
            worst = max(worst, abs(gpu[k] - ref) / max(abs(ref), 1e-3))
    # the discriminator's first gradient is the second step's
    zero = set().union(*(noise_gradients(g) for g in grads["cpu"]))
    grad_worst = [gradient_agreement(grads["cuda"][i], grads["cpu"][i], zero,
                                     *GRAD_TOL) for i in range(steps)]
    fault_caught = []
    for i in range(steps):
        faulty = dict(grads["cuda"][i])
        faulty[FAULT_LEAF] = faulty[FAULT_LEAF] * 1.01
        try:
            gradient_agreement(faulty, grads["cpu"][i], zero, *GRAD_TOL)
            fault_caught.append(False)
        except AssertionError:
            fault_caught.append(True)
    leaf = [leaf_agreement(leaves["cuda"][i], leaves["cpu"][i], zero, lr,
                           i + 1, 2e-5) for i in range(steps)]
    log(f"agreement tiny fp32 train_vae gpu-vs-cpu, {steps} steps from equal "
        f"states: metrics worst relative Δ {worst:.3e} (tol 1e-3); kinks by "
        f"step (leaky_relu calls, inputs within {KINK_MARGIN:.3g}·rms of zero "
        f"whose branch the cpu took from the gpu, largest |Δ input| of rms) "
        f"{json.dumps(kinks)}; gradients per leaf, worst (max|Δ|, rms(Δ)) / "
        f"rms(cpu) by step {json.dumps([list(w) for w in grad_worst])} "
        f"(limits {list(GRAD_TOL)}); planted fault ({FAULT_LEAF} ×1.01) "
        f"caught by step {fault_caught}; {len(zero)} biases with zero "
        f"gradients are noise on both; updated leaves by step (elements "
        f"beyond 2e-5·max(1, max|ref|) of those compared, limit 2 + 2 in 10³ "
        f"of a leaf; rms(Δ) of the steps' size; nearest its limit) "
        f"{json.dumps([list(r) for r in leaf])}; cpu metrics "
        f"{json.dumps(metrics['cpu'])}")
    if not worst <= 1e-3:
        raise AssertionError("GPU train step metrics disagree with the CPU's")
    if not all(fault_caught):
        raise AssertionError(f"the train agreement passes the planted fault "
                             f"{FAULT_LEAF} ×1.01: {fault_caught}")
    return kinks


def agreement_phase():
    """Tiny float32 pipelines, generate, inpaint and the video entry
    (``DiffFoley.extract_features`` then ``generate_from_features``): GPU
    (kernels) against CPU (plain versions). Head dims 40 and 80 in the
    UNet, 32 in the classifier and the VAE (ch 32): the kernels take the
    path's head dims only. The VAE's full-resolution norms stream in
    fp32."""
    ucfg = UNetConfig(model_channels=160, num_res_blocks=1,
                      channel_mult=(1, 2), attention_resolutions=(1, 2),
                      num_heads=4, context_dim=64)
    ccfg = UNetConfig(out_channels=1, model_channels=32, num_res_blocks=1,
                      channel_mult=(1, 2), attention_resolutions=(2,),
                      num_heads=2, context_dim=512)
    ldm = randomize_(LatentDiffusion(LDMConfig(
        unet=ucfg, vae=VAEConfig(ch=32, ch_mult=(1, 1, 1, 1),
                                 num_res_blocks=1), cond_embed_dim=64)), 3)
    clf = randomize_(ClassifierBackbone(ccfg), 4)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((WINDOW_FEATS, 512)).astype(np.float32)
    x_T = torch.as_tensor(rng.standard_normal((2, *LATENT_HW, 4)),
                          dtype=torch.float32)
    phase = torch.as_tensor(rng.uniform(size=(2, 513, 512)),
                            dtype=torch.float32)
    known = rng.uniform(0.2, 0.8, size=SPEC_HW).astype(np.float32)
    mask = continuation_mask(SPEC_HW[1], KEEP_FRAMES)
    mask_noise = torch.as_tensor(rng.standard_normal((4, 2, *LATENT_HW, 4)),
                                 dtype=torch.float32)
    gen = GenerationConfig(steps=3, sample_num=2, gl_iters=4)
    gen_in = dataclasses.replace(gen, sampler="ddim", steps=4)
    outs = {}
    for device in ("cpu", "cuda"):
        pipe = DiffFoleyPipeline(copy.deepcopy(ldm), copy.deepcopy(clf),
                                 device=device)
        outs[("generate", device)] = pipe.generate(
            feats, gen=gen, x_T=x_T.to(device), gl_phase=phase.to(device))
        outs[("inpaint", device)] = pipe.inpaint(
            feats, known, mask, gen=gen_in, x_T=x_T.to(device),
            mask_noise=mask_noise.to(device), gl_phase=phase.to(device))
    # the video entry, tiny: CAVP features of a small clip (seeded frames
    # without cv2), then generate_from_features with the same noise
    tiny_cavp = randomize_(CAVPModel(CAVPConfig(
        video_stage_blocks=(1, 1, 1, 1), video_base_channels=8,
        spec_channels=(8, 8, 16, 16, 32, 32))), 6)
    with tempfile.TemporaryDirectory() as tmp:
        clip = (write_clip(os.path.join(tmp, "tiny.avi"), size=48)
                if have_cv2() else None)
        feats_by = {}
        for device in ("cpu", "cuda"):
            df = DiffFoley(copy.deepcopy(ldm), copy.deepcopy(tiny_cavp),
                           copy.deepcopy(clf), bf16=False, frame_size=32,
                           device=device)
            f = (df.extract_features(clip, 0.0, 8.2) if clip else
                 encode_frames(seeded_frames()[:, ::7, ::7], df.cavp,
                               device=device))
            feats_by[device] = f
            outs[("video", device)] = df.generate_from_features(
                f, gen=gen, x_T=x_T.to(device), gl_phase=phase.to(device))
    d_feat = float(np.abs(feats_by["cpu"] - feats_by["cuda"]).max()
                   / np.sqrt(np.square(feats_by["cpu"]).mean()))
    log(f"agreement tiny fp32 DiffFoley.extract_features gpu-vs-cpu "
        f"{feats_by['cpu'].shape} max|Δ| {d_feat:.3e} of rms (tol 1e-4)")
    if not d_feat <= 1e-4:
        raise AssertionError("GPU CAVP features disagree with the CPU's")
    for run in ("generate", "inpaint", "video"):
        cpu, gpu = outs[(run, "cpu")], outs[(run, "cuda")]
        d_spec = float(np.abs(cpu["spec"] - gpu["spec"]).max())
        d_wav = float(np.abs(cpu["wav"] - gpu["wav"]).max())
        wav_scale = float(np.abs(cpu["wav"]).max())
        log(f"agreement tiny fp32 {run} gpu-vs-cpu spec max|Δ| {d_spec:.3e} "
            f"(tol 1e-3) wav max|Δ| {d_wav:.3e} of |wav| {wav_scale:.3e} "
            f"(tol 1e-2·|wav|)")
        if not d_spec <= 1e-3 or not d_wav <= 1e-2 * max(wav_scale, 1e-6):
            raise AssertionError(f"GPU {run} disagrees with the CPU's")


# the tiny sampler agreement: latents max|Δ| against max(1, max|x_cpu|),
# about five times the largest reading on an H100 (5.9e-6, DDIM with
# noise dropout): a fault of order 1e-4 in the latents fails it
SAMPLER_AGREE_TOL = 3e-5
SAMPLER_AGREE_CALLS = (
    ("dpm-multistep-order3", "dpm", 6, dict(order=3)),
    ("dpm-singlestep-order3", "dpm", 6, dict(method="singlestep", order=3,
                                             skip_type="logSNR")),
    ("dpm-adaptive-order2", "dpm", 0, dict(method="adaptive", order=2)),
    ("ddim-eta1-dropout", "ddim", 6, dict(eta=1.0, noise_dropout=0.1)),
    ("plms", "plms", 6, {}),
    ("p_sample_loop", "ancestral", 0, dict(timesteps=20)),
)


def agreement_sampler_phase():
    """One call of each sampler family and the tiled pair, tiny fp32 on
    the GPU (kernels) against the CPU (plain versions): agreement_phase's
    tiny models, CFG 4.5 and classifier guidance 50, shared x_T and step
    draws (noise and dropout keep masks made on the CPU and handed to
    both); the adaptive solver must take the same model calls."""
    ucfg = UNetConfig(model_channels=160, num_res_blocks=1,
                      channel_mult=(1, 2), attention_resolutions=(1, 2),
                      num_heads=4, context_dim=64)
    ccfg = UNetConfig(out_channels=1, model_channels=32, num_res_blocks=1,
                      channel_mult=(1, 2), attention_resolutions=(2,),
                      num_heads=2, context_dim=512)
    ldm = randomize_(LatentDiffusion(LDMConfig(
        unet=ucfg, vae=VAEConfig(ch=32, ch_mult=(1, 1, 1, 1),
                                 num_res_blocks=1), cond_embed_dim=64)), 3)
    clf = randomize_(ClassifierBackbone(ccfg), 4)
    rng = np.random.default_rng(11)
    b = 2
    feat = torch.as_tensor(rng.standard_normal((b, WINDOW_FEATS, 512)),
                           dtype=torch.float32)
    x_T = torch.as_tensor(rng.standard_normal((b, *LATENT_HW, 4)),
                          dtype=torch.float32)
    n_draws = 20
    draws = {"noise": torch.as_tensor(rng.standard_normal(
        (n_draws, b, *LATENT_HW, 4)), dtype=torch.float32),
        "keep": torch.as_tensor(rng.uniform(size=(n_draws, b, *LATENT_HW,
                                                  4)) < 0.9)}
    canvas = torch.as_tensor(rng.standard_normal((1, *TILED_CANVAS, 4)),
                             dtype=torch.float32)
    t_model = torch.tensor([500.0])
    outs = {}
    for device in ("cpu", "cuda"):
        m = copy.deepcopy(ldm).to(device).eval()
        c = copy.deepcopy(clf).to(device).eval()
        f = feat.to(device)
        for name, sampler, steps, opts in SAMPLER_AGREE_CALLS:
            stats = {}
            kw = dict(opts)
            if sampler == "dpm":
                kw["stats"] = stats
            if sampler in ("ddim", "ancestral"):
                kw["draws"] = {k: v.to(device) for k, v in draws.items()}
            with torch.no_grad():
                out = m.sample(f, sampler=sampler, steps=steps,
                               x_T=x_T.to(device), classifier=c,
                               cfg_scale=4.5, classifier_scale=50.0, **kw)
            outs[(name, device)] = (out.cpu(), stats.get("nfe"))
        with torch.no_grad():
            z = canvas.to(device)
            ctx = m.get_learned_conditioning(f[:1])
            outs[("decode_first_stage_tiled", device)] = (
                m.decode_first_stage_tiled(z, SplitInputParams()).cpu(),
                None)
            outs[("apply_model_tiled", device)] = (m.apply_model_tiled(
                z, t_model.to(device), ctx,
                SplitInputParams(ks=(16, 64), stride=(16, 32))).cpu(), None)
    names = [c[0] for c in SAMPLER_AGREE_CALLS] + [
        "decode_first_stage_tiled", "apply_model_tiled"]
    report = {}
    for name in names:
        (cpu, nfe_c), (gpu, nfe_g) = outs[(name, "cpu")], outs[(name,
                                                                "cuda")]
        scale = max(1.0, float(cpu.abs().max()))
        ratio = float((gpu - cpu).abs().max()) / scale
        report[name] = {"max_abs_delta_of_scale": ratio, "nfe_cpu": nfe_c,
                        "nfe_gpu": nfe_g}
        log(f"agreement tiny fp32 samplers {name} gpu-vs-cpu max|Δ| "
            f"{ratio:.3e} of max(1, max|x|) (tol {SAMPLER_AGREE_TOL:g})"
            + (f", model calls {nfe_g} on the GPU, {nfe_c} on the CPU"
               if nfe_c is not None else ""))
        if not ratio <= SAMPLER_AGREE_TOL or nfe_c != nfe_g:
            raise AssertionError(f"GPU {name} disagrees with the CPU's")
    return report


def train_agreement_runs(runs: int, card: str) -> int:
    """``agreement_train_phase`` ``runs`` times in one process: each run's
    flipped kinks by step, and failures / runs. Exits non-zero if any run
    failed."""
    failures, flips = [], []
    for i in range(runs):
        try:
            flips.append([k["flipped"] for k in agreement_train_phase()])
        except AssertionError as e:
            failures.append({"run": i, "error": str(e)[:300]})
            log(f"train agreement run {i} failed: {e}")
    log(card)
    print(json.dumps({"train_agreement": {
        "runs": runs, "failures": len(failures), "failed": failures,
        "flipped_by_step": flips,
        "device": torch.cuda.get_device_name(0)}}))
    return 1 if failures else 0


# ---- parallelism: a real NCCL group at world size 1 ---------------------------

# the --fsdp run of the stage-2 CLI: the main-path call's first steps
P_STEPS = 2
# the meshed modules at world size 1 against their unmeshed selves: every
# collective is a copy, so max|Δ| ≤ P_TOL·rms of each tensor (relative for
# a metric); the phase runs cuDNN's deterministic algorithms. The
# TP-wrapped stage-2 step (``tensor_parallel_`` on the UNet over the
# model group of one rank) adds each row-parallel layer's bias after its
# product (the partial products' sum comes first): fp32 rounding, held
# as the agreement phases hold a step's gradients (GRAD_TOL)
P_TOL = 1e-6


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def held_equal(what: str, got, ref, tol: float = P_TOL) -> dict:
    """``got`` against ``ref`` (dicts of tensors, arrays or floats): the
    worst max|Δ| over rms(ref) (relative for floats), and whether every
    entry is equal bit for bit; raises past ``tol``."""
    if not isinstance(ref, dict):
        got, ref = {"": got}, {"": ref}
    if set(got) != set(ref):
        raise AssertionError(f"{what}: entries {set(got) ^ set(ref)}")
    worst, bitwise = 0.0, True
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, float):
            d, size = abs(g - r), max(abs(r), 1e-30)
            bitwise &= g == r
        else:
            g, r = (torch.as_tensor(np.asarray(x) if not isinstance(
                x, torch.Tensor) else x).detach().double().cpu()
                for x in (g, r))
            d = float((g - r).abs().max()) if r.numel() else 0.0
            size = max(float(r.square().mean().sqrt()), 1e-30)
            bitwise &= bool(torch.equal(g, r))
        worst = max(worst, d / size)
    log(f"parallel {what}: worst max|Δ|/rms {worst:.3e} (limit {tol}), "
        f"bit for bit {bitwise}")
    if not worst <= tol:
        raise AssertionError(f"parallel {what} differs from its unmeshed "
                             f"counterpart: {worst:.3e}")
    return {"worst": worst, "bitwise": bitwise}


def s2_fsdp_launches(expect: dict) -> dict:
    """The stage-2 main-path call's prediction scaled to P_STEPS steps and
    no validation: the packed backward launches per step, every other
    kernel per forward."""
    out = {}
    for k, n in expect.items():
        per = S2_STEPS if k.startswith("attn_packed_bwd") else S2_FORWARDS
        if n % per:
            raise AssertionError(f"{k}: {n} launches over {per}")
        out[k] = n // per * P_STEPS
    return out


def s2_short_call(root: str, extra: list) -> dict:
    """``cli.train_stage2`` at the main-path call's full width, data,
    seeds and arguments for P_STEPS steps (no validation) into a logdir
    of its own: the launches, the train rows, the call's seconds and peak
    memory, the returned state."""
    data = os.path.join(root, "s2-data")
    logdir = os.path.join(root, "s2-short" + "".join(extra))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_stage2_cli.main(s2_args(data, logdir) + [
        "--max-steps", str(P_STEPS)] + extra)
    torch.cuda.synchronize()
    out = {"call_s": time.perf_counter() - t0, "launches": read_counts(),
           "peak": torch.cuda.max_memory_allocated() / 2**30,
           "rows": [json.loads(line) for line in open(os.path.join(
               logdir, "metrics.jsonl"))], "logdir": logdir,
           "state": state}
    log(f"parallel train_stage2 {' '.join(extra)} {P_STEPS} steps: "
        f"{out['call_s']:.3f} s, peak_mem_GiB {out['peak']:.3f}, metrics "
        + json.dumps(out["rows"]))
    return out


def parallel_stage2_phase(expect: dict, root: str, unsplit: dict,
                          card: str) -> dict:
    """``cli.train_stage2 --fsdp`` at the main-path call's full width,
    data, seeds and arguments, P_STEPS steps, in the NCCL group of one
    rank: its steps equal the unsplit short call's (and the main-path
    call's first steps), launches as predicted, its logdir loads through
    ``load_native_ldm``."""
    main_rows = [json.loads(line) for line in open(os.path.join(
        root, "s2", "metrics.jsonl"))]
    main_rows = [r for r in main_rows if "train/loss" in r][:P_STEPS]
    shutil.rmtree(unsplit.pop("logdir"))
    del unsplit["state"]
    torch.cuda.empty_cache()
    split = s2_short_call(root, ["--fsdp"])
    state, logdir, rows = split["state"], split["logdir"], split["rows"]
    check_launches("train_stage2 --fsdp", split["launches"],
                   s2_fsdp_launches(expect))
    if unsplit["launches"] != split["launches"]:
        raise AssertionError("the unsplit short call launched otherwise")
    keys = [k for k in rows[0] if k.startswith("train/")]
    diff, bitwise = {}, {}
    for name, ref in (("short", unsplit["rows"]), ("main", main_rows)):
        diff[name] = {k: max(abs(r[k] - u[k]) / max(abs(u[k]), 1e-30)
                             for r, u in zip(rows, ref)) for k in keys}
        bitwise[name] = all(r[k] == u[k] for r, u in zip(rows, ref)
                            for k in keys)
    log(f"parallel train_stage2 --fsdp steps 1–{P_STEPS} against the "
        f"unsplit calls' (short, main): bit for bit {json.dumps(bitwise)}, "
        f"relative Δ by metric {json.dumps(diff)}; warm step "
        f"{rows[-1]['step_s']:.4f} s against {unsplit['rows'][-1]['step_s']:.4f}"
        f" s unsplit; call {split['call_s']:.3f} s against "
        f"{unsplit['call_s']:.3f}; peak_mem_GiB {split['peak']:.3f} against "
        f"{unsplit['peak']:.3f} ({card})")
    if [r["step"] for r in rows] != list(range(1, P_STEPS + 1)) \
            or not max(max(d.values()) for d in diff.values()) <= 1e-4:
        raise AssertionError("train_stage2 --fsdp differs from the "
                             "unsplit run")
    loaded = load_native_ldm(logdir)
    key = "unet.in_conv.weight"
    if not torch.equal(loaded.state_dict()[key].cpu(),
                       state.ema.params[key].detach().cpu()):
        raise AssertionError("load_native_ldm of the --fsdp logdir is not "
                             "its EMA")
    del state, loaded, split["state"]
    shutil.rmtree(logdir)
    torch.cuda.empty_cache()
    return {"fsdp_call_s": split["call_s"], "fsdp_peak_mem_GiB": split["peak"],
            "fsdp_warm_step_s": rows[-1]["step_s"],
            "unsplit_call_s": unsplit["call_s"],
            "unsplit_peak_mem_GiB": unsplit["peak"],
            "unsplit_warm_step_s": unsplit["rows"][-1]["step_s"],
            "fsdp_bitwise": bitwise, "fsdp_max_rel_diff": diff}


def parallel_tiny_phase(mesh) -> dict:
    """Every other meshed module at tiny widths on CUDA tensors, its
    collectives through the NCCL group of one rank, against the same
    module unmeshed: the VAE step (PatchGAN BatchNorm), the classifier
    step, the CAVP step (gathered contrastive loss, cross-rank BatchNorm)
    and its accumulated step, a TP-wrapped stage-2 step, align-acc,
    ``generate`` and ``inpaint``, and one served batch through the
    announce/follow path, bit for bit against a meshed direct call."""
    out = {}
    cuda = lambda b: {k: v.to("cuda") for k, v in b.items()}
    rng = np.random.default_rng(40)
    vae_cfg = VAEConfig(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)

    # the VAE step
    x = torch.as_tensor(rng.uniform(size=(2, 64, 136, 3)), dtype=FP32)
    res = {}
    for name, m in (("one", None), ("mesh", mesh)):
        trainer = VAETrainer(vae_cfg, VAETrainConfig(
            lr=1e-4, loss=VAELossConfig(disc_start=0)), mesh=m)
        state = trainer.init_train_state(41, "cuda")
        metrics = trainer.train_step(
            state, x.cuda(), generator=torch.Generator("cuda").manual_seed(1))
        res[name] = {**{k: float(v) for k, v in metrics.items()},
                     **{f"vae.{k}": p.grad for k, p in
                        state.vae.named_parameters()},
                     **{f"disc.{k}": v for k, v in
                        state.disc.named_buffers()}}
    out["vae"] = held_equal("train_vae step", res["mesh"], res["one"])

    # the classifier step
    ccfg = UNetConfig(out_channels=1, model_channels=64, num_res_blocks=1,
                      channel_mult=(1, 2), attention_resolutions=(2,),
                      num_heads=4, context_dim=512)
    base = ClassifierTrainer(ccfg, AutoencoderKL(vae_cfg), cond_seq_len=40)
    randomize_(base.model, 42)
    randomize_(base.vae, 43)
    base_weights = base.model.state_dict()
    batch = {"spec": torch.as_tensor(rng.uniform(size=(2, 64, 128, 3)),
                                     dtype=FP32),
             "video_feat": torch.as_tensor(rng.standard_normal((2, 40, 512)),
                                           dtype=FP32),
             "labels": torch.tensor([1, 0])}
    res = {}
    for name, m in (("one", None), ("mesh", mesh)):
        trainer = ClassifierTrainer(ccfg, copy.deepcopy(base.vae),
                                    cond_seq_len=40, mesh=m)
        trainer.model.load_state_dict(base_weights)
        state = trainer.init_train_state(None, "cuda")
        metrics = trainer.train_step(
            state, cuda(batch), torch.Generator("cuda").manual_seed(2))
        res[name] = {**{k: float(v) for k, v in metrics.items()},
                     **{k: p.grad for k, p in state.params.items()}}
    out["classifier"] = held_equal("train_classifier step", res["mesh"],
                                   res["one"])

    # the CAVP step and its accumulated step
    cavp_cfg = CAVPConfig(video_stage_blocks=(1, 1, 1, 1),
                          video_base_channels=8,
                          spec_channels=(8, 8, 16, 16, 32, 32),
                          pool_kernel=4, axis_name="data")
    cavp = randomize_(CAVPModel(cavp_cfg), 44)
    clip = lambda lead: {
        "video": torch.as_tensor(rng.uniform(size=lead + (2, 4, 32, 32, 3)),
                                 dtype=FP32),
        "spec": torch.as_tensor(rng.uniform(size=lead + (2, 128, 64)),
                                dtype=FP32)}
    step_batch, micro = clip((2,)), clip((2, 2))
    res = {}
    # the towers' max-pool backwards accumulate with atomics on the card
    # (no deterministic kernel): the unmeshed step run twice gives the
    # card's own run-to-run difference, and the meshed step is held as
    # the agreement phases hold a step (GRAD_TOL) beside it
    for name, m in (("one", None), ("again", None), ("mesh", mesh)):
        trainer = Stage1Trainer(copy.deepcopy(cavp), Stage1TrainConfig(
            lr=1e-4, warmup_steps=0, clip_num=2), mesh=m)
        state = trainer.init_train_state(None, "cuda")
        gen = torch.Generator("cuda").manual_seed(3)
        m1 = trainer.train_step(state, cuda(step_batch), gen)
        g1 = {f"step.{k}": p.grad.clone() for k, p in state.params.items()}
        m2 = trainer.accum_train_step(state, cuda(micro), gen)
        res[name] = ({**{f"step.{k}": float(v) for k, v in m1.items()},
                      **{f"accum.{k}": float(v) for k, v in m2.items()}},
                     {**g1, **{f"accum.{k}": p.grad for k, p in
                               state.params.items()},
                      **{f"stats.{k}": v for k, v in
                         state.batch_stats.items()}})
    noise = noise_gradients(res["one"][1])
    control = gradient_agreement(res["again"][1], res["one"][1], noise,
                                 *GRAD_TOL)
    out["cavp"] = held_equal("train_cavp step and accumulated step metrics",
                             res["mesh"][0], res["one"][0], tol=1e-5)
    worst = gradient_agreement(res["mesh"][1], res["one"][1], noise,
                               *GRAD_TOL)
    log(f"parallel train_cavp: gradients and statistics per leaf, worst "
        f"(max|Δ|, rms(Δ)) / rms, meshed {list(worst)}, the unmeshed "
        f"step run again {list(control)} (limits {list(GRAD_TOL)})")
    out["cavp"].update(grad_worst=list(worst[:2]),
                       rerun_worst=list(control[:2]))

    # a TP-wrapped stage-2 step (the model axis of one rank)
    ucfg = UNetConfig(model_channels=160, num_res_blocks=1,
                      channel_mult=(1, 2), attention_resolutions=(1, 2),
                      num_heads=4, context_dim=64)
    ldm = randomize_(LatentDiffusion(LDMConfig(
        unet=ucfg, vae=vae_cfg, cond_embed_dim=64)), 45)
    batch = {"spec": torch.as_tensor(rng.uniform(size=(2, 64, 128, 3)),
                                     dtype=FP32),
             "video_feat": torch.as_tensor(rng.standard_normal((2, 8, 512)),
                                           dtype=FP32)}
    res = {}
    for name, m in (("one", None), ("mesh", mesh)):
        model = copy.deepcopy(ldm).to("cuda")
        if m is not None:   # at a model axis of 1 the trainer wraps nothing
            tensor_parallel_(model.unet, m, "unet.")
        trainer = Stage2Trainer(model, Stage2TrainConfig(
            base_lr=1e-4, warmup_steps=0, use_ema=True), mesh=m)
        state = trainer.init_train_state(None, "cuda")
        metrics = trainer.train_step(state, cuda(batch),
                                     torch.Generator("cuda").manual_seed(4))
        res[name] = ({k: float(v) for k, v in metrics.items()},
                     {k: p.grad for k, p in state.params.items()})
        if m is not None:
            wrapped = sum(isinstance(x, ColumnParallelDense)
                          for x in trainer.ldm.unet.modules())
    if not wrapped:
        raise AssertionError("the TP stage-2 step wrapped no layer")
    out["stage2_tp"] = held_equal("train_stage2 TP-wrapped step metrics",
                                  res["mesh"][0], res["one"][0], tol=1e-5)
    grad_worst = gradient_agreement(res["mesh"][1], res["one"][1],
                                    noise_gradients(res["one"][1]),
                                    *GRAD_TOL)
    log(f"parallel stage-2 TP: {wrapped} column-parallel layers; "
        f"gradients per leaf, worst (max|Δ|, rms(Δ)) / rms "
        f"{list(grad_worst)} (limits {list(GRAD_TOL)})")
    out["stage2_tp"]["grad_worst"] = list(grad_worst[:2])

    # align-acc: 5 rows in batches of 2 (the last ragged)
    clf = randomize_(AlignmentClassifier(ccfg, 40), 46)
    vae = randomize_(AutoencoderKL(vae_cfg), 47)
    rows = {"spec": rng.uniform(size=(5, 64, 128, 3)).astype(np.float32),
            "video_feat": rng.standard_normal((5, 40, 512)).astype(
                np.float32)}
    stream = lambda: ({k: v[i:i + 2] for k, v in rows.items()}
                      for i in range(0, 5, 2))
    acc = {name: alignment_accuracy(stream(), clf, vae, mesh=m,
                                    device="cuda")
           for name, m in (("one", None), ("mesh", mesh))}
    out["align_acc"] = held_equal("align_acc", acc["mesh"], acc["one"])

    # generate and inpaint, then one served batch
    pclf = randomize_(ClassifierBackbone(UNetConfig(
        out_channels=1, model_channels=32, num_res_blocks=1,
        channel_mult=(1, 2), attention_resolutions=(2,), num_heads=2,
        context_dim=512)), 48)
    feats = rng.standard_normal((WINDOW_FEATS + 3, 512)).astype(np.float32)
    known = rng.uniform(0.2, 0.8, size=SPEC_HW).astype(np.float32)
    gen = GenerationConfig(steps=3, sample_num=2, gl_iters=4)
    gen_in = dataclasses.replace(gen, sampler="ddim", steps=4)
    res, pipes = {}, {}
    for name, m in (("one", None), ("mesh", mesh)):
        pipes[name] = pipe = DiffFoleyPipeline(
            copy.deepcopy(ldm), copy.deepcopy(pclf), device="cuda", mesh=m)
        g = pipe.generate(feats, seed=5, gen=gen)
        i = pipe.inpaint(feats, known, continuation_mask(
            SPEC_HW[1], KEEP_FRAMES), seed=6, gen=gen_in)
        res[name] = {f"generate.{k}": v for k, v in g.items()} | {
            f"inpaint.{k}": v for k, v in i.items()}
    out["generate_inpaint"] = held_equal("generate and inpaint",
                                         res["mesh"], res["one"])
    serve_gen = GenerationConfig(steps=3, sample_num=1, gl_iters=4,
                                 return_spec=False, wav_dtype="int16")
    engine = BatchingEngine(pipes["mesh"], serve_gen, max_batch_windows=2,
                            max_wait_ms=1.0, seed=7)
    try:
        req = engine.enqueue(feats)
        if not req.event.wait(300) or req.error:
            raise AssertionError(f"served batch: {req.error}")
    finally:
        engine.stop()
    direct = pipes["mesh"].generate(feats, req.seed, serve_gen,
                                    bucket_windows=req.bucket)["wav"][0]
    if not np.array_equal(req.result, direct):
        raise AssertionError("the served batch differs from the meshed "
                             "direct generate")
    log(f"parallel serving: one request (bucket {req.bucket}, seed "
        f"{req.seed}) announced, served and replayed bit for bit")
    out["serve_bitwise"] = True
    return out


def parallel_phase(expect: dict, root: str, card: str) -> dict:
    """The unsplit stage-2 call of P_STEPS steps (no group), then a real
    NCCL group at world size 1 (torchrun's environment for rank 0 of 1;
    it must form, there is no other backend to fall to), and
    ``parallel_stage2_phase`` and ``parallel_tiny_phase`` in it; the
    group is destroyed and the environment restored at the end."""
    unsplit = s2_short_call(root, [])
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    deterministic = torch.backends.cudnn.deterministic
    try:
        t0 = time.perf_counter()
        info = init_distributed()
        log(f"parallel group: backend {dist.get_backend()}, world size "
            f"{dist.get_world_size()}, NCCL {torch.cuda.nccl.version()}, "
            f"{json.dumps({k: str(v) for k, v in info.items()})}, "
            f"{time.perf_counter() - t0:.3f} s")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError("no NCCL group of one rank")
        out = parallel_stage2_phase(expect, root, unsplit, card)
        torch.backends.cudnn.deterministic = True
        t0 = time.perf_counter()
        out.update(parallel_tiny_phase(make_mesh()))
        out["tiny_s"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def main(argv):
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = cuda_build.build()
    log(f"build {time.perf_counter() - t0:.3f} s "
        + json.dumps({k: round(v["seconds"], 3) for k, v in report.items()}))
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if any(w in line for w in ("Compiling", "registers", "spill")):
                log(f"ptxas {name}: {line.strip()}")
    for name, counts in sass_hmma().items():
        log(f"sass HMMA {name} " + json.dumps(
            {f: n for f, n in counts.items() if n}))
    log("sass gn_stream_apply_kernel " + json.dumps(sass_apply()))
    if "--train-agreement" in argv:
        return train_agreement_runs(
            int(argv[argv.index("--train-agreement") + 1]), card)

    t0 = time.perf_counter()
    pipe = build_flagship()
    torch.cuda.synchronize()
    log(f"pipeline build+random weights {time.perf_counter() - t0:.3f} s")
    expect = predicted_launches(pipe, STEPS)
    feats = np.random.default_rng(0).standard_normal(
        (WINDOWS * WINDOW_FEATS, 512)).astype(np.float32)
    profile = "--profile" in argv
    # first: late in a long run torch.profiler loses device events
    t0 = time.perf_counter()
    rows = kernel_phase(pipe, unit_sums())
    log(f"kernel phase {time.perf_counter() - t0:.3f} s; torch.profiler "
        f"traces taken again {len(PROFILER_RETRIES)}, device times from "
        f"CUDA events {len(DEVICE_MS_FALLBACKS)} {DEVICE_MS_FALLBACKS}")
    torch.cuda.empty_cache()
    launches = {}
    launches["generate"], times, spec = generate_phase(
        pipe, feats, expect["generate"], profile)
    log("generate times " + json.dumps(times))
    with tempfile.TemporaryDirectory() as tmp:
        log("transform_spec times " + json.dumps(
            transform_spec_phase(spec, tmp)))
    launches["inpaint"], times = inpaint_phase(
        pipe, feats, spec, expect["inpaint"], profile)
    log("inpaint times " + json.dumps(times))
    with tempfile.TemporaryDirectory() as tmp:
        launches["video"], times = video_phase(pipe, expect["video"], tmp,
                                               profile)
        log("video times " + json.dumps(times))
        # serving's /generate_video reads the video phase's clip
        launches["serve"], times = serve_phase(
            pipe, expect["serve"], os.path.join(tmp, "clip.avi"), card,
            profile)
        t0 = time.perf_counter()
        launches["samplers"], sp, _ = sampler_phase(
            pipe, feats, spec,
            os.path.join(tmp, "clip.avi") if have_cv2() else None)
        log(f"samplers phase {time.perf_counter() - t0:.3f} s units "
            + json.dumps(sp))
    # the kernel rows' credit of the sampler phase, from its units
    resolve_units(rows, sp)
    launches["train_vae"], times = train_phase(
        pipe, expect["train_vae"], profile)
    log("train_vae times " + json.dumps(times))
    del pipe
    torch.cuda.empty_cache()
    launches["train_sound_vae"], times = train_sound_vae_phase(
        expect["train_sound_vae"])
    log("train_sound_vae times " + json.dumps(times))
    torch.cuda.empty_cache()
    # the trainers' logdirs live until the composition phase reads them
    with tempfile.TemporaryDirectory() as root:
        launches["train_stage2"], times, ldm_logdir = train_stage2_phase(
            expect, profile, root)
        launches["sound_log"] = times.pop("sound_log_launches")
        log("train_stage2 times " + json.dumps(times))
        launches["train_classifier"], times, clf_logdir = \
            train_classifier_phase(expect["train_classifier"], root, profile)
        log("train_classifier times " + json.dumps(times))
        launches["align_acc"], times = align_acc_phase(expect["align_acc"],
                                                       clf_logdir, root)
        log("align_acc times " + json.dumps(times))
        times, cavp_logdir = train_cavp_phase(root)
        log("train_cavp times " + json.dumps(times))
        clip = write_clip(os.path.join(root, "clip.avi"))
        log("extract_features times " + json.dumps(
            extract_features_phase(clip, cavp_logdir, root)))
        log("from_native_checkpoints times " + json.dumps(
            native_compose_phase(clip, ldm_logdir, cavp_logdir, clf_logdir)))
        t0 = time.perf_counter()
        times = cavp_towers_phase(root, clip)
        times["phase_s"] = time.perf_counter() - t0
        log("cavp_towers times " + json.dumps(times))
        t0 = time.perf_counter()
        launches["decode"], times = stage2_decode_phase(cavp_logdir,
                                                        expect["decode"])
        times["phase_s"] = time.perf_counter() - t0
        log("stage2_decode times " + json.dumps(times))
        for run, phase in (("audio_unet", audio_unet_phase),
                           ("prior", prior_phase),
                           ("encoder_unet", encoder_unet_phase),
                           ("other_cond", other_cond_phase),
                           ("first_stages", first_stages_phase),
                           ("profile", profile_phase),
                           ("scan", lambda e: scan_phase(e, root)),
                           ("dropout_remat", dropout_remat_phase)):
            t0 = time.perf_counter()
            launches[run], times = phase(expect[run])
            times["phase_s"] = time.perf_counter() - t0
            log(f"{run} times " + json.dumps(times))
            torch.cuda.empty_cache()
        # last of the main paths: the group it forms would be joined by
        # every CLI run after it
        t0 = time.perf_counter()
        times = parallel_phase(expect["train_stage2"], root, card)
        times["phase_s"] = time.perf_counter() - t0
        log("parallel times " + json.dumps(times))
    agreement_phase()
    agreement_sampler_phase()
    agreement_train_phase()
    agreement_stage2_phase()
    agreement_sound_vae_phase()
    agreement_classifier_phase()
    agreement_cavp_phase()
    agreement_cavp_towers_phase()
    agreement_decode_phase()
    agreement_new_models_phase()
    agreement_other_phase()
    check_rows_cover(rows, launches)
    log(json.dumps({"kernels": summarize(rows, launches)}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except ProfilerBlind as e:
        # a process whose profiler sees no device event stays blind: the
        # whole run is made once more in a new process, which must see it
        if os.environ.get("CHIP_SMOKE_RERUN"):
            raise
        log(f"{e}: the run starts again in a new process")
        sys.stderr.flush()
        os.environ["CHIP_SMOKE_RERUN"] = "1"
        os.execv(sys.executable, [sys.executable, *sys.argv])
