"""Video → foley audio from the command line (``diff_foley_tpu/cli/generate.py``).

Usage:
  python -m diff_foley_tpu_torch.cli.generate --video path/to.mp4 \\
      --out out_dir --cavp-ckpt cavp_epoch66.ckpt \\
      --ldm-ckpt ldm_epoch240.ckpt \\
      --classifier-ckpt double_guidance_classifier.ckpt --bf16 \\
      [--cfg-scale 4.5 --cg-scale 50 --steps 25 --sample-num 4]

Each ``--*-ckpt`` is a reference checkpoint or a training logdir of this
package (``cli.train_stage2``, ``cli.train_cavp``,
``cli.train_classifier``): the stage-2 logdir brings its first stage, the
CAVP logdir its frame size (the default ``--frame-size``), and guidance
takes the classifier logdir's backbone with the raw CAVP features as its
context. The JAX package's orbax logdirs are refused.
``--random-weights`` runs the whole path with seeded random weights, for
smoke and speed runs only. It runs on the first CUDA device unless
``--device cpu``. For each sample it writes ``<video>_sample<i>.wav``
(int16, 16 kHz) and ``<video>_sample<i>_spec.npy`` into ``--out``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video", required=True)
    p.add_argument("--out", default="./generated")
    p.add_argument("--start-second", type=float, default=0.0)
    p.add_argument("--truncate-second", type=float, default=8.2)
    p.add_argument("--cavp-ckpt", default=None)
    p.add_argument("--ldm-ckpt", default=None)
    p.add_argument("--classifier-ckpt", default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--cfg-scale", type=float, default=4.5)
    p.add_argument("--cg-scale", type=float, default=50.0)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--sample-num", type=int, default=4)
    p.add_argument("--sampler", default="dpm", choices=["dpm", "ddim", "plms"])
    p.add_argument(
        "--continue-from", default=None,
        help="audio continuation: a 16 kHz .wav or a normalised mel-spec "
             ".npy whose first --known-seconds are kept; the rest is "
             "regenerated against the video (masked: forces --sampler ddim "
             "unless the sampler is one with a mask path)")
    p.add_argument("--known-seconds", type=float, default=None,
                   help="how much of --continue-from to keep (required "
                        "with it)")
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--frame-size", type=int, default=None,
                   help="ingest resize (default: a CAVP logdir's frame "
                        "size, else 224)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; fails without a GPU) or 'cpu'")
    return p.parse_args(argv)


def model_configs():
    """The (LDMConfig, CAVPConfig, classifier UNetConfig) the CLI builds:
    the shipped models."""
    from ..diffusion.latent_diffusion import LDMConfig
    from ..models.cavp import CAVPConfig
    from ..models.unet import CLASSIFIER_BACKBONE

    return LDMConfig(), CAVPConfig(), CLASSIFIER_BACKBONE


def _continue_audio(df, feats, args, gen):
    """--continue-from: keep the first --known-seconds of the given audio
    (wav or normalised mel .npy, tiled to the generated length) and
    regenerate the rest against the video features."""
    import torch

    from ..audio.transforms import wav_to_mel
    from ..pipeline import SPEC_HW, continuation_mask, window_features
    from ..utils.wav import read_wav

    if args.known_seconds is None:
        raise SystemExit("--continue-from requires --known-seconds")
    melspec = df.pipe.melspec
    if args.continue_from.endswith(".npy"):
        spec = np.asarray(np.load(args.continue_from), np.float32)
        if spec.ndim != 2 or spec.shape[0] != SPEC_HW[0]:
            raise SystemExit(f"--continue-from spec must be ({SPEC_HW[0]}, "
                             f"frames), got {spec.shape}")
    else:
        wav, sr = read_wav(args.continue_from)
        if sr != melspec.sr:
            raise SystemExit(f"--continue-from wav must be {melspec.sr} Hz, "
                             f"got {sr}")
        spec = wav_to_mel(torch.as_tensor(wav, device=df.device),
                          melspec).cpu().numpy()
    need = window_features(np.asarray(feats)).shape[0] * SPEC_HW[1]
    if spec.shape[1] < need:
        spec = np.tile(spec, (1, -(-need // spec.shape[1])))
    spec = spec[:, :need]
    known = int(round(args.known_seconds * melspec.sr / melspec.hop_length))
    mask = continuation_mask(need, min(known, need))
    return df.pipe.inpaint(feats, spec, mask, args.seed + 5, gen)


def build(args):
    """The DiffFoley the flags ask for: each of ``--ldm-ckpt``,
    ``--cavp-ckpt`` and ``--classifier-ckpt`` a reference checkpoint or a
    training logdir of this package; seeded random weights otherwise."""
    from ..api import DiffFoley
    from ..diffusion.latent_diffusion import LatentDiffusion
    from ..models.cavp import CAVPModel
    from ..models.unet import ClassifierBackbone
    from ..pipeline import resolve_device
    from ..utils.checkpoint import (is_native_logdir, is_port_logdir,
                                    load_native_cavp, load_native_classifier,
                                    load_native_ldm, load_reference_cavp,
                                    load_reference_classifier,
                                    load_reference_ldm,
                                    native_cavp_ingest_size)
    from ..utils.init import randomize_

    for flag, trainer in (("ldm_ckpt", "stage-2 trainer"),
                          ("cavp_ckpt", "CAVP trainer"),
                          ("classifier_ckpt", "classifier trainer")):
        path = getattr(args, flag)
        if is_native_logdir(path):
            raise SystemExit(
                f"--{flag.replace('_', '-')} {path} is a training logdir of "
                "the JAX package (orbax checkpoints), which the port does "
                "not read: pass a reference torch checkpoint or a logdir of "
                f"the port's {trainer}")
    if not (args.random_weights or (args.cavp_ckpt and args.ldm_ckpt)):
        raise SystemExit("provide --cavp-ckpt/--ldm-ckpt or pass "
                         "--random-weights")
    device = resolve_device(None if args.device == "cuda" else args.device)
    ldm_cfg, cavp_cfg, clf_cfg = model_configs()
    frame_size = args.frame_size
    if is_port_logdir(args.ldm_ckpt):
        # the EMA weights where the run trained them, the first stage from
        # the logdir's vae/
        ldm = load_native_ldm(args.ldm_ckpt)
    else:
        ldm = LatentDiffusion(ldm_cfg)
        if args.ldm_ckpt:
            load_reference_ldm(args.ldm_ckpt, ldm)
        else:
            randomize_(ldm, args.seed + 1)
    if is_port_logdir(args.cavp_ckpt):
        cavp = load_native_cavp(args.cavp_ckpt)
        if frame_size is None:
            frame_size = native_cavp_ingest_size(args.cavp_ckpt)
    else:
        cavp = CAVPModel(cavp_cfg)
        if args.cavp_ckpt:
            load_reference_cavp(args.cavp_ckpt, cavp)
        else:
            randomize_(cavp, args.seed)
    # guidance feeds the raw CAVP features to the backbone
    # (alignment_classifier.py:285-287)
    classifier = None
    if args.cg_scale > 0 and is_port_logdir(args.classifier_ckpt):
        classifier = load_native_classifier(
            args.classifier_ckpt)[0].model.backbone
    elif args.cg_scale > 0 and args.classifier_ckpt:
        classifier = load_reference_classifier(args.classifier_ckpt,
                                               clf_cfg)["backbone"]
    elif args.cg_scale > 0 and args.random_weights:
        classifier = randomize_(ClassifierBackbone(clf_cfg), 3)
    elif args.cg_scale > 0:
        print("no --classifier-ckpt: classifier guidance is off")
    return DiffFoley(ldm, cavp, classifier, bf16=args.bf16,
                     frame_size=frame_size or 224, device=device)


def main(argv=None):
    args = parse_args(argv)
    from ..pipeline import GenerationConfig
    from ..utils.wav import write_wav

    df = build(args)
    feats = df.extract_features(args.video, args.start_second,
                                args.truncate_second)
    print(f"CAVP features: {feats.shape}")
    sampler = args.sampler
    if args.continue_from and sampler not in ("ddim", "ancestral"):
        print(f"--continue-from needs a masked-capable sampler; {sampler!r} "
              "-> 'ddim'")
        sampler = "ddim"
    gen = GenerationConfig(sampler=sampler, steps=args.steps,
                           cfg_scale=args.cfg_scale,
                           classifier_scale=args.cg_scale,
                           sample_num=args.sample_num)
    if args.continue_from:
        out = _continue_audio(df, feats, args, gen)
    else:
        out = df.generate_from_features(feats, args.seed + 5, gen)
    os.makedirs(args.out, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.video))[0]
    paths = []
    for i in range(out["wav"].shape[0]):
        path = os.path.join(args.out, f"{base}_sample{i}.wav")
        write_wav(path, out["wav"][i], sr=16000)
        np.save(os.path.join(args.out, f"{base}_sample{i}_spec.npy"),
                out["spec"][i])
        print("wrote", path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
