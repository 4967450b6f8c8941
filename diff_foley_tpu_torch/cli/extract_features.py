"""Dataset preprocessing: videos → per-frame CAVP feature ``.npz`` files
(``diff_foley_tpu/cli/extract_features.py``), the ``CAVP_feat/<split>/
<id>.npz["feat"]`` inputs of the stage-2 and classifier datasets: 4 FPS,
batches of 40 frames, per-frame L2-normalised features.

Usage:
  python -m diff_foley_tpu_torch.cli.extract_features --video-dir videos/ \\
      --out-dir CAVP_feat/Train/ --cavp-ckpt logs/cavp

``--cavp-ckpt`` takes a ``cli.train_cavp`` logdir of this package (the
frame size then defaults to the one the towers trained at) or a reference
torch checkpoint; without it the towers have seeded random weights. It
runs on the first CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--cavp-ckpt", default=None)
    p.add_argument("--fps", type=float, default=4.0)
    p.add_argument("--batch-size", type=int, default=40)
    p.add_argument("--frame-size", type=int, default=None,
                   help="ingest resize; defaults to the size a CAVP logdir "
                        "was trained at, else 224")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; fails without a GPU) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..models.cavp import CAVPModel
    from ..pipeline import resolve_device
    from ..utils.checkpoint import (is_native_logdir, is_port_logdir,
                                    load_native_cavp, load_reference_cavp,
                                    native_cavp_ingest_size)
    from ..utils.init import randomize_
    from ..video.ingest import extract_cavp_features

    device = resolve_device(None if args.device == "cuda" else args.device)
    if is_port_logdir(args.cavp_ckpt):
        model = load_native_cavp(args.cavp_ckpt)
        if args.frame_size is None:
            args.frame_size = native_cavp_ingest_size(args.cavp_ckpt)
    elif is_native_logdir(args.cavp_ckpt):
        raise SystemExit(f"{args.cavp_ckpt} is a JAX package logdir (orbax "
                         "checkpoints), which the port does not read")
    elif args.cavp_ckpt:
        model = load_reference_cavp(args.cavp_ckpt)
    else:
        print("WARNING: random CAVP weights (no --cavp-ckpt)")
        model = randomize_(CAVPModel(), 0)
    model = model.to(device).eval().requires_grad_(False)
    os.makedirs(args.out_dir, exist_ok=True)
    exts = (".mp4", ".avi", ".mkv", ".mov", ".webm")
    names = sorted(f for f in os.listdir(args.video_dir)
                   if f.lower().endswith(exts))
    for name in names:
        feat = extract_cavp_features(
            os.path.join(args.video_dir, name), model, fps=args.fps,
            batch_size=args.batch_size, size=args.frame_size or 224,
            device=device)
        np.savez(os.path.join(args.out_dir,
                              f"{os.path.splitext(name)[0]}.npz"), feat=feat)
        print(f"{name}: {feat.shape}")
    print(f"wrote {len(names)} feature files to {args.out_dir}")
    return names


if __name__ == "__main__":
    main()
