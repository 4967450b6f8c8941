"""Alignment-accuracy evaluation entry point
(``diff_foley_tpu/cli/align_acc.py``): score a folder of generated mel
specs (``.npy``) against ground-truth CAVP features (``.npz``, key
"feat") with the alignment classifier at t = 0; writes the result line to
``--out``.

Usage:
  python -m diff_foley_tpu_torch.cli.align_acc --spec-dir gen/ --feat-dir feats/ \\
      --classifier-ckpt logs/classifier --out results_metric.txt

``--classifier-ckpt`` takes a ``cli.train_classifier`` logdir of this
package (the classifier and the frozen VAE it trained against) or a
reference torch checkpoint (the backbone, its cond encoder and the VAE);
without it the weights are seeded random ones. It runs on the first CUDA
device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--spec-dir", required=True)
    p.add_argument("--feat-dir", required=True)
    p.add_argument("--classifier-ckpt", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--out", default="results_metric.txt")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; fails without a GPU) or 'cpu'")
    return p.parse_args(argv)


def iter_batches(spec_dir, feat_dir, batch_size):
    """{"spec": (b, 128, ≤512, 3), "video_feat": (b, ≤40, 512)} batches
    over the specs of ``spec_dir`` in name order, each with the features
    of the same name; the last batch may be short."""
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(spec_dir)
                   if f.endswith(".npy"))
    batch = {"spec": [], "video_feat": []}
    for n in names:
        spec = np.load(os.path.join(spec_dir, f"{n}.npy")).astype(np.float32)
        spec = spec[:, :512]
        if spec.ndim == 2:
            spec = np.repeat(spec[:, :, None], 3, axis=2)   # 1 → 3 ch, NHWC
        feat = np.load(os.path.join(feat_dir, f"{n}.npz"))["feat"].astype(
            np.float32)[:40]
        batch["spec"].append(spec)
        batch["video_feat"].append(feat)
        if len(batch["spec"]) == batch_size:
            yield {k: np.stack(v) for k, v in batch.items()}
            batch = {"spec": [], "video_feat": []}
    if batch["spec"]:
        yield {k: np.stack(v) for k, v in batch.items()}


def load_classifier(ckpt):
    """(classifier, VAE) of a port logdir, a reference checkpoint, or
    seeded random weights (``ckpt`` None)."""
    from ..models.layers import init_weights_
    from ..train.classifier import (AlignmentClassifier, ClassifierTrainer,
                                    init_classifier_weights_)
    from ..utils.checkpoint import (is_native_logdir, is_port_logdir,
                                    load_native_classifier,
                                    load_reference_classifier)

    if is_port_logdir(ckpt):
        trainer, _, vae = load_native_classifier(ckpt)
        return trainer.model, vae
    if is_native_logdir(ckpt):
        raise SystemExit(f"{ckpt} is a JAX package logdir (orbax "
                         "checkpoints), which the port does not read")
    if ckpt:
        parts = load_reference_classifier(ckpt)
        if "vae" not in parts:
            raise SystemExit(f"{ckpt} holds no first_stage_model.* (VAE) "
                             "weights: align-acc needs the VAE the "
                             "classifier was trained against")
        model = AlignmentClassifier(parts["backbone"].cfg,
                                    parts["cond"].pos_emb.shape[0])
        model.backbone, model.cond = parts["backbone"], parts["cond"]
        return model, parts["vae"]
    trainer = ClassifierTrainer()
    init_classifier_weights_(trainer.model, torch.Generator().manual_seed(0))
    init_weights_(trainer.vae, torch.Generator().manual_seed(1))
    print("WARNING: random classifier weights (no --classifier-ckpt)")
    return trainer.model, trainer.vae


def main(argv=None):
    args = parse_args(argv)
    from ..eval.align_acc import alignment_accuracy
    from ..pipeline import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    model, vae = load_classifier(args.classifier_ckpt)
    acc = alignment_accuracy(
        iter_batches(args.spec_dir, args.feat_dir, args.batch_size),
        model, vae, device=device)
    line = f"align_acc: {acc:.6f}"
    print(line)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return acc


if __name__ == "__main__":
    main()
