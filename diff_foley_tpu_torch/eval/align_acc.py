"""Alignment accuracy, the paper's Align-Acc protocol
(``diff_foley_tpu/eval/align_acc.py``): each generated mel spec is encoded
by the frozen VAE (its mode, ×0.18215), the classifier scores it against
the ground-truth CAVP features at t = 0, and a sample counts as aligned
when round(p) is 1.

Every batch runs at the first batch's size: a ragged last batch is padded
by repeating its last row and the padded rows are masked out of the
counts, so the model sees one shape throughout.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ..pipeline import resolve_device
from ..utils.padding import pad_axis0

SPEC_FRAMES = 512   # evaluation/dataset.py:100-101 cuts the spec here


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (the batch sharded over devices) is ROADMAP §1 item 5 "
            "(parallelism), not ported: align-acc runs on one device")


def make_align_acc_fn(classifier, vae, scale_factor: float = 0.18215,
                      mesh=None):
    """fn(spec, feat, valid) → (correct, total), 0-dim int64 tensors.

    ``classifier(z, t, feat)`` → P(aligned) (B, 1): an
    ``AlignmentClassifier`` (cond encoder and backbone); spec (B, 128, T,
    3) NHWC mel images, cut to 512 frames; valid (B,) {0, 1}, so that
    padded rows do not count. On the device the models are on."""
    _refuse_mesh(mesh)

    @torch.no_grad()
    def fn(spec, feat, valid):
        spec = spec[:, :, :SPEC_FRAMES]
        z = scale_factor * vae.encode(spec).mode()
        t = torch.zeros((spec.shape[0],), device=spec.device)
        p = classifier(z, t, feat)
        hit = (torch.round(p[:, 0]) == 1).long() * valid
        return hit.sum(), valid.sum()

    return fn


def alignment_accuracy(batches: Iterator[Dict[str, np.ndarray]],
                       classifier, vae, mesh=None, device=None) -> float:
    """Stream batches {"spec", "video_feat"} → the overall accuracy. The
    models are moved to ``device`` (the first CUDA device when None) and
    put in eval mode."""
    _refuse_mesh(mesh)
    device = resolve_device(device)
    classifier.to(device).eval()
    vae.to(device).eval()
    fn = make_align_acc_fn(classifier, vae)
    correct = total = 0
    rows = None
    for b in batches:
        spec, feat = np.asarray(b["spec"]), np.asarray(b["video_feat"])
        n = spec.shape[0]
        rows = rows or n
        valid = np.zeros((max(rows, n),), np.int64)
        valid[:n] = 1
        as_t = lambda a: torch.as_tensor(pad_axis0(a, len(valid)),
                                         device=device)
        c, t = fn(as_t(spec.astype(np.float32)),
                  as_t(feat.astype(np.float32)), as_t(valid))
        correct += int(c)
        total += int(t)
    return correct / max(total, 1)
