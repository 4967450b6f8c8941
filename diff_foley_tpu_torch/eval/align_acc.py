"""Alignment accuracy, the paper's Align-Acc protocol
(``diff_foley_tpu/eval/align_acc.py``): each generated mel spec is encoded
by the frozen VAE (its mode, ×0.18215), the classifier scores it against
the ground-truth CAVP features at t = 0, and a sample counts as aligned
when round(p) is 1.

Every batch runs at the first batch's size: a ragged last batch is padded
by repeating its last row and the padded rows are masked out of the
counts, so the model sees one shape throughout.

With a ``mesh`` (``parallel/mesh.py``) each batch is padded to a multiple
of the data degree as well, each rank scores its rows, and the hits and
counts are summed over the data group (JAX :55-105): every rank returns
the one-process accuracy.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

import torch.distributed as dist

from ..pipeline import resolve_device
from ..utils.padding import pad_axis0

SPEC_FRAMES = 512   # evaluation/dataset.py:100-101 cuts the spec here


def make_align_acc_fn(classifier, vae, scale_factor: float = 0.18215,
                      mesh=None):
    """fn(spec, feat, valid) → (correct, total), 0-dim int64 tensors.

    ``classifier(z, t, feat)`` → P(aligned) (B, 1): an
    ``AlignmentClassifier`` (cond encoder and backbone); spec (B, 128, T,
    3) NHWC mel images, cut to 512 frames; valid (B,) {0, 1}, so that
    padded rows do not count. On the device the models are on. With a
    ``mesh`` the inputs are this rank's rows and the counts are summed
    over its data group."""
    group = None if mesh is None else mesh.data_group

    @torch.no_grad()
    def fn(spec, feat, valid):
        spec = spec[:, :, :SPEC_FRAMES]
        z = scale_factor * vae.encode(spec).mode()
        t = torch.zeros((spec.shape[0],), device=spec.device)
        p = classifier(z, t, feat)
        hit = (torch.round(p[:, 0]) == 1).long() * valid
        counts = torch.stack([hit.sum(), valid.sum()])
        if group is not None:
            dist.all_reduce(counts, group=group)
        return counts[0], counts[1]

    return fn


def alignment_accuracy(batches: Iterator[Dict[str, np.ndarray]],
                       classifier, vae, mesh=None, device=None) -> float:
    """Stream batches {"spec", "video_feat"} → the overall accuracy. The
    models are moved to ``device`` (the first CUDA device when None) and
    put in eval mode. With a ``mesh`` every rank streams the same batches
    and scores its rows of each."""
    device = resolve_device(device)
    classifier.to(device).eval()
    vae.to(device).eval()
    fn = make_align_acc_fn(classifier, vae, mesh=mesh)
    n_data = 1 if mesh is None else mesh.shape["data"]
    correct = total = 0
    rows = None
    for b in batches:
        spec, feat = np.asarray(b["spec"]), np.asarray(b["video_feat"])
        n = spec.shape[0]
        rows = rows or n
        m = -(-max(rows, n) // n_data) * n_data
        valid = np.zeros((m,), np.int64)
        valid[:n] = 1
        mine = slice(None) if mesh is None else mesh.rows(m)
        as_t = lambda a: torch.as_tensor(pad_axis0(a, m)[mine],
                                         device=device)
        c, t = fn(as_t(spec.astype(np.float32)),
                  as_t(feat.astype(np.float32)), as_t(valid))
        correct += int(c)
        total += int(t)
    return correct / max(total, 1)
