"""Contrastive losses of stage-1 CAVP training
(``diff_foley_tpu/train/losses.py``), after the reference's
``open_clip/loss.py``:

- :func:`clip_loss`: InfoNCE over the whole batch, both directions;
- :func:`intra_contrast_loss`: the shipped objective, the batch-wise
  ("extra") CE plus the CE inside each video's clip_num × clip_num
  diagonal block;
- :func:`temporal_semantic_loss`, :func:`temporal_semantic_bias_loss`
  and :func:`intra_contrast_temporal_mean_loss`: the temporal variants;
- :func:`retrieval_metrics`: R@1/5/10 and the mean and median rank.

The logits are plain products (``torch.matmul``/``einsum``) over the
batch they are given: these are global-batch functions, as the JAX
package's are under GSPMD. On a mesh the caller hands them every rank's
features through ``parallel.collectives.all_gather_with_grad`` (the
reference's ``--gather-with-grad``), as ``Stage1Trainer`` does.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels over the last axis."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def clip_loss(video_feats: torch.Tensor, spec_feats: torch.Tensor,
              logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch (loss.py:126-168)."""
    logits_v = logit_scale * video_feats @ spec_feats.T
    labels = torch.arange(video_feats.shape[0], device=logits_v.device)
    return 0.5 * (_ce(logits_v, labels) + _ce(logits_v.T, labels))


def intra_contrast_loss(video_feats: torch.Tensor, spec_feats: torch.Tensor,
                        logit_scale: torch.Tensor, clip_num: int = 3,
                        intra_weight: float = 1.0
                        ) -> Dict[str, torch.Tensor]:
    """Extra (batch-wise) and intra-video contrastive CE (loss.py:480-536).
    Inputs are (B·clip_num, D), each video's clip_num windows adjacent."""
    bs = video_feats.shape[0]
    if bs % clip_num:
        raise ValueError(f"batch {bs} is not a multiple of clip_num "
                         f"{clip_num}")
    logits_v = logit_scale * video_feats @ spec_feats.T   # (B, B)
    logits_s = logits_v.T
    labels = torch.arange(bs, device=logits_v.device)
    extra = 0.5 * (_ce(logits_v, labels) + _ce(logits_s, labels))

    nb = bs // clip_num
    diag = torch.arange(nb, device=logits_v.device)
    lab = torch.arange(clip_num, device=logits_v.device).repeat(nb)

    def _intra(logits):
        blocks = logits.reshape(nb, clip_num, nb, clip_num)[diag, :, diag, :]
        return _ce(blocks.reshape(nb * clip_num, clip_num), lab)

    intra = 0.5 * (_intra(logits_v) + _intra(logits_s))
    return {"total_loss": extra + intra_weight * intra,
            "extra_contrast_loss": extra, "intra_contrast_loss": intra}


def _frame_ce(logits: torch.Tensor) -> torch.Tensor:
    """CE of (B, T, T) frame logits with the diagonal as the target, both
    directions averaged."""
    t = logits.shape[1]
    labels = torch.arange(t, device=logits.device).expand(logits.shape[:2])
    return 0.5 * (_ce(logits, labels) + _ce(logits.transpose(1, 2), labels))


def temporal_semantic_loss(video_feats: torch.Tensor,
                           spec_feats: torch.Tensor,
                           video_temporal: torch.Tensor,
                           spec_temporal: torch.Tensor,
                           logit_scale: torch.Tensor,
                           temporal_weight: float = 1.0
                           ) -> Dict[str, torch.Tensor]:
    """Semantic (pooled) and temporal (per-frame, B×T×T) CE
    (loss.py:171-289); (B, T, D) per-frame features at matching rates."""
    semantic = clip_loss(video_feats, spec_feats, logit_scale)
    temporal = _frame_ce(logit_scale * torch.einsum(
        "btd,bsd->bts", video_temporal, spec_temporal))
    return {"total_loss": semantic + temporal_weight * temporal,
            "semantic_loss": semantic, "temporal_loss": temporal}


def temporal_semantic_bias_loss(video_temporal: torch.Tensor,
                                video_mean: torch.Tensor,
                                spec_temporal: torch.Tensor,
                                spec_mean: torch.Tensor,
                                logit_scale: torch.Tensor,
                                start_bias_index: torch.Tensor,
                                end_bias_index: torch.Tensor,
                                temporal_mix_weight: float = 0.5
                                ) -> Dict[str, torch.Tensor]:
    """Shifted-diagonal temporal CE for misaligned windows
    (loss.py:297-445). When the video window starts later than the spec's
    (``start_bias_index[:, 0] != 0``), video frame v aligns with spec frame
    v − shift, else v + shift; frames outside the overlap are masked out.
    ``start_bias_index``/``end_bias_index``: (B, 2) [video, spec]."""
    semantic = clip_loss(video_mean, spec_mean, logit_scale)
    _, t, _ = video_temporal.shape
    logits_v = logit_scale * torch.einsum("btd,bsd->bts", video_temporal,
                                          spec_temporal)
    logits_s = logits_v.transpose(1, 2)

    truncate_len = (end_bias_index - start_bias_index)[:, 0] + 1
    zp = (t - truncate_len)[:, None]                      # (B, 1)
    video_late = (start_bias_index[:, 0] != 0)[:, None]   # (B, 1)
    pos = torch.arange(t, device=logits_v.device)[None]   # (1, T)

    def masked_ce(logits, target, mask):
        ls = torch.log_softmax(logits, dim=-1)
        picked = torch.gather(ls, -1, target[..., None])[..., 0]
        per = -(picked * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1)
        return per.mean()

    shift = torch.where(video_late, zp, -zp)
    late_mask, early_mask = pos >= zp, pos < (t - zp)
    mask_v2s = torch.where(video_late, late_mask, early_mask)
    mask_s2v = torch.where(video_late, early_mask, late_mask)
    temporal = 0.5 * (
        masked_ce(logits_v, (pos - shift).clamp(0, t - 1),
                  mask_v2s.to(logits_v.dtype))
        + masked_ce(logits_s, (pos + shift).clamp(0, t - 1),
                    mask_s2v.to(logits_v.dtype)))
    return {"total_loss": semantic + temporal_mix_weight * temporal,
            "semantic_contrast_loss": semantic,
            "temporal_contrast_loss": temporal}


def intra_contrast_temporal_mean_loss(video_max: torch.Tensor,
                                      video_mean: torch.Tensor,
                                      spec_max: torch.Tensor,
                                      spec_mean: torch.Tensor,
                                      logit_scale: torch.Tensor,
                                      clip_num: int = 3,
                                      intra_weight: float = 1.0
                                      ) -> Dict[str, torch.Tensor]:
    """Max-pooled extra CE and mean-pooled per-video intra CE
    (loss.py:543-645; both directions of the intra CE, where the
    reference averages the video side with itself)."""
    extra = clip_loss(video_max, spec_max, logit_scale)
    c = video_mean.shape[1]
    v = video_mean.reshape(-1, clip_num, c)
    s = spec_mean.reshape(-1, clip_num, c)
    intra = _frame_ce(logit_scale * torch.einsum("bic,bjc->bij", v, s))
    return {"total_loss": extra + intra_weight * intra,
            "extra_contrast_loss": extra, "intra_contrast_loss": intra}


def retrieval_metrics(video_feats: torch.Tensor, spec_feats: torch.Tensor
                      ) -> Dict[str, float]:
    """R@1/5/10 and the mean and median rank (1-based), both directions
    (train_wds_intra_contrast.py:359-376)."""
    logits_v = video_feats @ spec_feats.T
    out = {}
    for name, logits in (("video_to_spec", logits_v),
                         ("spec_to_video", logits_v.T)):
        n = logits.shape[0]
        target = torch.arange(n, device=logits.device)
        ranking = torch.argsort(-logits, dim=1, stable=True)
        preds = (ranking == target[:, None]).float().argmax(dim=1).double()
        out[f"{name}_mean_rank"] = float(preds.mean()) + 1
        out[f"{name}_median_rank"] = float(preds.quantile(0.5)) + 1
        for k in (1, 5, 10):
            out[f"{name}_R@{k}"] = float((preds < k).double().mean())
    return out
