"""Video ingest: frames at 4 FPS, then CAVP features
(``diff_foley_tpu/video/ingest.py``).

The reference re-encodes with ffmpeg to fps=4 and resizes each frame to
224×224, then encodes batches of 40 frames with
``encode_video(normalize=True, pool=False)``. Here the 4-FPS resample is a
selection on the native stream (cv2): output frame k is source frame
round((start + k/4)·fps), ffmpeg's ``fps`` filter for constant-rate input.
cv2 is imported only when a video is read.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..models.cavp import CAVPModel
from ..pipeline import resolve_device


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("video ingest needs cv2 (opencv-python), which is "
                          "not installed") from e
    return cv2


def extract_frames(video_path: str, fps: float = 4.0, size: int = 224,
                   start_second: float = 0.0,
                   truncate_second: Optional[float] = None) -> np.ndarray:
    """→ (T, size, size, 3) float32 RGB in [0, 1] at ``fps`` frames a
    second."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    n_src = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    duration = n_src / src_fps
    end = duration if truncate_second is None else min(
        duration, start_second + truncate_second)
    n_out = max(0, int((end - start_second) * fps))
    # ffmpeg's fps filter: the first frame at t = start, then 1/fps apart
    src_idx = np.minimum(
        np.round((start_second + np.arange(n_out) / fps) * src_fps)
        .astype(int), n_src - 1)
    want = set(src_idx.tolist())
    mapping, i, ok = {}, 0, True
    if n_out and src_idx[0] > 0:
        # seek to the first wanted frame instead of decoding from 0
        if cap.set(cv2.CAP_PROP_POS_FRAMES, int(src_idx[0])):
            i = int(src_idx[0])
    while ok and i <= (src_idx.max() if n_out else -1):
        ok, frame = cap.read()
        if not ok:
            break
        if i in want:
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            mapping[i] = cv2.resize(rgb, (size, size),
                                    interpolation=cv2.INTER_LINEAR)
        i += 1
    cap.release()
    if not mapping:
        raise ValueError(f"no frames decoded from {video_path}")
    if len(mapping) < len(want):
        # the container over-reported its frame count (a truncated file):
        # the last decoded frame stands in for the missing ones
        warnings.warn(
            f"{video_path}: decode stopped at frame {max(mapping)} but "
            f"{int(src_idx.max())} was requested (container over-reported "
            "length); repeating the last decoded frame")
    last = max(mapping)
    frames = [mapping[j if j in mapping else last] for j in src_idx]
    return np.stack(frames).astype(np.float32) / 255.0


@torch.no_grad()
def encode_frames(frames: np.ndarray, cavp: CAVPModel,
                  batch_size: int = 40, device=None) -> np.ndarray:
    """(T, H, W, 3) frames in [0, 1] → (T, 512) L2-normalised per-frame
    CAVP features, in batches of ``batch_size`` frames (the ragged tail
    included), each encoded as one (1, t, H, W, 3) clip. The frames go to
    ``device`` (the first CUDA device when None), where ``cavp`` must
    already be."""
    device = resolve_device(device)
    where = next(cavp.parameters()).device
    if where.type != device.type or device.index not in (None, where.index):
        raise ValueError(f"the CAVP model is on {where}, the frames are "
                         f"asked on {device}: move the model first")
    feats = []
    for i in range(0, len(frames), batch_size):
        chunk = torch.as_tensor(frames[i:i + batch_size][None], device=where)
        out = cavp.encode_video(chunk, normalize=True, pool=False)
        feats.append(out[0].float().cpu().numpy())
    return np.concatenate(feats, axis=0)


def extract_cavp_features(video_path: str, cavp: CAVPModel, fps: float = 4.0,
                          batch_size: int = 40, start_second: float = 0.0,
                          truncate_second: Optional[float] = None,
                          size: int = 224, device=None) -> np.ndarray:
    """Video file → (T, 512) L2-normalised per-frame CAVP features
    (``extract_frames``, then ``encode_frames``)."""
    frames = extract_frames(video_path, fps, size, start_second,
                            truncate_second)
    return encode_frames(frames, cavp, batch_size, device)
