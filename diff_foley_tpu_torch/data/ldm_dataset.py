"""The trainers' datasets (``diff_foley_tpu/data/ldm_dataset.py``), numpy
only: ``SpecDataset`` (mel specs, first-stage VAE training) and
``SpecFeatDataset`` (mel spec and CAVP feature pairs, stage-2 training).

At the shipped 16 kHz operating point a spec is tiled up to
``sr·duration/hop`` frames, cropped at a random offset to
``truncate // hop_len`` = 512 frames, and repeated to 3 channels: one item
is ``{"spec": (128, T, 3)}`` float32, NHWC after collation. Draws come
from a generator keyed on (seed, epoch, index), so an item is the same
whatever worker loads it and in whatever order.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LDMDataConfig:
    sr: int = 16000
    duration: float = 10.0
    truncate: int = 131072     # 8.192 s → 512 spec frames, 32 feats @4 FPS
    fps: float = 4.0
    hop_len: int = 256
    min_duration: int = 2
    mix_prob: float = 0.5
    fix_frames: bool = False
    # False → emit single-channel (128, T) specs for consumers that tile
    # on the device
    tile_channels: bool = True


def _split_ids(data_dir: str, split: str):
    """(Split directory name, ids of ``<data_dir>/<Split>.txt``)."""
    split_cap = {"train": "Train", "valid": "Test", "test": "Test"}[split]
    with open(os.path.join(data_dir, f"{split_cap}.txt")) as f:
        return split_cap, [x.strip() for x in f if x.strip()]


class SpecFeatDataset:
    """Map-style dataset over (spec ``.npy``, CAVP feature ``.npz``) pairs.

    An item pads spec and features by tiling to ``sr·duration/hop`` frames
    and ``fps·duration`` features, then with probability ``mix_prob``
    splices two clips' segments, spec and features alike (the concat mix),
    else crops one 8.192-s window; ``{"spec": (128, T, 3) (or (128, T)
    without ``tile_channels``), "video_feat": (T', 512)}``. With
    ``alignment_labels`` the mix swaps in another clip's features instead
    and adds "labels" (0 for a mismatched pair, 1 for a true one): the
    classifier's training signal."""

    def __init__(self, spec_paths: Sequence[str], feat_paths: Sequence[str],
                 cfg: LDMDataConfig = LDMDataConfig(),
                 alignment_labels: bool = False, seed: int = 0):
        assert len(spec_paths) == len(feat_paths)
        self.spec_paths = list(spec_paths)
        self.feat_paths = list(feat_paths)
        self.cfg = cfg
        self.alignment_labels = alignment_labels
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Vary the draws per epoch (``PrefetchLoader`` calls this)."""
        self._epoch = int(epoch)

    def _item_rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self._epoch, int(idx)]))

    @classmethod
    def from_split_file(cls, data_dir: str, split: str,
                        cfg: LDMDataConfig = LDMDataConfig(),
                        feat_type: str = "CAVP_feat", **kw):
        """The reference layout: ids from ``<data_dir>/<Split>.txt``, specs
        at ``<data_dir>/<Split>/audio_npy_spec/<id>_mel.npy``, features at
        ``<data_dir>/<feat_type>/<Split>/<id>.npz`` (key "feat")."""
        split_cap, ids = _split_ids(data_dir, split)
        specs = [os.path.join(data_dir, split_cap, "audio_npy_spec",
                              f"{i}_mel.npy") for i in ids]
        feats = [os.path.join(data_dir, feat_type, split_cap, f"{i}.npz")
                 for i in ids]
        return cls(specs, feats, cfg, **kw)

    def __len__(self) -> int:
        return len(self.spec_paths)

    def _load(self, idx: int):
        spec = np.load(self.spec_paths[idx]).astype(np.float32)
        feat = np.load(self.feat_paths[idx])["feat"].astype(np.float32)
        cfg = self.cfg
        spec_len = int(cfg.sr * cfg.duration / cfg.hop_len)
        if spec.shape[1] < spec_len:
            spec = np.tile(spec, math.ceil(spec_len / spec.shape[1]))
        spec = spec[:, :spec_len]
        feat_len = int(cfg.fps * cfg.duration)
        if feat.shape[0] < feat_len:
            feat = np.tile(feat, (math.ceil(feat_len / feat.shape[0]), 1))
        return spec, feat[:feat_len]

    def _single(self, spec, feat, rng):
        """One window at a random start (in samples), features alike."""
        cfg = self.cfg
        hi = max(int(cfg.sr * cfg.duration) - cfg.truncate - 1, 0)
        start = 0 if cfg.fix_frames or hi == 0 else int(
            rng.integers(0, hi + 1))
        start_frame = int(cfg.fps * start / cfg.sr)
        truncate_frame = int(cfg.fps * cfg.truncate / cfg.sr)
        spec_start = start // cfg.hop_len
        spec_truncate = cfg.truncate // cfg.hop_len
        return (spec[:, spec_start:spec_start + spec_truncate],
                feat[start_frame:start_frame + truncate_frame])

    def _concat(self, spec1, spec2, feat1, feat2, rng):
        """Two clips' segments spliced, of at least ``min_duration`` each."""
        cfg = self.cfg
        total = cfg.truncate // cfg.hop_len
        min_frames = cfg.min_duration * cfg.sr // cfg.hop_len
        len1 = int(rng.integers(min_frames, total - min_frames))
        len2 = total - len1
        s1 = int(rng.integers(0, total - len1))
        s2 = int(rng.integers(0, total - len2))
        spec = np.concatenate(
            [spec1[:, s1:s1 + len1], spec2[:, s2:s2 + len2]], axis=1)
        f1_start = int(cfg.fps * s1 * cfg.hop_len / cfg.sr)
        f1_len = int(cfg.fps * len1 * cfg.hop_len / cfg.sr)
        f2_start = int(cfg.fps * s2 * cfg.hop_len / cfg.sr)
        f2_len = int(cfg.fps * cfg.truncate / cfg.sr) - f1_len
        feat = np.concatenate([feat1[f1_start:f1_start + f1_len],
                               feat2[f2_start:f2_start + f2_len]])
        return spec, feat

    def _other(self, idx: int, rng) -> int:
        j = idx
        while j == idx:
            j = int(rng.integers(0, len(self)))
        return j

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = self._item_rng(idx)
        spec1, feat1 = self._load(idx)
        mixed = float(rng.uniform()) < self.cfg.mix_prob
        if self.alignment_labels:
            if mixed:
                _, feat1 = self._load(self._other(idx, rng))
            spec, feat = self._single(spec1, feat1, rng)
            return {"spec": np.repeat(spec[:, :, None], 3, axis=2),
                    "video_feat": feat,
                    "labels": np.asarray(0 if mixed else 1, np.int32)}
        # the concat mix needs room for two segments of min_duration;
        # shorter crops fall back to the single window
        total = self.cfg.truncate // self.cfg.hop_len
        min_frames = self.cfg.min_duration * self.cfg.sr // self.cfg.hop_len
        if mixed and total > 2 * min_frames:
            spec2, feat2 = self._load(self._other(idx, rng))
            spec, feat = self._concat(spec1, spec2, feat1, feat2, rng)
        else:
            spec, feat = self._single(spec1, feat1, rng)
        if self.cfg.tile_channels:
            spec = np.repeat(spec[:, :, None], 3, axis=2)
        return {"spec": spec, "video_feat": feat}


class SpecDataset:
    """Map-style dataset over mel-spec ``.npy`` paths."""

    def __init__(self, spec_paths: Sequence[str],
                 cfg: LDMDataConfig = LDMDataConfig(), seed: int = 0):
        self.spec_paths = list(spec_paths)
        self.cfg = cfg
        self.seed = seed
        self._epoch = 0

    @classmethod
    def from_split_file(cls, data_dir: str, split: str,
                        cfg: LDMDataConfig = LDMDataConfig(), **kw):
        """The reference layout: ids from ``<data_dir>/<Split>.txt``, specs
        at ``<data_dir>/<Split>/audio_npy_spec/<id>_mel.npy``."""
        split_cap, ids = _split_ids(data_dir, split)
        specs = [
            os.path.join(data_dir, split_cap, "audio_npy_spec", f"{i}_mel.npy")
            for i in ids
        ]
        return cls(specs, cfg, **kw)

    @classmethod
    def from_dir(cls, spec_dir: str, cfg: LDMDataConfig = LDMDataConfig(),
                 **kw):
        """A flat directory of ``.npy`` mel specs."""
        specs = sorted(
            os.path.join(spec_dir, f)
            for f in os.listdir(spec_dir) if f.endswith(".npy")
        )
        if not specs:
            raise FileNotFoundError(f"no .npy specs under {spec_dir}")
        return cls(specs, cfg, **kw)

    def set_epoch(self, epoch: int) -> None:
        """Vary the crops per epoch (``PrefetchLoader`` calls this)."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.spec_paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self._epoch, int(idx)])
        )
        spec = np.load(self.spec_paths[idx]).astype(np.float32)
        spec_len = int(cfg.sr * cfg.duration / cfg.hop_len)
        if spec.shape[1] < spec_len:
            spec = np.tile(spec, math.ceil(spec_len / spec.shape[1]))
        spec = spec[:, :spec_len]
        spec_truncate = cfg.truncate // cfg.hop_len
        hi = max(spec_len - spec_truncate, 0)
        # inclusive upper bound: the final valid offset is sampled too
        start = 0 if cfg.fix_frames or hi == 0 else int(
            rng.integers(0, hi + 1))
        spec = spec[:, start : start + spec_truncate]
        if cfg.tile_channels:
            spec = np.repeat(spec[:, :, None], 3, axis=2)
        return {"spec": spec}
