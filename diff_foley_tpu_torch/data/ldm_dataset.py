"""Mel-spec ``.npy`` dataset for first-stage VAE training
(``diff_foley_tpu/data/ldm_dataset.py::SpecDataset``), numpy only.

At the shipped 16 kHz operating point a spec is tiled up to
``sr·duration/hop`` frames, cropped at a random offset to
``truncate // hop_len`` = 512 frames, and repeated to 3 channels: one item
is ``{"spec": (128, T, 3)}`` float32, NHWC after collation. The crop is
drawn from a generator keyed on (seed, epoch, index), so it is the same
whatever worker loads the item and in whatever order.
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
    truncate: int = 131072     # 8.192 s → 512 spec frames
    hop_len: int = 256
    fix_frames: bool = False
    # False → emit single-channel (128, T) specs for consumers that tile
    # on the device
    tile_channels: bool = True


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
        split_cap = {"train": "Train", "valid": "Test", "test": "Test"}[split]
        with open(os.path.join(data_dir, f"{split_cap}.txt")) as f:
            ids = [x.strip() for x in f if x.strip()]
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
