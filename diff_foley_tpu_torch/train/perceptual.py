"""Learned perceptual metrics: LPIPS (VGG16) and LPAPS (VGGishish)
(``diff_foley_tpu/train/perceptual.py``).

- LPIPS: a scaling layer (fixed RGB shift and scale), the VGG16 feature
  slices relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, per slice
  unit-normalise → squared difference → 1×1-conv linear head → spatial
  mean, summed over the slices.
- LPAPS: the same with a 1-channel trunk (the VGG16 conv plan, no
  BatchNorm) and per-frequency mel statistics in the scaling layer.

Surface layout as the JAX package's: images (B, H, W, 3) in [-1, 1],
spectrograms (B, F, T); NCHW inside. The modules carry the flax scope
names (``net.conv0`` …, ``lin0`` …, ``shift``, ``scale``), so
``utils/convert.py::from_jax_params`` loads them with ``strict=True``.
Pretrained weights are not part of this repository: the trainer's hook is
off by default, and the tests and the GPU smoke run use seeded random
weights.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import Conv2d, conv3x3

# torchvision VGG16 conv plan; 'M' = 2×2/2 max-pool
VGG_PLAN: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                   512, 512, 512, "M", 512, 512, 512)
# capture after the ReLU of these conv indices (relu1_2 … relu5_3)
SLICE_AFTER_CONV = (1, 3, 6, 9, 12)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

# the scaling layer's constants
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGGFeatures(nn.Module):
    """VGG16-style trunk over NCHW maps returning the five feature slices."""

    def __init__(self, in_channels: int = 3, plan: Sequence = VGG_PLAN):
        super().__init__()
        self.plan = tuple(plan)
        ch, i = in_channels, 0
        for v in self.plan:
            if v != "M":
                setattr(self, f"conv{i}", conv3x3(ch, v))
                ch, i = v, i + 1

    def forward(self, x):
        feats, i = [], 0
        for v in self.plan:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"conv{i}")(x))
            if i in SLICE_AFTER_CONV:
                feats.append(x)
            i += 1
        return feats


def _unit_normalize(x, eps: float = 1e-10):
    """Unit L2 over the channels (dim 1)."""
    return x / (torch.sqrt(torch.sum(x**2, dim=1, keepdim=True)) + eps)


class _PerceptualDistance(nn.Module):
    """The shared tail: trunk features of both inputs, unit-normalised,
    squared difference, linear heads, spatial mean, summed → (B,)."""

    def __init__(self, in_channels: int, shift, scale):
        super().__init__()
        self.shift = nn.Parameter(torch.as_tensor(shift, dtype=torch.float32))
        self.scale = nn.Parameter(torch.as_tensor(scale, dtype=torch.float32))
        self.net = VGGFeatures(in_channels)
        for k, ch in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{k}", Conv2d(ch, 1, 1, bias=False))

    def _distance(self, x, y):
        val = 0.0
        for k, (a, b) in enumerate(zip(self.net(x), self.net(y))):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            val = val + getattr(self, f"lin{k}")(d).mean(dim=(2, 3))[:, 0]
        return val


class LPIPS(_PerceptualDistance):
    """Image perceptual distance. Inputs (B, H, W, 3) in [-1, 1] → (B,)."""

    def __init__(self):
        super().__init__(3, LPIPS_SHIFT, LPIPS_SCALE)

    def forward(self, x, y):
        prep = lambda t: ((t - self.shift) / self.scale).permute(
            0, 3, 1, 2).contiguous()
        return self._distance(prep(x), prep(y))


class LPAPS(_PerceptualDistance):
    """Audio (mel-spectrogram) perceptual distance. Inputs (B, F, T) in
    [-1, 1] → (B,). ``n_freq`` sizes the per-frequency scaling statistics."""

    def __init__(self, n_freq: int = 80):
        super().__init__(1, torch.zeros(n_freq), torch.ones(n_freq))

    def forward(self, x, y):
        prep = lambda s: ((s - self.shift[None, :, None])
                          / self.scale[None, :, None])[:, None]
        return self._distance(prep(x), prep(y))


def make_lpips_fn(model: LPIPS, repeat_gray_to_rgb: bool = True):
    """→ ``perceptual_fn(x, rec)`` for the VAE trainer's hook (1-channel
    specs are repeated to RGB)."""

    def fn(x, rec):
        if repeat_gray_to_rgb and x.shape[-1] == 1:
            x, rec = x.expand(*x.shape[:-1], 3), rec.expand(*rec.shape[:-1], 3)
        return model(x, rec).mean()

    return fn


def make_lpaps_fn(model: LPAPS):
    """→ ``perceptual_fn(spec, rec_spec)`` over (B, F, T) mel pairs (a
    trailing mel-image channel is squeezed)."""

    def fn(x, rec):
        if x.dim() == 4:
            x, rec = x[..., 0], rec[..., 0]
        return model(x, rec).mean()

    return fn
