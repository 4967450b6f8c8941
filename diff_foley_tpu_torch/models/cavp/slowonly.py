"""SlowOnly-R50 3D video tower (``diff_foley_tpu/models/cavp/slowonly.py``).

- stem: Conv3d(3 → 64, (1, 7, 7), stride (1, 2, 2)) + BN + ReLU, then
  MaxPool3d((1, 3, 3), stride (1, 2, 2), padding (0, 1, 1)): the JAX
  tower's −∞ pad and VALID pool;
- stages of (3, 4, 6, 3) ``Bottleneck3d`` blocks, planes 64·2^s, spatial
  strides (1, 2, 2, 2) on conv2, stages 3–4 with (3, 1, 1) conv1 kernels;
- the spatial mean at the end: (B, T, 2048), T kept end to end.

Layout NCDHW, (B, 3, T, H, W). BatchNorm (eps 1e-5) runs flax's
semantics (``layers.py``): in eval mode on its running statistics, in
train mode on the batch's, updating them. The products run in the
activation's type.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm3d, Conv3d

Triple = Tuple[int, int, int]
SPATIAL_STRIDES = (1, 2, 2, 2)   # of each stage's first block, on conv2
INFLATE = (0, 0, 1, 1)           # stages with (3, 1, 1) conv1 kernels


class ConvBN(nn.Module):
    """Conv3d without bias, BatchNorm3d, optional ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: Triple,
                 stride: Triple = (1, 1, 1), padding: Triple = (0, 0, 0),
                 act: bool = True):
        super().__init__()
        self.conv = Conv3d(in_ch, features, kernel, stride, padding,
                           bias=False)
        self.bn = BatchNorm3d(features, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class Bottleneck3d(nn.Module):
    def __init__(self, in_ch: int, planes: int, spatial_stride: int = 1,
                 inflate: bool = False, has_downsample: bool = False):
        super().__init__()
        k1, p1 = ((3, 1, 1), (1, 0, 0)) if inflate else ((1, 1, 1), (0, 0, 0))
        s = spatial_stride
        self.conv1 = ConvBN(in_ch, planes, k1, padding=p1)
        self.conv2 = ConvBN(planes, planes, (1, 3, 3), (1, s, s), (0, 1, 1))
        self.conv3 = ConvBN(planes, 4 * planes, (1, 1, 1), act=False)
        self.downsample = (ConvBN(in_ch, 4 * planes, (1, 1, 1), (1, s, s),
                                  act=False) if has_downsample else None)

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class ResNet3dSlowOnly(nn.Module):
    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 base_channels: int = 64):
        super().__init__()
        self.conv1 = ConvBN(3, base_channels, (1, 7, 7), (1, 2, 2), (0, 3, 3))
        self.pool = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.blocks = []
        ch = base_channels
        for stage, (n, stride, infl) in enumerate(
                zip(stage_blocks, SPATIAL_STRIDES, INFLATE), start=1):
            planes = base_channels * 2 ** (stage - 1)
            for b in range(n):
                name = f"layer{stage}_{b}"
                setattr(self, name, Bottleneck3d(
                    ch, planes, stride if b == 0 else 1, bool(infl),
                    has_downsample=b == 0))
                self.blocks.append(name)
                ch = 4 * planes
        self.out_channels = ch

    def forward(self, x):
        """(B, 3, T, H, W) → (B, T, C) per-frame features."""
        h = self.pool(self.conv1(x))
        for name in self.blocks:
            h = getattr(self, name)(h)
        return h.mean(dim=(3, 4)).transpose(1, 2)
