"""R(2+1)D-34 video tower (``diff_foley_tpu/models/cavp/r2plus1d.py``), a
factory-selectable CAVP video encoder.

Depth 34 (BasicBlocks (3, 4, 6, 3)), a (3, 7, 7) stride-(1, 2, 2) first
conv, then a (1, 3, 3) max pool, spatial strides (1, 2, 2, 2), temporal
strides 1, BatchNorm ε 1e-3; the head averages space, adaptive-averages
time to 16 frames and projects 512 → 512 (``project``).

Every 3-D conv is factorised (``Conv2Plus1d``): a spatial (1, kh, kw)
conv → BatchNorm (ε 1e-5: the backbone's ε is not passed into the
factorised conv) → ReLU → a temporal (kt, 1, 1) conv, with
M = ⌊3·kh·kw·N_in·N_out / (kh·kw·N_in + 3·N_out)⌋ mid channels. mmcv's
ConvModule puts its own BatchNorm and ReLU after each (``ConvBN2Plus1d``).
Layout NCDHW, (B, 3, T, H, W) in, (B, head_frames, out_dim) out.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm3d, Conv3d, Linear
from .x3d import adaptive_avg_pool_t

Triple = Tuple[int, int, int]


def mid_channels_2plus1d(c_in: int, c_out: int, kernel: Triple) -> int:
    """Conv2plus1d's mid-plane count."""
    _, kh, kw = kernel
    m = 3 * (c_in * c_out * kh * kw)
    m /= c_in * kh * kw + 3 * c_out
    return int(m)


class Conv2Plus1d(nn.Module):
    """Factorised (2+1)-D conv: spatial conv → BatchNorm → ReLU → temporal
    conv."""

    def __init__(self, in_ch: int, features: int, kernel: Triple,
                 stride: Triple = (1, 1, 1)):
        super().__init__()
        kt, kh, kw = kernel
        st, sh, sw = stride
        mid = mid_channels_2plus1d(in_ch, features, kernel)
        self.conv_s = Conv3d(in_ch, mid, (1, kh, kw), (1, sh, sw),
                             (0, kh // 2, kw // 2), bias=False)
        self.bn_s = BatchNorm3d(mid, eps=1e-5)
        self.conv_t = Conv3d(mid, features, (kt, 1, 1), (st, 1, 1),
                             (kt // 2, 0, 0), bias=False)

    def forward(self, x):
        return self.conv_t(F.relu(self.bn_s(self.conv_s(x))))


class ConvBN2Plus1d(nn.Module):
    """mmcv's ConvModule around a Conv2plus1d: conv → BatchNorm (ε 1e-3)
    → optional ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: Triple,
                 stride: Triple = (1, 1, 1), act: bool = True):
        super().__init__()
        self.conv = Conv2Plus1d(in_ch, features, kernel, stride)
        self.bn = BatchNorm3d(features, eps=1e-3)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class BasicBlock2Plus1d(nn.Module):
    def __init__(self, in_ch: int, planes: int, spatial_stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        s = spatial_stride
        self.conv1 = ConvBN2Plus1d(in_ch, planes, (3, 3, 3), (1, s, s))
        self.conv2 = ConvBN2Plus1d(planes, planes, (3, 3, 3), act=False)
        self.downsample = (ConvBN2Plus1d(in_ch, planes, (1, 1, 1), (1, s, s),
                                         act=False)
                           if has_downsample else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


@dataclasses.dataclass(frozen=True)
class R2Plus1dConfig:
    stage_blocks: Sequence[int] = (3, 4, 6, 3)   # depth 34
    base_channels: int = 64
    spatial_strides: Sequence[int] = (1, 2, 2, 2)
    out_dim: int = 512
    head_frames: int = 16


class ResNet2Plus1d(nn.Module):
    def __init__(self, cfg: R2Plus1dConfig = R2Plus1dConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.base_channels
        self.conv1 = ConvBN2Plus1d(3, ch, (3, 7, 7), (1, 2, 2))
        self.pool = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.blocks = []
        for stage, (n, stride) in enumerate(
                zip(cfg.stage_blocks, cfg.spatial_strides), start=1):
            planes = cfg.base_channels * 2 ** (stage - 1)
            for b in range(n):
                s = stride if b == 0 else 1
                name = f"layer{stage}_{b}"
                setattr(self, name, BasicBlock2Plus1d(
                    ch, planes, s,
                    has_downsample=b == 0 and (s != 1 or ch != planes)))
                self.blocks.append(name)
                ch = planes
        self.project = Linear(ch, cfg.out_dim)

    def forward(self, x):
        """(B, 3, T, H, W) → (B, head_frames, out_dim)."""
        h = self.pool(self.conv1(x))
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = adaptive_avg_pool_t(h.mean(dim=(3, 4)).transpose(1, 2),
                                self.cfg.head_frames)
        return self.project(h)
