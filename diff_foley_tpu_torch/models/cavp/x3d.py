"""X3D-L and I3D ResNet-50 video towers (``diff_foley_tpu/models/cavp/x3d.py``),
factory-selectable CAVP video encoders.

- ``X3D``: ``X3DStem`` (a 1×3×3 stride-2 conv, then a depthwise 5×1×1
  conv, BatchNorm, ReLU), four stages of ``X3DBlock`` (1×1×1 → depthwise
  3×3×3 with stride on the first block → squeeze-excitation on even block
  indices → 1×1×1, a projected shortcut on the first block), the head
  conv_5 → BatchNorm → ReLU, the spatial mean, the time axis
  adaptive-averaged to 16 frames, ``lin_5`` (no bias) → ReLU →
  ``projection`` to 512. The reference's inner Swish after the depthwise
  conv is never executed (it is a plain function, which its forward's
  loop over ``children()`` skips), so the block has no activation there.
- ``I3DResNet``: a 5×7×7 stride-(1, 2, 2) stem, BatchNorm, ReLU, a
  (1, 3, 3) max pool, bottleneck stages (T×1×1 → 1×3×3 → 1×1×1) whose
  temporal kernels cycle through ``I3D_TEMP_KERNELS``, then the spatial
  mean, the 16-frame adaptive pool and ``projection``; the reference's
  pool after stage 2 is commented out, so time is never pooled.

Widths follow PySlowFast's ``round_width``; X3D-L has stage widths
(24, 48, 96, 192), inner ×2.25 and depths ⌈5·(1, 2, 5, 3)⌉. Layout NCDHW,
(B, 3, T, H, W) in, (B, head_frames, out_dim) out. Every BatchNorm is
``layers.BatchNorm3d`` (flax's statistics, the data group's under a
mesh), wrapped as the JAX module's ``BNReLU`` so the state dict carries
its scope names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm3d, Conv3d, Linear


def round_width(width, multiplier, min_width=1, divisor=1):
    """PySlowFast's round_width (its defaults: minimum 1, divisor 1)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def adaptive_avg_pool_t(x: torch.Tensor, out_t: int) -> torch.Tensor:
    """torch AdaptiveAvgPool1d over the time axis of (B, T, C): windows
    [⌊i·T/out⌋, ⌈(i+1)·T/out⌉)."""
    t = x.shape[1]
    if t == out_t:
        return x
    if t % out_t == 0:
        return x.reshape(x.shape[0], out_t, t // out_t, -1).mean(dim=2)
    if out_t % t == 0:
        return x.repeat_interleave(out_t // t, dim=1)
    outs = [x[:, (i * t) // out_t:-(-((i + 1) * t) // out_t)].mean(dim=1)
            for i in range(out_t)]
    return torch.stack(outs, dim=1)


def conv3d(in_ch: int, out_ch: int, kernel, stride=(1, 1, 1), groups=1,
           bias=False) -> Conv3d:
    """A Conv3d padded by k // 2 on each axis, as the JAX ``_conv3d``."""
    return Conv3d(in_ch, out_ch, kernel, stride, tuple(k // 2 for k in kernel),
                  groups=groups, bias=bias)


class BNReLU(nn.Module):
    def __init__(self, channels: int, act: bool = True):
        super().__init__()
        self.bn = BatchNorm3d(channels, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = self.bn(x)
        return F.relu(x) if self.act else x


class SE(nn.Module):
    """Squeeze-excitation with a ReLU inner activation."""

    def __init__(self, channels: int, ratio: float = 0.0625):
        super().__init__()
        dim_fc = round_width(channels, ratio, min_width=8, divisor=8)
        self.fc1 = Conv3d(channels, dim_fc, 1, bias=True)
        self.fc2 = Conv3d(dim_fc, channels, 1, bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class X3DStem(nn.Module):
    def __init__(self, features: int, temp_kernel: int = 5):
        super().__init__()
        self.conv_xy = conv3d(3, features, (1, 3, 3), (1, 2, 2))
        self.conv = conv3d(features, features, (temp_kernel, 1, 1),
                           groups=features)
        self.norm = BNReLU(features)

    def forward(self, x):
        return self.norm(self.conv(self.conv_xy(x)))


class X3DBlock(nn.Module):
    def __init__(self, in_ch: int, dim_out: int, dim_inner: int,
                 stride: int = 1, temp_kernel: int = 3, use_se: bool = False):
        super().__init__()
        s = stride
        self.a = conv3d(in_ch, dim_inner, (1, 1, 1))
        self.a_bn = BNReLU(dim_inner)
        self.b = conv3d(dim_inner, dim_inner, (temp_kernel, 3, 3), (1, s, s),
                        groups=dim_inner)
        self.b_bn = BNReLU(dim_inner, act=False)
        self.se = SE(dim_inner) if use_se else None
        self.c = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = BNReLU(dim_out, act=False)
        if in_ch != dim_out or s != 1:
            self.branch1 = conv3d(in_ch, dim_out, (1, 1, 1), (1, s, s))
            self.branch1_bn = BNReLU(dim_out, act=False)
        else:
            self.branch1 = None

    def forward(self, x):
        h = self.b_bn(self.b(self.a_bn(self.a(x))))
        if self.se is not None:
            h = self.se(h)
        h = self.c_bn(self.c(h))
        if self.branch1 is not None:
            x = self.branch1_bn(self.branch1(x))
        return F.relu(x + h)


@dataclasses.dataclass(frozen=True)
class X3DConfig:
    """The X3D-L operating point."""

    dim_c1: int = 12
    width_factor: float = 2.0
    depth_factor: float = 5.0
    bottleneck_factor: float = 2.25
    dim_c5: int = 2048
    out_dim: int = 512
    base_blocks: Sequence[int] = (1, 2, 5, 3)
    head_frames: int = 16   # the head's pool keeps 16 frames


class X3D(nn.Module):
    def __init__(self, cfg: X3DConfig = X3DConfig()):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.dim_c1]
        for _ in range(4):   # res2 keeps dim_c1
            dims.append(round_width(dims[-1], 2.0, divisor=8)
                        if len(dims) > 1 else dims[0])
        stage_dims = [round_width(d, cfg.width_factor) for d in dims[1:]]
        ch = round_width(cfg.dim_c1, cfg.width_factor)
        self.s1 = X3DStem(ch)
        self.blocks = []
        for stage, (base_n, dim_out) in enumerate(
                zip(cfg.base_blocks, stage_dims), start=2):
            dim_inner = int(cfg.bottleneck_factor * dim_out)
            for i in range(int(math.ceil(cfg.depth_factor * base_n))):
                name = f"s{stage}_b{i}"
                setattr(self, name, X3DBlock(
                    ch, dim_out, dim_inner, stride=2 if i == 0 else 1,
                    use_se=(i + 1) % 2 == 1))
                self.blocks.append(name)
                ch = dim_out
        dim_inner = int(cfg.bottleneck_factor * stage_dims[-1])
        self.conv_5 = conv3d(ch, dim_inner, (1, 1, 1))
        self.conv_5_bn = BNReLU(dim_inner)
        self.lin_5 = Linear(dim_inner, cfg.dim_c5, bias=False)
        self.projection = Linear(cfg.dim_c5, cfg.out_dim)

    def forward(self, x):
        """(B, 3, T, H, W) → (B, head_frames, out_dim) per-frame features."""
        h = self.s1(x)
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = self.conv_5_bn(self.conv_5(h))
        h = adaptive_avg_pool_t(h.mean(dim=(3, 4)).transpose(1, 2),
                                self.cfg.head_frames)
        return self.projection(F.relu(self.lin_5(h)))


class I3DBottleneck(nn.Module):
    def __init__(self, in_ch: int, dim_out: int, dim_inner: int,
                 temp_kernel: int = 3, stride: int = 1):
        super().__init__()
        s = stride
        self.a = conv3d(in_ch, dim_inner, (temp_kernel, 1, 1))
        self.a_bn = BNReLU(dim_inner)
        self.b = conv3d(dim_inner, dim_inner, (1, 3, 3), (1, s, s))
        self.b_bn = BNReLU(dim_inner)
        self.c = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = BNReLU(dim_out, act=False)
        if in_ch != dim_out or s != 1:
            self.branch1 = conv3d(in_ch, dim_out, (1, 1, 1), (1, s, s))
            self.branch1_bn = BNReLU(dim_out, act=False)
        else:
            self.branch1 = None

    def forward(self, x):
        h = self.c_bn(self.c(self.b_bn(self.b(self.a_bn(self.a(x))))))
        if self.branch1 is not None:
            x = self.branch1_bn(self.branch1(x))
        return F.relu(x + h)


# the i3d temporal-kernel basis of stages 2–5, cycled over each stage's blocks
I3D_TEMP_KERNELS = ((3,), (3, 1), (3, 1), (1, 3))


@dataclasses.dataclass(frozen=True)
class I3DConfig:
    """The i3d ResNet-50 operating point."""

    stage_blocks: Sequence[int] = (3, 4, 6, 3)
    width_per_group: int = 64
    out_dim: int = 512
    head_frames: int = 16


class I3DResNet(nn.Module):
    def __init__(self, cfg: I3DConfig = I3DConfig()):
        super().__init__()
        self.cfg = cfg
        w = cfg.width_per_group
        self.stem_conv = conv3d(3, w, (5, 7, 7), (1, 2, 2))
        self.stem_bn = BNReLU(w)
        # the JAX tower's −∞ pad and VALID pool
        self.pool = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.blocks = []
        ch = w
        for stage, n in enumerate(cfg.stage_blocks, start=2):
            dim_out, dim_inner = w * 4 * 2 ** (stage - 2), w * 2 ** (stage - 2)
            kernels = I3D_TEMP_KERNELS[stage - 2]
            for i in range(n):
                name = f"s{stage}_b{i}"
                setattr(self, name, I3DBottleneck(
                    ch, dim_out, dim_inner, kernels[i % len(kernels)],
                    stride=2 if i == 0 and stage > 2 else 1))
                self.blocks.append(name)
                ch = dim_out
        self.projection = Linear(ch, cfg.out_dim)

    def forward(self, x):
        """(B, 3, T, H, W) → (B, head_frames, out_dim)."""
        h = self.pool(self.stem_bn(self.stem_conv(x)))
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = adaptive_avg_pool_t(h.mean(dim=(3, 4)).transpose(1, 2),
                                self.cfg.head_frames)
        return self.projection(h)
