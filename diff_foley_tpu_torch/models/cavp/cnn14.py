"""PANN CNN14 and CNN10 audio towers, 16 kHz variant
(``diff_foley_tpu/models/cavp/cnn14.py``). CNN14: BatchNorm over the 128 mel
bins, six ConvBlocks 64 → 2048 with (2, 2)×4, (1, 2), (1, 1) average
pools, the mean over mels, the max + average 1-D pool fusion (k 3, s 1,
p 1, edge windows still ÷3), then fc1 applied twice with ReLU (the
reference forward's quirk, which its weights were trained with), then
``final_project``. CNN10: five ConvBlocks 64 → 1024 with (2, 2)×4 and
(1, 2) pools and the same tail; the factory builds it at
``embed_dim=2048`` under its own projection head.

Layout NCHW: (B, 1, T, 128 mels) in, (B, T/16, embed_dim) out. BatchNorm
runs flax's semantics (``layers.py``). In train mode each ConvBlock's
output takes dropout at 0.2, its keep mask drawn from the caller's
generator (``dropout_keep``). The products run in the activation's type.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel.mesh import draw_rows
from .layers import BatchNorm1d, BatchNorm2d, Conv2d, Linear

N_MELS = 128
POOLS = ((2, 2), (2, 2), (2, 2), (2, 2), (1, 2), (1, 1))
DROPOUT = 0.2


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, pool=(2, 2)):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_ch, eps=1e-5)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(out_ch, eps=1e-5)
        self.pool = pool

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.avg_pool2d(x, self.pool, self.pool)


def dropout_keep(shape, keep_prob: float, generator, device) -> torch.Tensor:
    """The keep mask of one dropout: uniform draws below ``keep_prob``."""
    return draw_rows(torch.rand, shape, generator=generator,
                     device=device) < keep_prob


class Cnn14(nn.Module):
    CHANNELS = (64, 128, 256, 512, 1024, 2048)
    POOLS = POOLS

    def __init__(self, embed_dim: int = 512,
                 channels: Optional[Sequence[int]] = None):
        super().__init__()
        chans = list(channels or self.CHANNELS)
        if len(chans) != len(self.POOLS):
            raise ValueError(f"{type(self).__name__} has {len(self.POOLS)} "
                             f"conv blocks, got {chans}")
        self.bn0 = BatchNorm1d(N_MELS, eps=1e-5)
        ch = 1
        for i, (c, p) in enumerate(zip(chans, self.POOLS), start=1):
            setattr(self, f"conv_block{i}", ConvBlock(ch, c, p))
            ch = c
        self.fc1 = Linear(ch, ch)
        self.final_project = Linear(ch, embed_dim)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """(B, 1, T, 128) → (B, T/16, embed_dim); in train mode the
        dropout masks come from ``generator``."""
        # BN over the mel bins, as (B·T, mels) rows: no transposed view
        # around the norm. The CPU's batch_norm backward miscomputes the
        # scale and bias gradients when the incoming gradient is a
        # transposed view (0.7–1.2 of their size off, torch 2.13)
        h = self.bn0(x.reshape(-1, x.shape[-1])).reshape(x.shape)
        keep_prob = 1.0 - DROPOUT
        for i in range(1, len(self.POOLS) + 1):
            h = getattr(self, f"conv_block{i}")(h)
            if self.training:
                keep = dropout_keep(h.shape, keep_prob, generator, h.device)
                h = torch.where(keep, h / keep_prob, torch.zeros_like(h))
        h = h.mean(dim=3)                                   # (B, C, T')
        h = (F.max_pool1d(h, 3, 1, 1)
             + F.avg_pool1d(h, 3, 1, 1, count_include_pad=True))
        h = h.transpose(1, 2)
        h = F.relu(self.fc1(h))
        h = F.relu(self.fc1(h))   # applied twice, as the reference does
        return self.final_project(h)


class Cnn10(Cnn14):
    """PANN CNN10: five conv blocks; ``channels`` (five widths) cuts it
    for tests, as CNN14's does."""

    CHANNELS = (64, 128, 256, 512, 1024)
    POOLS = POOLS[:5]

    def __init__(self, embed_dim: int = 2048,
                 channels: Optional[Sequence[int]] = None):
        super().__init__(embed_dim, channels)
