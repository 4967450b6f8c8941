"""The other CAVP audio towers (``diff_foley_tpu/models/cavp/spec_towers.py``):
the spectrogram ResNet-50 and Spec-ViT.

- ``SpecResNet50``: a 3×3 stride-1 stem, BatchNorm, ReLU, four
  ``SpecBottleneck`` stages (1×1 → 3×3 → 1×1·4), every stage's first block
  at stride 2, then an adaptive average pool to (1, 4·truncate_sec) over
  (mel, time): (B, 4·truncate_sec, 2048) per-step features.
- ``SpecViT``: a Conv1d patch embedding over time (128 mels → width,
  kernel = stride = patch_size, no bias), a CLS token and learned position
  embedding, ``ln_pre``, pre-norm CLIP blocks (``ResidualAttentionBlock``),
  then ``ln_post`` on the CLS token times ``proj``; it returns (pooled,
  tokens), the tokens without ``ln_post``.
- ``SpecViTMean``: the same trunk without the CLS token; ``ln_post`` and
  ``proj`` on every token → (B, L, output_dim).

The attention is plain tensor math (scores, softmax, weighted sum), as the
JAX module's einsums; LayerNorm has flax's ε 1e-6, GELU is the exact one.
The free parameters keep flax's names and layouts (``positional_embedding``
(L, width), ``class_embedding`` (width,), ``proj`` (width, output_dim)).
Layout: the ResNet takes (B, 1, mel, T) NCHW, the ViTs (B, mel, T).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cnn14 import N_MELS
from .layers import BatchNorm2d, Conv1d, Conv2d, Linear, layer_norm


class SpecBottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        s = stride
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = Conv2d(planes, planes, 3, s, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.conv3 = Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = BatchNorm2d(4 * planes, eps=1e-5)
        if in_ch != 4 * planes or s != 1:
            self.shortcut_conv = Conv2d(in_ch, 4 * planes, 1, s, bias=False)
            self.shortcut_bn = BatchNorm2d(4 * planes, eps=1e-5)
        else:
            self.shortcut_conv = None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.shortcut_conv is not None:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(h + x)


@dataclasses.dataclass(frozen=True)
class SpecResNetConfig:
    stage_blocks: Sequence[int] = (3, 4, 6, 3)
    truncate_sec: int = 4   # the pool's 16 time bins (8 s: 32)
    width: int = 64         # the stem's channels (the port's cut for tests)


class SpecResNet50(nn.Module):
    def __init__(self, cfg: SpecResNetConfig = SpecResNetConfig()):
        super().__init__()
        if cfg.truncate_sec not in (4, 8):
            raise ValueError(f"truncate_sec {cfg.truncate_sec}: 4 or 8")
        self.cfg = cfg
        w = cfg.width
        self.stem_conv = Conv2d(1, w, 3, padding=1, bias=False)
        self.stem_bn = BatchNorm2d(w, eps=1e-5)
        self.blocks = []
        ch = w
        for stage, n in enumerate(cfg.stage_blocks, start=2):
            planes = w * 2 ** (stage - 2)
            for b in range(n):
                name = f"conv{stage}_{b}"
                setattr(self, name, SpecBottleneck(ch, planes,
                                                   2 if b == 0 else 1))
                self.blocks.append(name)
                ch = 4 * planes
        self.out_channels = ch

    def forward(self, x):
        """(B, 1, mel, T) → (B, 4·truncate_sec, 32·width)."""
        h = F.relu(self.stem_bn(self.stem_conv(x)))
        for name in self.blocks:
            h = getattr(self, name)(h)
        t_out = 4 * self.cfg.truncate_sec
        b, c, _, t = h.shape
        if t % t_out:
            raise ValueError(f"time {t} does not split into {t_out} bins")
        h = h.mean(dim=2).reshape(b, c, t_out, t // t_out).mean(dim=3)
        return h.transpose(1, 2)


class MultiheadAttention(nn.Module):
    """torch nn.MultiheadAttention's layout: packed qkv, out projection."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = Linear(width, 3 * width)
        self.out_proj = Linear(width, width)

    def forward(self, x):
        b, l, w = x.shape
        hd = w // self.heads
        q, k, v = (t.reshape(b, l, self.heads, hd).transpose(1, 2)
                   for t in self.in_proj(x).chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, l, w)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.ln_1 = layer_norm(width)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = layer_norm(width)
        self.c_fc = Linear(width, int(width * mlp_ratio))
        self.c_proj = Linear(int(width * mlp_ratio), width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.c_proj(F.gelu(self.c_fc(self.ln_2(x))))


@dataclasses.dataclass(frozen=True)
class SpecViTConfig:
    """The shipped spec_vit operating point."""

    spec_size: int = 256
    patch_size: int = 16
    width: int = 512
    layers: int = 12
    heads: int = 8
    mlp_ratio: float = 4.0
    output_dim: int = 512
    cls_token: bool = True


class SpecViT(nn.Module):
    """(B, 128 mel, spec_size) → (pooled (B, output_dim), tokens (B, L,
    width)); ``cls_token=False`` pools by the tokens' mean."""

    def __init__(self, cfg: SpecViTConfig = SpecViTConfig()):
        super().__init__()
        self.cfg = cfg
        grid = cfg.spec_size // cfg.patch_size
        self.conv1 = Conv1d(N_MELS, cfg.width, cfg.patch_size,
                            cfg.patch_size, bias=False)
        n_pos = grid + (1 if cfg.cls_token else 0)
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos,
                                                             cfg.width))
        if cfg.cls_token:
            self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.ln_pre = layer_norm(cfg.width)
        for i in range(cfg.layers):
            setattr(self, f"block{i}", ResidualAttentionBlock(
                cfg.width, cfg.heads, cfg.mlp_ratio))
        self.ln_post = layer_norm(cfg.width)
        self.proj = nn.Parameter(torch.zeros(cfg.width, cfg.output_dim))

    def trunk(self, spec):
        x = self.conv1(spec).transpose(1, 2)          # (B, grid, width)
        if self.cfg.cls_token:
            cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1)
        x = self.ln_pre(x + self.positional_embedding.to(x.dtype))
        for i in range(self.cfg.layers):
            x = getattr(self, f"block{i}")(x)
        return x

    def forward(self, spec):
        x = self.trunk(spec)
        if self.cfg.cls_token:
            pooled, tokens = x[:, 0], x[:, 1:]
        else:
            pooled, tokens = x.mean(dim=1), x
        return self.ln_post(pooled) @ self.proj.to(x.dtype), tokens


class SpecViTMean(SpecViT):
    """No CLS token; ``ln_post`` and ``proj`` on every token → (B, L,
    output_dim)."""

    def __init__(self, cfg: SpecViTConfig = SpecViTConfig(cls_token=False)):
        super().__init__(dataclasses.replace(cfg, cls_token=False))

    def forward(self, spec):
        return self.ln_post(self.trunk(spec)) @ self.proj.to(spec.dtype)
