"""Decode path of the SD first-stage AutoencoderKL, f=8
(``diff_foley_tpu/models/vae.py``): post_quant_conv → Decoder. A
(B, 16, 64, 4) latent decodes to a (B, 128, 512, 3) mel image (NHWC at the
surface, NCHW inside).

The decoder's mid attention is single-head over h·w tokens (L 1024, D 512
at the shipped size); it runs the plain attention formula, as the JAX
package runs it through XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from .layers import GroupNorm32, conv1x1, conv3x3


def _gn(channels: int, act: str | None = None) -> GroupNorm32:
    # taming Normalize: GroupNorm(32, ε 1e-6), statistics in float32
    return GroupNorm32(channels, eps=1e-6, act=act)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4


SD_VAE = VAEConfig()


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _gn(in_ch, "silu")
        self.conv1 = conv3x3(in_ch, out_ch)
        self.norm2 = _gn(out_ch, "silu")
        self.conv2 = conv3x3(out_ch, out_ch)
        self.nin_shortcut = conv1x1(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over the h·w tokens."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _gn(ch)
        self.q, self.k, self.v = conv1x1(ch, ch), conv1x1(ch, ch), conv1x1(ch, ch)
        self.proj_out = conv1x1(ch, ch)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        tokens = lambda t: t.reshape(b, 1, c, h * w).transpose(2, 3)
        out = multi_head_attention(tokens(self.q(hn)), tokens(self.k(hn)),
                                   tokens(self.v(hn)), scale=c**-0.5)
        return x + self.proj_out(out.transpose(2, 3).reshape(b, c, h, w))


class VAEUpsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = conv3x3(ch, ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig = SD_VAE):
        super().__init__()
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = conv3x3(cfg.z_channels, ch)
        self.mid_block1 = VAEResnetBlock(ch, ch)
        self.mid_attn = VAEAttnBlock(ch)
        self.mid_block2 = VAEResnetBlock(ch, ch)
        self.plan = []
        for level, mult in reversed(list(enumerate(cfg.ch_mult))):
            out = cfg.ch * mult
            for i in range(cfg.num_res_blocks + 1):
                name = f"up_{level}_block{i}"
                setattr(self, name, VAEResnetBlock(ch, out))
                self.plan.append(name)
                ch = out
            if level != 0:
                setattr(self, f"up_{level}_us", VAEUpsample(ch))
                self.plan.append(f"up_{level}_us")
        self.norm_out = _gn(ch, "silu")
        self.conv_out = conv3x3(ch, cfg.out_channels)

    def forward(self, z):
        h = self.mid_block2(self.mid_attn(self.mid_block1(self.conv_in(z))))
        for name in self.plan:
            h = getattr(self, name)(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """The first stage's decode half: ``decode`` maps NHWC latents to NHWC
    images in the parameters' type."""

    def __init__(self, cfg: VAEConfig = SD_VAE):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = conv1x1(cfg.embed_dim, cfg.z_channels)

    def decode(self, z):
        h = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        return h.permute(0, 2, 3, 1)
