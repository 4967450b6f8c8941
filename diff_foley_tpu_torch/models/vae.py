"""The SD first-stage AutoencoderKL, f=8 (``diff_foley_tpu/models/vae.py``):
quant_conv ∘ Encoder → DiagonalGaussian, and post_quant_conv → Decoder. A
(B, 128, 512, 3) mel image encodes to a (B, 16, 64, 4) latent and decodes
back (NHWC at the surface, NCHW inside).

The mid attention of the encoder and of the decoder is single-head over
h·w tokens (L 1024, D 512 at the shipped size), through
``multi_head_attention``: the per-head attention kernel on CUDA tensors.
Every GroupNorm is a ``GroupNorm32`` (ε 1e-6): the GroupNorm kernels.
Children are registered in the order the forward runs them.

The other first stages of the reference are here too: ``SimpleDecoder``,
``UpsampleDecoder`` and ``LatentRescaler`` (NHWC maps in and out, as the
JAX modules; contiguous NCHW inside; the rescaler's attention is the
VAE's, at the resized map's h·w tokens), and the pass-through
``IdentityFirstStage``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from ..parallel.mesh import draw_rows
from .layers import Conv2d, GroupNorm32, conv1x1, conv3x3


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


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
    double_z: bool = True


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
    """Single-head self-attention over the h·w tokens. The tokens are a
    (B, 1, h·w, C) view of the NCHW projections, read in place."""

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


class VAEDownsample(nn.Module):
    """taming's asymmetric pad (0, 1) on H and W, then a VALID stride-2
    3×3 conv (not a symmetric padding of 1)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = conv3x3(ch, ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig = SD_VAE):
        super().__init__()
        self.conv_in = conv3x3(cfg.in_channels, cfg.ch)
        self.plan = []
        ch = cfg.ch
        for level, mult in enumerate(cfg.ch_mult):
            out = cfg.ch * mult
            for i in range(cfg.num_res_blocks):
                name = f"down_{level}_block{i}"
                setattr(self, name, VAEResnetBlock(ch, out))
                self.plan.append(name)
                ch = out
            if level != len(cfg.ch_mult) - 1:
                setattr(self, f"down_{level}_ds", VAEDownsample(ch))
                self.plan.append(f"down_{level}_ds")
        self.mid_block1 = VAEResnetBlock(ch, ch)
        self.mid_attn = VAEAttnBlock(ch)
        self.mid_block2 = VAEResnetBlock(ch, ch)
        self.norm_out = _gn(ch, "silu")
        z = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = conv3x3(ch, z)

    def forward(self, x):
        h = self.conv_in(x)
        for name in self.plan:
            h = getattr(self, name)(h)
        h = self.mid_block2(self.mid_attn(self.mid_block1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    """``in_channels``: the channels of the maps it decodes (None: the
    config's ``z_channels``); flax's ``conv_in`` takes whatever its input
    has, as the spec decoder's 512-channel feature canvas."""

    def __init__(self, cfg: VAEConfig = SD_VAE, in_channels: int = None):
        super().__init__()
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = conv3x3(in_channels or cfg.z_channels, ch)
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


class SimpleDecoder(nn.Module):
    """1×1 conv → three ResnetBlocks (2×, 4×, 2× the input width) → 1×1
    conv → upsample → GN·SiLU → 3×3 conv out
    (stage1_autoencoder/model.py:666-699)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c = in_channels
        self.conv0 = conv1x1(c, c)
        self.res1 = VAEResnetBlock(c, 2 * c)
        self.res2 = VAEResnetBlock(2 * c, 4 * c)
        self.res3 = VAEResnetBlock(4 * c, 2 * c)
        self.conv4 = conv1x1(2 * c, c)
        self.upsample = VAEUpsample(c)
        self.norm_out = _gn(c, "silu")
        self.conv_out = conv3x3(c, out_channels)

    def forward(self, x):
        x = self.res3(self.res2(self.res1(self.conv0(_nchw(x)))))
        x = self.upsample(self.conv4(x))
        return self.conv_out(self.norm_out(x)).permute(0, 2, 3, 1)


class UpsampleDecoder(nn.Module):
    """Per level (num_res_blocks + 1) ResnetBlocks at ch·mult, an upsample
    between levels, then GN·SiLU → 3×3 conv out (model.py:702-747).
    ``in_channels``: the channels of the maps it decodes."""

    def __init__(self, in_channels: int, out_channels: int, ch: int,
                 num_res_blocks: int, ch_mult: Sequence[int] = (2, 2),
                 dropout: float = 0.0):
        super().__init__()
        if dropout > 0:
            raise NotImplementedError(
                f"VAE dropout {dropout}: the port runs the shipped rate 0")
        self.plan = []
        c = in_channels
        for level, mult in enumerate(ch_mult):
            for i in range(num_res_blocks + 1):
                setattr(self, f"res_{level}_{i}", VAEResnetBlock(c, ch * mult))
                self.plan.append(f"res_{level}_{i}")
                c = ch * mult
            if level != len(ch_mult) - 1:
                setattr(self, f"up_{level}", VAEUpsample(c))
                self.plan.append(f"up_{level}")
        self.norm_out = _gn(c, "silu")
        self.conv_out = conv3x3(c, out_channels)

    def forward(self, x):
        x = _nchw(x)
        for name in self.plan:
            x = getattr(self, name)(x)
        return self.conv_out(self.norm_out(x)).permute(0, 2, 3, 1)


class NearestResize(nn.Module):
    """Nearest resize of an NCHW map to (round(h·factor), round(w·factor))
    by torch's index rule, src = floor(dst · in/out)."""

    def __init__(self, factor: float):
        super().__init__()
        self.factor = factor

    def out_hw(self, h: int, w: int) -> tuple:
        return int(round(h * self.factor)), int(round(w * self.factor))

    def forward(self, x):
        return F.interpolate(x, size=self.out_hw(*x.shape[2:]),
                             mode="nearest")


class LatentRescaler(nn.Module):
    """3×3 conv in → ``depth`` ResnetBlocks → nearest resize by ``factor``
    → single-head attention over the resized map's tokens (kernels 3 and
    4 on the card) → ``depth`` ResnetBlocks → 1×1 conv out
    (model.py:750-780)."""

    def __init__(self, factor: float, in_channels: int, mid_channels: int,
                 out_channels: int, depth: int = 2):
        super().__init__()
        self.depth = depth
        self.conv_in = conv3x3(in_channels, mid_channels)
        for i in range(depth):
            setattr(self, f"res1_{i}", VAEResnetBlock(mid_channels,
                                                      mid_channels))
        self.resize = NearestResize(factor)
        self.attn = VAEAttnBlock(mid_channels)
        for i in range(depth):
            setattr(self, f"res2_{i}", VAEResnetBlock(mid_channels,
                                                      mid_channels))
        self.conv_out = conv1x1(mid_channels, out_channels)

    def forward(self, x):
        x = self.conv_in(_nchw(x))
        for i in range(self.depth):
            x = getattr(self, f"res1_{i}")(x)
        x = self.attn(self.resize(x).contiguous())
        for i in range(self.depth):
            x = getattr(self, f"res2_{i}")(x)
        return self.conv_out(x).permute(0, 2, 3, 1)


class IdentityFirstStage:
    """A pass-through first stage (models/autoencoder.py:426-441); with
    ``vq_interface`` its ``quantize`` returns (x, None, [None, None,
    None]) as a VQ model's does."""

    def __init__(self, vq_interface: bool = False):
        self.vq_interface = vq_interface

    def encode(self, x, *args, **kwargs):
        return x

    def decode(self, x, *args, **kwargs):
        return x

    def quantize(self, x, *args, **kwargs):
        if self.vq_interface:
            return x, None, [None, None, None]
        return x

    def __call__(self, x, *args, **kwargs):
        return x


class DiagonalGaussian:
    """The posterior N(mean, diag σ²) over NHWC latents, the log-variance
    clipped to [−30, 20]."""

    def __init__(self, params: torch.Tensor):
        self.mean, logvar = params.chunk(2, dim=-1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """mean + σ·ε, with ε drawn from ``generator`` or given as ``noise``
        (the mean's shape)."""
        if noise is None:
            noise = draw_rows(torch.randn, self.mean.shape,
                              generator=generator, dtype=self.mean.dtype,
                              device=self.mean.device)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: "DiagonalGaussian | None" = None) -> torch.Tensor:
        """KL to the standard normal, or to ``other``, summed over all but
        the batch axis."""
        dims = tuple(range(1, self.mean.dim()))
        if other is None:
            return 0.5 * torch.sum(
                self.mean**2 + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var + self.var / other.var
            - 1.0 - self.logvar + other.logvar, dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, self.mean.dim()))
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar
            + (sample - self.mean) ** 2 / self.var, dim=dims)


class AutoencoderKL(nn.Module):
    """The first stage: ``encode`` maps NHWC images to a posterior,
    ``decode`` NHWC latents to NHWC images, in the parameters' type. Maps
    are contiguous NCHW inside, as the GroupNorm kernels take them. It has
    no dropout (the shipped rate is 0), so train and eval modes agree."""

    def __init__(self, cfg: VAEConfig = SD_VAE):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        z = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.quant_conv = conv1x1(z, 2 * cfg.embed_dim)
        self.post_quant_conv = conv1x1(cfg.embed_dim, cfg.z_channels)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2).contiguous()))
        return DiagonalGaussian(h.permute(0, 2, 3, 1))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.decoder(self.post_quant_conv(
            z.permute(0, 3, 1, 2).contiguous()))
        return h.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                sample_posterior: bool = False,
                generator: torch.Generator | None = None):
        """(reconstruction, posterior) of NHWC images: decodes a posterior
        sample (``noise`` or ``generator`` gives its ε) or the mode."""
        posterior = self.encode(x)
        z = (posterior.sample(generator, noise) if sample_posterior
             else posterior.mode())
        return self.decode(z), posterior
