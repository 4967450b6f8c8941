"""The 1-D ε-prediction UNet over sound-VAE latents
(``diff_foley_tpu/models/audio_unet.py``).

The OpenAI UNet with every convolution 1-D, cross-attention through
:class:`~.attention.SpatialTransformer1D`, and an optional non-zero
initialisation of the attention's output projection (``use_zero_module``
False). Inputs and outputs are (B, L, C), as in the JAX package; the
layers run NCL. Each ``GroupNorm32`` normalises a (B, C, 1, L) view, so
the GroupNorm kernels take it as an NCHW map. Children carry the flax
scope names (``down_{level}_{i}_res``, ``up_{level}_us``, …) in the order
the forward runs them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..diffusion.schedule import timestep_embedding
from .attention import SpatialTransformer1D
from .layers import (Conv1d, Dense, Dropout, GroupNorm32, TimestepEmbedMLP,
                     init_weights_, run_plan, zero_init_)


def conv1d(in_ch: int, out_ch: int, kernel: int = 3,
           stride: int = 1) -> Conv1d:
    return Conv1d(in_ch, out_ch, kernel, stride, kernel // 2)


def group_norm_1d(norm: GroupNorm32, x: torch.Tensor) -> torch.Tensor:
    """A GroupNorm32 over an NCL sequence, as a (B, C, 1, L) map."""
    return norm(x[:, :, None]).squeeze(2)


class ResBlock1D(nn.Module):
    """Time-conditioned residual block over NCL: GN32·SiLU → conv → the
    time embedding added before (plain) or as a scale and shift after
    (``use_scale_shift_norm``) the second GN32 → SiLU → conv, plus the
    input (through a 1×1 conv when the width changes); ``dropout`` acts
    before the second conv."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 use_scale_shift_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(in_ch, act="silu")
        self.in_conv = conv1d(in_ch, out_ch)
        self.emb_dense = Dense(emb_dim,
                               2 * out_ch if use_scale_shift_norm else out_ch)
        self.out_norm = GroupNorm32(
            out_ch, act=None if use_scale_shift_norm else "silu")
        self.dropout = Dropout(dropout)
        self.out_conv = conv1d(out_ch, out_ch)
        self.skip_conv = Conv1d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, emb):
        h = self.in_conv(group_norm_1d(self.in_norm, x))
        emb_out = self.emb_dense(F.silu(emb))[:, :, None].to(h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(group_norm_1d(self.out_norm, h) * (1 + scale) + shift)
        else:
            h = group_norm_1d(self.out_norm, h + emb_out)
        h = self.out_conv(self.dropout(h))
        if self.skip_conv is not None:
            x = self.skip_conv(x)
        return x + h


class Upsample1D(Conv1d):
    """Nearest ×2, then a conv (kernel 3)."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, 1, 1)

    def forward(self, x):
        return super().forward(x.repeat_interleave(2, dim=2))


@dataclasses.dataclass(frozen=True)
class AudioUNetConfig:
    in_channels: int = 128
    model_channels: int = 192
    out_channels: int = 128
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (2, 4)
    channel_mult: Sequence[int] = (1, 2, 4)
    num_heads: int = 8
    # the context's width; None for a model called without one (flax
    # infers the cross-attention's key and value width from the first call)
    context_dim: Optional[int] = 768
    dropout: float = 0.0
    use_scale_shift_norm: bool = False
    use_zero_module: bool = True
    transformer_depth: int = 1


class AudioUNetModel(nn.Module):
    """(B, L, C) latents, (B,) times and (B, Lc, context_dim) tokens →
    (B, L, out_channels) float32."""

    def __init__(self, cfg: AudioUNetConfig = AudioUNetConfig()):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        emb_dim = 4 * mc
        self.time_embed = TimestepEmbedMLP(mc, emb_dim)
        self.in_conv = conv1d(cfg.in_channels, mc)
        self.plan = []   # (child name or None, kind), in the forward's order
        skip_ch = [mc]
        ch, ds = mc, 1

        def add(name, module, kind):
            setattr(self, name, module)
            self.plan.append((name, kind))

        def res(name, cin, cout):
            add(name, ResBlock1D(cin, cout, emb_dim,
                                 cfg.use_scale_shift_norm, cfg.dropout),
                "res")

        def attn(name, c):
            add(name, SpatialTransformer1D(
                c, cfg.context_dim, cfg.num_heads, c // cfg.num_heads,
                cfg.transformer_depth, cfg.dropout), "attn")

        for level, mult in enumerate(cfg.channel_mult):
            out = mult * mc
            for i in range(cfg.num_res_blocks):
                res(f"down_{level}_{i}_res", ch, out)
                ch = out
                if ds in cfg.attention_resolutions:
                    attn(f"down_{level}_{i}_attn", ch)
                self.plan.append((None, "push"))
                skip_ch.append(ch)
            if level != len(cfg.channel_mult) - 1:
                add(f"down_{level}_ds", conv1d(ch, ch, stride=2), "plain")
                self.plan.append((None, "push"))
                skip_ch.append(ch)
                ds *= 2
        res("mid_res1", ch, ch)
        attn("mid_attn", ch)
        res("mid_res2", ch, ch)
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            out = mult * mc
            for i in range(cfg.num_res_blocks + 1):
                self.plan.append((None, "cat"))
                res(f"up_{level}_{i}_res", ch + skip_ch.pop(), out)
                ch = out
                if ds in cfg.attention_resolutions:
                    attn(f"up_{level}_{i}_attn", ch)
                if i == cfg.num_res_blocks and level != 0:
                    add(f"up_{level}_us", Upsample1D(ch), "plain")
                    ds //= 2
        self.out_norm = GroupNorm32(ch, act="silu")
        self.out_conv = conv1d(ch, cfg.out_channels)

    def forward(self, x, timesteps, context=None):
        emb = self.time_embed(timestep_embedding(timesteps,
                                                 self.cfg.model_channels))
        h = self.in_conv(x.transpose(1, 2).contiguous())
        hs = [h]
        h = run_plan(self, self.plan, h, emb, context, hs)
        assert not hs
        h = self.out_conv(group_norm_1d(self.out_norm, h))
        return h.float().transpose(1, 2)


@torch.no_grad()
def init_audio_unet_weights_(model: AudioUNetModel,
                             generator: torch.Generator) -> AudioUNetModel:
    """flax's initialisation, drawn on the generator's device: lecun-normal
    kernels, zero biases, unit scales, and zeros in the layers the JAX
    model zero-inits (each ResBlock1D's ``out_conv``; with
    ``use_zero_module`` each SpatialTransformer1D's ``proj_out`` and the
    model's ``out_conv``)."""
    init_weights_(model, generator)
    zero_init_(model, ResBlock1D,
               SpatialTransformer1D if model.cfg.use_zero_module else ())
    if model.cfg.use_zero_module:
        model.out_conv.weight.zero_()
    return model
