"""Shared building blocks of the model zoo (``diff_foley_tpu/models/layers.py``).

Activations are NCHW inside the models. Dense and Conv promote their input
and parameters to a common dtype before the product, as flax does, so a
float32 input meets bf16 weights in float32 (the UNet's timestep MLP) and a
bf16 input meets bf16 weights in bf16.

Normalisations follow flax's formula: statistics in float32 with the fast
variance max(0, E[x²] − E[x]²), y = (x − μ)·(rsqrt(σ² + ε)·scale) + bias,
result in the promoted type of input and parameters. ``GroupNorm32`` goes
through ``ops/hopper_groupnorm.py::fused_group_norm``: the GroupNorm
kernels on CUDA tensors, their plain versions on CPU tensors.

``Dropout`` is flax's: the identity unless a generator is given by
``dropout_draws`` (the JAX package's ``deterministic=False`` with the
step's dropout key), and then keep with probability 1 − rate, scaled by
1 / (1 − rate).
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.hopper_groupnorm import fused_group_norm
from ..parallel.mesh import draw_rows

_DROPOUT_GENERATOR = contextvars.ContextVar("dropout_generator",
                                            default=None)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


@contextlib.contextmanager
def dropout_draws(generator: torch.Generator | None):
    """Inside the block every ``Dropout`` of rate > 0 draws its keep mask
    from ``generator``, in the order the forward runs them; with None, or
    outside any block, dropout is the identity."""
    token = _DROPOUT_GENERATOR.set(generator)
    try:
        yield
    finally:
        _DROPOUT_GENERATOR.reset(token)


def dropout_generator() -> torch.Generator | None:
    """The generator of the innermost ``dropout_draws`` block, or None."""
    return _DROPOUT_GENERATOR.get()


class Dropout(nn.Module):
    """flax nn.Dropout: keep = U[0, 1) < 1 − rate, drawn over the whole
    tensor (the global batch's rows under ``parallel.mesh.global_rows``),
    then x / (1 − rate) where kept and 0 elsewhere, in x's dtype."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        gen = _DROPOUT_GENERATOR.get()
        if gen is None or self.rate == 0:
            return x
        if self.rate >= 1:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.rate
        keep = draw_rows(torch.rand, x.shape, generator=gen,
                         device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisation: lecun-normal kernels (σ² = 1 / fan-in),
    zero biases and unit scales (the modules' construction values); drawn
    on the generator's device."""
    for name, p in module.named_parameters():
        if name.endswith("weight") and p.dim() >= 2:
            std = 1.0 / math.sqrt(p[0].numel())
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * std)
    return module


@torch.no_grad()
def zero_init_(model: nn.Module, resblocks, transformers=()) -> None:
    """Zero the layers the JAX models wrap in ``zero_module``: the
    ``out_conv`` of each submodule of a type in ``resblocks`` and the
    ``proj_out`` of each of a type in ``transformers``."""
    for m in model.modules():
        if isinstance(m, resblocks):
            m.out_conv.weight.zero_()
        elif isinstance(m, transformers):
            m.proj_out.weight.zero_()


def _promote(x: torch.Tensor, *params) -> torch.dtype:
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return dt


def _cast(p, dt):
    return None if p is None else p.to(dt)


class Dense(nn.Module):
    """flax nn.Dense: weight (out, in), optional bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        dt = _promote(x, self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Module):
    """flax nn.Conv over NCHW maps: weight OIHW, symmetric padding,
    optional bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x):
        dt = _promote(x, self.weight, self.bias)
        return F.conv2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                        self.stride, self.padding)


class Conv1d(nn.Module):
    """flax nn.Conv over NCL sequences: weight (out, in, K), symmetric
    padding, bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        dt = _promote(x, self.weight, self.bias)
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


def conv3x3(in_ch: int, out_ch: int) -> Conv2d:
    return Conv2d(in_ch, out_ch, 3, padding=1)


def conv1x1(in_ch: int, out_ch: int) -> Conv2d:
    return Conv2d(in_ch, out_ch, 1)


def flax_norm(x: torch.Tensor, weight, bias, eps: float,
              groups: int | None = None) -> torch.Tensor:
    """flax GroupNorm (``groups`` over dim 1 of an N, C, ... tensor) or
    LayerNorm (``groups=None``, over the last dim)."""
    out_dtype = _promote(x, weight, bias)
    xf = x.float()
    if groups is None:
        dims, shape = (-1,), (-1,)
        xs = xf
    else:
        b, c = x.shape[:2]
        xs = xf.reshape(b, groups, -1)
        dims, shape = (-1,), (1, c) + (1,) * (x.dim() - 2)
    mu = xs.mean(dims, keepdim=True)
    var = torch.clamp(xs.square().mean(dims, keepdim=True) - mu.square(),
                      min=0.0)
    rstd = torch.rsqrt(var + eps)
    if groups is None:
        y = (xf - mu) * (rstd * weight.float())
    else:
        y = ((xs - mu) * rstd).reshape(x.shape) * weight.float().reshape(shape)
    return (y + bias.float().reshape(shape)).to(out_dtype)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm(32 groups)."""

    def __init__(self, channels: int, eps: float, groups: int = 32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps, self.groups = eps, groups

    def forward(self, x):
        return flax_norm(x, self.weight, self.bias, self.eps, self.groups)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: ε 1e-6 by default (torch's is 1e-5)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        return flax_norm(x, self.weight, self.bias, self.eps)


class GroupNorm32(GroupNorm):
    """GroupNorm in float32 whatever the activation type, cast back, with
    the caller's SiLU folded in (``act="silu"``, applied after the cast).
    γ and β are read in their own type."""

    def __init__(self, channels: int, eps: float = 1e-5, act: str | None = None):
        super().__init__(channels, eps)
        self.act = act

    def forward(self, x):
        return fused_group_norm(x, self.weight, self.bias, self.groups,
                                self.eps, self.act)


class TimestepEmbedMLP(nn.Module):
    """model_channels → 4·model_channels SiLU MLP."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.dense0 = Dense(in_dim, embed_dim)
        self.dense1 = Dense(embed_dim, embed_dim)

    def forward(self, t_emb):
        return self.dense1(F.silu(self.dense0(t_emb)))


class Upsample(nn.Module):
    """Nearest ×2 upsample, then a 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    """Stride-2 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class ResBlock(nn.Module):
    """Time-conditioned residual block:
    GN32·SiLU → conv3x3 → + Dense(SiLU(emb)) → GN32·SiLU → conv3x3, plus
    the input (through a 1×1 conv when the width changes).

    ``pos_seq_len`` > 0 adds a learned positional embedding over the map's
    W axis (the time axis of a mel latent) after the time embedding, as
    the openai_unetmodel_pos.py variant does; a map wider than
    ``pos_seq_len`` raises. ``dropout`` acts between the second GN·SiLU
    and its conv."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 pos_seq_len: int = 0, dropout: float = 0.0):
        super().__init__()
        self.in_norm = GroupNorm32(in_ch, act="silu")
        self.in_conv = conv3x3(in_ch, out_ch)
        self.emb_dense = Dense(emb_dim, out_ch)
        self.pos_emb = (nn.Embedding(pos_seq_len, out_ch) if pos_seq_len > 0
                        else None)
        self.out_norm = GroupNorm32(out_ch, act="silu")
        self.dropout = Dropout(dropout)
        self.out_conv = conv3x3(out_ch, out_ch)
        self.skip_conv = conv1x1(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x, emb):
        h = self.in_conv(self.in_norm(x))
        h = h + self.emb_dense(F.silu(emb))[:, :, None, None].to(h.dtype)
        if self.pos_emb is not None:
            w, n = h.shape[3], self.pos_emb.num_embeddings
            if w > n:
                raise ValueError(f"feature width {w} exceeds pos_seq_len {n}")
            h = h + self.pos_emb.weight[:w].T[None, :, None, :].to(h.dtype)
        h = self.out_conv(self.dropout(self.out_norm(h)))
        if self.skip_conv is not None:
            x = self.skip_conv(x)
        return x + h


def run_plan(model: nn.Module, plan, h, emb, context, hs: list):
    """Run a UNet's flat plan of (child name, kind) steps over h: "push"
    saves the current map for a skip, "cat" joins the last saved one on
    the channels, "res" calls a ResBlock with the time embedding, "attn" a
    SpatialTransformer with the context, any other kind the child alone."""
    for name, kind in plan:
        if kind == "push":
            hs.append(h)
        elif kind == "cat":
            h = torch.cat([h, hs.pop()], dim=1)
        elif kind == "res":
            h = getattr(model, name)(h, emb)
        elif kind == "attn":
            h = getattr(model, name)(h, context)
        else:
            h = getattr(model, name)(h)
    return h
