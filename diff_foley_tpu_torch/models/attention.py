"""Spatial transformer blocks of the UNets (``diff_foley_tpu/models/attention.py``).

SpatialTransformer: GroupNorm (ε 1e-6) → 1×1 proj_in → h·w tokens →
BasicTransformerBlock (self-attn → cross-attn → GEGLU feed-forward, each
pre-LayerNorm and residual) → 1×1 proj_out → + input. SpatialTransformer1D
is the same over an NCL sequence (the 1-D audio UNet), its 1×1
projections Conv1d. Attention runs on the packed (B, L, H·D) projections
through ``multi_head_attention_packed``.
With ``checkpoint`` each block runs under ``torch.utils.checkpoint`` while
gradients are on: its activations are recomputed in the backward, so its
attention forward runs twice a train step.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.attention import multi_head_attention_packed
from .layers import Conv1d, Dense, GroupNorm, LayerNorm, conv1x1


class CrossAttention(nn.Module):
    """Q from x, K and V from the context (x itself when None)."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = Dense(inner, query_dim)

    def forward(self, x, context=None):
        context = x if context is None else context
        out = multi_head_attention_packed(
            self.to_q(x), self.to_k(context), self.to_v(context), self.heads,
            scale=self.dim_head**-0.5)
        return self.to_out(out)


class GEGLU(nn.Module):
    """x·gelu(gate) with two projections and the exact (erf) GELU."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj_x = Dense(dim, dim_out)
        self.proj_gate = Dense(dim, dim_out)

    def forward(self, x):
        return self.proj_x(x) * F.gelu(self.proj_gate(x), approximate="none")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.geglu = GEGLU(dim, dim * mult)
        self.out = Dense(dim * mult, dim)

    def forward(self, x):
        return self.out(self.geglu(x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Token-space transformer over an NCHW map. ``context_dim`` is the
    width of the context it will be called with; None when it runs
    without one, whose cross-attention then reads the tokens themselves
    (flax infers attn2's key and value width from the first call)."""

    def __init__(self, channels: int, context_dim: int | None, heads: int,
                 dim_head: int, depth: int = 1, checkpoint: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.checkpoint = checkpoint
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = conv1x1(channels, inner)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block{i}", BasicTransformerBlock(
                inner, inner if context_dim is None else context_dim, heads,
                dim_head))
        self.proj_out = conv1x1(inner, channels)

    def forward(self, x, context=None):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x))
        inner = t.shape[1]
        t = t.reshape(b, inner, h * w).transpose(1, 2).contiguous()
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.checkpoint and torch.is_grad_enabled():
                t = torch.utils.checkpoint.checkpoint(block, t, context,
                                                      use_reentrant=False)
            else:
                t = block(t, context)
        # back to a contiguous NCHW map, as the GroupNorm kernels take them
        t = t.transpose(1, 2).reshape(b, inner, h, w).contiguous()
        return self.proj_out(t) + x


class SpatialTransformer1D(nn.Module):
    """Token-space transformer over an NCL sequence. ``context_dim`` is the
    width of the context it will be called with; None when it runs
    without one, whose cross-attention then reads the tokens themselves
    (flax infers attn2's key and value width from the first call)."""

    def __init__(self, channels: int, context_dim: int | None, heads: int,
                 dim_head: int, depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = Conv1d(channels, inner, 1)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block{i}", BasicTransformerBlock(
                inner, inner if context_dim is None else context_dim, heads,
                dim_head))
        self.proj_out = Conv1d(inner, channels, 1)

    def forward(self, x, context=None):
        # (B, L, inner) tokens: the blocks' Linear layers emit the packed
        # (B, L, H·D) projections the attention kernels read in place
        t = self.proj_in(self.norm(x)).transpose(1, 2).contiguous()
        for i in range(self.depth):
            t = getattr(self, f"block{i}")(t, context)
        return self.proj_out(t.transpose(1, 2).contiguous()) + x
