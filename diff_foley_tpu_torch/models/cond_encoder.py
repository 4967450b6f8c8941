"""Conditioning bridge: CAVP video features → UNet cross-attention tokens
(``diff_foley_tpu/models/cond_encoder.py``).

- ``VideoFeatEncoderPosembed``: Linear(origin → embed) plus a learned
  positional embedding over the token axis (the shipped encoder).
- ``VideoFeatEncoderMLP`` (Linear → ReLU → Linear) and
  ``VideoFeatEncoderSimple`` (one Linear): the training repo's plain
  variants, no positions.
- ``VideoFeatEncoderPosembedAR``: the autoregressive variant. It embeds
  the video features and the previous window's spec latent, adds
  per-axis learned positions, and fuses them in ``FusionNet``: a
  ``TokenTransformerCond`` whose cross-attention reads the latent's h·w
  tokens, then a projection to the UNet's context width.

Every constructor takes its input widths explicitly (flax infers them at
the first call). The token transformer's attention runs on the packed
(B, L, H·D) projections through ``multi_head_attention_packed``: the
packed kernels at head dim 64 with the defaults (8 heads of 64).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import BasicTransformerBlock
from .layers import Dense, LayerNorm, conv1x1


class VideoFeatEncoderPosembed(nn.Module):
    def __init__(self, origin_dim: int = 512, embed_dim: int = 768,
                 seq_len: int = 40):
        super().__init__()
        self.embedder = Dense(origin_dim, embed_dim)
        self.pos_emb = nn.Parameter(torch.zeros(seq_len, embed_dim))

    def forward(self, x):
        x = self.embedder(x)
        return x + self.pos_emb[None, :x.shape[1]].to(x.dtype)


class VideoFeatEncoderMLP(nn.Module):
    """Video_Feat_Encoder: Linear → ReLU → Linear, no positions."""

    def __init__(self, origin_dim: int = 512, embed_dim: int = 768):
        super().__init__()
        self.embedder_0 = Dense(origin_dim, embed_dim)
        self.embedder_2 = Dense(embed_dim, embed_dim)

    def forward(self, x):
        return self.embedder_2(F.relu(self.embedder_0(x)))


class VideoFeatEncoderSimple(nn.Module):
    """Video_Feat_Encoder_simple: one Linear."""

    def __init__(self, origin_dim: int = 512, embed_dim: int = 768):
        super().__init__()
        self.embedder = Dense(origin_dim, embed_dim)

    def forward(self, x):
        return self.embedder(x)


class TokenTransformerCond(nn.Module):
    """SpatialTransformer_Cond over a (B, L, C) token sequence: LayerNorm
    over C (flax's ε 1e-6) → Linear to heads·dim_head → ``depth``
    BasicTransformerBlocks (cross-attention over ``context`` of width
    ``context_dim``, or over the tokens themselves when None) → Linear
    back to C, plus the input. The reference builds LayerNorm(inner), so
    it runs only where C equals heads·dim_head; the norm here, as the JAX
    module's, is over C and does not check."""

    def __init__(self, in_dim: int, context_dim: int | None = None,
                 heads: int = 8, dim_head: int = 64, depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = LayerNorm(in_dim)
        self.proj_in = Dense(in_dim, inner)
        for i in range(depth):
            setattr(self, f"block{i}", BasicTransformerBlock(
                inner, inner if context_dim is None else context_dim, heads,
                dim_head))
        self.proj_out = Dense(inner, in_dim)

    def forward(self, x, context=None):
        h = self.proj_in(self.norm(x))
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h, context)
        return self.proj_out(h) + x


class FusionNet(nn.Module):
    """Video tokens (B, L, video_dim) cross-attend the NHWC spec latent's
    h·w tokens (h-major, as the reference's permute(0, 2, 3, 1)
    .reshape(b, -1, c)), then Linear(video_dim → embed_dim)."""

    def __init__(self, video_dim: int, spec_dim: int, embed_dim: int,
                 depth: int = 2, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.fusion_module = TokenTransformerCond(video_dim, spec_dim, heads,
                                                  dim_head, depth)
        self.proj_out = Dense(video_dim, embed_dim)

    def forward(self, video_feat, spec_feat):
        b, h, w, c = spec_feat.shape
        tokens = spec_feat.reshape(b, h * w, c)
        return self.proj_out(self.fusion_module(video_feat, tokens))


class VideoFeatEncoderPosembedAR(nn.Module):
    """Video_Feat_Encoder_Posembed_AR: embeds the video features (Linear)
    and the previous window's NHWC spec latent (1×1 conv), adds learned
    positions (the spec's indexed by the latent's width and broadcast over
    its height) and fuses them in ``FusionNet``. Takes {"video_feat": (B,
    L, origin_dim), "spec_prev_z": (B, H, W, spec_channels)} → (B, L,
    embed_dim)."""

    def __init__(self, origin_dim: int = 512, spec_channels: int = 4,
                 hidden_dim: int = 512, embed_dim: int = 768, depth: int = 2,
                 seq_len: int = 215, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.embed_video_feat = Dense(origin_dim, hidden_dim)
        self.embed_spec_feat = conv1x1(spec_channels, hidden_dim)
        self.pos_emb_video = nn.Parameter(torch.zeros(seq_len, hidden_dim))
        self.pos_emb_spec = nn.Parameter(torch.zeros(seq_len, hidden_dim))
        self.fusion_net = FusionNet(hidden_dim, hidden_dim, embed_dim, depth,
                                    heads, dim_head)

    def forward(self, batch):
        video_feat, spec_prev_z = batch["video_feat"], batch["spec_prev_z"]
        w = spec_prev_z.shape[2]
        v = self.embed_video_feat(video_feat)
        # the 1×1 conv runs NCHW; back to NHWC before the tokens flatten
        s = self.embed_spec_feat(
            spec_prev_z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        v = v + self.pos_emb_video[None, :v.shape[1]].to(v.dtype)
        s = s + self.pos_emb_spec[None, None, :w].to(s.dtype)
        return self.fusion_net(v, s)
