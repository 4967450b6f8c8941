"""Conditioning bridge: CAVP video features → UNet cross-attention tokens
(``diff_foley_tpu/models/cond_encoder.py``): Linear(origin → embed) plus a
learned positional embedding over the token axis."""
from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Dense


class VideoFeatEncoderPosembed(nn.Module):
    def __init__(self, origin_dim: int = 512, embed_dim: int = 768,
                 seq_len: int = 40):
        super().__init__()
        self.embedder = Dense(origin_dim, embed_dim)
        self.pos_emb = nn.Parameter(torch.zeros(seq_len, embed_dim))

    def forward(self, x):
        x = self.embedder(x)
        return x + self.pos_emb[None, :x.shape[1]].to(x.dtype)
