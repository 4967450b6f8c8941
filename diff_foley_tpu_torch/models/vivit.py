"""ViViT, the factorised space-time video transformer
(``diff_foley_tpu/models/vivit.py``), the temporal CAVP video tower.

Patch embedding (LayerNorm → Linear → LayerNorm over each frame's
(p1 p2 c) patches), a learned (frame, patch) position embedding, a
spatial CLS token per frame, the spatial transformer over each frame's
tokens, the per-frame CLS tokens, then the temporal transformer (with a
temporal CLS token in ``ViViT``, none in ``ViViTMean``). ``ViViT`` returns
(clip CLS (B, dim), per-frame tokens (B, F, dim)); ``ViViTMean`` every
temporal token (B, F, dim).

The attention is plain tensor math, as the JAX module's einsums;
LayerNorm has flax's ε 1e-6 and GELU is the exact one. The free
parameters keep flax's names and shapes: ``pos_embedding`` (1, frames,
patches, dim), ``spatial_cls_token`` and ``temporal_cls_token``
(1, 1, dim). The position embedding's shape comes from the config
(``frames``, ``image_size``/``patch_size``): a clip of another geometry
does not fit it, as in the JAX module, whose shape comes from the init
input. Layout: video (B, T, H, W, 3).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cavp.layers import Linear, layer_norm


class ViTAttention(nn.Module):
    """Packed qkv without bias over heads·dim_head; an output projection
    unless one head of the model's width."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Linear(dim, 3 * inner, bias=False)
        self.to_out = (None if heads == 1 and dim_head == dim
                       else Linear(inner, dim))

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.dim_head ** -0.5,
                             dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        return out if self.to_out is None else self.to_out(out)


class ViTBlockStack(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: int = 64):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"attn{i}_norm", layer_norm(dim))
            setattr(self, f"attn{i}", ViTAttention(dim, heads, dim_head))
            setattr(self, f"ff{i}_norm", layer_norm(dim))
            setattr(self, f"ff{i}_in", Linear(dim, mlp_dim))
            setattr(self, f"ff{i}_out", Linear(mlp_dim, dim))

    def forward(self, x):
        for i in range(self.depth):
            h = getattr(self, f"attn{i}_norm")(x)
            x = x + getattr(self, f"attn{i}")(h)
            h = F.gelu(getattr(self, f"ff{i}_in")(
                getattr(self, f"ff{i}_norm")(x)))
            x = x + getattr(self, f"ff{i}_out")(h)
        return x


@dataclasses.dataclass(frozen=True)
class ViViTConfig:
    """The 'vivit_base' operating point."""

    image_size: int = 224
    patch_size: int = 32
    frames: int = 16
    dim: int = 768
    spatial_depth: int = 8
    temporal_depth: int = 4
    heads: int = 12
    mlp_dim: int = 3072
    dim_head: int = 64


class ViViTMean(nn.Module):
    """(B, F, H, W, 3) → every temporal token (B, F, dim)."""

    temporal_cls = False

    def __init__(self, cfg: ViViTConfig = ViViTConfig()):
        super().__init__()
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.dim
        patches = (cfg.image_size // p) ** 2
        self.patch_norm1 = layer_norm(p * p * 3)
        self.patch_proj = Linear(p * p * 3, d)
        self.patch_norm2 = layer_norm(d)
        self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.frames,
                                                      patches, d))
        self.spatial_cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.spatial_transformer = ViTBlockStack(
            d, cfg.spatial_depth, cfg.heads, cfg.mlp_dim, cfg.dim_head)
        if self.temporal_cls:
            self.temporal_cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.temporal_transformer = ViTBlockStack(
            d, cfg.temporal_depth, cfg.heads, cfg.mlp_dim, cfg.dim_head)

    def _embed(self, video):
        b, f, hh, ww, c = video.shape
        p = self.cfg.patch_size
        h, w = hh // p, ww // p
        # 'b (f pf) (h p1) (w p2) c -> b f (h w) (p1 p2 pf c)', pf = 1
        x = video.reshape(b, f, h, p, w, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        x = x.reshape(b, f, h * w, p * p * c)
        x = self.patch_norm2(self.patch_proj(self.patch_norm1(x)))
        return x + self.pos_embedding.to(x.dtype)

    def _space_then_time(self, x):
        b, f, n, d = x.shape
        cls_s = self.spatial_cls_token.to(x.dtype).expand(b, f, 1, d)
        x = torch.cat([cls_s, x], dim=2).reshape(b * f, n + 1, d)
        x = self.spatial_transformer(x).reshape(b, f, n + 1, d)[:, :, 0]
        if self.temporal_cls:
            cls_t = self.temporal_cls_token.to(x.dtype).expand(b, 1, d)
            x = torch.cat([cls_t, x], dim=1)
        return self.temporal_transformer(x)

    def forward(self, video):
        return self._space_then_time(self._embed(video))


class ViViT(ViViTMean):
    """(B, F, H, W, 3) → (clip CLS (B, dim), per-frame tokens (B, F, dim))."""

    temporal_cls = True

    def forward(self, video) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._space_then_time(self._embed(video))
        return x[:, 0], x[:, 1:]
