"""Multi-head attention entry points (``diff_foley_tpu/ops/attention.py``).

``multi_head_attention`` is the plain formula over (B, H, L, D); the VAE's
single-head mid attention uses it. ``multi_head_attention_packed`` takes
the packed (B, L, H·D) projections of every SpatialTransformer and goes
through :class:`~.hopper_attention.FlashAttentionPacked`: the CUDA kernels
for CUDA tensors, their plain versions for CPU tensors.
"""
from __future__ import annotations

import torch

from .hopper_attention import FlashAttentionPacked, attention_reference


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, L, D), softmax in fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return attention_reference(q, k, v, scale)


def multi_head_attention_packed(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int,
                                scale: float | None = None) -> torch.Tensor:
    """Attention over packed (B, L, H·D) projections, heads on the last axis."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    return FlashAttentionPacked.apply(q, k, v, scale, heads)
