"""Multi-head attention entry points (``diff_foley_tpu/ops/attention.py``).

``multi_head_attention`` takes (B, H, L, D) operands (the VAE's
single-head mid attention) through
:class:`~.hopper_attention.FlashAttention`;
``multi_head_attention_packed`` takes the packed (B, L, H·D) projections of
every SpatialTransformer through
:class:`~.hopper_attention.FlashAttentionPacked`. Both launch the CUDA
kernels for CUDA tensors and run their plain versions for CPU tensors.
"""
from __future__ import annotations

import torch

from .hopper_attention import FlashAttention, FlashAttentionPacked


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, L, D), softmax in fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, scale)


def multi_head_attention_packed(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int,
                                scale: float | None = None) -> torch.Tensor:
    """Attention over packed (B, L, H·D) projections, heads on the last axis."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    return FlashAttentionPacked.apply(q, k, v, scale, heads)
