"""Multi-head attention entry points (``diff_foley_tpu/ops/attention.py``).

``multi_head_attention`` takes (B, H, L, D) operands (the VAE's
single-head mid attention) to :func:`~.hopper_attention.attention_fwd`;
``multi_head_attention_packed`` takes the packed (B, L, H·D) projections of
every SpatialTransformer through
:class:`~.hopper_attention.FlashAttentionPacked`. Both launch the CUDA
kernels for CUDA tensors and run their plain versions for CPU tensors.
"""
from __future__ import annotations

import torch

from .hopper_attention import FlashAttentionPacked, attention_fwd


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, L, D), softmax in fp32.

    The per-head backward kernel (``_attn_bwd_kernel``) is not ported, so a
    gradient through CUDA operands raises rather than differentiate the
    plain formula on the card."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (q.is_cuda and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        raise NotImplementedError(
            "no CUDA backward for multi_head_attention: the per-head backward "
            "kernel (pallas_attention.py::_attn_bwd_kernel) is not ported")
    return attention_fwd(q, k, v, scale)


def multi_head_attention_packed(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int,
                                scale: float | None = None) -> torch.Tensor:
    """Attention over packed (B, L, H·D) projections, heads on the last axis."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    return FlashAttentionPacked.apply(q, k, v, scale, heads)
