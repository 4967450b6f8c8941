"""Packed-heads softmax attention, forward and backward, as CUDA kernels.

Counterpart of ``diff_foley_tpu/ops/pallas_attention.py``'s packed-heads
kernels. Operands stay packed ``(B, L, H·D)``, exactly as the to_q/to_k/to_v
Linear layers emit them; the kernels read each head's D columns through
strides, so no transpose or copy surrounds a call.

- :func:`attention_packed_fwd` launches ``csrc/attention_fwd.cu``, which
  replaces ``_attn_packed_kernel`` (``_pallas_forward_packed``).
- :func:`attention_packed_bwd` launches ``csrc/attention_bwd.cu``, which
  replaces ``_attn_packed_bwd_kernel`` (``_pallas_backward_packed``).
- :class:`FlashAttentionPacked` is the ``custom_vjp`` of
  ``flash_attention_packed``: it saves exactly q, k and v.

Bound on the H100 (989 TFLOP/s bf16 tensor-core peak, 3.35 TB/s): the
forward does 4·B·Lq·Lk·H·D operations on (2·Lq + 2·Lk)·B·H·D operand
elements, the backward 10·B·Lq·Lk·H·D on (3·Lq + 4·Lk)·B·H·D. Against
the card's ~295 bf16 operations per byte that makes the forward at
Lq = Lk = 1024 (the UNet's level-0 self-attention) operation-bound, and
every other path shape, and every backward shape, byte-bound. These first
kernels use fp32 FMAs from shared memory; tensor-core tiles are later work.

Each wrapper runs its kernel's plain version when its tensors lie on the
CPU, launches the kernel when they lie on a CUDA device, and raises
otherwise. ``LAUNCHES`` counts the kernel launches of each wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

LAUNCHES = {"attn_packed_fwd": 0, "attn_packed_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the path's head dims; csrc/attention_common.cuh instantiates these only
_HEAD_DIMS = (32, 40, 80, 160)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, hd = t.shape
    return t.reshape(b, l, heads, hd // heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, d = t.shape
    return t.transpose(1, 2).reshape(b, l, h * d)


# ---- plain versions --------------------------------------------------------

def attention_reference(q, k, v, scale: float):
    """Softmax attention over (B, H, L, D): fp32 scores, softmax cast to the
    operand type, then P·V (``ops/attention.py::_xla_attention``)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    weights = torch.softmax(logits * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def attention_backward_reference(q, k, v, g, scale: float):
    """Recompute backward over (B, H, L, D) (``pallas_attention.py::_xla_bwd``)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(logits, dim=-1)
    gv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype), g)
    gp = torch.einsum("bhqd,bhkd->bhqk", g, v).float()
    ds = (p * (gp - (gp * p).sum(-1, keepdim=True))).to(q.dtype)
    gq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    gk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return gq, gk, gv


def attention_packed_reference(q3, k3, v3, scale: float, heads: int):
    return merge_heads(attention_reference(
        split_heads(q3, heads), split_heads(k3, heads),
        split_heads(v3, heads), scale))


def attention_packed_backward_reference(q3, k3, v3, g3, scale: float,
                                        heads: int):
    grads = attention_backward_reference(
        split_heads(q3, heads), split_heads(k3, heads),
        split_heads(v3, heads), split_heads(g3, heads), scale)
    return tuple(merge_heads(t) for t in grads)


# ---- kernel wrappers -------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"attention operands must all lie on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")


def _check_packed(q3, k3, v3, heads: int, *extra) -> int:
    for t in (q3, k3, v3, *extra):
        if t.dtype not in _DTYPE_CODES or t.dtype != q3.dtype:
            raise TypeError(f"operands must share one dtype of "
                            f"{list(_DTYPE_CODES)}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.dim() != 3 or t.device != q3.device:
            raise ValueError("operands must be (B, L, H·D) on one device")
    b, lq, hd = q3.shape
    if k3.shape != v3.shape or k3.shape[0] != b or k3.shape[2] != hd:
        raise ValueError(f"k {tuple(k3.shape)} / v {tuple(v3.shape)} do not "
                         f"match q {tuple(q3.shape)}")
    if hd % heads or hd // heads not in _HEAD_DIMS:
        raise ValueError(f"H·D={hd} does not split into {heads} heads of "
                         f"a dim in {_HEAD_DIMS}")
    return hd // heads


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _lib(name: str, fn: str, n_ptrs: int):
    lib = cuda_build.load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def attention_packed_fwd(q3, k3, v3, scale: float, heads: int):
    """softmax(Q_h K_hᵀ·scale) V_h per head over packed (B, L, H·D)."""
    if _on_cpu(q3, k3, v3):
        return attention_packed_reference(q3, k3, v3, scale, heads)
    d = _check_packed(q3, k3, v3, heads)
    b, lq, _ = q3.shape
    lk = k3.shape[1]
    o3 = torch.empty_like(q3)
    fn = _lib("attention_fwd", "dft_attn_packed_fwd", 4)
    with torch.cuda.device(q3.device):
        err = fn(_ptr(q3), _ptr(k3), _ptr(v3), _ptr(o3), b, lq, lk, heads, d,
                 float(scale), _DTYPE_CODES[q3.dtype], _stream(q3))
    if err:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {err}")
    LAUNCHES["attn_packed_fwd"] += 1
    return o3


def attention_packed_bwd(q3, k3, v3, g3, scale: float, heads: int):
    """(dQ, dK, dV) of :func:`attention_packed_fwd` for output gradient g3,
    in the operand type. One call launches two grids: dQ per query tile,
    then dK/dV per key tile."""
    if _on_cpu(q3, k3, v3, g3):
        return attention_packed_backward_reference(q3, k3, v3, g3, scale,
                                                   heads)
    d = _check_packed(q3, k3, v3, heads, g3)
    if g3.shape != q3.shape:
        raise ValueError(f"g {tuple(g3.shape)} must match q {tuple(q3.shape)}")
    b, lq, _ = q3.shape
    lk = k3.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q3, k3, v3))
    stats = torch.empty((3, b, heads, lq), dtype=torch.float32,
                        device=q3.device)
    fn = _lib("attention_bwd", "dft_attn_packed_bwd", 8)
    with torch.cuda.device(q3.device):
        err = fn(_ptr(q3), _ptr(k3), _ptr(v3), _ptr(g3), _ptr(dq), _ptr(dk),
                 _ptr(dv), _ptr(stats), b, lq, lk, heads, d, float(scale),
                 _DTYPE_CODES[q3.dtype], _stream(q3))
    if err:
        raise RuntimeError(f"attention_bwd launch failed: cudaError {err}")
    LAUNCHES["attn_packed_bwd"] += 1
    return dq, dk, dv


class FlashAttentionPacked(torch.autograd.Function):
    """Packed attention with the backward kernel as its gradient; saves
    q, k and v and recomputes the softmax in the backward."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale: float, heads: int):
        ctx.save_for_backward(q3, k3, v3)
        ctx.scale, ctx.heads = scale, heads
        return attention_packed_fwd(q3, k3, v3, scale, heads)

    @staticmethod
    def backward(ctx, g3):
        q3, k3, v3 = ctx.saved_tensors
        dq, dk, dv = attention_packed_bwd(q3, k3, v3, g3.contiguous(),
                                          ctx.scale, ctx.heads)
        return dq, dk, dv, None, None
