"""Softmax attention as CUDA kernels: packed heads forward and backward,
and the per-head forward and backward.

Counterpart of ``diff_foley_tpu/ops/pallas_attention.py``. Packed operands
stay ``(B, L, H·D)``, exactly as the to_q/to_k/to_v Linear layers emit
them; the kernels read each head's D columns through strides, so no
transpose or copy surrounds a call.

- :func:`attention_packed_fwd` launches ``csrc/attention_fwd.cu``, which
  replaces ``_attn_packed_kernel`` (``_pallas_forward_packed``).
- :func:`attention_packed_bwd` launches ``csrc/attention_bwd.cu``, which
  replaces ``_attn_packed_bwd_kernel`` (``_pallas_backward_packed``): the
  per-head backward's three launches (``csrc/head_bwd.cuh``) over each
  head of the packed operands read as a strided (B, H, L, D) view.
- :class:`FlashAttentionPacked` is the ``custom_vjp`` of
  ``flash_attention_packed``: it saves exactly q, k and v.
- :func:`attention_fwd` launches ``csrc/attention_head_fwd.cu``, which
  replaces ``_attn_kernel`` (``_pallas_forward``, entry
  ``flash_attention``) over (B, H, L, D) operands of any dense strides: the
  VAE's single-head mid attention at D 512.
- :func:`attention_bwd` launches ``csrc/attention_head_bwd.cu``, which
  replaces ``_attn_bwd_kernel`` (``_pallas_backward``): dQ, dK and dV in
  q's, k's and v's strides, so the 1×1 convolutions behind them see
  contiguous NCHW gradients.
- :class:`FlashAttention` is the ``custom_vjp`` of ``flash_attention``: it
  saves exactly q, k and v.

Bound on the H100 (989 TFLOP/s bf16 tensor-core peak, 495/3 = 165
TFLOP/s for fp32-accurate 3xTF32 products, 3.35 TB/s): the forward does
4·B·Lq·Lk·H·D operations on (2·Lq + 2·Lk)·B·H·D operand elements, the
backward 10·B·Lq·Lk·H·D on (3·Lq + 4·Lk)·B·H·D. Against the card's ~295
bf16 operations per byte that makes the forward at Lq = Lk = 1024 (the
UNet's level-0 self-attention, the VAE's mid attention) and the VAE's
backward there operation-bound, and every other path shape, the packed
backward's included, byte-bound. The packed forward in bf16, the packed
backward and the per-head forward and backward run on the tensor cores
(mma.sync, 3xTF32 for fp32).

Each wrapper runs its kernel's plain version when its tensors lie on the
CPU, launches the kernel when they lie on a CUDA device, and raises
otherwise. Under ``utils.profiling.cost_analysis`` each call counts its
kernel's work by formula (``kernel_cost.py``), on any device. ``LAUNCHES`` counts the kernel launches of each wrapper,
``LAUNCHES_BY_DTYPE`` the same launches by (wrapper, operand dtype).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import cuda_build
from .kernel_cost import counted, packed_work, per_head_work
from .cuda_build import DTYPE_CODES as _DTYPE_CODES, ptr as _ptr, \
    stream as _stream

LAUNCHES = {"attn_packed_fwd": 0, "attn_packed_bwd": 0, "attn_fwd": 0,
            "attn_bwd": 0}
LAUNCHES_BY_DTYPE = collections.Counter()   # {(wrapper, "bfloat16"): n}

# the path's head dims; csrc/common.cuh::supported_head_dim, the packed
# entries take these only: the classifier's and EncoderUNetModel's 32, the
# UNet's 40/80/160, the 1-D audio UNet's 48/96, and the cond encoders'
# TokenTransformerCond's 64 (the AR encoder's 8 heads of 64)
_HEAD_DIMS = (32, 40, 48, 64, 80, 96, 160)
# the per-head kernel's: the SD VAE's mid attention (512), the spec
# decoder's of train/stage2_decode.py (256), the diffusion prior's (64),
# and EncoderUNetModel's attention pool and the tiny VAEs (ch 32) of
# chip_smoke.py's agreement runs (32)
_HEAD_DIMS_PER_HEAD = (32, 64, 256, 512)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_DTYPE.clear()


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, hd = t.shape
    return t.reshape(b, l, heads, hd // heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, d = t.shape
    return t.transpose(1, 2).reshape(b, l, h * d)


# ---- plain versions --------------------------------------------------------

def attention_reference(q, k, v, scale: float):
    """Softmax attention over (B, H, L, D): fp32 scores, softmax cast to the
    operand type, then P·V (``ops/attention.py::_xla_attention``). float64
    operands keep float64 throughout (an exact yardstick for fp32)."""
    ct = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct))
    weights = torch.softmax(logits * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def attention_backward_reference(q, k, v, g, scale: float):
    """Recompute backward over (B, H, L, D)
    (``pallas_attention.py::_xla_bwd``). Scores and softmax in fp32 for fp32
    and bf16 operands; float64 operands keep float64 throughout (an exact
    yardstick for fp32)."""
    ct = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * scale
    p = torch.softmax(logits, dim=-1)
    gv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype), g)
    gp = torch.einsum("bhqd,bhkd->bhqk", g, v).to(ct)
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
    return cuda_build.on_cpu("attention", *tensors)


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


_ENTRIES = {   # C entry: (csrc source, argument types)
    "dft_attn_packed_fwd": ("attention_fwd", [ctypes.c_void_p] * 4
                            + [ctypes.c_int] * 5
                            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "dft_attn_packed_bwd": ("attention_bwd", [ctypes.c_void_p] * 8
                            + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 16
                            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "dft_attn_fwd": ("attention_head_fwd", [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 16
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "dft_attn_bwd": ("attention_head_bwd", [ctypes.c_void_p] * 8
                     + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 16
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}


def _cp_async_ready(t: torch.Tensor) -> bool:
    """True when the kernels' 16-byte copies can read t in place: its
    address and each stride other than 1 (over an axis longer than 1) are
    multiples of 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s * size % 16 == 0 for s, n in zip(t.stride(), t.shape)
        if s != 1 and n > 1)


def _launch(fn: str, key: str, *args, device, dtype):
    name, argtypes = _ENTRIES[fn]
    cuda_build.launch(name, fn, argtypes, *args, device=device)
    LAUNCHES[key] += 1
    LAUNCHES_BY_DTYPE[(key, str(dtype).removeprefix("torch."))] += 1


@counted(packed_work(backward=False), attention_packed_reference)
def attention_packed_fwd(q3, k3, v3, scale: float, heads: int):
    """softmax(Q_h K_hᵀ·scale) V_h per head over packed (B, L, H·D)."""
    if _on_cpu(q3, k3, v3):
        return attention_packed_reference(q3, k3, v3, scale, heads)
    d = _check_packed(q3, k3, v3, heads)
    if q3.dtype == torch.bfloat16:
        # the tensor-core kernel copies 16-byte chunks: an operand that
        # starts off a 16-byte boundary is copied (its rows, H·D bf16 with
        # D a multiple of 8, keep the alignment)
        q3, k3, v3 = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (q3, k3, v3))
    b, lq, _ = q3.shape
    lk = k3.shape[1]
    o3 = torch.empty_like(q3)
    _launch("dft_attn_packed_fwd", "attn_packed_fwd", _ptr(q3), _ptr(k3),
            _ptr(v3), _ptr(o3), b, lq, lk, heads, d, float(scale),
            _DTYPE_CODES[q3.dtype], _stream(q3), device=q3.device,
            dtype=q3.dtype)
    return o3


def packed_head_strides(l: int, heads: int, d: int) -> tuple:
    """Strides (batch, head, row, column) of head h of a contiguous packed
    (B, L, H·D) operand read as (B, H, L, D): the strides of
    :func:`split_heads`' view, without making it."""
    return (l * heads * d, d, heads * d, 1)


@counted(packed_work(backward=True),
         attention_packed_backward_reference)
def attention_packed_bwd(q3, k3, v3, g3, scale: float, heads: int):
    """(dQ, dK, dV) of :func:`attention_packed_fwd` for output gradient g3,
    in the operand type and the packed layout. One call launches the
    per-head backward's three grids (scores, softmax rows, products) over
    the heads of the packed operands read in place through
    :func:`packed_head_strides`, with its scratch
    (:func:`head_bwd_scratch`). An operand that starts off a 16-byte
    boundary is copied first."""
    if _on_cpu(q3, k3, v3, g3):
        return attention_packed_backward_reference(q3, k3, v3, g3, scale,
                                                   heads)
    d = _check_packed(q3, k3, v3, heads, g3)
    if g3.shape != q3.shape:
        raise ValueError(f"g {tuple(g3.shape)} must match q {tuple(q3.shape)}")
    q3, k3, v3, g3 = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (q3, k3, v3, g3))
    b, lq, _ = q3.shape
    lk = k3.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q3, k3, v3))
    sq, sk = packed_head_strides(lq, heads, d), packed_head_strides(lk, heads,
                                                                    d)
    scratch = head_bwd_scratch(b, heads, lq, lk, q3.dtype, q3.device)
    _launch("dft_attn_packed_bwd", "attn_packed_bwd", _ptr(q3), _ptr(k3),
            _ptr(v3), _ptr(g3), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(scratch),
            b, heads, lq, lk, d, *sq, *sk, *sk, *sq, float(scale),
            _DTYPE_CODES[q3.dtype], _stream(q3), device=q3.device,
            dtype=q3.dtype)
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


def _dense_per_head(t: torch.Tensor) -> bool:
    """Row-major (B, H, L, D), or the token view of an NCHW map: D the
    slowest axis inside a head, L the fastest."""
    return t.is_contiguous() or t.transpose(2, 3).is_contiguous()


def _check_per_head(q, k, v) -> int:
    for t in (q, k, v):
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"operands must share one dtype of "
                            f"{list(_DTYPE_CODES)}, got {t.dtype}")
        if t.dim() != 4 or t.device != q.device:
            raise ValueError("operands must be (B, H, L, D) on one device")
        if not _dense_per_head(t):
            raise ValueError(f"operand strides {t.stride()} are neither "
                             f"(B, H, L, D) nor (B, H, D, L) dense")
    b, h, _, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} must match "
                         f"q {tuple(q.shape)} in B, H and D")
    if d not in _HEAD_DIMS_PER_HEAD:
        raise ValueError(f"head dim {d} is not one of {_HEAD_DIMS_PER_HEAD}")
    return d


def _empty_strided_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor with exactly t's strides (t is dense)."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device)


def scratch_ld(lk: int) -> int:
    """Row stride of the per-head kernels' score scratch: Lk rounded up to
    8 elements, so that every row starts 16-byte aligned."""
    return -(-lk // 8) * 8


def head_fwd_scratch(b: int, h: int, lq: int, lk: int,
                     device) -> torch.Tensor:
    """The per-head forward's scratch: S = Q·Kᵀ in fp32, (B·H, Lq,
    scratch_ld(Lk)); the row pass writes P̃ in the operand type over each
    row's own scores, so one size serves both types."""
    return torch.empty(b * h * lq * scratch_ld(lk), dtype=torch.float32,
                       device=device)


@counted(per_head_work(backward=False), attention_reference)
def attention_fwd(q, k, v, scale: float):
    """softmax(Q Kᵀ·scale) V per (batch, head) over (B, H, L, D), in q's
    strides. One call launches three grids: the scores S into a scratch,
    the softmax rows (P̃ over S), then P̃·V. An operand whose address or
    strides the 16-byte copies cannot take is made contiguous first (a q
    copied so gives a contiguous output)."""
    if _on_cpu(q, k, v):
        return attention_reference(q, k, v, scale)
    d = _check_per_head(q, k, v)
    q, k, v = (t if _cp_async_ready(t) else t.contiguous() for t in (q, k, v))
    b, h, lq, _ = q.shape
    o = _empty_strided_like(q)
    scratch = head_fwd_scratch(b, h, lq, k.shape[2], q.device)
    _launch("dft_attn_fwd", "attn_fwd", _ptr(q), _ptr(k), _ptr(v), _ptr(o),
            _ptr(scratch), b, h, lq, k.shape[2], d, *q.stride(), *k.stride(),
            *v.stride(), *o.stride(), float(scale), _DTYPE_CODES[q.dtype],
            _stream(q), device=q.device, dtype=q.dtype)
    return o


# csrc/head_bwd.cuh::fp64_backward: an fp32 backward over at most
# _FEW_QUERIES queries or under _SHALLOW_K keys runs in fp64
_FEW_QUERIES, _SHALLOW_K = 32, 8


def fp64_backward(dtype, lq: int, lk: int) -> bool:
    return dtype == torch.float32 and (lq <= _FEW_QUERIES or lk < _SHALLOW_K)


def head_bwd_scratch(b: int, h: int, lq: int, lk: int, dtype,
                     device) -> torch.Tensor:
    """The per-head backward's scratch as one fp32 buffer: S = Q·Kᵀ and
    dP = g·Vᵀ in fp32, then P̃ and dS in the operand type, each
    (B·H, Lq, scratch_ld(Lk)); for an fp32 call over few queries or keys
    (:func:`fp64_backward`) S, dP, P and dS in fp64."""
    plane = b * h * lq * scratch_ld(lk)
    per_entry = 32 if fp64_backward(dtype, lq, lk) else 8 + 2 * dtype.itemsize
    return torch.empty(plane * per_entry // 4, dtype=torch.float32,
                       device=device)


@counted(per_head_work(backward=True), attention_backward_reference)
def attention_bwd(q, k, v, g, scale: float):
    """(dQ, dK, dV) of :func:`attention_fwd` for output gradient g, in the
    operand type and in q's, k's and v's strides. One call launches three
    grids: the scores S and g·Vᵀ into a scratch, the softmax rows (P̃, dS),
    then the three products. A gradient that is dense in neither layout is
    made contiguous first, and so is an operand whose address or strides
    the 16-byte copies cannot take (its gradient then comes out
    contiguous)."""
    if _on_cpu(q, k, v, g):
        return attention_backward_reference(q, k, v, g, scale)
    d = _check_per_head(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype} on its device")
    if not _dense_per_head(g):
        g = g.contiguous()
    q, k, v, g = (t if _cp_async_ready(t) else t.contiguous()
                  for t in (q, k, v, g))
    b, h, lq, _ = q.shape
    dq, dk, dv = (_empty_strided_like(t) for t in (q, k, v))
    scratch = head_bwd_scratch(b, h, lq, k.shape[2], q.dtype, q.device)
    _launch("dft_attn_bwd", "attn_bwd", _ptr(q), _ptr(k), _ptr(v), _ptr(g),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(scratch), b, h, lq, k.shape[2],
            d, *q.stride(), *k.stride(), *v.stride(), *g.stride(),
            float(scale), _DTYPE_CODES[q.dtype], _stream(q), device=q.device,
            dtype=q.dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Per-head attention with the backward kernel as its gradient; saves
    q, k and v and recomputes the softmax in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return attention_fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = attention_bwd(*ctx.saved_tensors, g, ctx.scale)
        return dq, dk, dv, None
