"""GroupNorm(+SiLU) forward as CUDA kernels (``diff_foley_tpu/ops/pallas_groupnorm.py``).

Maps are NCHW, so each (sample, group) is one contiguous slab of
(C / G)·H·W elements.

- :func:`group_norm_block` launches ``csrc/groupnorm.cu::gn_block_kernel``,
  which replaces ``_gn_kernel`` (``_pallas_forward``): each slab held in
  the registers of a team of threads (a warp for a small slab, several
  slabs a block; a cluster of blocks for a slab too large for one block
  or too few slabs to fill the card), 16-byte loads and stores, one read
  and one write of x.
- :func:`group_norm_stream` launches ``gn_stream_stats_kernel`` and
  ``gn_stream_apply_kernel``, which replace ``_stream_stats_kernel`` and
  ``_stream_apply_kernel`` (``_streaming_forward``): partial (Σx, Σx²)
  per (sample, group, chunk), the tiny (B, G) fold to a per-(sample,
  channel) affine in torch (as JAX folds it in XLA), then y = x·a + b.
- :func:`fused_group_norm` picks one by size: a slab of more than
  ``BLOCK_SLAB_BYTES`` in x's type streams, any other runs the block
  kernel. :class:`FusedGroupNorm` is its ``custom_vjp``: the backward is
  autograd of the plain formula, as ``_bwd`` is the vjp of the XLA one,
  so a gradient launches no kernel.

Numerics (:func:`group_norm_reference`, the plain version): fp32
statistics with the fast variance max(E[x²] − E[x]², 0) as flax's
``_compute_stats`` clamps it, normalise, per-channel affine in fp32,
rounded to x's type; SiLU, when asked, acts on the rounded value (the
order of the shipped GroupNorm32: cast, then SiLU). γ and β are read in
their own dtype. Bound on the H100: bytes, 2·N·itemsize over 3.35 TB/s
for the block kernel and 3·N·itemsize for the streaming pair.

Each wrapper runs the plain version when its tensors lie on the CPU,
launches the kernel when they lie on a CUDA device, and raises otherwise.
``LAUNCHES`` counts the kernel launches of each wrapper,
``LAUNCHES_BY_DTYPE`` the same launches by (wrapper, operand dtype).
"""
from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .cuda_build import DTYPE_CODES as _DTYPE_CODES, ptr as _ptr, \
    stream as _stream

LAUNCHES = {"gn_block": 0, "gn_stream_stats": 0, "gn_stream_apply": 0}
LAUNCHES_BY_DTYPE = collections.Counter()   # {(wrapper, "bfloat16"): n}

# the block kernel holds a whole slab in registers; larger slabs stream
BLOCK_SLAB_BYTES = 128 * 1024
STREAM_CHUNK = 16384   # elements of a slab per stats block


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_DTYPE.clear()


def uses_stream(shape, groups: int, itemsize: int) -> bool:
    """The size rule: True when one (C / G, H, W) slab of an NCHW map is
    larger than the block kernel's shared-memory budget."""
    _, c, h, w = shape
    return (c // groups) * h * w * itemsize > BLOCK_SLAB_BYTES


# ---- plain versions --------------------------------------------------------

def _finish(y: torch.Tensor, dtype, act):
    y = y.to(dtype)
    return F.silu(y) if act == "silu" else y


def group_norm_reference(x, gamma, beta, groups: int, eps: float, act=None):
    """GroupNorm over an NCHW map, statistics in fp32, result in x's type
    (``pallas_groupnorm.py::_xla_group_norm`` on NCHW, its variance clamped
    at 0, SiLU after the cast)."""
    b, c = x.shape[:2]
    xs = x.float().reshape(b, groups, -1)
    mu = xs.mean(-1, keepdim=True)
    var = torch.clamp(xs.square().mean(-1, keepdim=True) - mu.square(),
                      min=0.0)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = ((xs - mu) * torch.rsqrt(var + eps)).reshape(x.shape) \
        * gamma.float().reshape(shape)
    return _finish(y + beta.float().reshape(shape), x.dtype, act)


def _chunks(n: int) -> int:
    return -(-n // STREAM_CHUNK)


def stream_stats_reference(x, groups: int):
    """(B, G, chunks, 2) fp32: Σx and Σx² over each ``STREAM_CHUNK``
    elements of each slab."""
    b = x.shape[0]
    xs = x.float().reshape(b, groups, -1)
    n = xs.shape[-1]
    k = _chunks(n)
    xs = F.pad(xs, (0, k * STREAM_CHUNK - n)).reshape(b, groups, k,
                                                      STREAM_CHUNK)
    return torch.stack([xs.sum(-1), xs.square().sum(-1)], dim=-1)


def stream_apply_reference(x, a, b, act=None):
    """y = x·a + b (+SiLU) with a and b (B, C) fp32, result in x's type."""
    shape = a.shape + (1,) * (x.dim() - 2)
    return _finish(x.float() * a.reshape(shape) + b.reshape(shape), x.dtype,
                   act)


def fold_stats(partial, gamma, beta, n: int, eps: float):
    """Partial sums (B, G, chunks, 2) of slabs of n elements → the
    per-(sample, channel) affine (a, b), fp32 (B, C): a = rstd·γ,
    b = β − mean·a."""
    sums = partial.sum(2)
    mean = sums[..., 0] / n
    var = torch.clamp(sums[..., 1] / n - mean.square(), min=0.0)
    cg = gamma.shape[0] // mean.shape[1]
    a = (torch.rsqrt(var + eps).repeat_interleave(cg, dim=1)
         * gamma.float()[None])
    return a, beta.float()[None] - mean.repeat_interleave(cg, dim=1) * a


# ---- kernel wrappers -------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    return cuda_build.on_cpu("GroupNorm", *tensors)


def _check(x, groups: int, *params):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be one of {list(_DTYPE_CODES)}, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NCHW map, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if groups < 1 or x.shape[1] % groups:
        raise ValueError(f"{x.shape[1]} channels do not split into {groups} "
                         f"groups")
    for p in params:
        if p.device != x.device or not p.is_contiguous():
            raise ValueError("parameters must be contiguous, on x's device")
        if p.dtype not in _DTYPE_CODES:
            raise TypeError(f"parameters must be one of {list(_DTYPE_CODES)}, "
                            f"got {p.dtype}")
        if p.shape != (x.shape[1],):
            raise ValueError(f"parameter {tuple(p.shape)} does not match "
                             f"{x.shape[1]} channels")


_ARGTYPES = {
    "dft_gn_block": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "dft_gn_stream_stats": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "dft_gn_stream_apply": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "dft_gn_silu_check": [ctypes.c_void_p] * 2,
}


def _launch(fn: str, key: str, *args, device, dtype):
    cuda_build.launch("groupnorm", fn, _ARGTYPES[fn], *args, device=device)
    LAUNCHES[key] += 1
    LAUNCHES_BY_DTYPE[(key, str(dtype).removeprefix("torch."))] += 1


def group_norm_block(x, gamma, beta, groups: int, eps: float, act=None):
    """GroupNorm(+SiLU) of an NCHW map, one launch over every (sample,
    group) slab, each held in registers."""
    if _on_cpu(x, gamma, beta):
        return group_norm_reference(x, gamma, beta, groups, eps, act)
    _check(x, groups, gamma, beta)
    if uses_stream(x.shape, groups, x.element_size()):
        raise ValueError(f"a slab of {tuple(x.shape)} over {groups} groups "
                         f"exceeds {BLOCK_SLAB_BYTES} bytes: stream it")
    b, c, h, w = x.shape
    y = torch.empty_like(x)
    _launch("dft_gn_block", "gn_block", _ptr(x), _ptr(gamma), _ptr(beta),
            _ptr(y), b, c, groups, h * w, float(eps), int(act == "silu"),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[gamma.dtype], _stream(x),
            device=x.device, dtype=x.dtype)
    return y


def stream_stats(x, groups: int):
    """Partial (Σx, Σx²), (B, G, chunks, 2) fp32, of each slab chunk."""
    if _on_cpu(x):
        return stream_stats_reference(x, groups)
    _check(x, groups)
    b, c, h, w = x.shape
    k = _chunks(c // groups * h * w)
    partial = torch.empty((b, groups, k, 2), dtype=torch.float32,
                          device=x.device)
    _launch("dft_gn_stream_stats", "gn_stream_stats", _ptr(x), _ptr(partial),
            b, c, groups, h * w, STREAM_CHUNK, _DTYPE_CODES[x.dtype],
            _stream(x), device=x.device, dtype=x.dtype)
    return partial


def stream_apply(x, a, b, act=None):
    """y = x·a + b (+SiLU) with the folded (B, C) fp32 affine."""
    if _on_cpu(x, a, b):
        return stream_apply_reference(x, a, b, act)
    _check(x, 1)
    rows = x.shape[0] * x.shape[1]
    for t in (a, b):
        if (t.dtype != torch.float32 or t.device != x.device
                or t.shape != x.shape[:2] or not t.is_contiguous()):
            raise ValueError(f"the affine must be contiguous fp32 "
                             f"{tuple(x.shape[:2])} on x's device")
    y = torch.empty_like(x)
    _launch("dft_gn_stream_apply", "gn_stream_apply", _ptr(x), _ptr(a),
            _ptr(b), _ptr(y), rows, x.shape[2] * x.shape[3],
            int(act == "silu"), _DTYPE_CODES[x.dtype], _stream(x),
            device=x.device, dtype=x.dtype)
    return y


def silu_division_check(device) -> tuple[int, int]:
    """The block kernel's branch-free SiLU division against ``__fdiv_rn``
    over every fp32 input f (divisor 1 + exp(−f)) on a CUDA device: (inputs
    where the two differ bit for bit, inputs in the branch-free range). The
    rest go through ``__fdiv_rn`` itself."""
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    cuda_build.launch("groupnorm", "dft_gn_silu_check",
                      _ARGTYPES["dft_gn_silu_check"], _ptr(counts),
                      _stream(counts), device=counts.device)
    off, taken = counts.tolist()
    return off, taken


def group_norm_stream(x, gamma, beta, groups: int, eps: float, act=None):
    """GroupNorm(+SiLU) in two sweeps: partial sums, the fold, the apply."""
    if not _on_cpu(x, gamma, beta):
        _check(x, groups, gamma, beta)
    partial = stream_stats(x, groups)
    n = x[0].numel() // groups
    a, b = fold_stats(partial, gamma, beta, n, eps)
    return stream_apply(x, a, b, act)


def _forward(x, gamma, beta, groups: int, eps: float, act):
    if uses_stream(x.shape, groups, x.element_size()):
        return group_norm_stream(x, gamma, beta, groups, eps, act)
    return group_norm_block(x, gamma, beta, groups, eps, act)


class FusedGroupNorm(torch.autograd.Function):
    """GroupNorm(+SiLU) with the forward kernels; the backward recomputes
    through the plain formula and launches no kernel."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups: int, eps: float, act):
        ctx.save_for_backward(x, gamma, beta)
        ctx.args = (groups, eps, act)
        return _forward(x, gamma, beta, groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
            y = group_norm_reference(*leaves, *ctx.args)
            wrt = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(y, wrt, g))
        return (*(next(grads) if n else None for n in need), None, None, None)


def fused_group_norm(x, gamma, beta, groups: int, eps: float, act=None):
    """GroupNorm→affine(→SiLU) of an NCHW map (``fused_group_norm``)."""
    return FusedGroupNorm.apply(x, gamma, beta, groups, eps, act)
