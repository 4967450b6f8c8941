"""The work of a kernel call, by formula, for ``utils/profiling.py``.

A kernel launched through ``ctypes`` is invisible to a dispatch-level
counter, and the plain version that stands in for it on the CPU is seen
op by op (some in fp64): a naive count would differ between the card and
the CPU. So each kernel wrapper is decorated with ``counted``: while a
counter is active (``utils.profiling.cost_analysis``), the call adds its
formula's work and runs with the counter hidden, on any device. The
formulas are ``chip_smoke.py``'s bound formulas:

- attention forward (kernels 1 and 3): 4·B·H·Lq·Lk·D operations (the two
  products, 2 a multiply-add), (2·Lq + 2·Lk)·B·H·D elements moved,
  B·H·Lq·Lk exponentials;
- attention backward (kernels 2 and 4): 8·B·H·Lq·Lk·D operations (the
  four products of the gradient; the recompute of the scores, which the
  bound counts as a fifth, is left out of a model's count),
  (3·Lq + 4·Lk)·B·H·D elements moved, B·H·Lq·Lk exponentials;
- GroupNorm (kernels 5 and 7; 6, the statistics): no product, x read once
  and y written once (the statistics: x read once), one sigmoid an
  element under SiLU.
"""
from __future__ import annotations

import functools

import torch

# the active counters, innermost last; each has ``add(flops, bytes,
# transcendentals)`` and a ``hidden`` depth
ACTIVE: list = []


def counted(work, plain):
    """Decorate a kernel wrapper: ``work(*args, **kwargs)`` gives its call's
    (flops, bytes, transcendentals). Under a counter, tensors on ``meta``
    (shapes only, as when a model is counted there) take ``plain``, the
    kernel's plain version with the wrapper's arguments, which gives the
    result's shape; elsewhere the wrapper refuses them."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not ACTIVE:
                return fn(*args, **kwargs)
            counter = ACTIVE[-1]
            if not counter.hidden:
                counter.add(*work(*args, **kwargs))
            on_meta = any(isinstance(a, torch.Tensor) and a.is_meta
                          for a in args)
            counter.hidden += 1
            try:
                return (plain if on_meta else fn)(*args, **kwargs)
            finally:
                counter.hidden -= 1
        return call
    return wrap


def attention_work(backward: bool, b: int, h: int, lq: int, lk: int, d: int,
                   itemsize: int) -> tuple:
    """(flops, bytes, transcendentals) of one attention call."""
    if backward:
        return (8 * b * h * lq * lk * d,
                (3 * lq + 4 * lk) * b * h * d * itemsize, b * h * lq * lk)
    return (4 * b * h * lq * lk * d, (2 * lq + 2 * lk) * b * h * d * itemsize,
            b * h * lq * lk)


def packed_work(backward: bool):
    """``attention_work`` of a packed (B, L, H·D) wrapper."""
    def work(q3, k3, v3, *rest):
        heads = rest[-1]
        b, lq, hd = q3.shape
        return attention_work(backward, b, heads, lq, k3.shape[1],
                              hd // heads, q3.element_size())
    return work


def per_head_work(backward: bool):
    """``attention_work`` of a (B, H, L, D) wrapper."""
    def work(q, k, v, *rest):
        b, h, lq, d = q.shape
        return attention_work(backward, b, h, lq, k.shape[2], d,
                              q.element_size())
    return work


def groupnorm_work(passes: int):
    """The GroupNorm wrappers' work over x: ``passes`` 2 (x read, y
    written: the block kernel and the apply) or 1 (the statistics)."""
    def work(x, *rest, act=None, **kwargs):
        act = act if act is not None else next(
            (a for a in rest if isinstance(a, str)), None)
        return (0, passes * x.numel() * x.element_size(),
                x.numel() if act == "silu" else 0)
    return work
