"""The collectives GSPMD inserts implicitly in the JAX package, written out.

Each takes a process group; ``None`` (no process group, see
``distributed.py``) makes it the identity. They run on the tensors'
device through the group's backend, NCCL on the card and gloo on the
CPU; a tensor the backend cannot take raises.

The data-parallel convention: each rank's backward gives its rows'
contribution to the gradient of (data degree) × the global loss, and
``grad_mean_`` divides the summed contributions by the degree. A per-rank
mean loss gives that by itself; a loss computed on gathered features
(``all_gather_with_grad``) or normalised by cross-rank statistics
(``all_reduce_with_grad``) gives it through these functions' backwards.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

BUCKET_BYTES = 2**26


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0, in rank order; no
    gradient."""
    if group is None:
        return x
    x = x.detach().contiguous()
    out = x.new_empty((size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks (a new tensor); no gradient."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x / size(group)


class _AllGatherWithGrad(torch.autograd.Function):
    """Forward: the ranks' x concatenated along dim 0 in rank order.
    Backward: the incoming gradient summed over the ranks (each rank's
    loss reads every rank's rows), this rank's rows of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


def all_gather_with_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The gather of the JAX package's global-batch contrastive logits
    (``--gather-with-grad``): every rank's rows, differentiable."""
    if group is None:
        return x
    return _AllGatherWithGrad.apply(x, group)


class _AllReduceWithGrad(torch.autograd.Function):
    """Forward: x summed over the ranks. Backward: the incoming gradient
    summed over the ranks (each rank's sum feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_with_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks, differentiable (cross-rank BatchNorm's sums)."""
    if group is None:
        return x
    return _AllReduceWithGrad.apply(x, group)


@torch.no_grad()
def grad_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Each tensor's ``.grad`` replaced by its mean over the ranks, in
    buckets of at most ``BUCKET_BYTES`` a dtype (one all-reduce each)."""
    if group is None:
        return
    n = size(group)
    grads = [t.grad for t in tensors if t.grad is not None]
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        bucket, nbytes = [], 0
        for g in same + [None]:
            if g is not None and (not bucket or nbytes + g.numel()
                                  * g.element_size() <= BUCKET_BYTES):
                bucket.append(g)
                nbytes += g.numel() * g.element_size()
                continue
            if bucket:
                flat = _flatten_dense_tensors(bucket)
                dist.all_reduce(flat, group=group)
                flat.div_(n)
                for dst, src in zip(bucket,
                                    _unflatten_dense_tensors(flat, bucket)):
                    dst.copy_(src)
            bucket, nbytes = ([g], g.numel() * g.element_size()) \
                if g is not None else ([], 0)


def sync_batchnorm_(module: torch.nn.Module, group) -> None:
    """Every BatchNorm of ``module`` that has a ``process_group`` (the CAVP
    towers', the PatchGAN discriminator's) takes its train-mode statistics
    over ``group``."""
    for m in module.modules():
        if hasattr(m, "process_group"):
            m.process_group = group


class _CopyToModel(torch.autograd.Function):
    """Tensor parallelism's "copy to the model group": identity forward,
    the gradient summed over the model group backward (each rank's column
    shard reads the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Tensor parallelism's "reduce from the model group": the partial
    products summed over the model group forward, identity backward (every
    rank of the group continues with the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def sharded_global_norm(tensors: Sequence[torch.Tensor],
                        groups: Sequence[tuple]) -> torch.Tensor:
    """‖·‖₂ of tensors each split over the groups of its tuple (empty:
    whole on every rank, counted once): the squares of each leaf's shards
    all-reduced over its groups. With no group at all it is
    ``optim.global_norm``'s value."""
    from ..train.optim import global_norm

    if not any(groups):
        return global_norm(tensors)
    by_groups = {}
    for t, gs in zip(tensors, groups):
        by_groups.setdefault(tuple(gs), []).append(t)
    total = None
    for gs, ts in by_groups.items():
        sq = global_norm(ts).square()
        for g in gs:
            dist.all_reduce(sq, group=g)
        total = sq if total is None else total + sq
    return total.sqrt()
