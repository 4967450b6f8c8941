"""The CAVP towers' layers with flax's semantics.

- ``BatchNorm1d``/``BatchNorm2d``/``BatchNorm3d``: flax ``nn.BatchNorm`` (eps 1e-5,
  ``momentum=0.9``, which is torch's ``momentum=0.1``). In train mode
  they normalise with the batch statistics and update the running mean and
  variance, the variance with the *biased* batch variance, as flax does
  (torch's own update takes the unbiased one). The statistics stay float32
  whatever the activation type. ``frozen_statistics`` runs train-mode
  normalisation without the update. With a ``process_group`` of more than
  one rank (``parallel.collectives.sync_batchnorm_``) the train-mode
  statistics are the group's: Σx, Σx² and the count all-reduced, flax's
  fast variance E[x²] − E[x]² as its ``axis_name`` path takes it, and the
  normalisation written out in elementwise products, so its backward is
  autograd's of those products and the all-reduce's (never
  ``F.batch_norm``'s: torch.nn.SyncBatchNorm refuses CPU tensors).
- ``layer_norm``: flax ``nn.LayerNorm`` (ε 1e-6), for the ViT towers.
- ``Conv1d``/``Conv2d``/``Conv3d``/``Linear``: their parameters cast to the
  activation's type in the forward, a differentiable cast (flax's
  ``dtype``): bf16 activations run bf16 products whose gradients land on
  the float32 parameters.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel import collectives


class _FlaxStatistics:
    update_statistics = True
    process_group = None

    def forward(self, x):
        if self.training and collectives.size(self.process_group) > 1:
            return self._group_forward(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if not self.update_statistics:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        # the update lands in copies: autograd holds the tensors it was
        # given, and the buffers may not change under it
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            # torch added momentum·(n / (n − 1))·var: rescale that part to
            # the biased variance
            kept = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
            self.running_mean.copy_(mean)
        return y

    def _group_forward(self, x):
        dims = [0, *range(2, x.dim())]
        xf = x if x.dtype == torch.float64 else x.float()
        s1 = xf.sum(dims)
        local = torch.stack([s1, xf.square().sum(dims),
                             torch.full_like(s1, x.numel() // x.shape[1])])
        s1, s2, n = collectives.all_reduce_with_grad(local,
                                                     self.process_group)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean.square(), min=0.0)
        if self.update_statistics:
            with torch.no_grad():
                m = self.momentum   # torch's convention: 1 − flax's
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
        return y.to(x.dtype)


class BatchNorm1d(_FlaxStatistics, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxStatistics, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxStatistics, nn.BatchNorm3d):
    pass


@contextlib.contextmanager
def frozen_statistics(module: nn.Module):
    """Inside the block, train-mode BatchNorms of ``module`` normalise with
    the batch statistics but leave their running statistics as they are."""
    norms = [m for m in module.modules() if isinstance(m, _FlaxStatistics)]
    try:
        for m in norms:
            m.update_statistics = False
        yield module
    finally:
        for m in norms:
            del m.update_statistics


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None
                                  if self.bias is None
                                  else self.bias.to(x.dtype))


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None
                                  if self.bias is None
                                  else self.bias.to(x.dtype))


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), None
                        if self.bias is None else self.bias.to(x.dtype))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None
                                  if self.bias is None
                                  else self.bias.to(x.dtype))


def layer_norm(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=1e-6)   # flax's ε
