"""Mixed precision (``diff_foley_tpu/utils/precision.py``): bf16 compute
against float32 master weights and float32 norm statistics
(``GroupNorm32`` computes in float32 whatever its input), no loss scaler.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn as nn


def cast_floating(state: Dict[str, torch.Tensor],
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Dict[str, torch.Tensor]:
    """The floating tensors of a state dict in ``dtype``, the others as
    they are. The cast is differentiable: a gradient of the cast tensor
    lands on the float32 original."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in state.items()}


@contextlib.contextmanager
def swapped_parameters(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """``module``'s parameters named in ``tensors`` replaced by those
    tensors while the block runs, then restored. A backward run inside the
    block, with the recompute of a checkpointed block, sees the same
    tensors as the forward: bf16 casts of the float32 masters, whose
    gradients land on the masters, or an EMA shadow."""
    saved = []
    try:
        for name, t in tensors.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if leaf not in owner._parameters:
                raise KeyError(f"{name} is not a parameter of the module")
            saved.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = t
        yield module
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p
