"""Exponential moving average of the trained parameters
(``diff_foley_tpu/utils/ema.py``): the reference's LitEma, decay
min(decay, (1 + n)/(10 + n)) at the n-th update, a shadow copy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    """The shadow parameters by name, and the updates taken."""

    params: Dict[str, torch.Tensor]
    num_updates: int = 0


def ema_init(params: Dict[str, torch.Tensor]) -> EmaState:
    """A copy of ``params``, never an alias: the shadow must not move with
    the parameters it follows."""
    return EmaState({k: v.detach().clone() for k, v in params.items()}, 0)


@torch.no_grad()
def ema_update(state: EmaState, new_params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> EmaState:
    """One update, in place on ``state``'s tensors: e ← e − (1 − d)·(e − p)
    with d = min(decay, (1 + n)/(10 + n)) in float32, n the updates taken
    so far plus one. Each shadow keeps its dtype."""
    n = state.num_updates + 1
    d = min(np.float32(decay), np.float32(1 + n) / np.float32(10 + n))
    one_minus = float(np.float32(1.0) - d)
    same = [(e, new_params[k]) for k, e in state.params.items()
            if e.dtype == new_params[k].dtype]
    if same:
        shadow, params = map(list, zip(*same))
        torch._foreach_add_(shadow, torch._foreach_sub(shadow, params),
                            alpha=-one_minus)
    for k, e in state.params.items():
        p = new_params[k]
        if e.dtype != p.dtype:   # computed in float32, stored in e's type
            e.copy_(e.float() - one_minus * (e.float() - p.float()))
    state.num_updates = n
    return state
