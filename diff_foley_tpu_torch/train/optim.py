"""``optax.adamw`` for the port's three trainers (stage 2, the alignment
classifier, stage-1 CAVP): float32 tensors updated in place with
``torch._foreach_*`` kernels, optionally after ``optax.clip_by_global_norm``
and inside ``optax.MultiSteps``, with optax's per-leaf decay ``mask``; and the
trainers' shared state (:class:`TrainState`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.ema import EmaState


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """‖·‖₂ over all the tensors, float32, on their device (no sync)."""
    return torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(list(tensors))]))


class AdamW:
    """``optax.adamw`` (β ``b1``/``b2``, 0.9/0.999 by default, ε 1e-8
    outside the root, weight decay decoupled and scaled by the rate; with
    no decay it is ``optax.adam``) over float32 tensors, in place;
    optionally after ``optax.clip_by_global_norm`` and inside
    ``optax.MultiSteps``.

    ``lr(count)`` is read at the update count before the increment (0 on
    the first update), and the bias corrections at the count after it.
    ``mu_dtype`` stores the first moment in that type; it is computed and
    bias-corrected in float32. ``decay_mask`` (one bool a tensor, optax's
    ``mask``) leaves the False tensors out of the weight decay only: they
    still take the Adam update. With ``accum_steps`` K the gradients of K
    calls are averaged (a running mean, as MultiSteps') and the K-th call
    updates; the others leave the parameters as they are. ``norm`` takes
    the clip's global norm (``parallel.collectives.sharded_global_norm``
    over tensors split across ranks)."""

    eps = 1e-8

    def __init__(self, params: Sequence[torch.Tensor], lr, *,
                 weight_decay: float = 0.0, mu_dtype: torch.dtype = None,
                 grad_clip: Optional[float] = None, accum_steps: int = 1,
                 decay_mask: Optional[Sequence[bool]] = None,
                 norm=global_norm, b1: float = 0.9, b2: float = 0.999):
        self.params = list(params)
        self.b1, self.b2 = b1, b2
        self.norm = norm
        self.lr = lr
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        if decay_mask is not None and len(decay_mask) != len(self.params):
            raise ValueError(f"decay_mask has {len(decay_mask)} entries for "
                             f"{len(self.params)} tensors")
        self.decayed = (self.params if decay_mask is None else
                        [p for p, m in zip(self.params, decay_mask) if m])
        self.decay_index = (None if decay_mask is None else
                            [i for i, m in enumerate(decay_mask) if m])
        self.accum_steps = int(accum_steps)
        self.count, self.mini_step = 0, 0
        mu_dtype = mu_dtype or torch.float32
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accum_steps > 1 else None)

    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take the call's gradients; True when the parameters moved."""
        grads = list(grads)
        if self.acc is not None:
            torch._foreach_lerp_(self.acc, grads, 1.0 / (self.mini_step + 1))
            if self.mini_step < self.accum_steps - 1:
                self.mini_step += 1
                return False
            grads, self.mini_step = self.acc, 0
        self._update(grads)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return True

    @torch.no_grad()
    def _update(self, grads):
        if self.grad_clip:
            norm = self.norm(grads)
            factor = torch.where(norm < self.grad_clip,
                                 torch.ones_like(norm),
                                 self.grad_clip / norm)
            grads = torch._foreach_mul(grads, factor)
        lr = float(self.lr(self.count))
        self.count += 1
        bc1 = float(1.0 - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(1.0 - np.float32(self.b2) ** np.float32(self.count))
        mu = self.mu
        if mu[0].dtype != torch.float32:
            mu = [m.float() for m in mu]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        if self.weight_decay and self.decayed:
            target = (upd if self.decay_index is None
                      else [upd[i] for i in self.decay_index])
            torch._foreach_add_(target, self.decayed, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        if mu is not self.mu:
            torch._foreach_copy_(self.mu, mu)

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        for name in ("mu", "nu", "acc"):
            mine, theirs = getattr(self, name), sd[name]
            if (mine is None) != (theirs is None):
                raise ValueError(f"optimizer state {name}: accum_steps "
                                 "differs from the checkpoint's")
            if mine is not None:
                if len(mine) != len(theirs):
                    raise ValueError(f"optimizer state {name}: "
                                     f"{len(theirs)} tensors, expected "
                                     f"{len(mine)}")
                torch._foreach_copy_(mine, [t.to(m.device)
                                            for m, t in zip(mine, theirs)])


@dataclasses.dataclass
class TrainState:
    """The step, the float32 masters by name (the trained model's own
    parameter names), the optimizer and the EMA (``None`` without one)."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt: AdamW
    ema: Optional[EmaState]

    def state_dict(self) -> dict:
        return {"step": self.step,
                "params": {k: p.detach() for k, p in self.params.items()},
                "opt": self.opt.state_dict(),
                "ema": None if self.ema is None else {
                    "params": self.ema.params,
                    "num_updates": self.ema.num_updates}}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        if set(sd["params"]) != set(self.params):
            raise ValueError("checkpoint parameters differ from the model's")
        for k, p in self.params.items():
            p.copy_(sd["params"][k])
        self.opt.load_state_dict(sd["opt"])
        if (self.ema is None) != (sd["ema"] is None):
            raise ValueError("use_ema differs from the checkpoint's")
        if self.ema is not None:
            for k, e in self.ema.params.items():
                e.copy_(sd["ema"]["params"][k])
            self.ema.num_updates = int(sd["ema"]["num_updates"])
        self.step = int(sd["step"])
