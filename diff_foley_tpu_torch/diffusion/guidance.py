"""Classifier-free guidance and alignment-classifier gradient guidance in one
ε function per sampler step (``diff_foley_tpu/diffusion/guidance.py``).

- CFG runs [uncond, cond] as one 2×-batch model call and combines
  ε_u + s·(ε_c − ε_u).
- The classifier term is ε ← ε − σ_t·scale·∇ₓ Σ log p(aligned | x, t),
  the gradient taken at the unguided x through ``torch.autograd.grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

# model_fn(x, t_model_vec, context) -> ε; classifier_fn(x, t_model_vec,
# video_feat_context) -> LOG-probability of alignment, (B, 1)
ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
ClassifierFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                        torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GuidanceSpec:
    cfg_scale: float = 1.0
    classifier_scale: float = 0.0

    @property
    def use_cfg(self) -> bool:
        return self.cfg_scale != 1.0

    @property
    def use_classifier(self) -> bool:
        return self.classifier_scale > 0.0


def make_guided_eps_fn(model_fn: ModelFn, cond: torch.Tensor,
                       uncond: Optional[torch.Tensor], spec: GuidanceSpec,
                       classifier_fn: Optional[ClassifierFn] = None,
                       classifier_cond: Optional[torch.Tensor] = None):
    """eps_fn(x, t_model, sigma_t) -> guided ε; ``sigma_t`` a float."""
    if spec.use_cfg:
        assert uncond is not None, "CFG needs an unconditional embedding"
        c_in = torch.cat([uncond, cond], dim=0)
    if spec.use_classifier:
        assert classifier_fn is not None and classifier_cond is not None

    def eps_fn(x, t_model, sigma_t: float):
        with torch.no_grad():
            if spec.use_cfg:
                o_uncond, o_cond = model_fn(
                    torch.cat([x, x]), torch.cat([t_model, t_model]),
                    c_in).chunk(2)
                eps = o_uncond + spec.cfg_scale * (o_cond - o_uncond)
            else:
                eps = model_fn(x, t_model, cond)
        if spec.use_classifier:
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                log_p = classifier_fn(xg, t_model, classifier_cond)
                (grad,) = torch.autograd.grad(log_p.sum(), xg)
            # σ_t·scale in float32, as the JAX package forms it
            w = float(np.float32(sigma_t) * np.float32(spec.classifier_scale))
            eps = eps - w * grad
        return eps

    return eps_fn
