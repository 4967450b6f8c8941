"""Classifier-free guidance and alignment-classifier gradient guidance in one
ε function per sampler step (``diff_foley_tpu/diffusion/guidance.py``).

- CFG runs [uncond, cond] as one 2×-batch model call and combines
  o_u + s·(o_c − o_u).
- ``model_type`` names the network's output: "noise" (ε, the shipped
  case), "x_start" (x₀) or "v". It is converted to ε, with α = √(1−σ²),
  *before* the classifier term (the reference's order); the conversion is
  affine in the output, so it commutes with the CFG combine.
- The classifier term is ε ← ε − σ_t·scale·∇ₓ Σ log p(aligned | x, t),
  the gradient taken at the unguided x through ``torch.autograd.grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

# model_fn(x, t_model_vec, context) -> ε; classifier_fn(x, t_model_vec,
# video_feat_context) -> LOG-probability of alignment, (B, 1)
ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
ClassifierFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                        torch.Tensor]
MODEL_TYPES = ("noise", "x_start", "v")


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


def check_model_type(model_type: str) -> None:
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type must be 'noise', 'x_start' or 'v', got "
                         f"{model_type!r}")


def alpha_of_sigma(sigma_t: Union[float, torch.Tensor]):
    """α = √(1−σ²) in float32: a float for a float σ, else a tensor."""
    if isinstance(sigma_t, torch.Tensor):
        return torch.sqrt(1.0 - torch.square(sigma_t))
    s = np.float32(sigma_t)
    return float(np.sqrt(np.float32(1.0) - s * s))


def to_eps(model_type: str, x: torch.Tensor, out: torch.Tensor, sigma_t,
           alpha_t=None) -> torch.Tensor:
    """The ε of the raw output ``out``; α from σ unless given."""
    if model_type == "noise":
        return out
    a_t = alpha_of_sigma(sigma_t) if alpha_t is None else alpha_t
    if model_type == "x_start":   # ε = (x − α·x₀)/σ
        return (x - a_t * out) / sigma_t
    return a_t * out + sigma_t * x  # "v": ε = α·v + σ·x


def make_guided_eps_fn(model_fn: ModelFn, cond: torch.Tensor,
                       uncond: Optional[torch.Tensor], spec: GuidanceSpec,
                       classifier_fn: Optional[ClassifierFn] = None,
                       classifier_cond: Optional[torch.Tensor] = None,
                       model_type: str = "noise"):
    """eps_fn(x, t_model, sigma_t) -> guided ε. ``sigma_t`` is a float or
    a float32 tensor broadcasting over x (one σ per row, as the adaptive
    DPM-Solver gives)."""
    check_model_type(model_type)
    if spec.use_cfg:
        assert uncond is not None, "CFG needs an unconditional embedding"
        c_in = torch.cat([uncond, cond], dim=0)
    if spec.use_classifier:
        assert classifier_fn is not None and classifier_cond is not None

    def eps_fn(x, t_model, sigma_t):
        with torch.no_grad():
            if spec.use_cfg:
                o_uncond, o_cond = model_fn(
                    torch.cat([x, x]), torch.cat([t_model, t_model]),
                    c_in).chunk(2)
                out = o_uncond + spec.cfg_scale * (o_cond - o_uncond)
            else:
                out = model_fn(x, t_model, cond)
            eps = to_eps(model_type, x, out, sigma_t)
        if spec.use_classifier:
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                log_p = classifier_fn(xg, t_model, classifier_cond)
                (grad,) = torch.autograd.grad(log_p.sum(), xg)
            # σ_t·scale in float32, as the JAX package forms it
            if isinstance(sigma_t, torch.Tensor):
                w = sigma_t.float() * np.float32(spec.classifier_scale)
            else:
                w = float(np.float32(sigma_t)
                          * np.float32(spec.classifier_scale))
            eps = eps - w * grad
        return eps

    return eps_fn
