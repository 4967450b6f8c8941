"""Noise-schedule tables and the timestep embedding
(``diff_foley_tpu/diffusion/schedule.py``).

The tables are computed in float64 numpy and kept as float32, as the
reference materialises them; the DPM-Solver's float64 host math reads the
float32 ᾱ table, exactly as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The linear β schedule's tables, float32 numpy."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    num_timesteps: int

    @classmethod
    def create(cls, timesteps: int = 1000, linear_start: float = 1e-4,
               linear_end: float = 2e-2) -> "DiffusionSchedule":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, timesteps,
                            dtype=np.float64) ** 2
        return cls(
            betas=betas.astype(np.float32),
            alphas_cumprod=np.cumprod(1.0 - betas).astype(np.float32),
            num_timesteps=int(timesteps),
        )


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding in [cos | sin] order, float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
