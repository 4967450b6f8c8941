"""Noise-schedule tables, the DDIM timestep subset and the timestep
embedding (``diff_foley_tpu/diffusion/schedule.py``).

The tables are computed in float64 numpy and kept as float32, as the
reference materialises them; the samplers' float64 host math reads the
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
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    num_timesteps: int

    @classmethod
    def create(cls, timesteps: int = 1000, linear_start: float = 1e-4,
               linear_end: float = 2e-2) -> "DiffusionSchedule":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, timesteps,
                            dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        return cls(
            betas=betas.astype(np.float32),
            alphas_cumprod=ac.astype(np.float32),
            sqrt_alphas_cumprod=np.sqrt(ac).astype(np.float32),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac).astype(np.float32),
            num_timesteps=int(timesteps),
        )

    def q_sample(self, x_start: torch.Tensor, t: int,
                 noise: torch.Tensor) -> torch.Tensor:
        """x_0 diffused to step t: √ᾱ_t·x_0 + √(1−ᾱ_t)·noise."""
        return (float(self.sqrt_alphas_cumprod[t]) * x_start
                + float(self.sqrt_one_minus_alphas_cumprod[t]) * noise)


def make_ddim_timesteps(num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """The "uniform" DDIM subset, every (T // n)-th step plus 1 (the
    reference's shift). The stride may give more than n steps."""
    c = num_ddpm_timesteps // num_ddim_timesteps
    return np.arange(0, num_ddpm_timesteps, c) + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray,
                                  ddim_timesteps: np.ndarray):
    """(α, α_prev) float64 tables of a deterministic (η 0) DDIM run."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]]
                             + alphacums[ddim_timesteps[:-1]].tolist())
    return alphas, alphas_prev


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
