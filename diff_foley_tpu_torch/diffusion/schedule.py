"""Noise-schedule tables, the DDIM timestep subset and the timestep
embedding (``diff_foley_tpu/diffusion/schedule.py``).

The tables are computed in float64 numpy and kept as float32, as the
reference materialises them; the samplers' float64 host math reads the
float32 ᾱ table, exactly as the JAX package's does. Training reads the
posterior variance and the ε-parameterization's ``lvlb_weights``
(``v_posterior`` 0), and ``q_sample`` takes one step or a per-example
tensor of steps.
"""
from __future__ import annotations

import dataclasses
import functools
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
    posterior_variance: np.ndarray
    lvlb_weights: np.ndarray
    num_timesteps: int

    @classmethod
    def create(cls, timesteps: int = 1000, linear_start: float = 1e-4,
               linear_end: float = 2e-2) -> "DiffusionSchedule":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, timesteps,
                            dtype=np.float64) ** 2
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        # posterior_variance[0] is 0, so weight 0 is infinite: the
        # reference overwrites it with weight 1
        with np.errstate(divide="ignore"):
            lvlb = betas**2 / (2 * post_var * alphas * (1 - ac))
        lvlb[0] = lvlb[1]
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return cls(
            betas=f32(betas), alphas_cumprod=f32(ac),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            posterior_variance=f32(post_var), lvlb_weights=f32(lvlb),
            num_timesteps=int(timesteps),
        )

    @functools.cached_property
    def _on_device(self) -> dict:
        return {}

    def draw_t(self, shape, **kw) -> torch.Tensor:
        """Timesteps uniform in [0, T) (``torch.randint``'s keywords)."""
        return torch.randint(0, self.num_timesteps, shape, **kw)

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Table ``name`` at the steps ``t`` (int64, any device), float32.
        Each table is copied to a device once: a copy per call would wait
        for the device's queue."""
        table = self._on_device.get((name, t.device))
        if table is None:
            table = self._on_device[(name, t.device)] = torch.from_numpy(
                getattr(self, name)).to(t.device)
        return table[t]

    def q_sample(self, x_start: torch.Tensor, t,
                 noise: torch.Tensor) -> torch.Tensor:
        """x_0 diffused to step t: √ᾱ_t·x_0 + √(1−ᾱ_t)·noise. ``t`` is one
        int, or a (B,) tensor of steps, one per example; the float32 table
        promotes a bf16 ``x_start`` to float32, as in the JAX package."""
        if isinstance(t, int):
            return (float(self.sqrt_alphas_cumprod[t]) * x_start
                    + float(self.sqrt_one_minus_alphas_cumprod[t]) * noise)
        shape = (-1,) + (1,) * (x_start.dim() - 1)
        return (self.gather("sqrt_alphas_cumprod", t).view(shape) * x_start
                + self.gather("sqrt_one_minus_alphas_cumprod",
                              t).view(shape) * noise)


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
