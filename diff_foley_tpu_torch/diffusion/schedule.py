"""Noise-schedule tables, the DDIM timestep subset and the timestep
embedding (``diff_foley_tpu/diffusion/schedule.py``).

The tables are computed in float64 numpy and kept as float32, as the
reference materialises them; the samplers' float64 host math reads the
float32 ᾱ table, exactly as the JAX package's does. The four β schedules,
``v_posterior`` and the "eps" and "x0" parameterisations' ``lvlb_weights``
are the reference's ``register_schedule``. ``q_sample`` and the posterior
helpers take one step (an int) or a per-example tensor of steps.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4, linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """β table in float64: "linear", "cosine", "sqrt_linear" or "sqrt"."""
    if schedule == "linear":
        return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "cosine":
        steps = (np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
                 + cosine_s)
        alphas = np.cos(steps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1.0 - alphas[1:] / alphas[:-1], 0.0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown.")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The forward process's tables, float32 numpy."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    num_timesteps: int
    linear_start: float
    linear_end: float

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear",
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3, v_posterior: float = 0.0,
               parameterization: str = "eps") -> "DiffusionSchedule":
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start,
                                   linear_end, cosine_s)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = ((1 - v_posterior) * betas * (1.0 - ac_prev) / (1.0 - ac)
                    + v_posterior * betas)
        if parameterization == "eps":
            # posterior_variance[0] is 0, so weight 0 is infinite: the
            # reference overwrites it with weight 1
            with np.errstate(divide="ignore"):
                lvlb = betas**2 / (2 * post_var * alphas * (1 - ac))
        elif parameterization == "x0":
            lvlb = 0.5 * np.sqrt(ac) / (2.0 * (1 - ac))
        else:
            raise NotImplementedError(parameterization)
        lvlb = np.array(lvlb)
        lvlb[0] = lvlb[1]
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return cls(
            betas=f32(betas), alphas_cumprod=f32(ac),
            alphas_cumprod_prev=f32(ac_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - ac)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(post_var, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
            posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas)
                                     / (1.0 - ac)),
            lvlb_weights=f32(lvlb), num_timesteps=int(timesteps),
            linear_start=float(linear_start), linear_end=float(linear_end),
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

    def at(self, name: str, t, ndim: int):
        """Table ``name`` at step ``t``: a float for an int ``t``, else the
        (B, 1, …) float32 tensor of a per-example tensor of steps."""
        if isinstance(t, (int, np.integer)):
            return float(getattr(self, name)[t])
        return self.gather(name, t).view((-1,) + (1,) * (ndim - 1))

    def q_sample(self, x_start: torch.Tensor, t,
                 noise: torch.Tensor) -> torch.Tensor:
        """x_0 diffused to step t: √ᾱ_t·x_0 + √(1−ᾱ_t)·noise. ``t`` is one
        int, or a (B,) tensor of steps, one per example; the float32 table
        promotes a bf16 ``x_start`` to float32, as in the JAX package."""
        n = x_start.dim()
        return (self.at("sqrt_alphas_cumprod", t, n) * x_start
                + self.at("sqrt_one_minus_alphas_cumprod", t, n) * noise)

    def q_mean_variance(self, x_start: torch.Tensor, t):
        """(mean, variance, log variance) of q(x_t | x_0)."""
        n = x_start.dim()
        if isinstance(t, (int, np.integer)):
            var = float(np.float32(1.0) - self.alphas_cumprod[t])
        else:
            var = (1.0 - self.gather("alphas_cumprod", t)).view(
                (-1,) + (1,) * (n - 1))
        return (self.at("sqrt_alphas_cumprod", t, n) * x_start, var,
                self.at("log_one_minus_alphas_cumprod", t, n))

    def predict_start_from_noise(self, x_t: torch.Tensor, t,
                                 noise: torch.Tensor) -> torch.Tensor:
        n = x_t.dim()
        return (self.at("sqrt_recip_alphas_cumprod", t, n) * x_t
                - self.at("sqrt_recipm1_alphas_cumprod", t, n) * noise)

    def predict_eps_from_start(self, x_t: torch.Tensor, t,
                               x0: torch.Tensor) -> torch.Tensor:
        n = x_t.dim()
        return ((self.at("sqrt_recip_alphas_cumprod", t, n) * x_t - x0)
                / self.at("sqrt_recipm1_alphas_cumprod", t, n))

    def q_posterior(self, x_start: torch.Tensor, x_t: torch.Tensor, t):
        """(mean, variance, clipped log variance) of q(x_{t−1} | x_t, x_0)."""
        n = x_t.dim()
        mean = (self.at("posterior_mean_coef1", t, n) * x_start
                + self.at("posterior_mean_coef2", t, n) * x_t)
        return (mean, self.at("posterior_variance", t, n),
                self.at("posterior_log_variance_clipped", t, n))


def extract_into_tensor(a: np.ndarray, t: torch.Tensor,
                        x_shape) -> torch.Tensor:
    """``a[t]`` as a float32 (B, 1, …) tensor of rank len(x_shape)."""
    out = torch.from_numpy(np.asarray(a, np.float32)).to(t.device)[t]
    return out.view((t.shape[0],) + (1,) * (len(x_shape) - 1))


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        discr_method: str = "uniform") -> np.ndarray:
    """The DDIM subset plus 1 (the reference's shift): every (T // n)-th
    step ("uniform", whose stride may give more than n steps) or the
    squares of n points from 0 to √(0.8·T) ("quad")."""
    if discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ts = np.arange(0, num_ddpm_timesteps, c)
    elif discr_method == "quad":
        ts = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                          num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(discr_method)
    return ts + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray,
                                  ddim_timesteps: np.ndarray, eta: float):
    """(σ, α, α_prev) float64 tables of a DDIM run at ``eta``."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]]
                             + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                           * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


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
