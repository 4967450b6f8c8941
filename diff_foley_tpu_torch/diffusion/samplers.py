"""The samplers of the inference paths (``diff_foley_tpu/diffusion/samplers.py``):

- ``dpm_solver_sample`` at its defaults: ``method="multistep"``, order 2,
  ``time_uniform``, data prediction, ``solver_type="dpm_solver"``,
  lower_order_final, t from 1 down to 1/N (``generate``);
- ``ddim_sample`` at η 0, temperature 1 and "uniform" spacing, with the
  mask/x0 re-imposition of inpainting (``inpaint``).

All schedule math (the discrete NoiseScheduleVP marginals, the DDIM α
tables and each step's update coefficients) is float64 numpy on the host,
cast to float32; the loop on the device is one model call and a few scaled
adds per step.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.mesh import draw_rows
from .schedule import (DiffusionSchedule, make_ddim_sampling_parameters,
                       make_ddim_timesteps)

# eps_fn(x, t_model_vec, sigma_t) -> ε
EpsFn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]

ORDER = 2


def multistep_tables(alphas_cumprod, steps: int) -> dict[str, np.ndarray]:
    """Per-step float32 coefficients: the step from grid point i to i+1 is
    x' = cx·x + cm·m0 + cd1·(m0 − m1)·inv_r0, with the model evaluated at
    (t_model, alpha, sigma) of point i. cd1 and inv_r0 are zero on the
    first-order steps (the first, and the last when steps < 15)."""
    assert steps >= ORDER
    ac = np.asarray(alphas_cumprod, dtype=np.float64)
    n = len(ac)
    # discrete NoiseScheduleVP: log √ᾱ interpolated piecewise-linearly in t
    t_arr = np.linspace(0.0, 1.0, n + 1)[1:]
    tg = np.linspace(1.0, 1.0 / n, steps + 1)
    la_g = np.interp(tg, t_arr, 0.5 * np.log(ac))
    alpha = np.exp(la_g)
    sigma = np.sqrt(1.0 - np.exp(2.0 * la_g))
    lam = la_g - np.log(sigma)

    def upd_order(k):  # order of the update landing on grid point k
        if k < ORDER:
            return k
        if steps < 15:
            return min(ORDER, steps + 1 - k)
        return ORDER

    C = {k: np.zeros(steps) for k in ("cx", "cm", "cd1", "inv_r0")}
    for i in range(steps):
        h = lam[i + 1] - lam[i]
        phi1 = np.expm1(-h)
        C["cx"][i] = sigma[i + 1] / sigma[i]
        C["cm"][i] = -(alpha[i + 1] * phi1)
        if upd_order(i + 1) == 2:
            C["inv_r0"][i] = 1.0 / ((lam[i] - lam[i - 1]) / h)
            C["cd1"][i] = -0.5 * alpha[i + 1] * phi1
    C["t_model"] = (tg[:-1] - 1.0 / n) * 1000.0  # the model's input time
    C["alpha"] = alpha[:-1]
    C["sigma"] = sigma[:-1]
    return {k: v.astype(np.float32) for k, v in C.items()}


def dpm_solver_sample(eps_fn: EpsFn, schedule: DiffusionSchedule,
                      x_T: torch.Tensor, steps: int = 25) -> torch.Tensor:
    """DPM-Solver++(2M) from x_T over ``steps`` model calls."""
    tbl = multistep_tables(schedule.alphas_cumprod, steps)
    x = x_T
    m1 = torch.zeros_like(x_T)
    for i in range(steps):
        c = {k: float(v[i]) for k, v in tbl.items()}
        t_vec = torch.full((x.shape[0],), c["t_model"], dtype=x.dtype,
                           device=x.device)
        eps = eps_fn(x, t_vec, c["sigma"])
        m0 = (x - c["sigma"] * eps) / c["alpha"]
        d1 = (m0 - m1) * c["inv_r0"]
        x_new = c["cx"] * x + c["cm"] * m0 + c["cd1"] * d1
        # the carry keeps x_T's dtype whatever dtype ε comes back in
        x, m1 = x_new.to(x.dtype), m0.to(x.dtype)
    return x.to(x_T.dtype)


def ddim_sample(eps_fn: EpsFn, schedule: DiffusionSchedule, x_T: torch.Tensor,
                steps: int = 25, mask: Optional[torch.Tensor] = None,
                x0: Optional[torch.Tensor] = None,
                mask_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Deterministic DDIM (ddim.py:232-316) from x_T; the classifier-grad
    scale handed to ``eps_fn`` is √(1−ᾱ_t).

    With ``mask`` (1 = known) and ``x0``, the known region is re-imposed
    before each model call as q_sample(x0, t)·mask + (1−mask)·x
    (ddim.py:210-213). Its forward noise is ``mask_noise[i]`` at step i
    ((n, *x.shape), n the number of DDIM steps), else drawn from
    ``generator``. The "uniform" stride may give more than ``steps``
    steps, as in the reference."""
    ac = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
    ts = make_ddim_timesteps(steps, schedule.num_timesteps)
    alphas, alphas_prev = make_ddim_sampling_parameters(ac, ts)
    f32 = np.float32
    a, a_prev = alphas.astype(f32), alphas_prev.astype(f32)
    s1ma = np.sqrt(1.0 - alphas).astype(f32)
    if mask is not None and x0 is None:
        raise ValueError("mask inpainting needs x0")
    if mask_noise is not None and tuple(mask_noise.shape) != (len(ts),
                                                              *x_T.shape):
        raise ValueError(f"mask_noise {tuple(mask_noise.shape)} must be "
                         f"{(len(ts), *x_T.shape)}")
    x = x_T
    for i, j in enumerate(reversed(range(len(ts)))):
        if mask is not None:
            noise = mask_noise[i] if mask_noise is not None else draw_rows(
                torch.randn, x0.shape, generator=generator, dtype=x0.dtype,
                device=x0.device)
            x_known = schedule.q_sample(x0, int(ts[j]), noise)
            x = (x_known * mask + (1.0 - mask) * x).to(x.dtype)
        t_vec = torch.full((x.shape[0],), float(ts[j]), dtype=x.dtype,
                           device=x.device)
        e = eps_fn(x, t_vec, float(s1ma[j]))
        pred_x0 = (x - float(s1ma[j]) * e) / float(np.sqrt(a[j]))
        dir_xt = float(np.sqrt(f32(1.0) - a_prev[j])) * e
        x = (float(np.sqrt(a_prev[j])) * pred_x0 + dir_xt).to(x.dtype)
    return x
