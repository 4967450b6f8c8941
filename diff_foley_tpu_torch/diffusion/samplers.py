"""The sampler library (``diff_foley_tpu/diffusion/samplers.py``):

- DDIM (η, temperature, "uniform" or "quad" spacing, mask/x0 inpainting,
  noise dropout, ``score_corrector`` and ``denoised_fn``) with
  ``ddim_stochastic_encode``/``ddim_decode``, the img2img pair;
- the ancestral DDPM chain, ``p_sample_loop`` and
  ``progressive_denoising``;
- DPM-Solver: multistep orders 1–3, ``singlestep`` and
  ``singlestep_fixed``, ``adaptive``; data or noise prediction, the
  "noise"/"x_start"/"v" model types, dynamic thresholding;
- PLMS.

Every mode but ``adaptive`` has a fixed time grid: its schedule math (the
discrete NoiseScheduleVP marginals, λ↔t, the DDIM α tables, each step's
update coefficients) is float64 numpy on the host, cast to float32, and
the loop on the device is model calls and a few scaled adds. The adaptive
solver's step size depends on the data: its schedule math runs on the
device in float32, and each step reads the error on the host once (one
synchronisation a step, counted in ``stats``).

Each loop casts its carry back to x_T's dtype after the float32 table
scalars, so a bf16 model output never promotes the latent.

Random draws come from ``generator`` (through ``draw_rows``, so a meshed
call draws the global rows) unless ``draws`` gives them: a dict of
per-step tensors, "noise" (the step noise, (n, *x.shape)) and "keep"
(noise dropout's keep mask, (n, *x.shape)), indexed by loop step; the
mask's forward noise is ``mask_noise`` as before. The tests pass the JAX
package's own draws through them.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..parallel.mesh import draw_rows
from .guidance import check_model_type, to_eps
from .schedule import (DiffusionSchedule, make_ddim_sampling_parameters,
                       make_ddim_timesteps)

# eps_fn(x, t_model_vec, sigma_t) -> ε; sigma_t a float or a float32
# tensor that broadcasts over x
EpsFn = Callable[[torch.Tensor, torch.Tensor, Union[float, torch.Tensor]],
                 torch.Tensor]
f32 = np.float32


def _draw(draws: Optional[dict], name: str, i: int, like: torch.Tensor,
          generator: Optional[torch.Generator], fn=torch.randn):
    """Loop step i's draw ``name``: ``draws[name][i]`` when given, else a
    fresh one of ``like``'s shape from ``generator``."""
    if draws is not None and name in draws:
        return draws[name][i].to(like.device)
    return draw_rows(fn, like.shape, generator=generator, dtype=like.dtype,
                     device=like.device)


def _step_noise(draws, i, x, generator, scales, noise_dropout: float):
    """N(0, 1) times each of ``scales`` in turn, with noise dropout: zero
    with probability p, the rest rescaled by 1/(1−p)."""
    noise = _draw(draws, "noise", i, x, generator)
    for scale in scales:
        noise = noise * scale
    if noise_dropout > 0.0:
        if draws is not None and "keep" in draws:
            keep = draws["keep"][i].to(x.device)
        else:
            keep = _draw(None, "keep", i, x, generator,
                         torch.rand) < 1.0 - noise_dropout
        noise = noise * keep.to(noise.dtype) / (1.0 - noise_dropout)
    return noise


def _check_steps(name: str, t: Optional[torch.Tensor], n: int,
                 x: torch.Tensor):
    if t is not None and tuple(t.shape) != (n, *x.shape):
        raise ValueError(f"{name} {tuple(t.shape)} must be "
                         f"{(n, *x.shape)}")


def _full(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((x.shape[0],), value, dtype=x.dtype, device=x.device)


# ---- DDIM ---------------------------------------------------------------------

def _ddim_tables(schedule: DiffusionSchedule, steps: int, eta: float,
                 discr_method: str = "uniform") -> dict:
    """Float32 per-index tables of a DDIM run, ascending t."""
    ac = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
    ts = make_ddim_timesteps(steps, schedule.num_timesteps, discr_method)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(ac, ts, eta)
    a, a_prev, sig = alphas.astype(f32), alphas_prev.astype(f32), \
        sigmas.astype(f32)
    return dict(t=ts, alphas=alphas, s1ma=np.sqrt(1.0 - alphas).astype(f32),
                sqrt_a=np.sqrt(a), sqrt_a_prev=np.sqrt(a_prev), sigma=sig,
                # √(1 − α_prev − σ²), as the JAX loop forms it in float32
                dir=np.sqrt(f32(1.0) - a_prev - sig**2))


def ddim_sample(eps_fn: EpsFn, schedule: DiffusionSchedule, x_T: torch.Tensor,
                steps: int = 25, mask: Optional[torch.Tensor] = None,
                x0: Optional[torch.Tensor] = None,
                mask_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, *,
                eta: float = 0.0, temperature: float = 1.0,
                discr_method: str = "uniform", noise_dropout: float = 0.0,
                score_corrector=None, denoised_fn=None,
                draws: Optional[dict] = None) -> torch.Tensor:
    """DDIM (ddim.py:232-316) from x_T; the classifier-grad scale handed to
    ``eps_fn`` is √(1−ᾱ_t).

    With ``mask`` (1 = known) and ``x0``, the known region is re-imposed
    before each model call as q_sample(x0, t)·mask + (1−mask)·x
    (ddim.py:210-213), its forward noise ``mask_noise[i]`` at step i
    ((n, *x.shape), n the number of DDIM steps) or drawn. At η > 0 each
    step adds σ·temperature·N(0, 1) (``draws["noise"]``), with
    ``noise_dropout`` p zeroing it with probability p and rescaling the
    rest by 1/(1−p) (``draws["keep"]``). ``score_corrector(e_t, x, t_vec)``
    corrects ε after guidance, ``denoised_fn(pred_x0)`` the x₀ estimate.
    The "uniform" stride may give more than ``steps`` steps."""
    c = _ddim_tables(schedule, steps, eta, discr_method)
    n = len(c["t"])
    if mask is not None and x0 is None:
        raise ValueError("mask inpainting needs x0")
    _check_steps("mask_noise", mask_noise, n, x_T)
    x = x_T
    for i, j in enumerate(reversed(range(n))):
        t = int(c["t"][j])
        if mask is not None:
            noise = (mask_noise[i] if mask_noise is not None else _draw(
                None, "mask", i, x0, generator))
            x_known = schedule.q_sample(x0, t, noise)
            x = (x_known * mask + (1.0 - mask) * x).to(x.dtype)
        t_vec = _full(x, float(t))
        s1ma = float(c["s1ma"][j])
        e = eps_fn(x, t_vec, s1ma)
        if score_corrector is not None:
            e = score_corrector(e, x, t_vec)
        pred_x0 = (x - s1ma * e) / float(c["sqrt_a"][j])
        if denoised_fn is not None:
            pred_x0 = denoised_fn(pred_x0)
        x_new = float(c["sqrt_a_prev"][j]) * pred_x0 + float(c["dir"][j]) * e
        sigma = float(c["sigma"][j])
        if sigma != 0.0:
            x_new = x_new + _step_noise(draws, i, x, generator,
                                        (sigma, temperature), noise_dropout)
        x = x_new.to(x.dtype)
    return x


def ddim_stochastic_encode(schedule: DiffusionSchedule, x0: torch.Tensor,
                           t_index, steps: int = 25,
                           noise: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """x0 diffused forward to DDIM step index ``t_index`` (an int, or one
    per example) of a "uniform" ``steps``-step run (ddim.py:399-413), the
    img2img entry; ``noise`` is drawn from ``generator`` unless given."""
    alphas = _ddim_tables(schedule, steps, 0.0)["alphas"]
    sqrt_a, sqrt_1ma = (np.sqrt(a).astype(f32) for a in (alphas,
                                                          1.0 - alphas))
    if noise is None:
        noise = draw_rows(torch.randn, x0.shape, generator=generator,
                          dtype=x0.dtype, device=x0.device)
    if isinstance(t_index, (int, np.integer)):
        return float(sqrt_a[t_index]) * x0 + float(sqrt_1ma[t_index]) * noise
    shape = (-1,) + (1,) * (x0.dim() - 1)
    pick = lambda a: torch.from_numpy(a).to(x0.device)[
        t_index.to(x0.device)].view(shape)
    return pick(sqrt_a) * x0 + pick(sqrt_1ma) * noise


def ddim_decode(eps_fn: EpsFn, schedule: DiffusionSchedule,
                x_latent: torch.Tensor, t_start: int,
                steps: int = 25) -> torch.Tensor:
    """Deterministic DDIM from step index ``t_start`` down (ddim.py:415-433):
    img2img's second half after ``ddim_stochastic_encode``."""
    c = _ddim_tables(schedule, steps, 0.0)
    if not 1 <= t_start <= len(c["t"]):
        raise ValueError(f"t_start {t_start} not in [1, {len(c['t'])}]")
    x = x_latent
    for j in range(t_start - 1, -1, -1):
        s1ma = float(c["s1ma"][j])
        e = eps_fn(x, _full(x, float(c["t"][j])), s1ma)
        pred_x0 = (x - s1ma * e) / float(c["sqrt_a"][j])
        x = (float(c["sqrt_a_prev"][j]) * pred_x0
             + float(c["dir"][j]) * e).to(x.dtype)
    return x


# ---- the ancestral chain ----------------------------------------------------

def _ancestral_loop(eps_fn, schedule: DiffusionSchedule, x_T, *, num_steps,
                    collect: str, clip_denoised, temperature, noise_dropout,
                    mask, x0, mask_noise, log_every_t, score_corrector,
                    denoised_fn, generator, draws):
    """p_sample_loop and progressive_denoising (ddpm.py:1065-1253): at each
    t = T−1 … 0 an ε-model call, x₀ = predict_start_from_noise (clipped to
    [−1, 1] if asked), the posterior mean plus exp(½·log var)·noise (none at
    t = 0), then the known region re-imposed AFTER the step (the DDIM loop
    blends before). The model's time is t itself; the classifier scale
    √(1−ᾱ_t). Logged at t = T−1 and every ``log_every_t``: the running x
    (``collect="x"``, seeded with x_T) or the x₀ estimate ("x0")."""
    T = int(num_steps)
    if mask is not None and x0 is None:
        raise ValueError("mask inpainting needs x0")
    _check_steps("mask_noise", mask_noise, T, x_T)
    if isinstance(temperature, (int, float)):
        temp = np.full(T, float(temperature))
    else:
        temp = np.asarray(temperature, np.float64)[:T]
    temp = temp.astype(f32)
    s1ma = schedule.sqrt_one_minus_alphas_cumprod
    inter = [x_T] if collect == "x" else []
    x = x_T
    for i, t in enumerate(range(T - 1, -1, -1)):
        t_vec = torch.full((x.shape[0],), t, dtype=torch.int64,
                           device=x.device)
        eps = eps_fn(x, t_vec.to(x.dtype), float(s1ma[t]))
        if score_corrector is not None:
            eps = score_corrector(eps, x, t_vec)
        x_recon = schedule.predict_start_from_noise(x, t, eps)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        if denoised_fn is not None:
            x_recon = denoised_fn(x_recon)
        x_new, _, log_var = schedule.q_posterior(x_recon, x, t)
        if t != 0:
            noise = _step_noise(draws, i, x, generator, (float(temp[t]),),
                                noise_dropout)
            x_new = x_new + float(np.exp(f32(0.5) * f32(log_var))) * noise
        if mask is not None:
            q_noise = (mask_noise[i] if mask_noise is not None else _draw(
                None, "mask", i, x0, generator))
            x_new = (schedule.q_sample(x0, t, q_noise) * mask
                     + (1.0 - mask) * x_new)
        x_new = x_new.to(x.dtype)
        if collect and (t == T - 1 or t % log_every_t == 0):
            inter.append(x_new if collect == "x" else x_recon.to(x.dtype))
        x = x_new
    return x, (torch.stack(inter) if collect else None)


def _chain_length(schedule, timesteps, start_T) -> int:
    T = schedule.num_timesteps if timesteps is None else int(timesteps)
    return T if start_T is None else min(T, int(start_T))


def p_sample_loop(eps_fn: EpsFn, schedule: DiffusionSchedule,
                  x_T: torch.Tensor, *, timesteps: Optional[int] = None,
                  start_T: Optional[int] = None, clip_denoised: bool = False,
                  temperature=1.0, noise_dropout: float = 0.0,
                  mask: Optional[torch.Tensor] = None,
                  x0: Optional[torch.Tensor] = None,
                  mask_noise: Optional[torch.Tensor] = None,
                  log_every_t: int = 100, return_intermediates: bool = False,
                  score_corrector=None, denoised_fn=None,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None):
    """Ancestral DDPM sampling over t = T−1 … 0 (``_ancestral_loop``); T is
    the schedule's length unless ``timesteps``/``start_T`` cut it.
    ``temperature`` is a float or a per-t array (indexed by t). Returns x,
    or (x, intermediates) with ``return_intermediates``: x_T, then the
    running x at each logged step."""
    x, inter = _ancestral_loop(
        eps_fn, schedule, x_T,
        num_steps=_chain_length(schedule, timesteps, start_T),
        collect="x" if return_intermediates else "",
        clip_denoised=clip_denoised, temperature=temperature,
        noise_dropout=noise_dropout, mask=mask, x0=x0, mask_noise=mask_noise,
        log_every_t=log_every_t, score_corrector=score_corrector,
        denoised_fn=denoised_fn, generator=generator, draws=draws)
    return (x, inter) if return_intermediates else x


def progressive_denoising(eps_fn: EpsFn, schedule: DiffusionSchedule,
                          x_T: torch.Tensor, *,
                          timesteps: Optional[int] = None,
                          start_T: Optional[int] = None,
                          clip_denoised: bool = False, temperature=1.0,
                          noise_dropout: float = 0.0,
                          mask: Optional[torch.Tensor] = None,
                          x0: Optional[torch.Tensor] = None,
                          mask_noise: Optional[torch.Tensor] = None,
                          log_every_t: int = 100, score_corrector=None,
                          denoised_fn=None,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[dict] = None):
    """The ancestral chain collecting the x₀ predictions at each logged
    step (ddpm.py:1146-1203), not seeded with x_T → (x, x0 partials)."""
    return _ancestral_loop(
        eps_fn, schedule, x_T,
        num_steps=_chain_length(schedule, timesteps, start_T), collect="x0",
        clip_denoised=clip_denoised, temperature=temperature,
        noise_dropout=noise_dropout, mask=mask, x0=x0, mask_noise=mask_noise,
        log_every_t=log_every_t, score_corrector=score_corrector,
        denoised_fn=denoised_fn, generator=generator, draws=draws)


# ---- DPM-Solver ---------------------------------------------------------------

METHODS = ("multistep", "singlestep", "singlestep_fixed", "adaptive")
SKIP_TYPES = ("logSNR", "time_uniform", "time_quadratic")
SOLVER_TYPES = ("dpm_solver", "taylor")


class _NSMath:
    """NoiseScheduleVP('discrete') marginals (dpm_solver.py:95-175): log α_t
    interpolated piecewise-linearly over the (t, ½·log ᾱ) table, t =
    (i+1)/N. On the host (``device`` None) in float64 numpy; on a device in
    float32 tensors, for the adaptive solver's data-dependent (B,) times,
    through ``interp`` (``jnp.interp``'s operations)."""

    def __init__(self, alphas_cumprod, device=None):
        ac = self.alphas_cumprod = np.asarray(alphas_cumprod,
                                              dtype=np.float64)
        self.N = len(ac)
        self.T = 1.0
        t_arr = np.linspace(0.0, 1.0, self.N + 1)[1:]
        la_arr = 0.5 * np.log(ac)
        if device is None:
            self.xp, self.interp = np, np.interp
            self.t_arr, self.la_arr = t_arr, la_arr
            self.t_up, self.la_up = t_arr[::-1], la_arr[::-1]
        else:
            self.xp, self.interp = torch, interp
            self.t_arr, self.la_arr = (
                torch.tensor(a, dtype=torch.float32, device=device)
                for a in (t_arr, la_arr))
            self.t_up, self.la_up = self.t_arr.flip(0), self.la_arr.flip(0)

    def log_mean_coeff(self, t):
        return self.interp(t, self.t_arr, self.la_arr)

    def alpha(self, t):
        return self.xp.exp(self.log_mean_coeff(t))

    def std(self, t):
        return self.xp.sqrt(1.0 - self.xp.exp(2.0 * self.log_mean_coeff(t)))

    def lam(self, t):
        la = self.log_mean_coeff(t)
        return la - 0.5 * self.xp.log(1.0 - self.xp.exp(2.0 * la))

    def inv_lam(self, lamb):
        # λ → log α → t over the flipped (ascending) table
        zero = 0.0 if self.xp is np else torch.zeros_like(lamb)
        la = -0.5 * self.xp.logaddexp(zero, -2.0 * lamb)
        return self.interp(la, self.la_up, self.t_up)

    def t_model(self, t):
        # the model's input time for a discrete schedule
        return (t - 1.0 / self.N) * 1000.0


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """``jnp.interp`` on tensors: piecewise-linear over ascending ``xp``,
    the end values outside it, in the same operations."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _get_time_steps(ns: _NSMath, skip_type: str, t_T: float, t_0: float,
                    n: int) -> np.ndarray:
    """The sampling time grid (dpm_solver.py:409-434), float64."""
    if skip_type == "logSNR":
        return ns.inv_lam(np.linspace(ns.lam(t_T), ns.lam(t_0), n + 1))
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, n + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** 0.5, t_0 ** 0.5, n + 1) ** 2
    raise ValueError(f"unsupported skip_type '{skip_type}'")


def _threshold(x0: torch.Tensor, max_val: float) -> torch.Tensor:
    """Dynamic thresholding (dpm_solver.py:373-381): x₀ clamped to its
    per-sample 0.995 quantile of |x₀| (at least ``max_val``) and divided
    by it; ``torch.quantile`` interpolates linearly, as ``jnp.quantile``."""
    flat = x0.abs().reshape(x0.shape[0], -1)
    s = torch.quantile(flat, 0.995, dim=1).clamp(min=max_val)
    s = s.view((-1,) + (1,) * (x0.dim() - 1))
    return torch.minimum(torch.maximum(x0, -s), s) / s


def _bc(v, ndim: int):
    """A (B,) coefficient as (B, 1, …); floats pass through."""
    if isinstance(v, torch.Tensor) and v.dim() == 1:
        return v.view((-1,) + (1,) * (ndim - 1))
    return v


class _DPMModel:
    """eps_fn → the solver's model m(x, t): ε (``predict_x0=False``) or
    the data prediction (x − σ·ε)/α, thresholded if asked
    (dpm_solver.py:385-408); the classifier scale handed down is σ_t.
    ``model_type`` converts a raw network's output to ε first, with the
    solver's own α; the guided ε of ``LatentDiffusion.sample`` arrives
    converted already ("noise")."""

    def __init__(self, eps_fn, predict_x0, thresholding, max_val,
                 model_type="noise"):
        check_model_type(model_type)
        self.eps_fn = eps_fn
        self.predict_x0 = predict_x0
        self.thresholding = thresholding
        self.max_val = max_val
        self.model_type = model_type
        self.nfe = 0

    def __call__(self, x, t_model, alpha_t, sigma_t):
        self.nfe += 1
        t_vec = (t_model.to(x.dtype) if isinstance(t_model, torch.Tensor)
                 else _full(x, float(t_model)))
        a_b, s_b = _bc(alpha_t, x.dim()), _bc(sigma_t, x.dim())
        eps = to_eps(self.model_type, x, self.eps_fn(x, t_vec, s_b), s_b,
                     a_b)
        if not self.predict_x0:
            return eps
        x0 = (x - s_b * eps) / a_b
        return _threshold(x0, self.max_val) if self.thresholding else x0


def dpm_solver_sample(eps_fn: EpsFn, schedule: DiffusionSchedule,
                      x_T: torch.Tensor, steps: int = 25, *, order: int = 2,
                      method: str = "multistep",
                      skip_type: str = "time_uniform",
                      solver_type: str = "dpm_solver",
                      predict_x0: bool = True, thresholding: bool = False,
                      max_val: float = 1.0, lower_order_final: bool = True,
                      denoise_to_zero: bool = False,
                      t_start: Optional[float] = None,
                      t_end: Optional[float] = None, atol: float = 0.0078,
                      rtol: float = 0.05, model_type: str = "noise",
                      stats: Optional[dict] = None) -> torch.Tensor:
    """DPM-Solver sampling (DPM_Solver.sample, dpm_solver.py:516-675).

    The defaults are the shipped operating point: DPM-Solver++ multistep
    order 2, uniform time grid, lower_order_final, t from 1 down to 1/N.
    ``steps`` is the model-call budget (``adaptive`` ignores it). A
    ``stats`` dict receives "nfe" (model calls) and "host_syncs" (the
    adaptive loop's reads of the device)."""
    if method not in METHODS:
        raise ValueError(f"unsupported method '{method}'")
    if skip_type not in SKIP_TYPES:
        raise ValueError(f"unsupported skip_type '{skip_type}'")
    if solver_type not in SOLVER_TYPES:
        raise ValueError(f"unsupported solver_type '{solver_type}'")
    ns = _NSMath(schedule.alphas_cumprod)
    t_0 = 1.0 / ns.N if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    model = _DPMModel(eps_fn, predict_x0, thresholding, max_val, model_type)
    syncs = 0
    if method == "multistep":
        x = _dpm_multistep(model, ns, x_T, steps, order, skip_type,
                           solver_type, predict_x0, lower_order_final, t_T,
                           t_0)
    elif method == "adaptive":
        x, syncs = _dpm_adaptive(model, schedule, x_T, order, solver_type,
                                 predict_x0, t_T, t_0, atol, rtol)
    else:
        x = _dpm_singlestep(model, ns, x_T, steps, order, skip_type, method,
                            solver_type, predict_x0, t_T, t_0)
    if denoise_to_zero:
        # a last first-order denoise to λ = ∞ (dpm_solver.py:498-502)
        model.predict_x0 = True
        x = model(x, ns.t_model(t_0), float(ns.alpha(t_0)),
                  float(ns.std(t_0)))
    if stats is not None:
        stats.update(nfe=model.nfe, host_syncs=syncs)
    return x.to(x_T.dtype)


def multistep_tables(alphas_cumprod, steps: int, order: int = 2,
                     skip_type: str = "time_uniform",
                     solver_type: str = "dpm_solver",
                     predict_x0: bool = True, lower_order_final: bool = True,
                     t_T: float = 1.0, t_0: Optional[float] = None) -> dict:
    """Per-step coefficients of multistep DPM-Solver (dpm_solver.py:
    628-656): the step from grid point i to i+1 evaluates the model at
    (t_model, alpha, sigma) of point i, then
    x' = cx·x + cm·m0 + cd1·Deff + cd2·D2 with D1_0 = (m0 − m1)·inv_r0,
    D1_1 = (m1 − m2)·inv_r1, Deff = D1_0 + w3·(D1_0 − D1_1) and
    D2 = (D1_0 − D1_1)·inv_r01. "order" is each update's order: the
    warm-up's first steps and lower_order_final's tail go lower. Float32,
    from float64."""
    if not 1 <= order <= 3:
        raise ValueError(f"multistep order must be 1, 2 or 3, got {order}")
    if steps < order:
        raise ValueError(f"multistep order {order} needs ≥ {order} steps")
    ns = _NSMath(alphas_cumprod)
    t_0 = 1.0 / ns.N if t_0 is None else t_0
    tg = _get_time_steps(ns, skip_type, t_T, t_0, steps)
    la_g = ns.log_mean_coeff(tg)
    alpha = np.exp(la_g)
    sigma = np.sqrt(1.0 - np.exp(2.0 * la_g))
    lam = la_g - np.log(sigma)

    def upd_order(k):  # order of the update landing on grid point k
        if k < order:
            return k
        if lower_order_final and steps < 15:
            return min(order, steps + 1 - k)
        return order

    C = {k: np.zeros(steps) for k in
         ("cx", "cm", "cd1", "cd2", "inv_r0", "inv_r1", "w3", "inv_r01")}
    C["order"] = np.array([upd_order(i + 1) for i in range(steps)])
    for i in range(steps):
        o = C["order"][i]
        h = lam[i + 1] - lam[i]
        if predict_x0:
            phi1 = np.expm1(-h)
            C["cx"][i] = sigma[i + 1] / sigma[i]
            C["cm"][i] = -(alpha[i + 1] * phi1)
            cd1_dpm = -0.5 * alpha[i + 1] * phi1
            cd1_tay = alpha[i + 1] * (phi1 / h + 1.0)
            cd2 = -(alpha[i + 1] * ((phi1 + h) / h ** 2 - 0.5))
        else:
            phi1 = np.expm1(h)
            C["cx"][i] = np.exp(la_g[i + 1] - la_g[i])
            C["cm"][i] = -(sigma[i + 1] * phi1)
            cd1_dpm = -0.5 * sigma[i + 1] * phi1
            cd1_tay = -(sigma[i + 1] * (phi1 / h - 1.0))
            cd2 = -(sigma[i + 1] * ((phi1 - h) / h ** 2 - 0.5))
        if o >= 2:
            r0 = (lam[i] - lam[i - 1]) / h
            C["inv_r0"][i] = 1.0 / r0
            C["cd1"][i] = (cd1_tay if (o == 3 or solver_type == "taylor")
                           else cd1_dpm)
        if o == 3:
            r1 = (lam[i - 1] - lam[i - 2]) / h
            C["w3"][i] = r0 / (r0 + r1)
            C["inv_r01"][i] = 1.0 / (r0 + r1)
            C["cd2"][i] = cd2
            C["inv_r1"][i] = h / (lam[i - 1] - lam[i - 2])
    C["t_model"] = ns.t_model(tg[:-1])
    C["alpha"] = alpha[:-1]
    C["sigma"] = sigma[:-1]
    return {k: v if k == "order" else v.astype(f32) for k, v in C.items()}


def _dpm_multistep(model, ns, x_T, steps, order, skip_type, solver_type,
                   predict_x0, lower_order_final, t_T, t_0):
    """One model call a step; the D1/D2 terms only where the step's order
    has them (their coefficients are zero elsewhere in the JAX scan)."""
    tbl = multistep_tables(ns.alphas_cumprod, steps, order, skip_type,
                           solver_type, predict_x0, lower_order_final, t_T,
                           t_0)
    x = x_T
    m1 = m2 = None
    for i in range(steps):
        c = {k: float(v[i]) for k, v in tbl.items()}
        m0 = model(x, c["t_model"], c["alpha"], c["sigma"])
        x_new = c["cx"] * x + c["cm"] * m0
        o = int(tbl["order"][i])
        if o >= 2:
            d1_0 = (m0 - m1) * c["inv_r0"]
            if o == 3:
                d1_1 = (m1 - m2) * c["inv_r1"]
                deff = d1_0 + c["w3"] * (d1_0 - d1_1)
                d2 = (d1_0 - d1_1) * c["inv_r01"]
                x_new = x_new + c["cd1"] * deff + c["cd2"] * d2
            else:
                x_new = x_new + c["cd1"] * d1_0
        # the carry keeps x_T's dtype whatever dtype m comes back in
        x, m1, m2 = x_new.to(x.dtype), m0.to(x.dtype), m1
    return x


def _ss_update(model, ns, x, s, t, order, r1, r2, solver_type, predict_x0,
               cache=None):
    """One singlestep update of ``order`` from time s to t
    (dpm_solver.py:504-758). On the host ``ns`` its coefficients are
    float64, handed down as floats; on a device ``ns`` (the adaptive
    solver) s and t are (B,) float32 tensors and each coefficient
    broadcasts over its row. ``cache`` keeps the model's m(s) and m(s1)
    for a second update from the same x, s and r1."""
    xp = ns.xp
    if xp is np:
        arg = coef = float
    else:
        arg, coef = (lambda v: v), (lambda v: _bc(v, x.dim()))
    cache = {} if cache is None else cache

    def model_at(x_u, u, key):
        if key not in cache:
            cache[key] = model(x_u.to(x.dtype), arg(ns.t_model(u)),
                               arg(ns.alpha(u)), arg(ns.std(u)))
        return cache[key]

    def dmean(a, b):
        return xp.exp(ns.log_mean_coeff(a) - ns.log_mean_coeff(b))

    lam_s = ns.lam(s)
    h = ns.lam(t) - lam_s
    m_s = model_at(x, s, "m_s")
    if order == 1:
        if predict_x0:
            x_t = (coef(ns.std(t) / ns.std(s)) * x
                   - coef(ns.alpha(t) * xp.expm1(-h)) * m_s)
        else:
            x_t = coef(dmean(t, s)) * x - coef(ns.std(t) * xp.expm1(h)) * m_s
        return x_t.to(x.dtype)

    s1 = ns.inv_lam(lam_s + r1 * h)
    if predict_x0:
        x_s1 = (coef(ns.std(s1) / ns.std(s)) * x
                - coef(ns.alpha(s1) * xp.expm1(-r1 * h)) * m_s)
    else:
        x_s1 = (coef(dmean(s1, s)) * x
                - coef(ns.std(s1) * xp.expm1(r1 * h)) * m_s)
    m_s1 = model_at(x_s1, s1, ("m_s1", r1))

    if order == 2:
        if predict_x0:
            phi1 = xp.expm1(-h)
            cx, base = ns.std(t) / ns.std(s), ns.alpha(t) * phi1
            cd = (-(0.5 / r1) * base if solver_type == "dpm_solver"
                  else (1.0 / r1) * ns.alpha(t) * (phi1 / h + 1.0))
        else:
            phi1 = xp.expm1(h)
            cx, base = dmean(t, s), ns.std(t) * phi1
            cd = (-(0.5 / r1) * base if solver_type == "dpm_solver"
                  else -(1.0 / r1) * ns.std(t) * (phi1 / h - 1.0))
        x_t = coef(cx) * x - coef(base) * m_s + coef(cd) * (m_s1 - m_s)
        return x_t.to(x.dtype)

    s2 = ns.inv_lam(lam_s + r2 * h)
    if predict_x0:
        phi1 = xp.expm1(-h)
        phi_22 = xp.expm1(-r2 * h) / (r2 * h) + 1.0
        phi_2 = phi1 / h + 1.0
        x_s2 = (coef(ns.std(s2) / ns.std(s)) * x
                - coef(ns.alpha(s2) * xp.expm1(-r2 * h)) * m_s
                + coef(r2 / r1 * ns.alpha(s2) * phi_22) * (m_s1 - m_s))
        m_s2 = model_at(x_s2, s2, "m_s2")
        cx, a_t = coef(ns.std(t) / ns.std(s)), ns.alpha(t)
        if solver_type == "dpm_solver":
            x_t = (cx * x - coef(a_t * phi1) * m_s
                   + coef((1.0 / r2) * a_t * phi_2) * (m_s2 - m_s))
        else:
            d1, d2 = _ss_d(m_s, m_s1, m_s2, r1, r2)
            x_t = (cx * x - coef(a_t * phi1) * m_s + coef(a_t * phi_2) * d1
                   - coef(a_t * (phi_2 / h - 0.5)) * d2)
    else:
        phi1 = xp.expm1(h)
        phi_22 = xp.expm1(r2 * h) / (r2 * h) - 1.0
        phi_2 = phi1 / h - 1.0
        x_s2 = (coef(dmean(s2, s)) * x
                - coef(ns.std(s2) * xp.expm1(r2 * h)) * m_s
                - coef(r2 / r1 * ns.std(s2) * phi_22) * (m_s1 - m_s))
        m_s2 = model_at(x_s2, s2, "m_s2")
        cx, s_t = coef(dmean(t, s)), ns.std(t)
        if solver_type == "dpm_solver":
            x_t = (cx * x - coef(s_t * phi1) * m_s
                   - coef((1.0 / r2) * s_t * phi_2) * (m_s2 - m_s))
        else:
            d1, d2 = _ss_d(m_s, m_s1, m_s2, r1, r2)
            x_t = (cx * x - coef(s_t * phi1) * m_s - coef(s_t * phi_2) * d1
                   - coef(s_t * (phi_2 / h - 0.5)) * d2)
    return x_t.to(x.dtype)


def _ss_d(m_s, m_s1, m_s2, r1, r2):
    """The order-3 Taylor update's first and second differences."""
    d1_0 = (1.0 / r1) * (m_s1 - m_s)
    d1_1 = (1.0 / r2) * (m_s2 - m_s)
    return ((r2 * d1_0 - r1 * d1_1) / (r2 - r1),
            2.0 * (d1_1 - d1_0) / (r2 - r1))


def singlestep_orders(steps: int, order: int, method: str) -> list:
    """The orders of a singlestep run's updates (dpm_solver.py:536-566,
    660-663): their sum is the model calls."""
    if not 1 <= order <= 3:
        raise ValueError(f"singlestep order must be 1, 2 or 3, got {order}")
    if method == "singlestep_fixed":
        return [order] * (steps // order)
    if order == 3:
        k = steps // 3 + 1
        return {0: [3] * (k - 2) + [2, 1], 1: [3] * (k - 1) + [1],
                2: [3] * (k - 1) + [2]}[steps % 3]
    if order == 2:
        return [2] * (steps // 2) + [1] * (steps % 2)
    return [1] * steps


def _dpm_singlestep(model, ns, x_T, steps, order, skip_type, method,
                    solver_type, predict_x0, t_T, t_0):
    """Singlestep DPM-Solver: a fixed order schedule over an outer time
    grid, each update 1–3 model calls. For ``singlestep`` off logSNR the
    outer grid indexes the fine grid at the cumulative orders, the
    reference's intent (its own cumsum there lacks a dim and raises)."""
    orders = singlestep_orders(steps, order, method)
    if method == "singlestep_fixed" or skip_type == "logSNR":
        outer = _get_time_steps(ns, skip_type, t_T, t_0, len(orders))
    else:
        grid = _get_time_steps(ns, skip_type, t_T, t_0, steps)
        outer = grid[np.cumsum([0] + orders)]
    x = x_T
    for i, o in enumerate(orders):
        s, t = float(outer[i]), float(outer[i + 1])
        lam_inner = ns.lam(_get_time_steps(ns, skip_type, s, t, o))
        h = lam_inner[-1] - lam_inner[0]
        r1 = None if o <= 1 else float((lam_inner[1] - lam_inner[0]) / h)
        r2 = None if o <= 2 else float((lam_inner[2] - lam_inner[0]) / h)
        x = _ss_update(model, ns, x, s, t, o, r1, r2, solver_type,
                       predict_x0)
    return x


def _dpm_adaptive(model, schedule, x_T, order, solver_type, predict_x0, t_T,
                  t_0, atol, rtol, h_init=0.05, theta=0.9, t_err=1e-5):
    """The adaptive step-size solver (dpm_solver.py:460-514): an embedded
    lower/higher-order singlestep pair from s to t = λ⁻¹(λ_s + h), the
    higher one reusing the lower one's model calls (``order`` calls a
    step); accept when the scaled error E ≤ 1, then
    h ← min(θ·h·E^(−1/order), λ_0 − λ_s). Times are (B,) float32 tensors;
    each step reads the loop's condition on the host once. Returns (x,
    host reads)."""
    if order not in (2, 3):
        raise ValueError(f"adaptive order must be 2 or 3, got {order}")
    ns = _NSMath(schedule.alphas_cumprod, x_T.device)
    b = x_T.shape[0]
    r1, r2 = (0.5, None) if order == 2 else (1.0 / 3.0, 2.0 / 3.0)

    def pair(x, s, t):
        """(lower, higher) from s to t, sharing m(s) and m(s1). The
        reference's order-3 update here has only its dpm_solver form."""
        cache = {}
        lower = _ss_update(model, ns, x, s, t, order - 1, r1, None,
                           solver_type, predict_x0, cache)
        higher = _ss_update(model, ns, x, s, t, order, r1, r2,
                            solver_type if order == 2 else "dpm_solver",
                            predict_x0, cache)
        return lower, higher

    vec = lambda v: torch.full((b,), v, dtype=torch.float32,
                               device=x_T.device)
    lam_0 = ns.lam(vec(t_0))
    s = vec(t_T)
    lam_s = ns.lam(s)
    h = vec(h_init)
    x, x_prev = x_T, x_T
    syncs = 1
    go = bool((s - t_0).abs().mean() > t_err)
    while go:
        t = ns.inv_lam(lam_s + h)
        x_lower, x_higher = pair(x, s, t)
        delta = torch.clamp(
            rtol * torch.maximum(x_lower.abs(), x_prev.abs()), min=atol)
        err = ((x_higher - x_lower) / delta).reshape(b, -1)
        e = torch.sqrt(torch.mean(err ** 2, dim=-1)).max()
        accept = e <= 1.0
        x = torch.where(accept, x_higher, x)
        s = torch.where(accept, t, s)
        x_prev = torch.where(accept, x_lower, x_prev)
        lam_s = torch.where(accept, ns.lam(s), lam_s)
        h = torch.minimum(theta * h * e ** (-1.0 / order), lam_0 - lam_s)
        go = bool((s - t_0).abs().mean() > t_err)
        syncs += 1
    return x, syncs


# ---- PLMS -------------------------------------------------------------------

def plms_sample(eps_fn: EpsFn, schedule: DiffusionSchedule, x_T: torch.Tensor,
                steps: int = 25) -> torch.Tensor:
    """Pseudo linear multistep (plms.py:58-236), η 0: Adams-Bashforth on
    the ε history, orders 1–4. The first step is the 2-call midpoint
    bootstrap, its second call at t_next with the classifier scale
    √(1−ᾱ) there (α_prev); the last step's t_next clips at 0. Calls:
    the DDIM steps plus one."""
    c = _ddim_tables(schedule, steps, 0.0)
    ts = c["t"]
    n = len(ts)
    rev = lambda a: a[::-1]
    t_next = np.concatenate([rev(ts)[1:], [ts[0] - (ts[1] - ts[0])]]).clip(
        min=0).astype(f32)
    # at η 0 "dir" is √(1 − α_prev): also the bootstrap's second scale
    sqrt_a, sqrt_ap, s1ma, dir_ = (rev(c[k]) for k in
                                   ("sqrt_a", "sqrt_a_prev", "s1ma", "dir"))

    def x_prev(x, e, i):
        pred_x0 = (x - float(s1ma[i]) * e) / float(sqrt_a[i])
        return (float(sqrt_ap[i]) * pred_x0 + float(dir_[i]) * e).to(x.dtype)

    t_r = rev(ts).astype(f32)
    e0 = eps_fn(x_T, _full(x_T, float(t_r[0])), float(s1ma[0]))
    x1 = x_prev(x_T, e0, 0)
    e0_next = eps_fn(x1, _full(x1, float(t_next[0])), float(dir_[0]))
    x = x_prev(x_T, 0.5 * (e0 + e0_next), 0)
    hist = [e0]   # most recent first
    for i in range(1, n):
        e_t = eps_fn(x, _full(x, float(t_r[i])), float(s1ma[i]))
        k = min(len(hist), 3)
        if k == 1:
            e_prime = (3.0 * e_t - hist[0]) / 2.0
        elif k == 2:
            e_prime = (23.0 * e_t - 16.0 * hist[0] + 5.0 * hist[1]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * hist[0] + 37.0 * hist[1]
                       - 9.0 * hist[2]) / 24.0
        x = x_prev(x, e_prime, i)
        hist = [e_t] + hist[:2]
    return x
