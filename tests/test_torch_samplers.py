"""The port's sampler library and schedule against the JAX package's, on
the CPU.

The samplers run on a closed-form ε (``_toy_eps``, as in
test_torch_models.py) at (2, 4, 8, 4), so the comparison is the solvers'
own arithmetic: 1e-5 of x (adaptive DPM-Solver: 1e-4, and the same number
of model calls). Stochastic samplers get the JAX package's own draws from
its key stream: ``split(key, n)``, ``normal(k)`` for the step noise,
``fold_in(k, 1)`` for the mask's forward noise and ``fold_in(k, 2)`` for
the noise-dropout Bernoulli. The schedule's tables are held bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.diffusion import guidance as jg
from diff_foley_tpu.diffusion import samplers as js
from diff_foley_tpu.diffusion import schedule as jsch
from diff_foley_tpu_torch.diffusion import guidance as tg
from diff_foley_tpu_torch.diffusion import samplers as ts
from diff_foley_tpu_torch.diffusion import schedule as tsch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

KW = dict(timesteps=1000, linear_start=0.00085, linear_end=0.0120)
J_SCHED = jsch.DiffusionSchedule.create(**KW)
T_SCHED = tsch.DiffusionSchedule.create(**KW)
SHAPE = (2, 4, 8, 4)
TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
          "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1",
          "posterior_mean_coef2", "lvlb_weights")


def _toy_eps_jax(x, t, s):
    return 0.5 * jnp.sin(x) + 1e-3 * t.reshape(-1, 1, 1, 1) * jnp.cos(x) \
        + 0.1 * s


def _toy_eps_torch(x, t, s):
    return 0.5 * torch.sin(x) + 1e-3 * t.reshape(-1, 1, 1, 1) \
        * torch.cos(x) + 0.1 * s


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _x(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(out, ref, tol, what=""):
    """max|Δ| ≤ tol · max(1, max|ref|)."""
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    scale = max(1.0, np.abs(ref).max())
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3e} > {tol:.1e}·{scale:.3g}"


def _jax_draws(key, n, shape, dropout=0.0, mask=False):
    """The JAX loops' per-step draws of ``key``: {"noise", "keep"} and the
    mask's forward noise. (jax.random's functions are jitted per shape, so
    a loop over the keys compiles each of them once.)"""
    keys = jax.random.split(key, n)
    stack = lambda f: torch.from_numpy(np.stack([np.array(f(k))
                                                 for k in keys]))
    draws = {"noise": stack(lambda k: jax.random.normal(k, shape))}
    if dropout:
        draws["keep"] = stack(lambda k: jax.random.bernoulli(
            jax.random.fold_in(k, 2), 1.0 - dropout, shape))
    mask_noise = stack(lambda k: jax.random.normal(
        jax.random.fold_in(k, 1), shape)) if mask else None
    return draws, mask_noise


# ---- the schedule -------------------------------------------------------------

@pytest.mark.parametrize("beta", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_schedule_tables_bit_for_bit(beta):
    # every table of the four β schedules, with v_posterior 0 and 0.1 and
    # both parameterisations, equal to JAX's float32 tables
    for kw in (dict(), dict(v_posterior=0.1, parameterization="x0")):
        j = jsch.DiffusionSchedule.create(timesteps=200, beta_schedule=beta,
                                          linear_start=1e-4, linear_end=2e-2,
                                          **kw)
        t = tsch.DiffusionSchedule.create(timesteps=200, beta_schedule=beta,
                                          linear_start=1e-4, linear_end=2e-2,
                                          **kw)
        for name in TABLES:
            ref = np.asarray(getattr(j, name))
            got = getattr(t, name)
            assert got.dtype == np.float32, name
            np.testing.assert_array_equal(got, ref, err_msg=f"{beta} {name}")
    with pytest.raises(ValueError):
        tsch.make_beta_schedule("exp", 10)


def test_schedule_helpers_match():
    # the flagship's tables (stage-2 trains on them) are unchanged, and the
    # forward-process helpers at per-example steps and at one step
    x, n, x0 = _x(1), _x(2), _x(3)
    steps = np.array([0, 999], np.int32)
    tt = torch.from_numpy(steps.astype(np.int64))
    jt = jnp.asarray(steps)
    for got, ref in (
            (T_SCHED.q_sample(_t(x), tt, _t(n)),
             J_SCHED.q_sample(jnp.asarray(x), jt, jnp.asarray(n))),
            (T_SCHED.predict_start_from_noise(_t(x), tt, _t(n)),
             J_SCHED.predict_start_from_noise(jnp.asarray(x), jt,
                                              jnp.asarray(n))),
            (T_SCHED.predict_eps_from_start(_t(x), tt, _t(x0)),
             J_SCHED.predict_eps_from_start(jnp.asarray(x), jt,
                                            jnp.asarray(x0))),
            (T_SCHED.predict_start_from_noise(_t(x), 500, _t(n)),
             J_SCHED.predict_start_from_noise(
                 jnp.asarray(x), jnp.full((2,), 500), jnp.asarray(n)))):
        _close(got, ref, 1e-6)
    for got, ref in zip(T_SCHED.q_posterior(_t(x0), _t(x), tt),
                        J_SCHED.q_posterior(jnp.asarray(x0), jnp.asarray(x),
                                            jt)):
        _close(got * torch.ones(SHAPE), jnp.broadcast_to(ref, SHAPE), 1e-6)
    for got, ref in zip(T_SCHED.q_mean_variance(_t(x0), tt),
                        J_SCHED.q_mean_variance(jnp.asarray(x0), jt)):
        _close(got * torch.ones(SHAPE), jnp.broadcast_to(ref, SHAPE), 1e-6)
    _close(tsch.extract_into_tensor(T_SCHED.betas, tt, SHAPE),
           jsch.extract_into_tensor(J_SCHED.betas, jt, SHAPE), 0.0)
    for method, n_steps in (("uniform", 25), ("uniform", 6), ("quad", 25),
                            ("quad", 10)):
        ts_t = tsch.make_ddim_timesteps(n_steps, 1000, method)
        np.testing.assert_array_equal(
            ts_t, jsch.make_ddim_timesteps(method, n_steps, 1000))
        ac = np.asarray(J_SCHED.alphas_cumprod, np.float64)
        for a, b in zip(tsch.make_ddim_sampling_parameters(ac, ts_t, 0.7),
                        jsch.make_ddim_sampling_parameters(ac, ts_t, 0.7)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        tsch.make_ddim_timesteps(10, 1000, "cubic")


# ---- guidance -------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["noise", "x_start", "v"])
def test_guidance_model_types_match(model_type):
    # CFG 4.5 and the classifier term at 50·σ on closed-form model and
    # classifier functions: the raw output converted to ε (α = √(1−σ²))
    # before the classifier term, σ a float or one per row
    rng = np.random.default_rng(5)
    x, ctx, feat = (rng.standard_normal(s).astype(np.float32)
                    for s in (SHAPE, (2, 3, 5), (2, 3, 7)))
    w = rng.standard_normal(SHAPE[1:]).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)

    def model_j(x_, t_, c_):
        return 0.3 * jnp.sin(x_) + 1e-3 * t_.reshape(-1, 1, 1, 1) \
            + c_.mean(axis=(1, 2)).reshape(-1, 1, 1, 1)

    def model_t(x_, t_, c_):
        return 0.3 * torch.sin(x_) + 1e-3 * t_.reshape(-1, 1, 1, 1) \
            + c_.mean(dim=(1, 2)).reshape(-1, 1, 1, 1)

    def clf_j(x_, t_, f_):
        z = (jnp.tanh(x_) * w).sum(axis=(1, 2, 3)) + f_.mean(axis=(1, 2))
        return jax.nn.log_sigmoid(z)[:, None]

    def clf_t(x_, t_, f_):
        z = (torch.tanh(x_) * _t(w)).sum(dim=(1, 2, 3)) + f_.mean(dim=(1, 2))
        return torch.nn.functional.logsigmoid(z)[:, None]

    spec = dict(cfg_scale=4.5, classifier_scale=50.0)
    j_eps = jg.make_guided_eps_fn(model_j, jnp.asarray(ctx),
                                  jnp.zeros_like(ctx), jg.GuidanceSpec(**spec),
                                  clf_j, jnp.asarray(feat),
                                  model_type=model_type)
    t_eps = tg.make_guided_eps_fn(model_t, _t(ctx), torch.zeros(ctx.shape),
                                  tg.GuidanceSpec(**spec), clf_t, _t(feat),
                                  model_type=model_type)
    sig = np.array([0.3, 0.9], np.float32).reshape(-1, 1, 1, 1)
    for sj, st in ((np.float32(0.6), 0.6), (jnp.asarray(sig), _t(sig))):
        ref = j_eps(jnp.asarray(x), jnp.asarray(t), sj)
        _close(t_eps(_t(x), _t(t), st), ref, 1e-5, model_type)
    with pytest.raises(ValueError):
        tg.make_guided_eps_fn(model_t, _t(ctx), None, tg.GuidanceSpec(),
                              model_type="score")


# ---- DPM-Solver -------------------------------------------------------------

# the JAX file's library list (tests/test_samplers.py), multistep orders
# 1–3 at 14 and 15 steps (either side of lower_order_final), the time
# range, thresholding and denoise_to_zero
DPM_CASES = [
    dict(steps=12, method="multistep", order=1),
    dict(steps=12, method="multistep", order=2),
    dict(steps=20, method="multistep", order=3),
    dict(steps=12, method="multistep", order=2, solver_type="taylor"),
    dict(steps=12, method="multistep", order=2, predict_x0=False),
    dict(steps=20, method="multistep", order=3, predict_x0=False),
    dict(steps=12, method="multistep", order=2, skip_type="logSNR"),
    dict(steps=12, method="multistep", order=2, thresholding=True),
    dict(steps=12, method="multistep", order=2, denoise_to_zero=True),
    dict(steps=12, method="singlestep", order=2, skip_type="logSNR"),
    dict(steps=12, method="singlestep", order=3, skip_type="logSNR"),
    dict(steps=13, method="singlestep", order=3, skip_type="logSNR"),
    dict(steps=12, method="singlestep", order=3, skip_type="logSNR",
         solver_type="taylor"),
    dict(steps=12, method="singlestep", order=2, skip_type="logSNR",
         predict_x0=False),
    dict(steps=12, method="singlestep_fixed", order=2,
         skip_type="time_quadratic"),
    dict(steps=12, method="singlestep_fixed", order=3),
    dict(steps=11, method="singlestep", order=3, skip_type="time_uniform"),
    dict(steps=14, method="singlestep", order=1, predict_x0=False,
         solver_type="taylor"),
    *[dict(steps=s, method="multistep", order=o)
      for o in (1, 2, 3) for s in (14, 15)],
    dict(steps=15, method="multistep", order=3, solver_type="taylor",
         skip_type="time_quadratic"),
    dict(steps=12, method="multistep", order=3, t_start=0.8, t_end=0.01),
    dict(steps=12, method="multistep", order=2, thresholding=True,
         max_val=0.5, denoise_to_zero=True, predict_x0=True),
    dict(steps=10, method="singlestep_fixed", order=2, thresholding=True),
]


@pytest.mark.parametrize(
    "kw", DPM_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_dpm_solver_library_matches(kw):
    x_T = _x(10)
    ref = js.dpm_solver_sample(_toy_eps_jax, J_SCHED, jnp.asarray(x_T), **kw)
    stats = {}
    out = ts.dpm_solver_sample(_toy_eps_torch, T_SCHED, _t(x_T), stats=stats,
                               **kw)
    _close(out, ref, 1e-5, str(kw))
    orders = (ts.singlestep_orders(kw["steps"], kw["order"], kw["method"])
              if kw["method"] != "multistep" else [1] * kw["steps"])
    assert stats["nfe"] == sum(orders) + bool(kw.get("denoise_to_zero"))


@pytest.mark.parametrize("model_type", ["x_start", "v"])
@pytest.mark.parametrize("predict_x0", [True, False])
def test_dpm_model_types_match(model_type, predict_x0):
    # the toy output read as x₀ or v, converted to ε with the solver's α
    x_T = _x(11)
    kw = dict(steps=10, order=3, model_type=model_type,
              predict_x0=predict_x0)
    ref = js.dpm_solver_sample(_toy_eps_jax, J_SCHED, jnp.asarray(x_T), **kw)
    out = ts.dpm_solver_sample(_toy_eps_torch, T_SCHED, _t(x_T), **kw)
    _close(out, ref, 1e-5, model_type)


@pytest.mark.parametrize("order", [2, 3])
def test_dpm_adaptive_matches_with_equal_calls(order):
    # the data-dependent step size on float32 device tables: the same
    # accept/reject sequence, so the same model calls (JAX's loop calls the
    # model 3 (order 2) or 5 (order 3) times a step without reusing m_s;
    # the port, as the reference, ``order`` times), and x within 1e-4
    calls = []

    def counted(x, t, s):
        jax.debug.callback(lambda: calls.append(1))
        return _toy_eps_jax(x, t, s)

    x_T = _x(12)
    kw = dict(method="adaptive", order=order, rtol=0.02)
    ref = js.dpm_solver_sample(counted, J_SCHED, jnp.asarray(x_T), **kw)
    jax.effects_barrier()
    stats = {}
    out = ts.dpm_solver_sample(_toy_eps_torch, T_SCHED, _t(x_T), stats=stats,
                               **kw)
    per_step = 3 if order == 2 else 5
    assert len(calls) % per_step == 0
    steps = len(calls) // per_step
    assert steps >= 5
    assert stats["nfe"] == order * steps
    assert stats["host_syncs"] == steps + 1
    _close(out, ref, 1e-4, f"adaptive {order}")


def test_dpm_rejects_unknown_options():
    x = _t(_x(13))
    for kw in (dict(method="pndm"), dict(skip_type="karras"),
               dict(solver_type="heun"), dict(model_type="score"),
               dict(order=4), dict(method="adaptive", order=1),
               dict(method="singlestep", order=4)):
        with pytest.raises(ValueError):
            ts.dpm_solver_sample(_toy_eps_torch, T_SCHED, x, steps=6, **kw)


# ---- DDIM, img2img, PLMS --------------------------------------------------------

DDIM_CASES = [
    dict(steps=10, eta=0.5),
    dict(steps=10, eta=1.0, temperature=0.7),
    dict(steps=12, eta=1.0, discr_method="quad", noise_dropout=0.1),
    dict(steps=8, eta=0.0, discr_method="quad", score=True, denoise=True),
    dict(steps=8, eta=0.5, mask=True, noise_dropout=0.3, score=True),
]


@pytest.mark.parametrize("kw", DDIM_CASES, ids=str)
def test_ddim_options_match(kw):
    kw = dict(kw)
    score, denoise, masked = (kw.pop(k, False)
                              for k in ("score", "denoise", "mask"))
    x_T, x0 = _x(20), _x(21)
    mask = np.zeros(SHAPE[:3] + (1,), np.float32)
    mask[:, :, :4] = 1.0
    key = jax.random.PRNGKey(7)
    n = len(tsch.make_ddim_timesteps(kw["steps"], 1000,
                                     kw.get("discr_method", "uniform")))
    draws, mask_noise = _jax_draws(key, n, SHAPE, kw.get("noise_dropout", 0),
                                   masked)
    jkw, tkw = dict(kw), dict(kw)
    if score:
        jkw["score_corrector"] = lambda e, x, t: e * 0.9 + 1e-4 * t.reshape(
            -1, 1, 1, 1)
        tkw["score_corrector"] = lambda e, x, t: e * 0.9 + 1e-4 * t.reshape(
            -1, 1, 1, 1)
    if denoise:
        jkw["denoised_fn"] = lambda x0_: jnp.clip(x0_, -1.0, 1.0)
        tkw["denoised_fn"] = lambda x0_: x0_.clamp(-1.0, 1.0)
    if masked:
        # JAX draws the mask's noise itself (fold_in 1); the port is handed it
        jkw.update(mask=jnp.asarray(mask), x0=jnp.asarray(x0))
        tkw.update(mask=_t(mask), x0=_t(x0), mask_noise=mask_noise)
    ref = js.ddim_sample(_toy_eps_jax, J_SCHED, jnp.asarray(x_T), key, **jkw)
    out = ts.ddim_sample(_toy_eps_torch, T_SCHED, _t(x_T), draws=draws,
                         **tkw)
    _close(out, ref, 1e-5, str(kw))


def test_img2img_encode_decode_match():
    x0, noise = _x(22), _x(23)
    key = jax.random.PRNGKey(0)
    for t_index in (12, np.array([3, 20])):
        jt = t_index if isinstance(t_index, int) else jnp.asarray(t_index)
        tt = t_index if isinstance(t_index, int) else torch.from_numpy(
            t_index)
        ref = js.ddim_stochastic_encode(J_SCHED, jnp.asarray(x0), jt, key,
                                        noise=jnp.asarray(noise))
        out = ts.ddim_stochastic_encode(T_SCHED, _t(x0), tt,
                                        noise=_t(noise))
        _close(out, ref, 1e-6, "encode")
    z = ts.ddim_stochastic_encode(T_SCHED, _t(x0), 12, noise=_t(noise))
    ref = js.ddim_decode(_toy_eps_jax, J_SCHED, jnp.asarray(z.numpy()), 12)
    out = ts.ddim_decode(_toy_eps_torch, T_SCHED, z, 12)
    _close(out, ref, 1e-5, "decode")
    # the encode's own draw: finite and of x0's shape
    g = torch.Generator().manual_seed(0)
    assert ts.ddim_stochastic_encode(T_SCHED, _t(x0), 5,
                                     generator=g).shape == SHAPE
    with pytest.raises(ValueError):
        ts.ddim_decode(_toy_eps_torch, T_SCHED, z, 0)


@pytest.mark.parametrize("steps", [6, 25])
def test_plms_matches(steps):
    calls = []
    x_T = _x(24)
    ref = js.plms_sample(_toy_eps_jax, J_SCHED, jnp.asarray(x_T), steps=steps)
    out = ts.plms_sample(lambda *a: calls.append(1) or _toy_eps_torch(*a),
                         T_SCHED, _t(x_T), steps=steps)
    _close(out, ref, 1e-5, "plms")
    assert len(calls) == len(tsch.make_ddim_timesteps(steps, 1000)) + 1


# ---- the ancestral chain ------------------------------------------------------

CHAIN_CASES = [
    dict(fn="p_sample_loop", timesteps=30, log_every_t=7,
         return_intermediates=True),
    dict(fn="p_sample_loop", timesteps=40, start_T=25, clip_denoised=True,
         temperature="per_t", noise_dropout=0.2, mask=True, score=True),
    dict(fn="progressive_denoising", timesteps=30, log_every_t=10,
         temperature="per_t", denoise=True),
    dict(fn="progressive_denoising", timesteps=20, mask=True,
         clip_denoised=True, log_every_t=4),
]


@pytest.mark.parametrize("kw", CHAIN_CASES, ids=str)
def test_ancestral_chain_matches(kw):
    kw = dict(kw)
    name = kw.pop("fn")
    score, denoise, masked = (kw.pop(k, False)
                              for k in ("score", "denoise", "mask"))
    T = min(kw["timesteps"], kw.get("start_T", kw["timesteps"]))
    x_T, x0 = _x(30), _x(31)
    mask = np.zeros(SHAPE[:3] + (1,), np.float32)
    mask[:, :, 4:] = 1.0
    key = jax.random.PRNGKey(9)
    draws, mask_noise = _jax_draws(key, T, SHAPE, kw.get("noise_dropout", 0),
                                   masked)
    if kw.get("temperature") == "per_t":
        kw["temperature"] = np.linspace(0.5, 1.2, kw["timesteps"])
    jkw, tkw = dict(kw), dict(kw)
    if score:
        jkw["score_corrector"] = lambda e, x, t: e + 1e-4 * t.reshape(
            -1, 1, 1, 1)
        tkw["score_corrector"] = lambda e, x, t: e + 1e-4 * t.reshape(
            -1, 1, 1, 1)
    if denoise:
        jkw["denoised_fn"] = lambda x0_: 0.9 * x0_
        tkw["denoised_fn"] = lambda x0_: 0.9 * x0_
    if masked:
        jkw.update(mask=jnp.asarray(mask), x0=jnp.asarray(x0))
        tkw.update(mask=_t(mask), x0=_t(x0), mask_noise=mask_noise)
    ref = getattr(js, name)(_toy_eps_jax, J_SCHED, jnp.asarray(x_T), key,
                            **jkw)
    out = getattr(ts, name)(_toy_eps_torch, T_SCHED, _t(x_T), draws=draws,
                            **tkw)
    if isinstance(ref, tuple):
        assert isinstance(out, tuple) and len(out) == 2
        _close(out[1], ref[1], 1e-5, f"{name} intermediates")
        ref, out = ref[0], out[0]
    _close(out, ref, 1e-5, name)


def test_stochastic_samplers_draw_from_the_generator():
    # without draws each call draws from its generator: a seed repeats the
    # result, another seed changes it
    x_T = _t(_x(40))

    def run(seed, fn, **kw):
        return fn(_toy_eps_torch, T_SCHED, x_T,
                  generator=torch.Generator().manual_seed(seed), **kw)

    for fn, kw in ((ts.ddim_sample, dict(steps=5, eta=1.0,
                                         noise_dropout=0.5)),
                   (ts.p_sample_loop, dict(timesteps=5))):
        a, b, c = run(0, fn, **kw), run(0, fn, **kw), run(1, fn, **kw)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert torch.isfinite(a).all()


def test_bf16_carry_keeps_its_dtype():
    # a float32 model output never promotes a bf16 latent
    x_T = _t(_x(41)).to(torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    outs = [
        ts.dpm_solver_sample(_toy_eps_torch, T_SCHED, x_T, steps=6, order=3),
        ts.dpm_solver_sample(_toy_eps_torch, T_SCHED, x_T, steps=6,
                             method="singlestep", order=3),
        ts.ddim_sample(_toy_eps_torch, T_SCHED, x_T, steps=6, eta=1.0,
                       generator=g),
        ts.plms_sample(_toy_eps_torch, T_SCHED, x_T, steps=6),
        ts.p_sample_loop(_toy_eps_torch, T_SCHED, x_T, timesteps=4,
                         generator=g),
    ]
    for out in outs:
        assert out.dtype == torch.bfloat16
