"""The port's diffusion stack against the JAX package, on the CPU, through
the entries a user calls: ``LatentDiffusion.sample``'s dispatch (PLMS, the
ancestral chain, progressive denoising, DPM-Solver with options) with CFG
and the alignment classifier, ``inpaint(sampler="ancestral")``,
``GenerationConfig.solver_opts`` through ``generate``, the tiled canvas
(tests/test_tiled_latent.py's cases) and ``cli.generate --sampler plms``.

The tiny LDM and classifier are test_torch_pipeline.py's, carried over
with ``from_jax_params``; x_T, the chain's step noise (the JAX key
stream's own draws) and Griffin-Lim's phase are shared. The JAX reference
is its ``LatentDiffusion.sample`` composed from its parts: the guided ε
(CFG 4.5 and the classifier at 50, ``make_guided_eps_fn`` as ``sample``
builds it) jitted once, and the JAX sampler run op by op under
``jax.disable_jit()`` around it (compiling ``sample`` whole costs 8–28 s
a sampler here). Latents: 1e-4 of x, as the tiny-UNet DDIM inpaint case.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu import pipeline as jpipe
from diff_foley_tpu.diffusion import samplers as js
from diff_foley_tpu.diffusion import tiled as jt
from diff_foley_tpu.diffusion.guidance import GuidanceSpec as JSpec
from diff_foley_tpu.diffusion.guidance import make_guided_eps_fn as j_guided
from diff_foley_tpu_torch import pipeline as tpipe
from diff_foley_tpu_torch.cli import generate as generate_cli
from diff_foley_tpu_torch.diffusion import samplers as ts
from diff_foley_tpu_torch.diffusion import tiled as tt
from diff_foley_tpu_torch.diffusion.guidance import (GuidanceSpec,
                                                     make_guided_eps_fn)
from diff_foley_tpu_torch.ops import hopper_attention as ha
from diff_foley_tpu_torch.ops import hopper_groupnorm as hg
from test_torch_pipeline import _tiny_pair
from test_torch_samplers import _close, _jax_draws
from test_torch_video import _read_pcm, _tiny_configs, write_clip

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

B = 2
LATENT = (B, 16, 64, 4)
GUIDE = dict(cfg_scale=4.5, classifier_scale=50.0)


@pytest.fixture(scope="module")
def pair():
    pipe_j, pipe_t = _tiny_pair()
    ldm, params = pipe_j.ldm, pipe_j.params
    clf_apply, clf_params = pipe_j.classifier

    @jax.jit
    def eps(x, t, s, ctx, feat):
        def clf_fn(x_, t_, f_):
            return jax.nn.log_sigmoid(clf_apply(clf_params, x_, t_, f_,
                                                return_logits=True))
        return j_guided(lambda x_, t_, c_: ldm.apply_model(params, x_, t_, c_),
                        ctx, jnp.zeros_like(ctx), JSpec(**GUIDE), clf_fn,
                        feat)(x, t, s)

    def eps_for(feat):
        """JAX's guided ε of ``sample`` for these features, jitted inside
        the JAX samplers' op-by-op loops."""
        feat = jnp.asarray(feat)
        ctx = ldm.get_learned_conditioning(params, feat)

        def eps_fn(x, t, s):
            with jax.disable_jit(False):
                return eps(x, t.astype(jnp.float32),
                           jnp.asarray(s, jnp.float32), ctx, feat)
        return eps_fn

    return pipe_j, pipe_t, eps_for


def _inputs(seed, b=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 512)).astype(np.float32),
            rng.standard_normal((b, 16, 64, 4)).astype(np.float32))


def _port_sample(pipe_t, feat, x_T, sampler, steps, **kw):
    with torch.no_grad():
        return pipe_t.ldm.sample(
            torch.from_numpy(feat), sampler=sampler, steps=steps,
            classifier=pipe_t.classifier, x_T=torch.from_numpy(x_T), **GUIDE,
            **kw)


@pytest.mark.parametrize("sampler,kw,steps", [
    ("plms", {}, 4),
    ("dpm", dict(order=3, method="singlestep", skip_type="logSNR",
                 solver_type="taylor"), 5),
    ("dpm", dict(order=2, predict_x0=False, thresholding=True), 3),
    ("ancestral", dict(timesteps=4, temperature=0.8, log_every_t=2,
                       return_intermediates=True), 25),
    ("progressive", dict(timesteps=3, clip_denoised=True), 25),
], ids=["plms", "dpm-singlestep3", "dpm-eps-threshold", "ancestral",
        "progressive"])
def test_sample_dispatch_matches(pair, sampler, kw, steps):
    pipe_j, pipe_t, eps_for = pair
    feat, x_T = _inputs(60)
    sched = pipe_j.ldm.schedule
    torch_kw = dict(kw)
    with jax.disable_jit():
        eps = eps_for(feat)
        if sampler == "plms":
            ref = js.plms_sample(eps, sched, jnp.asarray(x_T), steps=steps)
        elif sampler == "dpm":
            ref = js.dpm_solver_sample(eps, sched, jnp.asarray(x_T),
                                       steps=steps, **kw)
        else:
            # sample's key 3 splits into the initial noise's and the chain's
            k_samp = jax.random.split(jax.random.PRNGKey(3))[1]
            torch_kw["draws"] = _jax_draws(k_samp, kw["timesteps"],
                                           LATENT)[0]
            chain = (js.progressive_denoising if sampler == "progressive"
                     else js.p_sample_loop)
            ref = chain(eps, sched, jnp.asarray(x_T), k_samp, **kw)
    out = _port_sample(pipe_t, feat, x_T, sampler, steps, **torch_kw)
    if isinstance(ref, tuple):
        assert isinstance(out, tuple)
        _close(out[1], ref[1], 1e-4, f"{sampler} logged")
        out, ref = out[0], ref[0]
    _close(out, ref, 1e-4, sampler)


def test_sample_routes_model_type_into_guidance(pair):
    # DPM-Solver's model_type goes into the guided ε (converted before the
    # classifier term), and the solver gets a plain ε model: bit for bit the
    # composition by hand (guidance's conversion is held against JAX in
    # tests/test_torch_samplers.py)
    _, pipe_t, _ = pair
    feat, x_T = _inputs(61)
    ldm = pipe_t.ldm
    out = _port_sample(pipe_t, feat, x_T, "dpm", 3, model_type="x_start",
                       order=1)
    with torch.no_grad():
        f = torch.from_numpy(feat)
        ctx = ldm.get_learned_conditioning(f)
        eps = make_guided_eps_fn(
            ldm.apply_model, ctx, torch.zeros_like(ctx), GuidanceSpec(**GUIDE),
            lambda x, t, c: torch.nn.functional.logsigmoid(
                pipe_t.classifier(x, t, c, return_logits=True)), f,
            model_type="x_start")
        ref = ts.dpm_solver_sample(eps, ldm.schedule, torch.from_numpy(x_T),
                                   steps=3, order=1)
    assert torch.equal(out, ref)


def test_sample_dispatch_refusals(pair):
    _, pipe_t, _ = pair
    feat = torch.zeros(1, 32, 512)
    ldm = pipe_t.ldm
    with pytest.raises(TypeError, match="plms accepts no solver options"):
        ldm.sample(feat, sampler="plms", order=3)
    with pytest.raises(TypeError, match="plms accepts no solver options"):
        ldm.sample(feat, sampler="plms", model_type="v")
    with pytest.raises(ValueError, match="unknown sampler"):
        ldm.sample(feat, sampler="euler")
    for kw in (dict(method="pndm"), dict(skip_type="karras"),
               dict(solver_type="heun"), dict(model_type="score")):
        with pytest.raises(ValueError):
            ldm.sample(feat, sampler="dpm", steps=2, **kw)
    with pytest.raises(TypeError):   # the DPM-Solver has no mask path
        ldm.sample(feat, sampler="dpm", steps=2,
                   mask=torch.ones(1, 16, 64, 1), x0=torch.zeros(1, 16, 64, 4))


def test_inpaint_ancestral_matches_jax(pair):
    # the ancestral chain's 5 steps keeping the first 256 frames of the
    # window: the blend after each posterior step with JAX's step and mask
    # draws, the final composite and the decode; specs in [0, 1]: 1e-4
    pipe_j, pipe_t, eps_for = pair
    w, s, T = 1, 2, 5
    kw = dict(sampler="ancestral", sample_num=s, gl_iters=2,
              solver_opts=(("timesteps", T),), **GUIDE)
    rng = np.random.default_rng(62)
    feats = rng.standard_normal((w * 32, 512)).astype(np.float32)
    known = rng.uniform(0.2, 0.8, size=(128, w * 512)).astype(np.float32)
    mask = tpipe.continuation_mask(512, 256)
    x_T = rng.standard_normal(LATENT).astype(np.float32)
    # inpaint's sampling key, then sample's split of it
    k_samp = jax.random.split(jax.random.split(jax.random.PRNGKey(6))[0])[1]
    draws, mask_noise = _jax_draws(k_samp, T, LATENT, mask=True)

    ldm, vp = pipe_j.ldm, pipe_j.vae_params
    z0 = jax.jit(ldm.encode_first_stage)(vp, jnp.repeat(
        jnp.asarray(known)[None, ..., None], 3, axis=-1))
    z0 = jnp.repeat(z0, s, 0)
    m = jnp.repeat(jnp.asarray(jpipe.spec_mask_to_latent(mask[None])), s, 0)
    with jax.disable_jit():
        z = js.p_sample_loop(eps_for(np.repeat(feats[None], s, 0)),
                             ldm.schedule, jnp.asarray(x_T), k_samp,
                             timesteps=T, mask=m, x0=z0)
    z = z0 * m + (1.0 - m) * z
    specs = jnp.clip(jax.jit(ldm.decode_first_stage)(vp, z)[..., 0], 0.0,
                     1.0)

    out = pipe_t.inpaint(feats, known, mask,
                         gen=tpipe.GenerationConfig(**kw),
                         x_T=torch.from_numpy(x_T), mask_noise=mask_noise,
                         draws=draws)
    assert out["spec"].shape == (s, 128, 512)
    assert np.abs(out["spec"] - np.asarray(specs)).max() <= 1e-4
    assert out["wav"].shape == (s, 131072) and np.isfinite(out["wav"]).all()


def test_generate_takes_solver_opts(pair):
    # GenerationConfig.solver_opts reach the sampler on generate's path:
    # bit for bit sample's call with the same options, decoded
    _, pipe_t, _ = pair
    feat, x_T = _inputs(63, 1)
    x_T = np.repeat(x_T, 2, 0)
    opts = (("order", 3), ("skip_type", "time_quadratic"))
    gen = tpipe.GenerationConfig(steps=4, sample_num=2, gl_iters=1,
                                 solver_opts=opts, **GUIDE)
    out = pipe_t.generate(feat[0], gen=gen, x_T=torch.from_numpy(x_T))
    z = _port_sample(pipe_t, np.repeat(feat, 2, 0), x_T, "dpm", 4,
                     **dict(opts))
    ref = pipe_t.decode_specs(z).numpy()
    np.testing.assert_array_equal(out["spec"], ref)
    plain = pipe_t.generate(feat[0], gen=tpipe.GenerationConfig(
        steps=4, sample_num=2, gl_iters=1, **GUIDE), x_T=torch.from_numpy(x_T))
    assert np.abs(out["spec"] - plain["spec"]).max() > 1e-3


# ---- the tiled canvas (tests/test_tiled_latent.py's cases) ---------------------

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def test_tiled_helpers_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
    p = tt.unfold_patches(_nchw(x), (4, 4), (4, 4))
    assert p.shape == (6, 2, 3, 4, 4)
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jt.unfold_patches(jnp.asarray(x), (4, 4),
                                                (4, 4))).transpose(
            0, 1, 4, 2, 3))
    back = tt.fold_patches(p, (8, 12), (4, 4), (4, 4))
    np.testing.assert_array_equal(back.numpy(), _nchw(x).numpy())
    np.testing.assert_array_equal(tt.delta_border(5, 7).numpy(),
                                  np.asarray(jt.delta_border(5, 7)))
    for split in (jt.SplitInputParams(),
                  jt.SplitInputParams(tie_braker=False, clip_min_weight=0.1)):
        tsplit = tt.SplitInputParams(**vars(split))
        np.testing.assert_array_equal(
            tt.get_weighting(16, 24, 2, 3, tsplit).numpy(),
            np.asarray(jt.get_weighting(16, 24, 2, 3, split)))
    # a pointwise function: the weighted overlap-add gives it back
    x = rng.normal(size=(2, 16, 24, 4)).astype(np.float32)
    split = tt.SplitInputParams(ks=(8, 8), stride=(4, 4))
    out = tt.tiled_apply(lambda t: 2.0 * t + 1.0, _nchw(x), split)
    _close(out, 2.0 * _nchw(x) + 1.0, 1e-5, "pointwise identity")
    with pytest.raises(ValueError, match="not covered"):
        tt.tiled_apply(lambda t: t, _nchw(x), tt.SplitInputParams(
            ks=(8, 8), stride=(5, 5)))


@pytest.mark.parametrize("hw,ks,stride", [
    ((16, 64), (16, 64), (16, 64)),   # one tile: the plain apply_model
    ((32, 96), (16, 64), (16, 32)),   # 2 × 3 tiles, against JAX's
])
def test_apply_model_tiled_matches(pair, hw, ks, stride):
    pipe_j, pipe_t, _ = pair
    rng = np.random.default_rng(64)
    b = 2
    x = rng.normal(size=(b, *hw, 4)).astype(np.float32)
    t = np.array([5.0, 7.0], np.float32)
    ctx = rng.normal(size=(b, 32, 24)).astype(np.float32)
    split = dict(ks=ks, stride=stride)
    with torch.no_grad():
        out = pipe_t.ldm.apply_model_tiled(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
            tt.SplitInputParams(**split))
        if hw == ks:
            ref = pipe_t.ldm.apply_model(torch.from_numpy(x),
                                         torch.from_numpy(t),
                                         torch.from_numpy(ctx))
    if hw != ks:
        ref = jax.jit(lambda x_, t_, c_: pipe_j.ldm.apply_model_tiled(
            pipe_j.params, x_, t_, c_, jt.SplitInputParams(**split)))(
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    assert out.shape == x.shape
    _close(out, ref, 1e-4, "apply_model_tiled")


@pytest.mark.parametrize("ks,stride", [
    ((16, 32), (16, 32)),   # one tile: the plain decode
    ((12, 16), (4, 8)),     # 2 × 3 overlapping tiles, against JAX's
])
def test_decode_first_stage_tiled_matches(pair, ks, stride):
    # the tiny VAE's four levels upsample by 8: vqf 8
    pipe_j, pipe_t, _ = pair
    z = np.random.default_rng(65).normal(size=(1, 16, 32, 4)).astype(
        np.float32)
    split = dict(ks=ks, stride=stride, vqf=8)
    with torch.no_grad():
        out = pipe_t.ldm.decode_first_stage_tiled(
            torch.from_numpy(z), tt.SplitInputParams(**split))
        plain = pipe_t.ldm.decode_first_stage(torch.from_numpy(z))
    assert out.shape == plain.shape == (1, 128, 256, 3)
    if ks == (16, 32):
        _close(out, plain, 1e-5, "one tile")
        return
    ref = jax.jit(lambda z_: pipe_j.ldm.decode_first_stage_tiled(
        pipe_j.vae_params, z_, jt.SplitInputParams(**split)))(jnp.asarray(z))
    _close(out, ref, 1e-4, "decode tiled")
    # per-tile GroupNorm statistics and halos: near the plain decode only
    assert float((out - plain).abs().mean()) < 0.2 * float(plain.std())


def test_tiled_runs_one_batched_call(pair):
    # all 15 tiles of a 16×128 canvas at ks 16×16, stride 8×8 decode in one
    # call of 15·B rows, and no kernel launches on the CPU
    _, pipe_t, _ = pair
    calls = []
    vae = pipe_t.ldm.vae
    decode = vae.decode
    vae.decode = lambda z: calls.append(tuple(z.shape)) or decode(z)
    ha.reset_launch_counts()
    hg.reset_launch_counts()
    try:
        with torch.no_grad():
            out = pipe_t.ldm.decode_first_stage_tiled(
                torch.zeros(2, 16, 128, 4), tt.SplitInputParams())
    finally:
        vae.decode = decode
    assert calls == [(30, 16, 16, 4)]
    assert out.shape == (2, 128, 1024, 3) and torch.isfinite(out).all()
    assert not any(ha.LAUNCHES.values()) and not any(hg.LAUNCHES.values())


# ---- the CLI ------------------------------------------------------------------

def test_cli_generate_plms_writes_wavs(tmp_path, monkeypatch):
    # --sampler plms end to end at the tiny configs: finite int16 wavs
    monkeypatch.setattr(generate_cli, "model_configs", _tiny_configs)
    clip = write_clip(str(tmp_path / "clip.avi"), seconds=8.5, size=32)
    out = str(tmp_path / "out")
    paths = generate_cli.main([
        "--video", clip, "--out", out, "--random-weights", "--device", "cpu",
        "--steps", "4", "--sample-num", "1", "--frame-size", "32",
        "--sampler", "plms"])
    assert len(paths) == 1 and _read_pcm(paths[0]) == (16000, 2, 131072)
    spec = np.load(os.path.join(out, "clip_sample0_spec.npy"))
    assert spec.shape == (128, 512) and np.isfinite(spec).all()
