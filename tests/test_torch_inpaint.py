"""The port's ``DiffFoleyPipeline.inpaint`` (audio continuation) against the
JAX package, on the CPU.

JAX's ``inpaint`` draws its own x_T, so the reference composes the steps of
``DiffFoleyPipeline._inpaint_fused`` itself (canvas encode, masked DDIM with
a given x_T and forward noise, the final known-region composite, decode,
Griffin-Lim from the phase its key draws); the port's ``inpaint`` gets the
same x_T, forward noise and phase. The tiny LDM and classifier are
test_torch_pipeline.py's. The contract cases mirror
tests/test_pipeline_inpaint.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu import pipeline as jpipe
from diff_foley_tpu.audio.transforms import mel_to_wav as j_mel_to_wav
from diff_foley_tpu_torch import pipeline as tpipe
from test_torch_pipeline import _tiny_pair

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

GEN_KW = dict(sampler="ddim", steps=4, sample_num=2, gl_iters=4,
              cfg_scale=4.5, classifier_scale=50.0)


def _canvas(w: int, seed: int):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((w * 32, 512)).astype(np.float32)
    known = rng.uniform(0.2, 0.8, size=(128, w * 512)).astype(np.float32)
    return feats, known


def jax_inpaint_reference(pipe_j, feats, known, mask, x_T, noise, key,
                          gen_j):
    """JAX's ``inpaint`` composed from its steps with a given x_T and forward
    noise: canvas encode, masked DDIM, the final known-region composite,
    decode, Griffin-Lim from the phase ``key`` draws. Returns the packed
    outputs and that phase."""
    w, s = known.shape[1] // 512, gen_j.sample_num
    k_s, k_g = jax.random.split(key)
    to_w = lambda a: a.reshape(128, w, 512).transpose(1, 0, 2)
    ldm = pipe_j.ldm
    x_img = jnp.repeat(jnp.asarray(to_w(known))[..., None], 3, axis=-1)
    z0 = jnp.repeat(ldm.encode_first_stage(pipe_j.vae_params, x_img), s, 0)
    m = jnp.repeat(jnp.asarray(jpipe.spec_mask_to_latent(to_w(mask))), s, 0)
    clf_apply, clf_params = pipe_j.classifier
    z = ldm.sample(
        pipe_j.params, jnp.repeat(jnp.asarray(jpipe.window_features(feats)),
                                  s, 0), k_s,
        latent_hw=jpipe.LATENT_HW, sampler="ddim", steps=gen_j.steps,
        cfg_scale=gen_j.cfg_scale, classifier=(clf_apply, clf_params),
        classifier_scale=gen_j.classifier_scale, x_T=jnp.asarray(x_T),
        mask=m, x0=z0, mask_noise=jnp.asarray(noise))
    z = z0 * m + (1.0 - m) * z
    specs = jnp.clip(ldm.decode_first_stage(pipe_j.vae_params, z)[..., 0],
                     0.0, 1.0)
    wavs = j_mel_to_wav(specs, k_g, n_iter=gen_j.gl_iters,
                        length=jpipe.WINDOW_SAMPLES)
    phase = np.array(jax.random.uniform(k_g, (w * s, 513, 512),
                                        dtype=jnp.float32))
    return pipe_j._pack_outputs(specs, wavs, w, w, gen_j), phase


def test_inpaint_matches_jax_steps_with_shared_noise():
    # fp32 end to end: canvas encode, 4 guided DDIM steps (CFG 4.5,
    # classifier 50) keeping the first 256 frames of each window, the
    # final composite, decode, FISTA and 4 Griffin-Lim iterations. Specs
    # lie in [0, 1]: 1e-4; the waveform: 1e-3 of its peak, as generate's
    pipe_j, pipe_t = _tiny_pair()
    w, s = 2, GEN_KW["sample_num"]
    feats, known = _canvas(w, 50)
    mask = np.tile(tpipe.continuation_mask(512, 256), (1, w))
    rng = np.random.default_rng(51)
    x_T = rng.standard_normal((w * s, 16, 64, 4)).astype(np.float32)
    noise = rng.standard_normal((4, w * s, 16, 64, 4)).astype(np.float32)
    ref, phase = jax_inpaint_reference(
        pipe_j, feats, known, mask, x_T, noise, jax.random.PRNGKey(6),
        jpipe.GenerationConfig(**GEN_KW))

    out = pipe_t.inpaint(feats, known, mask,
                         gen=tpipe.GenerationConfig(**GEN_KW),
                         x_T=torch.from_numpy(x_T),
                         mask_noise=torch.from_numpy(noise),
                         gl_phase=torch.from_numpy(phase))
    assert out["spec"].shape == ref["spec"].shape == (s, 128, w * 512)
    assert out["wav"].shape == ref["wav"].shape == (s, w * 131072)
    assert np.abs(out["spec"] - ref["spec"]).max() <= 1e-4
    peak = np.abs(ref["wav"]).max()
    assert np.abs(out["wav"] - ref["wav"]).max() <= 1e-3 * max(peak, 1e-6)


def test_spec_masks_match_jax_and_min_pool():
    # continuation_mask and the 8×8 min-pool, identical to JAX's; a latent
    # cell is known only when its whole patch is
    for n, k in ((512, 100), (1024, 256)):
        np.testing.assert_array_equal(tpipe.continuation_mask(n, k),
                                      jpipe.continuation_mask(n, k))
    m = tpipe.continuation_mask(512, 100)[None]
    lat = tpipe.spec_mask_to_latent(m)
    np.testing.assert_array_equal(lat, jpipe.spec_mask_to_latent(m))
    assert lat.shape == (1, 16, 64, 1)
    assert (lat[0, :, :12] == 1.0).all() and (lat[0, :, 12:] == 0.0).all()
    part = np.ones((1, 128, 512), np.float32)
    part[0, 3, 17] = 0.0
    lat2 = tpipe.spec_mask_to_latent(part)
    assert lat2[0, 0, 2, 0] == 0.0 and lat2.sum() == 16 * 64 - 1
    assert tpipe.SPEC_HW == jpipe.SPEC_HW == (128, 512)


def test_fully_known_canvas_is_the_vae_roundtrip():
    # a fully known canvas comes back as decode(encode(canvas)) (the final
    # composite pins every latent), free generation does not: at least ten
    # times closer. CFG 1 and no classifier, as the JAX package's test
    _, pipe = _tiny_pair()
    w = 2
    feats, known = _canvas(w, 52)
    gen = tpipe.GenerationConfig(sampler="ddim", steps=4, sample_num=2,
                                 gl_iters=2, cfg_scale=1.0,
                                 classifier_scale=0.0)
    out = pipe.inpaint(feats, known, np.ones_like(known), seed=3, gen=gen)
    assert out["spec"].shape == (2, 128, w * 512)
    assert out["wav"].shape == (2, w * 131072) and np.isfinite(out["wav"]).all()
    assert out["spec"].min() >= 0.0 and out["spec"].max() <= 1.0
    spec_w = torch.from_numpy(known.reshape(128, w, 512).transpose(1, 0, 2)
                              .copy())
    rt = pipe.decode_specs(pipe.encode_canvas(spec_w)).numpy()
    rt = rt.transpose(1, 0, 2).reshape(128, w * 512)
    free = pipe.generate(feats, seed=3, gen=gen)
    err_inpaint = np.abs(out["spec"] - rt[None]).mean()
    err_free = np.abs(free["spec"] - rt[None]).mean()
    assert err_inpaint < 0.1 * err_free, (err_inpaint, err_free)


def test_inpaint_rejects_bad_inputs():
    _, pipe = _tiny_pair()
    feats = np.zeros((32, 512), np.float32)
    known = np.zeros((128, 512), np.float32)
    with pytest.raises(ValueError, match="sampler"):
        pipe.inpaint(feats, known, np.ones_like(known),
                     gen=tpipe.GenerationConfig(sampler="dpm"))
    with pytest.raises(ValueError, match="shape mismatch"):
        pipe.inpaint(feats, known, np.ones((128, 256), np.float32))
    short = np.zeros((128, 256), np.float32)
    with pytest.raises(ValueError, match="known_spec must be"):
        pipe.inpaint(feats, short, np.ones_like(short))
    with pytest.raises(ValueError, match="mask_noise"):
        pipe.inpaint(feats, known, np.ones_like(known),
                     gen=tpipe.GenerationConfig(sampler="ddim", steps=4),
                     mask_noise=torch.zeros(3, 4, 16, 64, 4))
