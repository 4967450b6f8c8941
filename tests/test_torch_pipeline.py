"""The PyTorch port's pipeline end to end against the JAX package, and the
port's hygiene, on the CPU.

End to end: one tiny LDM (UNet, Posembed encoder, VAE), a tiny alignment
classifier, seeded random weights carried over with ``from_jax_params``,
one shared x_T and one shared Griffin-Lim phase; JAX runs
``DiffFoleyPipeline._sample_and_decode(..., x_T=…)`` + ``mel_to_wav``, the
port ``DiffFoleyPipeline.generate``.
"""
import ast
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu import pipeline as jpipe
from diff_foley_tpu.audio.transforms import mel_to_wav as j_mel_to_wav
from diff_foley_tpu.diffusion import latent_diffusion as jld
from diff_foley_tpu.models import unet as ju
from diff_foley_tpu.models import vae as jv
from diff_foley_tpu.utils.wav import write_wav as j_write_wav
from diff_foley_tpu_torch import pipeline as tpipe
from diff_foley_tpu_torch.diffusion import latent_diffusion as tld
from diff_foley_tpu_torch.models import unet as tu
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.ops import hopper_attention as ha
from diff_foley_tpu_torch.ops import hopper_groupnorm as hg
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params
from diff_foley_tpu_torch.utils.wav import write_wav

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
UNET_KW = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
               attention_resolutions=(2,), num_heads=4, context_dim=24)
CLF_KW = dict(out_channels=1, model_channels=32, num_res_blocks=1,
              channel_mult=(1, 2), attention_resolutions=(2,), num_heads=4,
              context_dim=512)
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
GEN_KW = dict(steps=3, sample_num=2, gl_iters=4, cfg_scale=4.5,
              classifier_scale=50.0)


def _rand(tree_fn, seed):
    shapes = jax.eval_shape(tree_fn)
    return {"params": random_flax_params(shapes["params"], seed)}


def _tiny_pair():
    jcfg = jld.LDMConfig(unet=ju.UNetConfig(**UNET_KW),
                         vae=jv.VAEConfig(**VAE_KW), cond_embed_dim=24)
    ldm_j = jld.LatentDiffusion(jcfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(ldm_j.init_params, key)
    params = {name: {"params": random_flax_params(shapes[name]["params"], s)}
              for name, s in (("unet", 40), ("cond", 41))}
    vae_params = _rand(lambda: ldm_j.init_vae_params(key), 42)
    clf_j = ju.ClassifierBackbone(ju.UNetConfig(**CLF_KW))
    clf_params = _rand(lambda: clf_j.init(
        key, jnp.zeros((1, 16, 64, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 32, 512))), 43)

    ldm_t = tld.LatentDiffusion(tld.LDMConfig(
        unet=tu.UNetConfig(**UNET_KW), vae=tv.VAEConfig(**VAE_KW),
        cond_embed_dim=24))
    ldm_t.unet.load_state_dict(from_jax_params(params["unet"]), strict=True)
    ldm_t.cond.load_state_dict(from_jax_params(params["cond"]), strict=True)
    ldm_t.vae.load_state_dict(from_jax_params(vae_params), strict=True)
    clf_t = tu.ClassifierBackbone(tu.UNetConfig(**CLF_KW))
    clf_t.load_state_dict(from_jax_params(clf_params), strict=True)
    pipe_j = jpipe.DiffFoleyPipeline(ldm_j, params, vae_params,
                                     classifier=(clf_j.apply, clf_params))
    return pipe_j, tpipe.DiffFoleyPipeline(ldm_t, clf_t, device="cpu")


def test_generate_matches_jax_with_shared_noise():
    # fp32 end to end: 3 guided DPM-Solver++ steps, VAE decode, FISTA and
    # 4 Griffin-Lim iterations. Specs lie in [0, 1]: 1e-4; the waveform
    # after Griffin-Lim: 1e-3 of its peak (measured: 8e-6 and 7e-5)
    pipe_j, pipe_t = _tiny_pair()
    rng = np.random.default_rng(44)
    w, s = 2, GEN_KW["sample_num"]
    feats = rng.standard_normal((w * 32 + 5, 512)).astype(np.float32)
    x_T = rng.standard_normal((w * s, 16, 64, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    k_s, k_g = jax.random.split(key)
    gen_j = jpipe.GenerationConfig(**GEN_KW)
    specs = pipe_j._sample_and_decode(
        pipe_j.params, pipe_j.vae_params,
        jnp.asarray(jpipe.window_features(feats)), k_s, gen_j,
        x_T=jnp.asarray(x_T))
    wavs = j_mel_to_wav(specs, k_g, n_iter=gen_j.gl_iters,
                        length=jpipe.WINDOW_SAMPLES)
    phase = np.array(jax.random.uniform(k_g, (w * s, 513, 512),
                                        dtype=jnp.float32))
    ref = pipe_j._pack_outputs(specs, wavs, w, w, gen_j)

    out = pipe_t.generate(feats, gen=tpipe.GenerationConfig(**GEN_KW),
                          x_T=torch.from_numpy(x_T),
                          gl_phase=torch.from_numpy(phase))
    assert out["spec"].shape == ref["spec"].shape == (s, 128, w * 512)
    assert out["wav"].shape == ref["wav"].shape == (s, w * 131072)
    assert np.abs(out["spec"] - ref["spec"]).max() <= 1e-4
    peak = np.abs(ref["wav"]).max()
    assert np.abs(out["wav"] - ref["wav"]).max() <= 1e-3 * max(peak, 1e-6)


def test_pack_wav_int16_matches():
    # C-cast truncation of clip(-1, 1)·32767: identical integers
    x = np.array([-1.5, -1.0, -0.99999, -0.5, -1e-5, 0.0, 3e-5, 0.25,
                  0.99999, 1.0, 2.0], np.float32)
    x = np.concatenate([x, np.random.default_rng(45).uniform(-1.2, 1.2, 999)
                        .astype(np.float32)])
    ref = np.asarray(jpipe._pack_wav(jnp.asarray(x), "int16"))
    out = tpipe._pack_wav(torch.from_numpy(x), "int16").numpy()
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError):
        tpipe._pack_wav(torch.from_numpy(x), "int8")


def test_window_features_and_write_wav_match(tmp_path):
    feats = np.arange(70 * 4, dtype=np.float32).reshape(70, 4)
    np.testing.assert_array_equal(tpipe.window_features(feats),
                                  jpipe.window_features(feats))
    pcm = tpipe._pack_wav(torch.linspace(-1, 1, 300), "int16").numpy()
    write_wav(str(tmp_path / "t.wav"), pcm)
    j_write_wav(str(tmp_path / "j.wav"), pcm)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "diff_foley_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    # the gloo ranks of the parallel tests import torch, numpy, the port
    files.append(REPO / "tests" / "test_torch_parallel_ranks.py")
    assert len(files) > 43
    # the trainers' modules, the evaluation's, the video entry's and the
    # parallelism's are in
    for sub in ("train", "data", "cli", "video", "cavp", "eval", "parallel"):
        assert any(p.parent.name == sub for p in files), sub
    for name in ("api.py", "generate.py", "checkpoint.py", "slowonly.py",
                 "cnn14.py", "ingest.py", "mux.py", "optim.py",
                 "classifier.py", "train_classifier.py", "align_acc.py",
                 "padding.py", "losses.py", "stage1_cavp.py", "layers.py",
                 "cavp_shards.py", "train_cavp.py", "extract_features.py",
                 "serving.py", "native_loader.py", "preprocess_audio.py",
                 "distributed.py", "mesh.py", "collectives.py",
                 "sharding_rules.py", "test_torch_parallel_ranks.py",
                 "logging.py", "spec_transform.py", "transform_spec.py",
                 "sound_vae.py", "sound_gan.py", "train_sound_vae.py",
                 "resilience.py", "callbacks.py", "config.py", "tiled.py",
                 "samplers.py", "guidance.py", "x3d.py", "r2plus1d.py",
                 "spec_towers.py", "vivit.py", "spec_augment.py",
                 "stage2_decode.py", "audio_unet.py", "prior.py",
                 "cond_text.py", "cond_encoder.py", "profiling.py",
                 "profile.py", "synthetic.py", "scan.py", "kernel_cost.py"):
        assert any(p.name == name for p in files), name
    banned = ("jax", "flax", "optax", "orbax", "diff_foley_tpu")
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in banned, f"{path.relative_to(REPO)} imports {mod}"


def test_no_gpu_default_device_raises_and_cpu_never_launches():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    tiny = tld.LatentDiffusion(tld.LDMConfig(
        unet=tu.UNetConfig(**UNET_KW), vae=tv.VAEConfig(**VAE_KW),
        cond_embed_dim=24))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.DiffFoleyPipeline(tiny)
    ha.reset_launch_counts()
    hg.reset_launch_counts()
    q = torch.randn(1, 20, 64, requires_grad=True)
    kv = torch.randn(1, 12, 64)
    ha.FlashAttentionPacked.apply(q, kv, kv, 0.25, 4).sum().backward()
    ha.attention_packed_bwd(q.detach(), kv, kv, q.detach(), 0.25, 4)
    ha.attention_fwd(q.detach()[None], kv[None], kv[None], 0.25)
    ha.attention_bwd(q.detach()[None], kv[None], kv[None], q.detach()[None],
                     0.25)
    ha.FlashAttention.apply(q[None], kv[None], kv[None], 0.25).sum().backward()
    x = torch.randn(2, 64, 4, 8, requires_grad=True)
    gamma, beta = torch.ones(64), torch.zeros(64)
    hg.fused_group_norm(x, gamma, beta, 32, 1e-6, "silu").sum().backward()
    hg.group_norm_stream(x.detach(), gamma, beta, 32, 1e-6)
    meta = torch.empty(1, 20, 64, device="meta")
    with pytest.raises(ValueError):
        ha.attention_packed_fwd(meta, meta, meta, 0.25, 4)
    with pytest.raises(ValueError):
        hg.group_norm_block(meta[None], gamma, beta, 1, 1e-6)
    assert ha.LAUNCHES == {"attn_packed_fwd": 0, "attn_packed_bwd": 0,
                           "attn_fwd": 0, "attn_bwd": 0}
    assert hg.LAUNCHES == {"gn_block": 0, "gn_stream_stats": 0,
                           "gn_stream_apply": 0}
