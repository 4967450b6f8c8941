"""The port's evaluation and training-surface leftovers against the JAX
package's, on the CPU: the SpecVQGAN spec transforms and
``cli.transform_spec``'s split, the reference-format YAML builders on
``configs/*.yaml``, ``MetricsLogger``/``Meter``/``Stopwatch``, the
preemption checkpointer and its companions, and ``SoundLogger``'s three
specs and wavs with the JAX logger's sampler noise and Griffin-Lim phases
injected, in fp32 and as under mixed precision.
"""
import copy
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu import config as jconfig
from diff_foley_tpu.cli import transform_spec as jcli
from diff_foley_tpu.diffusion import latent_diffusion as jld
from diff_foley_tpu.eval import spec_transform as jst
from diff_foley_tpu.models.unet import UNetConfig as JUNetConfig
from diff_foley_tpu.models.vae import VAEConfig as JVAEConfig
from diff_foley_tpu.train.callbacks import SoundLogger as JSoundLogger
from diff_foley_tpu_torch import config as tconfig
from diff_foley_tpu_torch.cli import transform_spec as tcli
from diff_foley_tpu_torch.diffusion import latent_diffusion as tld
from diff_foley_tpu_torch.eval import spec_transform as tst
from diff_foley_tpu_torch.models.unet import UNetConfig
from diff_foley_tpu_torch.models.vae import VAEConfig
from diff_foley_tpu_torch.train.callbacks import SoundLogger
from diff_foley_tpu_torch.utils import logging as tlog
from diff_foley_tpu_torch.utils import resilience
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params
from diff_foley_tpu_torch.utils.wav import read_wav

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the SpecVQGAN transforms ------------------------------------------------

@pytest.mark.parametrize("direction,shape", [
    ("to_specvqgan", (128, 512)), ("to_native", (80, 704)),
    ("to_specvqgan", (2, 128, 100))])
def test_spec_transforms_match_jax(direction, shape):
    spec = np.random.default_rng(0).uniform(0.1, 0.9, shape).astype(
        np.float32)
    port, ref = ((tst.spec_16k128_to_22k80, jst.spec_16k128_to_22k80)
                 if direction == "to_specvqgan" else
                 (tst.spec_22k80_to_16k128, jst.spec_22k80_to_16k128))
    got, want = port(spec), ref(spec)
    assert got.shape == want.shape
    # both are float64 numpy and scipy: equal to rounding
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_spec_transform_round_trip_stays_near():
    # a spec smooth in frequency survives the 80-mel bottleneck
    m, n = np.arange(128)[:, None], np.arange(512)[None]
    spec = 0.5 + 0.2 * np.sin(m / 15.0) * np.cos(n / 30.0)
    there = tst.spec_16k128_to_22k80(spec)
    back = tst.spec_22k80_to_16k128(there)
    # 512 frames at 16 kHz are 705.6 at 22.05 kHz: the resampler rounds up
    assert there.shape == (80, 706) and back.shape == (128, 513)
    d = np.abs(back[:, :512] - spec)
    assert float(d.mean()) < 0.01 and float(d.max()) < 0.1


def write_specs(root, n, seed=2):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for i in range(n):
        np.save(root / f"s{i}.npy", rng.uniform(0.2, 0.8, (128, 64)))


@pytest.mark.parametrize("n,split", [(7, 3), (6, 3), (2, 4)])
def test_transform_spec_split_matches_jax(tmp_path, n, split):
    write_specs(tmp_path / "in", n)
    for node in range(split):
        for name, mod in (("port", tcli), ("jax", jcli)):
            out = tmp_path / f"{name}{node}"
            assert mod.main(["--input", str(tmp_path / "in"), "--output",
                             str(out), "--split", str(split), "--node",
                             str(node)]) == 0
        got = sorted(os.listdir(tmp_path / f"port{node}"))
        assert got == sorted(os.listdir(tmp_path / f"jax{node}"))
        # the ceil split, not the reference's len // split + 1
        chunk = -(-n // split)
        assert got == sorted(f"s{i}.npy" for i in range(
            node * chunk, min((node + 1) * chunk, n)))
        for f in got:
            np.testing.assert_allclose(
                np.load(tmp_path / f"port{node}" / f),
                np.load(tmp_path / f"jax{node}" / f), rtol=0, atol=1e-9)
    with pytest.raises(SystemExit, match="out of range"):
        tcli.main(["--input", str(tmp_path / "in"), "--output",
                   str(tmp_path / "x"), "--split", "2", "--node", "2"])


def test_transform_spec_workers_and_failures(tmp_path):
    write_specs(tmp_path / "in", 3)
    np.save(tmp_path / "in" / "bad.npy", np.zeros((5,)))
    # the module's command line, a pool of two spawned workers, one bad
    # file
    run = subprocess.run(
        [sys.executable, "-m", "diff_foley_tpu_torch.cli.transform_spec",
         "--input", str(tmp_path / "in"), "--output", str(tmp_path / "out"),
         "--workers", "2"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 1, run.stderr
    assert "converted 3/4 specs" in run.stdout and "FAILED bad.npy" in \
        run.stdout
    for i in range(3):
        np.testing.assert_allclose(
            np.load(tmp_path / "out" / f"s{i}.npy"),
            jst.spec_16k128_to_22k80(np.load(tmp_path / "in" / f"s{i}.npy")),
            rtol=0, atol=1e-9)


# ---- the reference-format YAML -----------------------------------------------

def common_fields(port_cfg, jax_cfg) -> tuple:
    """The two configs' shared fields as dicts (the port's UNetConfig has
    its own dtype/remat fields, JAX's VAEConfig a dropout rate)."""
    a, b = dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg)

    def common(x, y):
        return {k: (common(x[k], y[k])[0] if isinstance(x[k], dict) else
                    x[k]) for k in x if k in y}, \
            {k: (common(x[k], y[k])[1] if isinstance(x[k], dict) else
                 y[k]) for k in x if k in y}
    return common(a, b)


def test_load_ldm_from_yaml_matches_jax():
    path = os.path.join(REPO, "configs", "stage2_ldm.yaml")
    with torch.device("meta"):   # the 860M model's config, no weights
        ldm = tconfig.load_ldm_from_yaml(path)
    assert isinstance(ldm, tld.LatentDiffusion)
    got, want = common_fields(ldm.cfg, jconfig.load_ldm_from_yaml(path).cfg)
    assert got == want and len(got) >= 11
    assert len(got["unet"]) >= 11 and len(got["vae"]) == 8
    # the shipped point, with the YAML's block recompute
    flagship = dataclasses.replace(tld.LDMConfig(), unet=dataclasses.replace(
        tld.LDMConfig().unet, use_checkpoint=True))
    assert ldm.cfg == flagship


def test_instantiate_from_config_matches_jax():
    path = os.path.join(REPO, "configs", "double_guidance_classifier.yaml")
    model = tconfig.load_yaml(path)["model"]
    got = tconfig.instantiate_from_config(model)
    assert isinstance(got, UNetConfig)
    a, b = common_fields(got, jconfig.instantiate_from_config(
        jconfig.load_yaml(path)["model"]))
    assert a == b and a["out_channels"] == 1 and a["context_dim"] == 512
    # the trailing class name resolves another package's dotted path
    vae = {"target": "adm.models.autoencoder.AutoencoderKL",
           "params": {"embed_dim": 4, "ddconfig": {"ch": 64}}}
    assert tconfig.instantiate_from_config(vae) == VAEConfig(ch=64)
    for bad in ({"target": "no.such.Thing", "params": {}}, {"params": {}}):
        with pytest.raises(KeyError):
            tconfig.instantiate_from_config(bad)
    with pytest.raises(NotImplementedError, match="dropout"):
        tconfig.instantiate_from_config(
            {"target": vae["target"], "params": {"ddconfig": {
                "dropout": 0.1}}})


# ---- logging and resilience --------------------------------------------------

def test_metrics_logger_rows(tmp_path):
    logger = tlog.MetricsLogger(str(tmp_path / "log"), name="metrics",
                                use_tensorboard=True)
    logger.log(3, {"loss": torch.tensor(0.5), "name": "x"}, prefix="train/")
    logger.log(4, {"val/loss": np.float32(0.25)})
    logger.close()
    rows = [json.loads(line) for line in
            (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [set(r) for r in rows] == [{"train/loss", "train/name", "step",
                                       "time"}, {"val/loss", "step", "time"}]
    assert rows[0]["train/loss"] == 0.5 and rows[0]["train/name"] == "x"
    assert rows[1]["step"] == 4 and rows[1]["time"] >= rows[0]["time"]
    try:
        import tensorboardX  # noqa: F401
        events = [f for f in os.listdir(tmp_path / "log")
                  if f.startswith("events.")]
        assert len(events) == 1
    except ImportError:
        pass
    quiet = tlog.MetricsLogger(None)   # a rank other than 0
    quiet.log(1, {"loss": 1.0})
    assert quiet.jsonl_path is None
    meter = tlog.Meter()
    meter.update(2.0)
    meter.update(4.0, n=3)
    assert meter.avg == 3.5 and meter.last == 4.0
    watch = tlog.Stopwatch()
    time.sleep(0.01)
    assert watch.lap() >= 0.01


def test_preemption_checkpointer_and_companions(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    p = resilience.PreemptionCheckpointer()
    assert not p.should_checkpoint
    os.kill(os.getpid(), signal.SIGUSR1)
    assert p.should_checkpoint
    p.clear()
    os.kill(os.getpid(), signal.SIGTERM)   # caught: the flag, no exit
    assert p.should_checkpoint
    p.close()
    assert signal.getsignal(signal.SIGTERM) == before
    assert signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL

    saved = []

    @resilience.checkpoint_on_exception(lambda: saved.append(1))
    def fails():
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        fails()
    assert saved == [1]

    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "a.txt").write_text("a")
    sync = resilience.BackgroundSync(str(tmp_path / "src"),
                                     str(tmp_path / "dst"),
                                     interval_s=0.05).start()
    time.sleep(0.2)
    (tmp_path / "src" / "b.txt").write_text("b")
    sync.stop()
    assert sorted(os.listdir(tmp_path / "dst")) == ["a.txt", "b.txt"]


# ---- SoundLogger ---------------------------------------------------------------

UNET_KW = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
               attention_resolutions=(2,), num_heads=4, context_dim=24)
VAE_KW = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
LDM_KW = dict(cond_embed_dim=24, cond_seq_len=8)
STEPS, GL_ITERS = 5, 8
# the mixed-precision sample: 5 DPM-Solver++ steps of the tiny UNet in
# bf16 against the JAX logger's fp32 (0.062 max|Δ| measured)
SAMPLE_BF16_TOL = 0.1


@pytest.fixture(scope="module")
def sound_logged(tmp_path_factory):
    """The JAX logger's step-7 directory (fp32 VAE weights, as the JAX
    CLI keeps them) and the port's inputs for the same call: the LDM with
    the same weights, the named UNet/cond parameters, the batch and the
    JAX logger's draws."""
    tmp = tmp_path_factory.mktemp("sound")
    ldm = jld.LatentDiffusion(jld.LDMConfig(
        unet=JUNetConfig(**UNET_KW), vae=JVAEConfig(**VAE_KW), **LDM_KW))
    params = jax.tree_util.tree_map(jnp.asarray, random_flax_params(
        jax.eval_shape(ldm.init_params, jax.random.PRNGKey(0)), seed=1))
    vae = jax.tree_util.tree_map(jnp.asarray, random_flax_params(
        jax.eval_shape(ldm.init_vae_params, jax.random.PRNGKey(1)), seed=2))
    # the JAX logger's model calls, jitted (eager flax takes minutes); 5
    # sampler steps and 8 Griffin-Lim iterations keep the JAX compile
    # short (the card runs the defaults, 25 and 32)
    sample = jax.jit(lambda p, f, k: jld.LatentDiffusion.sample(
        ldm, p, f, k, sampler="dpm", steps=STEPS, cfg_scale=6.5))
    ldm.sample = lambda p, f, k, **kw: sample(p, f, k)
    for name in ("encode_first_stage", "decode_first_stage"):
        setattr(ldm, name, jax.jit(getattr(ldm, name)))
    rng = np.random.default_rng(3)
    batch = {"spec": rng.uniform(size=(3, 128, 64, 3)).astype(np.float32),
             "video_feat": rng.standard_normal((3, 8, 512)).astype(
                 np.float32)}
    key = jax.random.PRNGKey(5)
    want = JSoundLogger(str(tmp / "jax"), ldm, vae,
                        sampler_steps=STEPS, gl_iters=GL_ITERS).log(
        7, params, batch, key)

    port = tld.LatentDiffusion(tld.LDMConfig(
        unet=UNetConfig(**UNET_KW), vae=VAEConfig(**VAE_KW), **LDM_KW))
    tree = jax.tree_util.tree_map(np.asarray, params)
    named = {f"{part}.{k}": v for part in ("unet", "cond")
             for k, v in from_jax_params(tree[part]).items()}
    port.vae.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, vae)), strict=True)
    # the JAX logger's draws: split(key, 3) → x_T from split(k1)[0], the
    # gt/rec phase from k2, the sample's from k3
    k1, k2, k3 = jax.random.split(key, 3)
    as_t = lambda a: torch.from_numpy(np.asarray(a))
    draws = {"x_T": as_t(jax.random.normal(jax.random.split(k1)[0],
                                           (2, 16, 64, 4))),
             "phase": as_t(jax.random.uniform(k2, (2, 513, 64))),
             "sample_phase": as_t(jax.random.uniform(k3, (2, 513, 512)))}
    return dict(tmp=tmp, want=want, port=port, named=named, draws=draws,
                batch={k: torch.from_numpy(v) for k, v in batch.items()})


def check_logged(got: str, want: str, tols: dict, wav_ratio: float):
    """Both loggers' files: each spec within ``tols[name]`` (max|Δ|), each
    wav within ``wav_ratio`` of the clip's rms."""
    assert os.path.basename(got) == os.path.basename(want) == "step_00000007"
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name, tol in tols.items():
        a = np.load(os.path.join(got, f"{name}_spec.npy"))
        b = np.load(os.path.join(want, f"{name}_spec.npy"))
        assert a.dtype == np.float32
        assert a.shape == b.shape == ((2, 128, 512) if name == "sample"
                                      else (2, 128, 64))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)
        for i in range(2):
            wa = read_wav(os.path.join(got, f"{name}_{i}.wav"))[0]
            wb = read_wav(os.path.join(want, f"{name}_{i}.wav"))[0]
            assert wa.shape == wb.shape
            ratio = float(np.sqrt(np.mean((wa - wb) ** 2))
                          / np.sqrt(np.mean(wb ** 2)))
            print(name, i, ratio, float(np.abs(wa - wb).max()))
            assert ratio <= wav_ratio, (name, i, ratio)


def test_sound_logger_matches_jax(sound_logged):
    r = sound_logged
    logger = SoundLogger(str(r["tmp"] / "port"), r["port"], every_n_steps=7,
                         sampler_steps=STEPS, gl_iters=GL_ITERS)
    assert logger.maybe_log(6, r["named"], r["batch"]) is None
    got = logger.log(7, r["named"], r["batch"], draws=r["draws"])
    # gt: equal; rec: a tiny VAE in fp32 with random weights (5e-5);
    # sample: 5 CFG 6.5 DPM-Solver++ steps of a tiny UNet, then the
    # decode (1e-4). Wavs: 32 momentum Griffin-Lim iterations on FFTs of
    # two libraries from the same phase, written as int16: rms(Δ) within
    # 1% of the clip's rms
    check_logged(got, r["want"], {"gt": 0.0, "rec": 5e-5, "sample": 1e-4},
                 0.01)


def test_sound_logger_mixed_precision_decodes_in_fp32(sound_logged):
    # as under the stage-2 CLI's --mixed-precision: the UNet computes in
    # bf16 and the trainer holds the frozen VAE in bf16; the logger swaps
    # in the VAE's fp32 weights, so gt and rec hold the fp32 JAX logger's
    # limits (the bf16 VAE itself puts rec 0.12 off), and the sample
    # differs by the bf16 UNet alone
    r = sound_logged
    port = copy.deepcopy(r["port"])
    vae_fp32 = {k: p.detach().clone() for k, p in port.vae.named_parameters()}
    port.unet.cfg = dataclasses.replace(port.unet.cfg, dtype="bfloat16")
    port.vae.to(torch.bfloat16)
    logger = SoundLogger(str(r["tmp"] / "port_bf16"), port, every_n_steps=7,
                         sampler_steps=STEPS, gl_iters=GL_ITERS,
                         dtype=torch.bfloat16, vae_params=vae_fp32)
    got = logger.log(7, r["named"], r["batch"], draws=r["draws"])
    assert next(port.vae.parameters()).dtype == torch.bfloat16
    check_logged(got, r["want"], {"gt": 0.0, "rec": 5e-5}, 0.01)
    a = np.load(os.path.join(got, "sample_spec.npy"))
    b = np.load(os.path.join(r["want"], "sample_spec.npy"))
    err = float(np.abs(a - b).max())
    print("bf16 UNet sample max|Δ|", err)
    assert err <= SAMPLE_BF16_TOL
