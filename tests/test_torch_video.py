"""The port's video → wav entry against the JAX package, on the CPU:
ingest (cv2 frame selection, batched CAVP encode), the ``DiffFoley`` API,
wav I/O and muxing, and ``cli.generate`` end to end.

The tiny LDM and classifier are test_torch_pipeline.py's, the tiny CAVP
test_torch_cavp.py's; clips are seeded MJPG files written with cv2.
"""
import os
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import cv2
import pytest
import torch

from diff_foley_tpu import api as japi  # noqa: E402
from diff_foley_tpu import pipeline as jpipe  # noqa: E402
from diff_foley_tpu.audio.transforms import wav_to_mel as j_wav_to_mel  # noqa: E402
from diff_foley_tpu.models import cavp as jc  # noqa: E402
from diff_foley_tpu.utils import wav as jwav  # noqa: E402
from diff_foley_tpu.video import ingest as jingest  # noqa: E402
from diff_foley_tpu.video import mux as jmux  # noqa: E402
from diff_foley_tpu_torch import api as tapi  # noqa: E402
from diff_foley_tpu_torch import pipeline as tpipe  # noqa: E402
from diff_foley_tpu_torch.audio.transforms import wav_to_mel  # noqa: E402
from diff_foley_tpu_torch.cli import generate as generate_cli  # noqa: E402
from diff_foley_tpu_torch.diffusion import latent_diffusion as tld  # noqa: E402
from diff_foley_tpu_torch.models import cavp as tc  # noqa: E402
from diff_foley_tpu_torch.models import unet as tu  # noqa: E402
from diff_foley_tpu_torch.models import vae as tv  # noqa: E402
from diff_foley_tpu_torch.utils import wav as twav  # noqa: E402
from diff_foley_tpu_torch.utils.convert import from_jax_params  # noqa: E402
from diff_foley_tpu_torch.utils.init import random_flax_params  # noqa: E402
from diff_foley_tpu_torch.video import ingest as tingest  # noqa: E402
from diff_foley_tpu_torch.video import mux as tmux  # noqa: E402
from test_torch_cavp import CAVP_KW  # noqa: E402
from test_torch_inpaint import jax_inpaint_reference  # noqa: E402
from test_torch_pipeline import CLF_KW, UNET_KW, VAE_KW, _tiny_pair  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

FRAME = 32
# CAVP features, fp32: max|Δ| against rms(JAX) (the towers reach ≤ 1.4e-6)
FEAT_TOL = 1e-5


def write_clip(path: str, seconds: float = 8.5, fps: float = 10.0,
               size: int = 48, seed: int = 0) -> str:
    """A seeded constant-rate MJPG clip of random frames."""
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                        (size, size))
    assert w.isOpened()
    for _ in range(int(round(seconds * fps))):
        w.write(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    w.release()
    return path


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(str(tmp_path_factory.mktemp("clip") / "clip.avi"))


@pytest.mark.parametrize("start, truncate", [(0.0, None), (0.0, 8.2),
                                             (1.3, 2.0), (7.9, 5.0)])
def test_extract_frames_bit_for_bit(clip, start, truncate):
    ref = jingest.extract_frames(clip, size=FRAME, start_second=start,
                                 truncate_second=truncate)
    out = tingest.extract_frames(clip, size=FRAME, start_second=start,
                                 truncate_second=truncate)
    assert out.dtype == ref.dtype == np.float32 and len(out) > 0
    np.testing.assert_array_equal(out, ref)


def test_extract_frames_repeats_the_last_frame(tmp_path, monkeypatch):
    # a container that over-reports its length: the last decoded frame
    # stands in, with a warning, as in JAX
    path = write_clip(str(tmp_path / "short.avi"), seconds=2.0)
    real = cv2.VideoCapture

    class Lying:
        def __init__(self, *args):
            self.cap = real(*args)

        def __getattr__(self, name):
            return getattr(self.cap, name)

        def get(self, prop):
            n = self.cap.get(prop)
            return n + 10 if prop == cv2.CAP_PROP_FRAME_COUNT else n

    monkeypatch.setattr(cv2, "VideoCapture", Lying)
    with pytest.warns(UserWarning, match="repeating the last decoded frame"):
        ref = jingest.extract_frames(path, size=FRAME)
    with pytest.warns(UserWarning, match="repeating the last decoded frame"):
        out = tingest.extract_frames(path, size=FRAME)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[-1], out[-2])


@pytest.fixture(scope="module")
def cavp_pair():
    jm = jc.CAVPModel(jc.CAVPConfig(**CAVP_KW))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, FRAME, FRAME, 3)),
        jnp.zeros((1, 128, 32))))
    variables = {name: random_flax_params(tree, 70 + i)
                 for i, (name, tree) in enumerate(shapes.items())}
    tm = tc.CAVPModel(tc.CAVPConfig(**CAVP_KW)).eval()
    tm.load_state_dict(from_jax_params(variables), strict=True)
    return jm, variables, tm


def _feat_err(out, ref) -> float:
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.sqrt(np.square(ref).mean()))


def test_extract_cavp_features_ragged_batches(clip, cavp_pair):
    # batches of 3 frames: 32 frames end in a batch of 2
    jm, variables, tm = cavp_pair
    encode = jax.jit(lambda v, x: jm.apply(
        v, x, method=lambda m, a: m.encode_video(a, normalize=True,
                                                 pool=False)))
    ref = jingest.extract_cavp_features(clip, encode, variables,
                                        batch_size=3, truncate_second=8.2,
                                        size=FRAME)
    out = tingest.extract_cavp_features(clip, tm, batch_size=3,
                                        truncate_second=8.2, size=FRAME,
                                        device="cpu")
    assert out.shape == (32, 512)
    assert _feat_err(out, ref) <= FEAT_TOL


@pytest.fixture(scope="module")
def api_pair(cavp_pair):
    jm, variables, tm = cavp_pair
    pipe_j, pipe_t = _tiny_pair()
    df_j = japi.DiffFoley(pipe_j.ldm, pipe_j.params, pipe_j.vae_params, jm,
                          variables, pipe_j.classifier, bf16=False,
                          frame_size=FRAME)
    df_t = tapi.DiffFoley(pipe_t.ldm, tm, pipe_t.classifier, bf16=False,
                          frame_size=FRAME, device="cpu")
    return df_j, df_t


def test_extract_features_matches_jax(clip, api_pair):
    df_j, df_t = api_pair
    ref = df_j.extract_features(clip, 0.5, 8.2)
    out = df_t.extract_features(clip, 0.5, 8.2)
    assert out.shape == (32, 512)
    assert _feat_err(out, ref) <= FEAT_TOL


def test_continue_audio_matches_jax_inpaint(api_pair):
    # JAX's continue_audio is inpaint with the first known_seconds kept:
    # its steps with shared x_T, forward noise and Griffin-Lim phase, as
    # test_torch_inpaint.py; specs 1e-4, waveform 1e-3 of its peak
    df_j, df_t = api_pair
    rng = np.random.default_rng(71)
    w, s, known_seconds = 1, 2, 3.3
    feats = rng.standard_normal((w * 32, 512)).astype(np.float32)
    known = rng.uniform(0.2, 0.8, size=(128, w * 512)).astype(np.float32)
    x_T = rng.standard_normal((w * s, 16, 64, 4)).astype(np.float32)
    noise = rng.standard_normal((4, w * s, 16, 64, 4)).astype(np.float32)
    kw = dict(sampler="ddim", steps=4, sample_num=s, gl_iters=4)
    frames = int(round(known_seconds * 16000 / 256))
    mask = jpipe.continuation_mask(known.shape[1], frames)
    ref, phase = jax_inpaint_reference(
        df_j.pipe, feats, known, mask, x_T, noise, jax.random.PRNGKey(7),
        jpipe.GenerationConfig(**kw))
    out = df_t.continue_audio(feats, known, known_seconds,
                              gen=tpipe.GenerationConfig(**kw),
                              x_T=torch.from_numpy(x_T),
                              mask_noise=torch.from_numpy(noise),
                              gl_phase=torch.from_numpy(phase))
    assert out["spec"].shape == ref["spec"].shape == (s, 128, 512)
    assert np.abs(out["spec"] - ref["spec"]).max() <= 1e-4
    peak = np.abs(ref["wav"]).max()
    assert np.abs(out["wav"] - ref["wav"]).max() <= 1e-3 * max(peak, 1e-6)


def test_generate_for_video_on_the_cpu(clip, api_pair, tmp_path):
    _, df_t = api_pair
    gen = tpipe.GenerationConfig(steps=2, sample_num=2, gl_iters=2)
    out = df_t.generate_for_video(clip, seed=3, gen=gen)
    assert out["wav"].shape == (2, 131072) and out["wav"].dtype == np.float32
    assert np.isfinite(out["wav"]).all() and np.isfinite(out["spec"]).all()
    assert out["spec"].shape == (2, 128, 512)
    packed = df_t.generate_for_video(
        clip, seed=3, gen=tpipe.GenerationConfig(
            steps=2, sample_num=2, gl_iters=2, wav_dtype="int16"))
    assert packed["wav"].dtype == np.int16
    twav.write_wav(str(tmp_path / "f.wav"), out["wav"][0])
    twav.write_wav(str(tmp_path / "i.wav"), packed["wav"][0])
    assert (tmp_path / "f.wav").read_bytes() == (tmp_path / "i.wav").read_bytes()


def test_wav_io_matches_jax(tmp_path):
    rng = np.random.default_rng(72)
    x = rng.uniform(-1.2, 1.2, 4001).astype(np.float32)
    for name, port, ref in (("utils", twav.write_wav, jwav.write_wav),
                            ("mux", tmux.write_wav, jmux.write_wav)):
        port(str(tmp_path / f"{name}_t.wav"), x)
        ref(str(tmp_path / f"{name}_j.wav"), x)
        assert ((tmp_path / f"{name}_t.wav").read_bytes()
                == (tmp_path / f"{name}_j.wav").read_bytes())
    pcm, sr = twav.read_wav(str(tmp_path / "utils_t.wav"))
    ref_pcm, ref_sr = jwav.read_wav(str(tmp_path / "utils_t.wav"))
    assert sr == ref_sr == 16000 and pcm.dtype == np.float32
    np.testing.assert_array_equal(pcm, ref_pcm)
    np.testing.assert_array_equal(
        pcm, (np.clip(x, -1, 1) * 32767.0).astype(np.int16)
        .astype(np.float32) / 32767.0)
    with wave.open(str(tmp_path / "stereo.wav"), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(8000)
        f.writeframes(rng.integers(-3000, 3000, 600, dtype="<i2").tobytes())
    pcm, sr = twav.read_wav(str(tmp_path / "stereo.wav"))
    ref_pcm, _ = jwav.read_wav(str(tmp_path / "stereo.wav"))
    assert sr == 8000 and pcm.shape == (300,)
    np.testing.assert_array_equal(pcm, ref_pcm)


def test_wav_to_mel_matches_jax():
    # the normalised mel in [0, 1]: 1e-4 (measured ~1e-6)
    rng = np.random.default_rng(73)
    wav = (0.3 * rng.standard_normal(16384)).astype(np.float32)
    ref = np.asarray(j_wav_to_mel(jnp.asarray(wav)))
    out = wav_to_mel(torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape == (128, 65)
    assert np.abs(out - ref).max() <= 1e-4


def test_mux_raises_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(tmux.shutil, "which", lambda name: None)
    assert not tmux.has_ffmpeg() and tmux.which_ffmpeg() == ""
    with pytest.raises(RuntimeError, match="ffmpeg not found"):
        tmux.mux_audio_video("in.mp4", np.zeros(16), str(tmp_path / "o.mp4"))
    assert not os.path.exists(tmp_path / "o_audio.wav")


def _tiny_configs():
    return (tld.LDMConfig(unet=tu.UNetConfig(**UNET_KW),
                          vae=tv.VAEConfig(**VAE_KW), cond_embed_dim=24),
            tc.CAVPConfig(**CAVP_KW), tu.UNetConfig(**CLF_KW))


def _read_pcm(path: str):
    with wave.open(path, "rb") as f:
        return f.getframerate(), f.getsampwidth(), f.getnframes()


def test_cli_generate_end_to_end_on_the_cpu(clip, tmp_path, monkeypatch):
    # the CLI's models cut to the tiny configs; the flags are the CLI's own
    monkeypatch.setattr(generate_cli, "model_configs", _tiny_configs)
    out = str(tmp_path / "out")
    args = ["--video", clip, "--out", out, "--random-weights", "--device",
            "cpu", "--steps", "2", "--sample-num", "2",
            "--frame-size", str(FRAME)]
    paths = generate_cli.main(args)
    assert [os.path.basename(p) for p in paths] == [
        "clip_sample0.wav", "clip_sample1.wav"]
    for i, p in enumerate(paths):
        assert _read_pcm(p) == (16000, 2, 131072)
        spec = np.load(os.path.join(out, f"clip_sample{i}_spec.npy"))
        assert spec.shape == (128, 512) and np.isfinite(spec).all()
    # continuation from the first sample's wav, masked DDIM
    cont = str(tmp_path / "cont")
    paths = generate_cli.main(args[:3] + [cont] + args[4:] + [
        "--continue-from", paths[0], "--known-seconds", "2.0"])
    assert len(paths) == 2 and _read_pcm(paths[0]) == (16000, 2, 131072)


def test_cli_generate_refusals(clip, tmp_path):
    base = ["--video", clip, "--random-weights", "--device", "cpu"]
    # --sampler takes the JAX CLI's choices (dpm, ddim, plms; plms runs in
    # tests/test_torch_diffusion_stack.py): argparse refuses the rest
    with pytest.raises(SystemExit) as refused:
        generate_cli.main(base + ["--sampler", "ancestral"])
    assert refused.value.code == 2
    logdir = tmp_path / "logdir"
    logdir.mkdir()
    (logdir / "config.json").write_text("{}")
    with pytest.raises(SystemExit, match="stage-2 trainer"):
        generate_cli.main(["--video", clip, "--ldm-ckpt", str(logdir),
                           "--cavp-ckpt", "c.ckpt", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--random-weights"):
        generate_cli.main(["--video", clip, "--device", "cpu"])


def test_video_entry_defaults_to_the_card(clip, cavp_pair):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    _, _, tm = cavp_pair
    with pytest.raises(RuntimeError, match="CUDA"):
        tingest.extract_cavp_features(clip, tm, size=FRAME)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.DiffFoley(tld.LatentDiffusion(_tiny_configs()[0]), tm,
                       bf16=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_cli.main(["--video", clip, "--random-weights"])


def test_ingest_never_moves_the_model(cavp_pair):
    # frames asked on another device than the CAVP model's: an error, not
    # a quiet move of either
    _, _, tm = cavp_pair
    frames = np.zeros((3, FRAME, FRAME, 3), np.float32)
    assert tingest.encode_frames(frames, tm, device="cpu").shape == (3, 512)
    with pytest.raises(ValueError, match="move the model first"):
        tingest.encode_frames(frames, tm, device="meta")
    assert next(tm.parameters()).device.type == "cpu"


def test_package_imports_without_cv2():
    # cv2 is imported only when a video is read, and its absence says so
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "import diff_foley_tpu_torch.api, diff_foley_tpu_torch.cli.generate\n"
        "from diff_foley_tpu_torch.video.ingest import extract_frames\n"
        "try:\n"
        "    extract_frames('x.avi')\n"
        "except ImportError as e:\n"
        "    print('raised', e)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "raised video ingest needs cv2" in r.stdout
