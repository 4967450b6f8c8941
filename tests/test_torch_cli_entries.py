"""The port's ``cli.preprocess_audio`` against the JAX package's on the
CPU: seeded 16-kHz wavs (one shorter than the cut, one longer, one at
the cut) to ``*_mel.npy`` in a batch and a ragged last batch, and the
refusal of a file at another sample rate.

(``cli.generate`` over the port's logdirs and ``cli.train_cavp
--native-loader`` are tested in test_torch_stage1.py, beside the logdir
and shard fixtures they use.)
"""
import os

import numpy as np
import pytest
import torch

from diff_foley_tpu.cli import preprocess_audio as j_cli
from diff_foley_tpu_torch.cli import preprocess_audio as t_cli
from diff_foley_tpu_torch.utils.wav import write_wav

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

# fp32 mels of the same waveform through two STFT implementations, in
# [0, 1]: 1e-4 (test_torch_video.py's wav_to_mel limit)
MEL_TOL = 1e-4


def _write(root, lengths, sr=16000, seed=0):
    root.mkdir()
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lengths):
        wav = (0.4 * np.sin(np.arange(n) * (0.01 + 0.003 * i))
               + 0.1 * rng.standard_normal(n)).astype(np.float32)
        write_wav(str(root / f"w{i}.wav"), wav, sr=sr)
    return str(root)


def test_preprocess_audio_matches_jax(tmp_path):
    wavs = _write(tmp_path / "wavs", [3000, 8000, 12345])
    args = ["--wav-dir", wavs, "--seconds", "0.5", "--batch", "2"]
    j_cli.main(args + ["--out-dir", str(tmp_path / "j")])
    names = t_cli.main(args + ["--out-dir", str(tmp_path / "t"),
                               "--device", "cpu"])
    assert names == ["w0.wav", "w1.wav", "w2.wav"]
    for i in range(3):
        ref = np.load(tmp_path / "j" / f"w{i}_mel.npy")
        out = np.load(tmp_path / "t" / f"w{i}_mel.npy")
        assert out.dtype == ref.dtype == np.float32
        assert out.shape == ref.shape and out.shape[0] == 128
        assert np.abs(out - ref).max() <= MEL_TOL, i


def test_preprocess_audio_refuses_another_rate(tmp_path):
    wavs = _write(tmp_path / "wavs", [4000], sr=22050)
    for cli, extra in ((j_cli, []), (t_cli, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="sr 22050 != 16000"):
            cli.main(["--wav-dir", wavs, "--out-dir", str(tmp_path / "o"),
                      *extra])
    assert t_cli.parse_args(["--wav-dir", "a", "--out-dir", "b"]).device \
        == "cuda"
