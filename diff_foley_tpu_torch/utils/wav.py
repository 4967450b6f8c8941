"""Minimal PCM16 WAV writer (``diff_foley_tpu/utils/wav.py``)."""
from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, wav: np.ndarray, sr: int = 16000) -> None:
    """Float waveform in [-1, 1], or int16 PCM, → 16-bit mono WAV."""
    wav = np.asarray(wav)
    if wav.dtype == np.int16:
        pcm = wav.astype("<i2", copy=False)
    else:
        pcm = (np.clip(wav.astype(np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
