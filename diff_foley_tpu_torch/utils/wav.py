"""Minimal PCM16 WAV writer and reader (``diff_foley_tpu/utils/wav.py``)."""
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


def read_wav(path: str):
    """16-bit WAV → (float32 waveform in [-1, 1], sample rate); several
    channels are averaged to mono."""
    with wave.open(path, "rb") as f:
        sr, width, channels = f.getframerate(), f.getsampwidth(), \
            f.getnchannels()
        raw = f.readframes(f.getnframes())
    if width != 2:
        raise ValueError(f"unsupported sample width {width}")
    pcm = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
    if channels > 1:   # interleaved frames
        pcm = pcm.reshape(-1, channels).mean(axis=1)
    return pcm, sr
