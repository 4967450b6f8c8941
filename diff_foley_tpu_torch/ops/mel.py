"""Slaney mel filterbank, as librosa.filters.mel(htk=False, norm='slaney').

The 128-bin bank of the mel pipeline (sr 16000, n_fft 1024, fmin 125,
fmax 7600), built in float64 numpy from the slaney formula: linear below
1 kHz, logarithmic above with step ln(6.4)/27.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    return np.where(
        freq >= _MIN_LOG_HZ,
        _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        freq / _F_SP,
    )


def mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    return np.where(
        mel >= _MIN_LOG_MEL,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)),
        _F_SP * mel,
    )


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """n_mels float64 frequencies (Hz) evenly spaced on the slaney mel
    scale from fmin to fmax."""
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


@lru_cache(maxsize=8)
def mel_filterbank_np(sr: int, n_fft: int, n_mels: int, fmin: float,
                      fmax: float) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) float64 slaney filterbank."""
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # slaney normalisation: equal-area triangles
    return weights * (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]


def mel_filterbank(sr: int = 16000, n_fft: int = 1024, n_mels: int = 128,
                   fmin: float = 125.0, fmax: float = 7600.0,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(
        mel_filterbank_np(int(sr), int(n_fft), int(n_mels), float(fmin),
                          float(fmax)), dtype=dtype, device=device)
