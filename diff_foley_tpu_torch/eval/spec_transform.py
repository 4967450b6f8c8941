"""Mel-format interop: 128-mel/16 kHz ↔ 80-mel/22.05 kHz spectrograms
(``diff_foley_tpu/eval/spec_transform.py``).

Turns generated specs into the SpecVQGAN metric toolchain's format
(IS/FID/KL): denormalise, resample the linear mel rows by the sample-rate
ratio (``scipy.signal.resample_poly``), project through the pseudo-inverse
of the source mel basis (no non-negativity clamp) onto the target mel
basis, renormalise. Both bases are librosa's defaults (fmin 0, fmax sr/2,
slaney), not the 125–7600 Hz training basis. Host numpy and scipy: no
tensor moves.
"""
from __future__ import annotations

import numpy as np

from ..ops.mel import mel_filterbank_np


def _denorm(spec: np.ndarray) -> np.ndarray:
    return 10.0 ** (((spec * 100.0 - 100.0) + 20.0) / 20.0)


def _norm(spec: np.ndarray) -> np.ndarray:
    x = np.log10(np.maximum(1e-5, spec))
    return np.clip((x * 20.0 - 20.0 + 100.0) / 100.0, 0.0, 1.0)


def _transform(spec: np.ndarray, origin_n_mels: int, origin_sr: int,
               new_n_mels: int, new_sr: int, n_fft: int = 1024) -> np.ndarray:
    import scipy.signal

    linear = _denorm(spec)
    g = np.gcd(new_sr, origin_sr)
    linear = scipy.signal.resample_poly(linear, new_sr // g, origin_sr // g,
                                        axis=-1)
    basis_src = mel_filterbank_np(origin_sr, n_fft, origin_n_mels, 0.0,
                                  origin_sr / 2)
    basis_dst = mel_filterbank_np(new_sr, n_fft, new_n_mels, 0.0, new_sr / 2)
    stft_est = np.linalg.pinv(basis_src) @ linear
    return _norm(basis_dst @ stft_est)


def spec_16k128_to_22k80(spec: np.ndarray) -> np.ndarray:
    """A generated (…, 128, T) spec → the SpecVQGAN evaluation format."""
    return _transform(spec, 128, 16000, 80, 22050)


def spec_22k80_to_16k128(spec: np.ndarray) -> np.ndarray:
    return _transform(spec, 80, 22050, 128, 16000)
