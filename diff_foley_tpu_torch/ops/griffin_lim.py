"""Mel inversion: NNLS mel→STFT (FISTA) and momentum Griffin-Lim
(``diff_foley_tpu/ops/griffin_lim.py``).

NNLS is accelerated projected gradient (FISTA) on the normal equations,
all matrix products; Griffin-Lim is librosa 0.8's momentum variant
(n_iter 32, momentum 0.99) from a random initial phase.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.mesh import draw_rows
from .mel import mel_filterbank
from .stft import istft, stft


def mel_to_stft(mel_spec: torch.Tensor, sr: int = 16000, n_fft: int = 1024,
                fmin: float = 125.0, fmax: float = 7600.0, power: float = 1.0,
                n_iter: int = 60) -> torch.Tensor:
    """Invert (..., n_mels, n_frames) mel magnitudes to (..., n_freq,
    n_frames): min_{S≥0} ‖B S − M‖² by FISTA, B the slaney filterbank."""
    B = mel_filterbank(sr, n_fft, mel_spec.shape[-2], fmin, fmax,
                       mel_spec.dtype, mel_spec.device)
    BtB = B.T @ B
    BtM = torch.einsum("mf,...mt->...ft", B, mel_spec)

    # Lipschitz constant of the gradient, ‖BtB‖₂, by 30 power iterations
    v = torch.full((BtB.shape[0],), 1.0 / BtB.shape[0], dtype=mel_spec.dtype,
                   device=mel_spec.device)
    for _ in range(30):
        v = BtB @ v
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    lip = torch.dot(v, BtB @ v) / (torch.dot(v, v) + 1e-12)
    step = 1.0 / (lip + 1e-6)

    # warm start: the transpose projection
    x = torch.clamp(BtM, min=0.0)
    y = x
    t = np.float32(1.0)
    for _ in range(n_iter):
        grad = torch.einsum("fg,...gt->...ft", BtB, y) - BtM
        x_new = torch.clamp(y - step * grad, min=0.0)
        t_new = np.float32(0.5) * (1 + np.sqrt(1 + 4 * t * t, dtype=np.float32))
        y = x_new + float((t - 1) / t_new) * (x_new - x)
        x, t = x_new, t_new
    if power != 1.0:
        x = torch.pow(x, 1.0 / power)
    return x


def griffin_lim(spec_mag: torch.Tensor, phase: torch.Tensor | None = None,
                generator: torch.Generator | None = None, n_fft: int = 1024,
                hop_length: int = 256, n_iter: int = 32, momentum: float = 0.99,
                length: int | None = None) -> torch.Tensor:
    """Phase recovery of a (..., n_freq, n_frames) magnitude.

    The initial phase, in turns, is ``phase`` (uniform [0, 1) of the
    magnitude's shape) when given, else drawn from ``generator``."""
    if phase is None:
        phase = draw_rows(torch.rand, spec_mag.shape, generator=generator,
                          dtype=torch.float32, device=spec_mag.device)
    angles = torch.exp(2j * math.pi * phase.to(spec_mag.device, torch.float32))
    spec_c = spec_mag.to(torch.complex64)
    rebuilt_prev = torch.zeros_like(angles)
    for _ in range(n_iter):
        inverse = istft(spec_c * angles, n_fft=n_fft, hop_length=hop_length)
        rebuilt = stft(inverse, n_fft=n_fft, hop_length=hop_length)
        angles = rebuilt - (momentum / (1.0 + momentum)) * rebuilt_prev
        angles = angles / (angles.abs() + 1e-16)
        rebuilt_prev = rebuilt
    return istft(spec_c * angles, n_fft=n_fft, hop_length=hop_length,
                 length=length)
