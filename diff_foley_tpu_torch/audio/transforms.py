"""The normalised-mel ↔ wav transform chain (``diff_foley_tpu/audio/transforms.py``).

Forward: mel magnitude → max(1e-5, ·) → log10 → ×20 −20 +100 ÷100 →
clip(0, 1). Inverse: the affine and 10^x undone, NNLS mel→STFT, then
Griffin-Lim.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.griffin_lim import griffin_lim, mel_to_stft
from ..ops.mel import mel_filterbank
from ..ops.stft import stft_magnitude


@dataclasses.dataclass(frozen=True)
class MelSpec:
    """Mel-pipeline hyperparameters."""

    sr: int = 16000
    n_fft: int = 1024
    fmin: float = 125.0
    fmax: float = 7600.0
    n_mels: int = 128
    hop_length: int = 256
    spec_power: float = 1.0


DEFAULT_MELSPEC = MelSpec()


def normalize_spectrogram(mel: torch.Tensor) -> torch.Tensor:
    """Raw mel magnitude → [0, 1]."""
    x = torch.log10(torch.clamp(mel, min=1e-5))
    return torch.clamp((x * 20.0 - 20.0 + 100.0) / 100.0, 0.0, 1.0)


def denormalize_spectrogram(spec: torch.Tensor) -> torch.Tensor:
    """[0, 1] normalised spec → raw mel magnitude."""
    return torch.pow(10.0, (spec * 100.0 - 100.0 + 20.0) / 20.0)


def wav_to_mel(wav: torch.Tensor,
               cfg: MelSpec = DEFAULT_MELSPEC) -> torch.Tensor:
    """(..., n_samples) waveform → (..., n_mels, n_frames) normalised mel."""
    mag = stft_magnitude(wav, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                         power=cfg.spec_power)
    fb = mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax,
                        dtype=mag.dtype, device=mag.device)
    return normalize_spectrogram(torch.einsum("mf,...ft->...mt", fb, mag))


def mel_to_wav(spec: torch.Tensor, cfg: MelSpec = DEFAULT_MELSPEC,
               n_iter: int = 32, length: int | None = None,
               phase: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Normalised (..., n_mels, n_frames) spec → (..., n_samples) waveform.
    ``phase``/``generator`` give Griffin-Lim's initial phase."""
    mag = mel_to_stft(denormalize_spectrogram(spec), sr=cfg.sr,
                      n_fft=cfg.n_fft, fmin=cfg.fmin, fmax=cfg.fmax,
                      power=cfg.spec_power)
    return griffin_lim(mag, phase=phase, generator=generator, n_fft=cfg.n_fft,
                       hop_length=cfg.hop_length, n_iter=n_iter, length=length)
