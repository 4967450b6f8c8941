"""Batched STFT / ISTFT on ``torch.fft`` (``diff_foley_tpu/ops/stft.py``).

librosa 0.8 semantics: centred frames, reflect padding, periodic Hann
window, win_length = n_fft by default; the inverse is Hann-squared
overlap-add with window-sum normalisation. Spectra are freq-major,
(..., n_freq, n_frames). ``win_length < n_fft`` and ``normalized`` follow
torch.stft (the multi-scale GAN losses of ``train/sound_gan.py``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (scipy.signal.get_window('hann', n))."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    return torch.as_tensor(w, dtype=dtype, device=device)


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
         win_length: int | None = None,
         normalized: bool = False) -> torch.Tensor:
    """Complex STFT of (..., n_samples) → (..., n_freq, n_frames). A
    ``win_length`` below ``n_fft`` centre-pads its Hann window to
    ``n_fft``; ``normalized`` divides by √n_fft."""
    shape = x.shape
    x = F.pad(x.reshape(-1, 1, shape[-1]), (n_fft // 2, n_fft // 2),
              mode="reflect").reshape(*shape[:-1], -1)
    frames = x.unfold(-1, n_fft, hop_length)          # (..., frames, n_fft)
    if win_length is None or win_length == n_fft:
        window = hann_window(n_fft, x.dtype, x.device)
    else:
        left = (n_fft - win_length) // 2
        window = F.pad(hann_window(win_length, x.dtype, x.device),
                       (left, n_fft - win_length - left))
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    if normalized:
        spec = spec / np.sqrt(n_fft).astype(np.float32)
    return spec.transpose(-1, -2)


def stft_magnitude(x: torch.Tensor, n_fft: int = 1024,
                   hop_length: int = 256, power: float = 1.0) -> torch.Tensor:
    """|STFT|^power of (..., n_samples) → (..., n_freq, n_frames)."""
    mag = stft(x, n_fft=n_fft, hop_length=hop_length).abs()
    return mag if power == 1.0 else mag**power


def istft(spec: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
          length: int | None = None) -> torch.Tensor:
    """Inverse of :func:`stft`, (..., n_freq, n_frames) → (..., n_samples).
    Requires hop_length | n_fft: each frame splits into n_fft/hop aligned
    blocks, and the overlap-add is that many shifted adds."""
    assert n_fft % hop_length == 0, "istft requires hop_length | n_fft"
    k = n_fft // hop_length
    win = hann_window(n_fft, torch.float32, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * win
    n_frames = frames.shape[-2]
    batch = frames.shape[:-2]
    n_blocks = n_frames + k - 1
    chunks = frames.reshape(*batch, n_frames, k, hop_length)
    out = frames.new_zeros((*batch, n_blocks, hop_length))
    for j in range(k):
        out[..., j:j + n_frames, :] += chunks[..., :, j, :]
    y = out.reshape(*batch, n_blocks * hop_length)

    wsq = (win * win).reshape(k, hop_length)
    wsum = frames.new_zeros((n_blocks, hop_length))
    for j in range(k):
        wsum[j:j + n_frames, :] += wsq[j]
    y = y / torch.clamp(wsum.reshape(-1), min=1e-10)

    y = y[..., n_fft // 2:]
    if length is None:
        return y[..., :(n_frames - 1) * hop_length]
    if y.shape[-1] < length:
        y = F.pad(y, (0, length - y.shape[-1]))
    return y[..., :length]
