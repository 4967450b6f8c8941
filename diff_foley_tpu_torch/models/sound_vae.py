"""The 1-D waveform VAE, a SoundStream-style conv/LSTM codec
(``diff_foley_tpu/models/sound_vae.py``).

- Encoder: Conv1d(1→C, k 1) + ELU; 4 blocks of a ResidualUnit (two 1×1
  convolutions with ELU between, residual) + ELU + a strided convolution
  (K = 2S, padding (K−S)/2) + ELU + ELU, channels doubling, strides
  (2, 2, 2, 4); a 2-layer LSTM; ELU → 1×1 convolution to 2·z, the
  Gaussian's parameters, → ELU unless ``remove_act`` (a quirk of the
  reference kept for parity).
- Decoder: 1×1 convolution z → C·2⁴ + ELU; a 2-layer LSTM; ELU; 4 blocks
  of a ResidualUnit + ELU + ``ConvTranspose1d`` (K = 2S, padding (K−S)/2)
  + ELU + ELU, channels halving; 1×1 convolution → 1.

Waveforms are (B, L, 1) and latents (B, L/32, z) at the surface, as in
the JAX package; convolutions run NCL inside. Children carry the flax
scope names (``block0_res.conv1``, ``lstm.OptimizedLSTMCell_0``), so
``utils.convert.from_jax_params`` loads the JAX variables with
``strict=True``. Each LSTM layer is one ``nn.LSTM``: flax's cell keeps a
single bias per gate (on its hidden-side Dense), so ``bias_ih_l0`` holds
it and ``bias_hh_l0`` is a zero that takes no gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .vae import DiagonalGaussian


@dataclasses.dataclass(frozen=True)
class SoundVAEConfig:
    channels: int = 32
    z_channels: int = 128
    enc_out_channels: int = 256   # 2·z (mean ‖ logvar)
    strides: Sequence[int] = (2, 2, 2, 4)
    lstm_layers: int = 2
    remove_act: bool = False


def _conv1(cin: int, cout: int) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, 1)


class ResidualUnit1D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = _conv1(channels, channels)
        self.conv2 = _conv1(channels, channels)

    def forward(self, x):
        return x + self.conv2(F.elu(self.conv1(x)))


class LSTMStack(nn.Module):
    """``layers`` batch-first LSTM layers over NCL maps."""

    def __init__(self, channels: int, hidden: int, layers: int = 2):
        super().__init__()
        for i in range(layers):
            lstm = nn.LSTM(channels if i == 0 else hidden, hidden,
                           batch_first=True)
            with torch.no_grad():
                lstm.bias_hh_l0.zero_()
            lstm.bias_hh_l0.requires_grad_(False)
            self.add_module(f"OptimizedLSTMCell_{i}", lstm)

    def forward(self, x):
        h = x.transpose(1, 2)
        for lstm in self.children():
            h, _ = lstm(h)
        return h.transpose(1, 2)


class SoundEncoder(nn.Module):
    def __init__(self, cfg: SoundVAEConfig = SoundVAEConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.stem = _conv1(1, c)
        for i, s in enumerate(cfg.strides):
            cin, cout, k = c * 2**i, c * 2**(i + 1), 2 * s
            self.add_module(f"block{i}_res", ResidualUnit1D(cin))
            self.add_module(f"block{i}_down", nn.Conv1d(
                cin, cout, k, stride=s, padding=(k - s) // 2))
        top = c * 2**len(cfg.strides)
        self.lstm = LSTMStack(top, top, cfg.lstm_layers)
        self.last_conv = _conv1(top, cfg.enc_out_channels)

    def forward(self, x):
        """(B, L, 1) waveform → (B, L/32, 2·z) Gaussian parameters."""
        h = F.elu(self.stem(x.transpose(1, 2)))
        for i in range(len(self.cfg.strides)):
            h = F.elu(getattr(self, f"block{i}_res")(h))
            h = F.elu(F.elu(getattr(self, f"block{i}_down")(h)))
        h = self.last_conv(F.elu(self.lstm(h)))
        h = h if self.cfg.remove_act else F.elu(h)
        return h.transpose(1, 2)


class SoundDecoder(nn.Module):
    def __init__(self, cfg: SoundVAEConfig = SoundVAEConfig()):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.strides)
        top = cfg.channels * 2**n
        self.stem = _conv1(cfg.z_channels, top)
        self.lstm = LSTMStack(top, top, cfg.lstm_layers)
        cin = top
        # JAX walks the levels top-down and indexes the reversed stride
        # list: block j runs stride strides[j]
        for j, i in enumerate(reversed(range(n))):
            cout, s = cfg.channels * 2**i, cfg.strides[n - 1 - i]
            k = 2 * s
            self.add_module(f"block{j}_res", ResidualUnit1D(cin))
            # torch's padding p is JAX's VALID transposed conv cropped by p
            self.add_module(f"block{j}_up", nn.ConvTranspose1d(
                cin, cout, k, stride=s, padding=(k - s) // 2))
            cin = cout
        self.last_conv = _conv1(cin, 1)

    def forward(self, z):
        """(B, L', z) latent → (B, L'·32, 1) waveform."""
        h = F.elu(self.stem(z.transpose(1, 2)))
        h = F.elu(self.lstm(h))
        for j in range(len(self.cfg.strides)):
            h = F.elu(getattr(self, f"block{j}_res")(h))
            h = F.elu(F.elu(getattr(self, f"block{j}_up")(h)))
        return self.last_conv(h).transpose(1, 2)


class SoundAutoencoderKL(nn.Module):
    """encode → DiagonalGaussian over (B, L', z); decode → waveform."""

    def __init__(self, cfg: SoundVAEConfig = SoundVAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = SoundEncoder(cfg)
        self.decoder = SoundDecoder(cfg)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True):
        """→ (reconstruction, posterior); the posterior's ε is ``noise``
        (the latent's shape) or drawn from ``generator``."""
        posterior = self.encode(x)
        z = (posterior.sample(generator, noise) if sample_posterior
             else posterior.mode())
        return self.decode(z), posterior
