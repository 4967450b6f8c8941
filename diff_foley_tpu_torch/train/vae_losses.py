"""First-stage (VAE) training losses: reconstruction + KL + adversarial
(``diff_foley_tpu/train/vae_losses.py``).

``NLayerDiscriminator`` is the PatchGAN discriminator with BatchNorm; like
the VAE it takes and returns NHWC at its surface and runs NCHW inside. Its
``BatchNorm`` follows flax: batch statistics in float32 with the fast
variance max(0, E[x²] − E[x]²), and running statistics that average the
*biased* batch variance with momentum 0.9 (torch's ``BatchNorm2d`` would
store the unbiased one). Whether a call uses batch or running statistics is
the ``train`` argument of the call, not the module's mode: the generator
step scores its reconstruction with running statistics while the
discriminator step trains on batch statistics.

The LPIPS perceptual term is a pluggable ``perceptual_fn(x, rec) -> scalar``
(``train/perceptual.py``) and is off by default (``perceptual_weight=0``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..audio.transforms import MelSpec
from ..models.layers import Conv2d
from ..ops.mel import mel_filterbank
from ..ops.stft import stft_magnitude
from ..parallel import collectives


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over the channels of an NCHW map (ε 1e-5)."""

    process_group = None

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float()
            if collectives.size(self.process_group) > 1:
                s = collectives.all_reduce_with_grad(torch.stack(
                    [xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))]),
                    self.process_group)
                n = x.numel() // x.shape[1] \
                    * collectives.size(self.process_group)
                mean, mean_sq = s[0] / n, s[1] / n
            else:
                mean, mean_sq = xf.mean((0, 2, 3)), xf.square().mean((0, 2, 3))
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape)
        return y + self.bias.reshape(shape)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator, BatchNorm variant: (B, H, W, C) images →
    (B, h, w, 1) patch logits. 4×4 convolutions with explicit padding 1."""

    def __init__(self, in_channels: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = Conv2d(in_channels, ndf, 4, stride=2, padding=1)
        ch = ndf
        for n in range(1, n_layers + 1):
            out = ndf * min(2**n, 8)
            stride = 2 if n < n_layers else 1
            setattr(self, f"conv{n}", Conv2d(ch, out, 4, stride=stride,
                                             padding=1, bias=False))
            setattr(self, f"bn{n}", BatchNorm(out))
            ch = out
        self.conv_out = Conv2d(ch, 1, 4, padding=1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(x.permute(0, 3, 1, 2).contiguous()), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(h)
            h = F.leaky_relu(getattr(self, f"bn{n}")(h, train), 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    """The softplus form."""
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def feature_match_loss(feats_real: Sequence, feats_fake: Sequence):
    """L1 between discriminator features."""
    return sum(torch.mean(torch.abs(a - b))
               for a, b in zip(feats_real, feats_fake)) / max(len(feats_real), 1)


def mel_spectrogram_loss(wav_hat: torch.Tensor, wav: torch.Tensor,
                         cfgs: Sequence[MelSpec] = (MelSpec(),),
                         log_eps: float = 1e-5):
    """Multi-config mel L1 (+log-L1) on waveforms."""
    total = 0.0
    for cfg in cfgs:
        fb = mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax,
                            dtype=wav.dtype, device=wav.device)
        mel_a, mel_b = (torch.einsum("mf,...ft->...mt", fb, stft_magnitude(
            w, cfg.n_fft, cfg.hop_length, power=cfg.spec_power))
            for w in (wav_hat, wav))
        total = total + torch.mean(torch.abs(mel_a - mel_b)) + torch.mean(
            torch.abs(torch.log(mel_a + log_eps) - torch.log(mel_b + log_eps)))
    return total / len(cfgs)


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    kl_weight: float = 1e-6              # SD first-stage default
    disc_weight: float = 0.5
    disc_start: int = 50001              # steps before the GAN term engages
    disc_factor: float = 1.0
    logvar_init: float = 0.0
    disc_loss: str = "hinge"
    perceptual_weight: float = 0.0       # the LPIPS hook is off by default


def _disc_factor(step: int, cfg: VAELossConfig) -> float:
    return cfg.disc_factor if step >= cfg.disc_start else 0.0


def generator_loss(rec: torch.Tensor, x: torch.Tensor, posterior,
                   logits_fake: torch.Tensor, step: int, cfg: VAELossConfig,
                   adaptive_weight, perceptual_fn: Optional[Callable] = None):
    """The generator's loss and its logged terms: |x − rec| (+ the
    perceptual term) over exp(logvar_init) plus logvar_init, summed over
    all but batch-mean; the KL; −mean(logits_fake) weighted by the adaptive
    weight and gated by ``step >= disc_start``."""
    rec_loss = torch.abs(x - rec)
    if perceptual_fn is not None and cfg.perceptual_weight > 0:
        rec_loss = rec_loss + cfg.perceptual_weight * perceptual_fn(x, rec)
    nll = rec_loss / math.exp(cfg.logvar_init) + cfg.logvar_init
    nll_loss = torch.sum(nll) / nll.shape[0]
    kl_loss = torch.sum(posterior.kl()) / x.shape[0]
    g_loss = -torch.mean(logits_fake)
    loss = nll_loss + cfg.kl_weight * kl_loss + (
        adaptive_weight * _disc_factor(step, cfg) * g_loss)
    return loss, {"nll_loss": nll_loss, "kl_loss": kl_loss, "g_loss": g_loss,
                  "d_weight": adaptive_weight}


def discriminator_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor,
                       step: int, cfg: VAELossConfig):
    fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    return _disc_factor(step, cfg) * fn(logits_real, logits_fake)
