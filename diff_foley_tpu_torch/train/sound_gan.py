"""SoundStream-style GAN training of the 1-D waveform VAE
(``diff_foley_tpu/train/sound_gan.py``).

Generator loss: time-domain L1 + multi-window mel L1 and L2 + feature
matching over one STFT discriminator per scale + the hinge adversarial
term (gated by ``disc_start``) + KL. Discriminator loss: the hinge on the
same multi-scale real/imaginary STFT maps (gated likewise). One step runs
the two Adam(lr, β 0.5, 0.9) updates in the JAX step's order: the
generator's loss scores the reconstruction with the discriminators from
before their update, and the discriminators train on the reconstruction
from before the generator's update.

Waveforms are (B, L, 1); the discriminators take (B, 2, F, T) real and
imaginary STFT maps (NCHW; JAX's are (B, F, T, 2)). No TPU kernel runs
here: 1-D convolutions, LSTMs, STFTs and 2-D convolutions.

On a ``mesh`` each rank takes its rows of the global batch, the
posterior's ε is the global draw's rows, and the gradients and the
metrics are averaged over the data group before Adam: the mean of the
ranks' losses, which is the global batch's loss. The mel L2 term, a root
of a mean, takes the root of the ranks' summed means, so that it too is
the global batch's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.sound_vae import SoundAutoencoderKL, SoundVAEConfig
from ..ops.mel import mel_filterbank
from ..ops.stft import stft
from ..parallel import collectives
from ..parallel.mesh import Mesh, global_rows
from ..pipeline import resolve_device
from .vae import VAETrainState

# (channels, kernel, stride, dilation) of the four dilated VALID convs
_DISC_LAYERS = ((32, (3, 8), (1, 1), (1, 1)),
                (64, (3, 3), (2, 2), (1, 1)),
                (128, (3, 3), (2, 2), (1, 2)),
                (128, (3, 3), (2, 2), (1, 4)))


class STFTDiscriminator(nn.Module):
    """Per-scale conv discriminator over a (B, 2, F, T) STFT map → every
    layer's activations, the logit map last."""

    def __init__(self, last_act: bool = True):
        super().__init__()
        self.last_act = last_act
        cin = 2
        for i, (ch, k, s, d) in enumerate(_DISC_LAYERS):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, k, stride=s,
                                                  dilation=d))
            cin = ch
        self.conv_out = nn.Conv2d(cin, 1, 3)

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for i in range(len(_DISC_LAYERS)):
            x = F.elu(getattr(self, f"conv{i}")(x))
            feats.append(x)
        x = self.conv_out(x)
        feats.append(F.elu(x) if self.last_act else x)
        return feats


@dataclasses.dataclass(frozen=True)
class AudioGANConfig:
    """AudioLoss's defaults."""

    time_weight: float = 1.0
    freq_weight: float = 1.0
    feat_weight: float = 1.0
    g_weight: float = 1.0
    d_weight: float = 1.0
    kl_weight: float = 1.0
    disc_start: int = 50001
    mel_windows: Sequence[int] = tuple(range(5, 12))   # win 32..2048
    stft_windows: Sequence[int] = tuple(range(9, 12))  # win 512..2048
    n_fft: int = 2048
    sr: int = 16000
    num_mels: int = 80
    fmin: float = 80.0
    fmax: float = 7600.0
    lr: float = 3e-4


def multi_window_mel_loss(a: torch.Tensor, b: torch.Tensor,
                          cfg: AudioGANConfig, group=None) -> torch.Tensor:
    """L1 + L2 mel distances averaged over the window scales, (B, L)
    waveforms. With a data ``group`` each rank holds its rows of the
    global batch, and the L2 term is the global batch's on every rank."""
    fb = mel_filterbank(cfg.sr, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax,
                        dtype=a.dtype, device=a.device)
    l1 = l2 = 0.0
    for i in cfg.mel_windows:
        mel = lambda w: torch.einsum("mf,bft->bmt", fb, stft(
            w, n_fft=cfg.n_fft, hop_length=2**(i - 2), win_length=2**i,
            normalized=True).abs())
        d = mel(a) - mel(b)
        l1 = l1 + d.abs().mean()
        ms = d.square().mean()
        if group is not None:   # equal rows a rank: the mean of the means
            ms = (collectives.all_reduce_with_grad(ms, group)
                  / collectives.size(group))
        l2 = l2 + torch.sqrt(ms + 1e-12)
    n = len(cfg.mel_windows)
    return l1 / n + l2 / n


def stft_feature_list(wav: torch.Tensor,
                      cfg: AudioGANConfig) -> List[torch.Tensor]:
    """(B, L) → per scale the (B, 2, F, T) real and imaginary maps."""
    out = []
    for i in cfg.stft_windows:
        s = stft(wav, n_fft=cfg.n_fft, hop_length=2**(i - 2),
                 win_length=2**i, normalized=True)
        out.append(torch.stack([s.real, s.imag], dim=1))
    return out


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator):
    """flax's initialisation: lecun-normal kernels (σ² = 1 / fan-in, a
    transposed conv's fan-in its out·K as flax counts it), zero biases,
    and orthogonal recurrent kernels per LSTM gate."""
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            p.copy_(torch.randn(p.shape, generator=generator)
                    / math.sqrt(p[0].numel()))
        else:
            p.zero_()
    for m in module.modules():
        if isinstance(m, nn.LSTM):
            for gate in m.weight_hh_l0.chunk(4):
                nn.init.orthogonal_(gate, generator=generator)
    return module


class SoundVAETrainer:
    """The two-optimizer waveform VAE-GAN."""

    def __init__(self, cfg: AudioGANConfig = AudioGANConfig(),
                 vae_cfg: SoundVAEConfig = SoundVAEConfig(),
                 mesh: Optional[Mesh] = None):
        self.cfg, self.vae_cfg = cfg, vae_cfg
        self.mesh = mesh
        self.group = None if mesh is None else mesh.data_group

    def init_train_state(self, seed: int = 0, device=None) -> VAETrainState:
        """Seeded initial state on ``device``; ``None`` means the first CUDA
        device and raises without one (pass ``"cpu"`` to train on the CPU)."""
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        vae = init_weights_(SoundAutoencoderKL(self.vae_cfg), g).to(device)
        discs = nn.ModuleList(init_weights_(STFTDiscriminator(), g)
                              for _ in self.cfg.stft_windows).to(device)
        adam = lambda m: torch.optim.Adam(
            [p for p in m.parameters() if p.requires_grad], lr=self.cfg.lr,
            betas=(0.5, 0.9))
        return VAETrainState(vae, discs, adam(vae), adam(discs))

    def _disc_outputs(self, discs, wav):
        return [d(f) for d, f in zip(discs, stft_feature_list(wav, self.cfg))]

    def _factor(self, step: int) -> float:
        return 1.0 if step >= self.cfg.disc_start else 0.0

    def _mean(self, metrics: dict) -> dict:
        return {k: collectives.all_reduce_mean(v, self.group)
                for k, v in metrics.items()}

    def generator_step(self, state: VAETrainState, wav: torch.Tensor,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
        """One Adam step on the VAE → (logs, the detached reconstruction)."""
        cfg = self.cfg
        with global_rows(self.mesh):
            rec, posterior = state.vae(wav, noise=noise, generator=generator)
        time_loss = (wav - rec).abs().mean()
        freq_loss = multi_window_mel_loss(wav[..., 0], rec[..., 0], cfg,
                                          self.group)
        with torch.no_grad():
            outs_real = self._disc_outputs(state.disc, wav[..., 0])
        outs_fake = self._disc_outputs(state.disc, rec[..., 0])
        feat_match = sum((a - b).abs().mean()
                         for o_r, o_f in zip(outs_real, outs_fake)
                         for a, b in zip(o_r, o_f)) \
            / sum(len(o) for o in outs_real)
        g_loss = sum(-o[-1].mean() for o in outs_fake) / len(outs_fake)
        kl = posterior.kl().sum() / wav.shape[0]
        loss = (cfg.time_weight * time_loss + cfg.freq_weight * freq_loss
                + cfg.feat_weight * feat_match
                + self._factor(state.step) * cfg.g_weight * g_loss
                + cfg.kl_weight * kl)
        params = [p for p in state.vae.parameters() if p.requires_grad]
        state.opt.zero_grad(set_to_none=True)
        loss.backward(inputs=params)
        collectives.grad_mean_(params, self.group)
        state.opt.step()
        logs = {"time_domain_loss": time_loss, "freq_domain_loss": freq_loss,
                "feat_match_loss": feat_match, "g_loss": g_loss,
                "kl_loss": kl, "total_loss": loss}
        return (self._mean({k: v.detach() for k, v in logs.items()}),
                rec.detach())

    def discriminator_step(self, state: VAETrainState, wav: torch.Tensor,
                           rec: torch.Tensor) -> torch.Tensor:
        """One Adam step on the discriminators → their loss."""
        outs_real = self._disc_outputs(state.disc, wav[..., 0])
        outs_fake = self._disc_outputs(state.disc, rec[..., 0])
        real = sum(F.relu(1.0 - o[-1]).mean() for o in outs_real)
        fake = sum(F.relu(1.0 + o[-1]).mean() for o in outs_fake)
        d_loss = (self._factor(state.step) * self.cfg.d_weight * 0.5
                  * (real + fake) / len(outs_real))
        state.disc_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        collectives.grad_mean_(list(state.disc.parameters()), self.group)
        state.disc_opt.step()
        return collectives.all_reduce_mean(d_loss.detach(), self.group)

    def train_step(self, state: VAETrainState, wav: torch.Tensor,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> dict:
        """Both steps on the (B, L, 1) batch ``wav``, in place on ``state``
        → the metrics as 0-dim tensors. ``noise`` (the latent's shape) or
        ``generator`` gives the posterior's ε."""
        metrics, rec = self.generator_step(state, wav, noise, generator)
        metrics["d_loss"] = self.discriminator_step(state, wav, rec)
        state.step += 1
        return metrics
