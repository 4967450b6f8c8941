"""stage2_decode: mel spectrograms reconstructed from frozen CAVP features
(``diff_foley_tpu/train/stage2_decode.py``; the reference's
Decoder_Wrapper).

A frozen CAVP spec tower encodes the spec to per-step features z (B, T,
C) (``encode_spec``: normalised, not pooled; the tower in eval mode,
without gradients); the taming VAE ``Decoder`` maps z, as a (B, C, 1, T)
canvas, back to the spec, its output (B, c, h, t) read as (B, c·h, t).
At the default config (ch 64, ch_mult (1, 1, 2, 2, 4), one res block, 8
out channels) 16 feature steps of a 256-step spec give 128 × 256: mel
bins = out_channels·2^(levels−1). The decoder's mid attention is
single-head over the 16 canvas steps at D = ch·ch_mult[-1] = 256, the
per-head attention kernel (forward, and its backward in a train step) on
CUDA tensors; its GroupNorms are the GroupNorm kernels.

- ``DecoderWrapper.train_step``: MSE on the overlapping time extent, Adam
  (optax ``adam``: β (0.5, 0.9), ε 1e-8, bias-corrected, no decay);
- ``GANDecoderWrapper.train_step``: the generator's L1 (+ an optional
  perceptual term) plus the discriminator's hinge term (``disc_weight``,
  gated by ``disc_start``), scored with the PatchGAN's running statistics;
  then the discriminator's step on the spec and the detached
  reconstruction, in train mode, its BatchNorm statistics persisting
  across steps; each with its own Adam.

The train states live on the first CUDA device unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..models.cavp import CAVPConfig, CAVPModel
from ..models.layers import init_weights_
from ..models.vae import Decoder, VAEConfig
from ..pipeline import resolve_device
from .optim import AdamW
from .vae_losses import NLayerDiscriminator, VAELossConfig, \
    discriminator_loss


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decoder canvas: (B, 1, T, feat_dim) → (B, mel_bins, T·up)."""

    feat_dim: int = 512
    decoder: VAEConfig = VAEConfig(ch=64, ch_mult=(1, 1, 2, 2, 4),
                                   num_res_blocks=1, out_channels=8)
    lr: float = 4.5e-6

    @property
    def mel_bins(self) -> int:
        return self.decoder.out_channels * 2 ** (len(self.decoder.ch_mult) - 1)


@dataclasses.dataclass
class DecodeTrainState:
    """The step count and the optimizers (the modules are the wrapper's)."""

    step: int
    opt: AdamW
    disc_opt: Optional[AdamW] = None


def _adam(params, lr: float) -> AdamW:
    # optax.adam(lr, b1=0.5, b2=0.9)
    return AdamW(list(params), lambda count: lr, b1=0.5, b2=0.9)


class DecoderWrapper:
    """Frozen CAVP spec tower + trainable spec decoder (MSE objective)."""

    def __init__(self, cfg: DecodeConfig = DecodeConfig(),
                 cavp: Optional[CAVPModel] = None):
        self.cfg = cfg
        self.cavp = (cavp or CAVPModel(CAVPConfig())).eval()
        self.cavp.requires_grad_(False)
        self.decoder = Decoder(cfg.decoder, in_channels=cfg.feat_dim)

    def init_train_state(self, seed: Optional[int] = 0,
                         device=None) -> DecodeTrainState:
        """The modules on ``device`` (None: the first CUDA device, and
        without one it raises; pass "cpu" for the CPU); ``seed`` draws
        flax's initialisation, None keeps the weights they have."""
        device = resolve_device(device)
        if seed is not None:
            init_weights_(self.decoder, torch.Generator().manual_seed(seed))
        self.decoder.to(device).train()
        self.cavp.to(device).eval()
        return DecodeTrainState(0, _adam(self.decoder.parameters(),
                                         self.cfg.lr))

    def reconstruct(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, C) features → (B, c·h, t) spec."""
        z = feats.transpose(1, 2)[:, :, None].contiguous()   # (B, C, 1, T)
        out = self.decoder(z)                                # (B, c, h, t)
        b, c, h, t = out.shape
        return out.reshape(b, c * h, t)

    @torch.no_grad()
    def encode_spec(self, spec: torch.Tensor) -> torch.Tensor:
        """The frozen tower's per-step features (normalised, not pooled)."""
        return self.cavp.encode_spec(spec, normalize=True, pool=False)

    def train_step(self, state: DecodeTrainState, spec: torch.Tensor) -> dict:
        """One MSE step in place: spec (B, mel, T) on the state's device →
        {"l2_loss"} as 0-dim tensors."""
        feats = self.encode_spec(spec)
        params = list(self.decoder.parameters())
        rec = self.reconstruct(feats)
        t = min(rec.shape[-1], spec.shape[-1])
        loss = torch.mean((rec[..., :t] - spec[..., :t]) ** 2)
        grads = torch.autograd.grad(loss, params)
        state.opt.step(grads)
        state.step += 1
        return {"l2_loss": loss.detach()}


class GANDecoderWrapper(DecoderWrapper):
    """Decoder_Wrapper's GAN mode: the LPIPSWithDiscriminator objective on
    (spec, reconstruction) pairs, two Adam(0.5, 0.9) optimizers.
    ``perceptual_fn(x, rec)`` supplies the perceptual term when
    ``loss_cfg.perceptual_weight > 0``; without it the term is left out."""

    def __init__(self, cfg: DecodeConfig = DecodeConfig(),
                 cavp: Optional[CAVPModel] = None,
                 loss_cfg: Optional[VAELossConfig] = None,
                 perceptual_fn: Optional[Callable] = None):
        super().__init__(cfg, cavp)
        self.loss_cfg = loss_cfg or VAELossConfig(disc_start=0)
        self.perceptual_fn = perceptual_fn
        self.disc = NLayerDiscriminator(in_channels=1)

    def init_train_state(self, seed: Optional[int] = 0,
                         device=None) -> DecodeTrainState:
        state = super().init_train_state(seed, device)
        if seed is not None:
            init_weights_(self.disc,
                          torch.Generator().manual_seed(seed + 1))
        self.disc.to(next(self.decoder.parameters()).device)
        state.disc_opt = _adam(self.disc.parameters(), self.cfg.lr)
        return state

    def train_step(self, state: DecodeTrainState, spec: torch.Tensor) -> dict:
        """One generator and one discriminator step in place → {nll_loss,
        g_loss, decode_loss, d_loss} as 0-dim tensors."""
        lcfg = self.loss_cfg
        feats = self.encode_spec(spec)
        rec = self.reconstruct(feats)
        t = min(rec.shape[-1], spec.shape[-1])
        rec, spec = rec[..., :t], spec[..., :t]
        rec_loss = torch.abs(spec - rec)
        if self.perceptual_fn is not None and lcfg.perceptual_weight > 0:
            rec_loss = rec_loss + lcfg.perceptual_weight * self.perceptual_fn(
                spec[..., None], rec[..., None])
        nll = torch.sum(rec_loss) / rec.shape[0]
        g_loss = -torch.mean(self.disc(rec[..., None], train=False))
        factor = lcfg.disc_factor if state.step >= lcfg.disc_start else 0.0
        loss = nll + factor * lcfg.disc_weight * g_loss
        state.opt.step(torch.autograd.grad(
            loss, list(self.decoder.parameters())))
        # the discriminator in train mode: its statistics advance on the
        # spec, then on the reconstruction
        logits_real = self.disc(spec[..., None], train=True)
        logits_fake = self.disc(rec.detach()[..., None], train=True)
        d_loss = discriminator_loss(logits_real, logits_fake, state.step,
                                    lcfg)
        state.disc_opt.step(torch.autograd.grad(
            d_loss, list(self.disc.parameters())))
        state.step += 1
        return {"nll_loss": nll.detach(), "g_loss": g_loss.detach(),
                "decode_loss": loss.detach(), "d_loss": d_loss.detach()}
