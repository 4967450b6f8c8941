"""First-stage VAE trainer: alternating generator / discriminator steps
(``diff_foley_tpu/train/vae.py``).

One train step on a batch of NHWC mel images:

1. Generator. Encode, sample the posterior, decode; score the
   reconstruction with the discriminator on its running statistics. The
   adaptive GAN weight ‖∇nll‖ / (‖∇g‖ + 1e-4) w.r.t. the decoder's last
   convolution kernel comes from two ``torch.autograd.grad`` probes of the
   one graph (the JAX package runs two extra forward passes for the same
   value); clipped to [0, 1e4], times ``disc_weight``, detached.
   Adam(lr, β 0.5, 0.9) on the VAE.
2. Discriminator, on the input and on the detached reconstruction of step
   1 (from before the generator update), both calls on batch statistics,
   the running statistics carried from the first call into the second.
   Adam(lr, β 0.5, 0.9) on the discriminator.

The backward of step 1 runs through the VAE's two mid-attention blocks
(the per-head attention backward kernel on CUDA tensors) and every
``GroupNorm32`` (forward kernels; the backward recomputes the plain
formula).

On a ``mesh`` each rank takes its rows of the global batch and the step
is the one-process step on it: the posterior's ε is the global draw's
rows, the PatchGAN's BatchNorm takes its statistics over the data group,
the adaptive weight's two probe gradients and every gradient are
averaged over the group before Adam, and so are the metrics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..models.layers import init_weights_
from ..models.vae import AutoencoderKL, VAEConfig
from ..parallel import collectives
from ..parallel.mesh import Mesh, global_rows
from ..pipeline import resolve_device
from .vae_losses import (NLayerDiscriminator, VAELossConfig,
                         discriminator_loss, generator_loss)


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    lr: float = 4.5e-6            # SD first-stage base lr
    loss: VAELossConfig = VAELossConfig()


@dataclasses.dataclass
class VAETrainState:
    """The two models, their optimizers and the step count."""

    vae: AutoencoderKL
    disc: NLayerDiscriminator
    opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    step: int = 0

    def state_dict(self) -> dict:
        return {"vae": self.vae.state_dict(), "disc": self.disc.state_dict(),
                "opt": self.opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.vae.load_state_dict(sd["vae"], strict=True)
        self.disc.load_state_dict(sd["disc"], strict=True)
        self.opt.load_state_dict(sd["opt"])
        self.disc_opt.load_state_dict(sd["disc_opt"])
        self.step = int(sd["step"])


class VAETrainer:
    def __init__(self, vae_cfg: VAEConfig = VAEConfig(),
                 cfg: VAETrainConfig = VAETrainConfig(),
                 perceptual_fn: Optional[Callable] = None,
                 mesh: Optional[Mesh] = None):
        """``perceptual_fn(x, rec) -> scalar`` supplies the LPIPS/LPAPS term
        (``train.perceptual.make_lpips_fn`` / ``make_lpaps_fn``); active
        when ``cfg.loss.perceptual_weight > 0``."""
        self.vae_cfg = vae_cfg
        self.cfg = cfg
        self.perceptual_fn = perceptual_fn
        self.mesh = mesh
        self.group = None if mesh is None else mesh.data_group

    def init_train_state(self, seed: int = 0, device=None) -> VAETrainState:
        """Seeded initial state on ``device``; ``None`` means the first CUDA
        device and raises without one (pass ``"cpu"`` to train on the CPU)."""
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        vae = init_weights_(AutoencoderKL(self.vae_cfg), g).to(device)
        disc = init_weights_(
            NLayerDiscriminator(self.vae_cfg.out_channels), g).to(device)
        collectives.sync_batchnorm_(disc, self.group)
        adam = lambda m: torch.optim.Adam(m.parameters(), lr=self.cfg.lr,
                                          betas=(0.5, 0.9))
        return VAETrainState(vae, disc, adam(vae), adam(disc))

    def _perceptual(self, x, rec):
        lcfg = self.cfg.loss
        if self.perceptual_fn is not None and lcfg.perceptual_weight > 0:
            return lcfg.perceptual_weight * self.perceptual_fn(x, rec)
        return 0.0

    def generator_step(self, state: VAETrainState, x: torch.Tensor,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
        """One Adam step on the VAE → (logs, the detached reconstruction)."""
        lcfg = self.cfg.loss
        with global_rows(self.mesh):
            rec, posterior = state.vae(x, noise=noise, sample_posterior=True,
                                       generator=generator)
        logits_fake = state.disc(rec, train=False)

        # The adaptive weight: the gradient norms of the reconstruction
        # term (the perceptual component included) and of the GAN term at
        # the decoder's last kernel. Each probe stops there.
        last = state.vae.decoder.conv_out.weight
        rl = (torch.abs(x - rec) + self._perceptual(x, rec)) \
            / math.exp(lcfg.logvar_init)
        nll_grad, = torch.autograd.grad(rl.sum() / x.shape[0], last,
                                        retain_graph=True)
        g_grad, = torch.autograd.grad(-logits_fake.mean(), last,
                                      retain_graph=True)
        nll_grad = collectives.all_reduce_mean(nll_grad, self.group)
        g_grad = collectives.all_reduce_mean(g_grad, self.group)
        d_weight = torch.linalg.vector_norm(nll_grad) / (
            torch.linalg.vector_norm(g_grad) + 1e-4)
        d_weight = (torch.clamp(d_weight, 0.0, 1e4) * lcfg.disc_weight).detach()

        loss, logs = generator_loss(rec, x, posterior, logits_fake, state.step,
                                    lcfg, d_weight, self.perceptual_fn)
        state.opt.zero_grad(set_to_none=True)
        # the GAN term reaches the discriminator's parameters too: only
        # the VAE's take this gradient
        loss.backward(inputs=list(state.vae.parameters()))
        collectives.grad_mean_(list(state.vae.parameters()), self.group)
        state.opt.step()
        logs = {k: v.detach() for k, v in logs.items()}
        logs["total_loss"] = loss.detach()
        return self._mean(logs), rec.detach()

    def _mean(self, metrics: dict) -> dict:
        return {k: collectives.all_reduce_mean(v, self.group)
                for k, v in metrics.items()}

    def discriminator_step(self, state: VAETrainState, x: torch.Tensor,
                           rec: torch.Tensor) -> torch.Tensor:
        """One Adam step on the discriminator → its loss."""
        logits_real = state.disc(x, train=True)
        logits_fake = state.disc(rec, train=True)
        d_loss = discriminator_loss(logits_real, logits_fake, state.step,
                                    self.cfg.loss)
        state.disc_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        collectives.grad_mean_(list(state.disc.parameters()), self.group)
        state.disc_opt.step()
        return collectives.all_reduce_mean(d_loss.detach(), self.group)

    def train_step(self, state: VAETrainState, x: torch.Tensor,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> dict:
        """Both steps on the NHWC batch ``x``, in place on ``state`` → the
        metrics as 0-dim tensors. ``noise`` (the latent's shape) or
        ``generator`` gives the posterior's ε."""
        metrics, rec = self.generator_step(state, x, noise, generator)
        metrics["disc_loss"] = self.discriminator_step(state, x, rec)
        state.step += 1
        return metrics
