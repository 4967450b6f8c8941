"""LatentDiffusion: conditioning, the ε-UNet, guided sampling by any
sampler of ``samplers.py``, the first stage's encode and decode (also over
a big canvas in tiles), and the training loss ``p_losses``
(``diff_foley_tpu/diffusion/latent_diffusion.py``).

Children mirror the JAX params layout: ``unet`` ({"unet": …}), ``cond``
({"cond": …}) and ``vae`` (the separate VAE params). ``forward`` is the
training loss, as in the reference's LatentDiffusion.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.cond_encoder import VideoFeatEncoderPosembed
from ..models.layers import dropout_draws
from ..models.unet import LDM_UNET, UNetConfig, UNetModel
from ..models.vae import SD_VAE, AutoencoderKL, VAEConfig
from ..parallel.mesh import draw_rows
from .guidance import GuidanceSpec, make_guided_eps_fn
from .samplers import (ddim_sample, dpm_solver_sample, p_sample_loop,
                       plms_sample, progressive_denoising)
from .schedule import DiffusionSchedule
from .tiled import SplitInputParams, tiled_apply


@dataclasses.dataclass(frozen=True)
class LDMConfig:
    """Shipped Stage-2 operating point."""

    unet: UNetConfig = LDM_UNET
    vae: VAEConfig = SD_VAE
    cond_origin_dim: int = 512
    cond_embed_dim: int = 768
    cond_seq_len: int = 40
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    scale_factor: float = 0.18215
    cond_drop_prob: float = 0.2   # CFG dropout of the context in training
    # how apply_model routes conditioning into the UNet: None, "concat",
    # "crossattn", "hybrid" or "adm"
    conditioning_key: Optional[str] = "crossattn"


CONDITIONING_KEYS = (None, "concat", "crossattn", "hybrid", "adm")


class LatentDiffusion(nn.Module):
    def __init__(self, cfg: LDMConfig = LDMConfig()):
        super().__init__()
        if cfg.conditioning_key not in CONDITIONING_KEYS:
            raise ValueError(f"conditioning_key {cfg.conditioning_key!r} is "
                             f"not one of {CONDITIONING_KEYS}")
        self.cfg = cfg
        # concat and adm call the UNet with no context: its cross-attention
        # reads the tokens, as the JAX UNet initialised without one
        self.unet = UNetModel(cfg.unet, with_context=cfg.conditioning_key
                              not in ("concat", "adm"))
        self.cond = VideoFeatEncoderPosembed(
            cfg.cond_origin_dim, cfg.cond_embed_dim, cfg.cond_seq_len)
        self.vae = AutoencoderKL(cfg.vae)
        self.schedule = DiffusionSchedule.create(
            timesteps=cfg.timesteps, linear_start=cfg.linear_start,
            linear_end=cfg.linear_end)

    def get_learned_conditioning(self, feat: torch.Tensor) -> torch.Tensor:
        return self.cond(feat)

    def apply_model(self, x, t, context=None, c_concat=None, y=None):
        """Conditioning into the UNet by ``cfg.conditioning_key``
        (DiffusionWrapper, ddpm.py:1545-1571): "concat" joins ``c_concat``
        to the NHWC latents' channels and passes no context, "hybrid" joins
        it and passes the context, "adm" passes the class ids ``y`` and no
        context, "crossattn" and None pass the context."""
        key = self.cfg.conditioning_key
        if key in ("concat", "hybrid"):
            if c_concat is None:
                raise ValueError(f"conditioning_key {key!r} needs c_concat")
            x = torch.cat([x, c_concat.to(x.dtype)], dim=-1)
        if key in ("concat", "adm"):
            context = None
        return self.unet(x, t, context, y=y if key == "adm" else None)

    def apply_model_tiled(self, x: torch.Tensor, t: torch.Tensor,
                          context: torch.Tensor,
                          split: SplitInputParams) -> torch.Tensor:
        """The UNet's output over a big NHWC latent canvas in overlapping
        ``split.ks`` tiles, all in one batched call, every tile with its
        example's context and time, blended by the border weighting
        (ddpm.py:936-1018)."""
        def fn(tiles):
            n_rep = tiles.shape[0] // x.shape[0]
            return self.unet(tiles.permute(0, 2, 3, 1), t.repeat(n_rep),
                             context.repeat(n_rep, 1, 1)).permute(0, 3, 1, 2)

        return tiled_apply(fn, x.permute(0, 3, 1, 2), split).permute(
            0, 2, 3, 1)

    def encode_first_stage(self, x: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """NHWC mel image → scaled latent: the posterior's sample when a
        ``generator`` (or its ε as ``noise``) is given, as in training,
        else its mode."""
        post = self.vae.encode(x)
        z = (post.sample(generator, noise)
             if generator is not None or noise is not None else post.mode())
        return self.cfg.scale_factor * z

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent → mel image, NHWC."""
        return self.vae.decode(z / self.cfg.scale_factor)

    def decode_first_stage_tiled(self, z: torch.Tensor,
                                 split: SplitInputParams) -> torch.Tensor:
        """A big canvas's scaled NHWC latent → NHWC image, decoded in
        overlapping ``split.ks`` tiles (all at once) and blended by the
        border weighting, the image canvas ``split.vqf`` times the
        latent's (ddpm.py:749-786)."""
        z = (z / self.cfg.scale_factor).permute(0, 3, 1, 2)
        out = tiled_apply(lambda t: self.vae.decode(
            t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2), z, split,
            uf=split.vqf)
        return out.permute(0, 2, 3, 1)

    def p_losses(self, z_start: torch.Tensor, video_feat: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None):
        """The ε-prediction loss with CFG dropout → (loss, {loss_simple,
        loss_vlb, t_mean}), reduced in float32.

        Draws from ``generator``, in this order: t uniform in [0, T), the
        noise in z_start's dtype, and the keep mask (uniform ≥
        ``cond_drop_prob``; the context is zeroed where an example is
        dropped). ``draws`` gives them instead, as tensors under "t",
        "noise" and "keep" (B, 1, 1): the seam through which a test hands
        in the JAX package's draws. The UNet's dropout, when its rate is
        over 0, then draws its masks from ``generator`` (the JAX loss's
        ``deterministic=False`` with its own key); it needs one."""
        b = z_start.shape[0]
        dev = z_start.device
        if draws is None:
            t = draw_rows(self.schedule.draw_t, (b,), generator=generator,
                          device=dev)
            noise = draw_rows(torch.randn, z_start.shape, generator=generator,
                              dtype=z_start.dtype, device=dev)
            keep = draw_rows(torch.rand, (b, 1, 1), generator=generator,
                             device=dev) >= self.cfg.cond_drop_prob
        else:
            t, noise, keep = draws["t"], draws["noise"], draws["keep"]
        t = t.to(dev, torch.int64)
        z_noisy = self.schedule.q_sample(z_start, t, noise)
        context = self.get_learned_conditioning(video_feat)
        if self.cfg.cond_drop_prob > 0:
            context = torch.where(keep.to(dev).view(b, 1, 1), context,
                                  torch.zeros_like(context))
        if self.unet.cfg.dropout > 0 and generator is None:
            raise ValueError(f"UNet dropout {self.unet.cfg.dropout} draws "
                             "its masks from a generator: pass one")
        with dropout_draws(generator):
            eps_hat = self.apply_model(z_noisy, t.float(), context)
        per_example = (eps_hat.float() - noise.float()).square() \
            .reshape(b, -1).mean(dim=1)
        loss_simple = per_example.mean()
        loss_vlb = (self.schedule.gather("lvlb_weights", t)
                    * per_example).mean()
        # l_simple_weight 1, no learned log-variance, ELBO weight 0
        return loss_simple, {"loss_simple": loss_simple,
                             "loss_vlb": loss_vlb,
                             "t_mean": t.float().mean()}

    def forward(self, z_start, video_feat, **kw):
        """The training loss: :meth:`p_losses`."""
        return self.p_losses(z_start, video_feat, **kw)

    def sample(self, video_feat: torch.Tensor, *, latent_hw=(16, 64),
               sampler: str = "dpm", steps: int = 25, cfg_scale: float = 4.5,
               classifier: Optional[nn.Module] = None,
               classifier_scale: float = 0.0,
               x_T: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               **solver_kwargs):
        """Latents conditioned on CAVP features, with CFG (zeros as the null
        embedding) and, when a classifier is given, alignment guidance. The
        classifier (a ``ClassifierBackbone``) sees the raw 512-d features,
        not the encoded ones. ``x_T`` overrides the initial noise drawn from
        ``generator``, which also draws the stochastic samplers' noise.

        ``sampler`` (ddpm.py:1288-1356): "dpm" (``dpm_solver_sample``;
        ``solver_kwargs`` reach the whole library, and ``model_type`` is
        the network's parameterisation, converted to ε inside the guided
        function before the classifier term), "ddim" (``ddim_sample``: η,
        mask/x0/mask_noise inpainting, noise dropout, hooks …),
        "ancestral"/"ddpm" (``p_sample_loop``: the whole chain unless
        ``timesteps`` cuts it; ``steps`` does not apply), "progressive"
        (``progressive_denoising``: returns (x, x0 partials)) or "plms",
        which takes no option (TypeError)."""
        if sampler not in ("dpm", "ddim", "ancestral", "ddpm",
                           "progressive", "plms"):
            raise ValueError(f"unknown sampler '{sampler}'")
        if sampler == "plms" and solver_kwargs:
            # silently dropping e.g. order=3 would misreport what ran
            raise TypeError(f"plms accepts no solver options, got "
                            f"{sorted(solver_kwargs)}")
        model_type = (solver_kwargs.pop("model_type", "noise")
                      if sampler == "dpm" else "noise")
        context = self.get_learned_conditioning(video_feat)
        classifier_fn = None
        if classifier is not None:
            def classifier_fn(x, t_model, feat_ctx):
                return F.logsigmoid(
                    classifier(x, t_model, feat_ctx, return_logits=True))

        eps_fn = make_guided_eps_fn(
            self.apply_model, context, torch.zeros_like(context),
            GuidanceSpec(cfg_scale=cfg_scale,
                         classifier_scale=classifier_scale),
            classifier_fn, video_feat if classifier is not None else None,
            model_type=model_type)
        if x_T is None:
            x_T = draw_rows(
                torch.randn,
                (video_feat.shape[0], *latent_hw, self.cfg.unet.in_channels),
                generator=generator, device=video_feat.device)
        if sampler == "dpm":
            return dpm_solver_sample(eps_fn, self.schedule, x_T, steps=steps,
                                     **solver_kwargs)
        if sampler == "ddim":
            return ddim_sample(eps_fn, self.schedule, x_T, steps=steps,
                               generator=generator, **solver_kwargs)
        if sampler == "plms":
            return plms_sample(eps_fn, self.schedule, x_T, steps=steps)
        chain = (progressive_denoising if sampler == "progressive"
                 else p_sample_loop)
        return chain(eps_fn, self.schedule, x_T, generator=generator,
                     **solver_kwargs)
