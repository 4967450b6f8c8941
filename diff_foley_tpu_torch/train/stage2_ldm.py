"""Stage-2 LDM trainer (``diff_foley_tpu/train/stage2_ldm.py``): AdamW on
the UNet and the cond encoder against the frozen first stage.

One step: the frozen VAE encodes the mel image and draws the posterior
sample (×0.18215), or the batch gives the posterior's moments (``z_mu``,
``z_sigma``); ``LatentDiffusion.p_losses`` draws t, the noise and the CFG
keep mask; the gradient of the ε-loss lands on the float32 masters;
AdamW with optax's semantics updates them; the EMA follows.

Mixed precision (``compute_dtype="bfloat16"``) is the JAX package's, not
``torch.autocast``: the masters are cast to bf16 inside the step and
swapped into the modules for its forward and backward
(``utils.precision.swapped_parameters``), so the gradients land on the
float32 leaves; the frozen VAE and the spec run in bf16, ``GroupNorm32``
computes in float32 and the loss is reduced in float32.

The step draws its randomness from one ``torch.Generator``, in this
order: the posterior's ε, t, the noise, the keep mask. ``draws`` hands
them in instead (the parity seam of the tests); no main path passes it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ..diffusion.latent_diffusion import LatentDiffusion
from ..models.attention import SpatialTransformer
from ..models.layers import ResBlock
from ..pipeline import resolve_device
from ..utils.ema import EmaState, ema_init, ema_update
from ..utils.lr_schedules import lambda_linear
from ..utils.precision import cast_floating, swapped_parameters
from .optim import AdamW, TrainState, global_norm
from .vae import init_weights_

DTYPES = {None: torch.float32, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Stage2TrainConfig:
    base_lr: float = 1e-4           # launch.sh --scale_lr False
    warmup_steps: int = 1000
    use_ema: bool = False
    ema_decay: float = 0.9999
    grad_clip: Optional[float] = None
    weight_decay: float = 0.01      # torch AdamW's default
    accum_steps: int = 1            # gradients averaged over K calls
    mu_dtype: Optional[str] = None  # "bfloat16": a bf16 first moment
    compute_dtype: Optional[str] = None  # "bfloat16": mixed precision


def make_optimizer(cfg: Stage2TrainConfig,
                   params: Sequence[torch.Tensor]) -> AdamW:
    return AdamW(params, lambda_linear(cfg.base_lr, cfg.warmup_steps),
                 weight_decay=cfg.weight_decay,
                 mu_dtype=DTYPES[cfg.mu_dtype], grad_clip=cfg.grad_clip,
                 accum_steps=cfg.accum_steps)


@torch.no_grad()
def init_ldm_weights_(ldm: LatentDiffusion, generator: torch.Generator):
    """flax's initialisation of the UNet and the cond encoder, drawn on the
    generator's device: lecun-normal kernels, zero biases, unit scales,
    N(0, 1) positions, and zeros in the layers the JAX models zero-init
    (each ResBlock's ``out_conv``, each SpatialTransformer's ``proj_out``,
    the UNet's ``out_conv``)."""
    for module in (ldm.unet, ldm.cond):
        init_weights_(module, generator)
    ldm.cond.pos_emb.copy_(torch.randn(ldm.cond.pos_emb.shape,
                                       generator=generator,
                                       device=generator.device))
    ldm.unet.out_conv.weight.zero_()
    for m in ldm.unet.modules():
        if isinstance(m, ResBlock):
            m.out_conv.weight.zero_()
        elif isinstance(m, SpatialTransformer):
            m.proj_out.weight.zero_()
    return ldm


class Stage2Trainer:
    """The train and eval steps of ``ldm`` under ``cfg``. The first stage
    (``ldm.vae``) is frozen here, and under mixed precision cast to bf16
    once (the JAX step casts it inside every step: the same values); the
    UNet's compute type follows ``cfg.compute_dtype``."""

    def __init__(self, ldm: LatentDiffusion,
                 cfg: Stage2TrainConfig = Stage2TrainConfig()):
        if cfg.compute_dtype not in DTYPES or cfg.mu_dtype not in DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r} / "
                             f"mu_dtype {cfg.mu_dtype!r}: float32 or "
                             "bfloat16")
        self.ldm, self.cfg = ldm, cfg
        self.dtype = DTYPES[cfg.compute_dtype]
        self.mixed = self.dtype == torch.bfloat16
        if self.mixed and ldm.unet.cfg.dtype != "bfloat16":
            ldm.unet.cfg = dataclasses.replace(ldm.unet.cfg,
                                               dtype="bfloat16")
        ldm.vae.requires_grad_(False).to(self.dtype)

    def init_train_state(self, seed: Optional[int] = 0,
                         device=None) -> TrainState:
        """The state on ``device`` (``None``: the first CUDA device, and
        without one it raises; pass "cpu" to train on the CPU). ``seed``
        draws flax's initialisation on the device; ``None`` keeps the
        weights the model has."""
        device = resolve_device(device)
        self.ldm.to(device)
        if seed is not None:
            init_ldm_weights_(self.ldm,
                              torch.Generator(device).manual_seed(seed))
        params = {k: p for k, p in self.ldm.named_parameters()
                  if k.startswith(("unet.", "cond."))}
        for p in params.values():
            if p.dtype != torch.float32:
                raise TypeError("the masters must be float32")
            p.requires_grad_(True)
        return TrainState(0, params, make_optimizer(self.cfg,
                                                    list(params.values())),
                          ema_init(params) if self.cfg.use_ema else None)

    def _compute_params(self, params: Dict[str, torch.Tensor]):
        """``params`` in the compute type (bf16 casts under mixed
        precision, themselves in float32) swapped into the model."""
        return swapped_parameters(self.ldm, cast_floating(params, self.dtype))

    def _latents(self, batch: dict, generator, draws) -> torch.Tensor:
        """The posterior sample of the frozen first stage, scaled."""
        ldm = self.ldm
        eps = None if draws is None else draws.get("eps")
        with torch.no_grad():
            if "z_mu" in batch:
                mu, sigma = batch["z_mu"], batch["z_sigma"]
                if eps is None:
                    eps = torch.randn(mu.shape, generator=generator,
                                      device=mu.device)
                z = ldm.cfg.scale_factor * (mu + sigma * eps)
                return z.to(self.dtype) if self.mixed else z
            spec = batch["spec"]
            if spec.dim() == 3:   # single-channel mel: tiled ×3 here
                spec = spec[..., None].expand(*spec.shape, 3)
            spec = spec.to(self.dtype).contiguous()
            return ldm.encode_first_stage(spec, generator, eps)

    def _loss(self, batch, generator, draws):
        z = self._latents(batch, generator, draws)
        return self.ldm.p_losses(z, batch["video_feat"], generator=generator,
                                 draws=draws)

    def gradients(self, state: TrainState, batch: dict,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None) -> dict:
        """The forward and backward of one step: the gradients land on the
        masters' ``.grad`` (set anew), the loss's metrics come back."""
        masters = list(state.params.values())
        for p in masters:
            p.grad = None
        with self._compute_params(state.params):
            loss, metrics = self._loss(batch, generator, draws)
            loss.backward(inputs=masters)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return metrics

    def apply_gradients(self, state: TrainState) -> None:
        """AdamW on the masters' gradients, then the EMA, once per
        optimizer update: under accumulation the parameters move on every
        K-th call only."""
        if state.opt.step([p.grad for p in state.params.values()]) \
                and state.ema is not None:
            ema_update(state.ema, state.params, self.cfg.ema_decay)

    def train_step(self, state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None) -> dict:
        """One step on ``batch`` (tensors on the state's device: "spec"
        (B, 128, T, 3) or (B, 128, T), or "z_mu" and "z_sigma"; and
        "video_feat" (B, T', 512)), in place on ``state`` → the metrics as
        0-dim tensors: loss_simple, loss_vlb, t_mean, loss, and grad_norm
        (the global norm before clipping). The gradients stay on the
        masters' ``.grad``."""
        metrics = self.gradients(state, batch, generator, draws)
        metrics["grad_norm"] = global_norm(
            [p.grad for p in state.params.values()])
        self.apply_gradients(state)
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None) -> dict:
        """The loss's metrics on ``batch`` with the EMA parameters when the
        state has them (the reference's val/loss_simple_ema), else the
        parameters."""
        params = state.ema.params if state.ema is not None else state.params
        with self._compute_params(params):
            _, metrics = self._loss(batch, generator, draws)
        return metrics
