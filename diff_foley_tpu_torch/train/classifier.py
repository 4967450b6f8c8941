"""Alignment-classifier trainer (``diff_foley_tpu/train/classifier.py``):
P(audio aligned with video | z_t, t) for double guidance and the
align-acc metric.

One step: the frozen VAE encodes the mel image and draws the posterior
sample (or the batch gives its moments, ``z_mu`` and ``z_sigma``), ×0.18215;
t ~ U[0, 1000) and ``q_sample``; the cond encoder (512 → context,
positions) and the half-UNet backbone give p; the loss is the binary
cross-entropy of p clipped to [1e-7, 1 − 1e-7] against the aligned /
misaligned labels; AdamW (weight decay 0.01) with optax's semantics
updates the backbone and the cond encoder, in float32.

The frozen encoder runs under ``torch.no_grad``: it takes no gradient, so
the per-head attention backward never runs in this step. The step draws
its randomness from one ``torch.Generator`` in this order: the
posterior's ε, t, the noise. ``draws`` hands them in instead (the parity
seam of the tests); no main path passes it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..diffusion.schedule import DiffusionSchedule
from ..models.attention import SpatialTransformer
from ..models.cond_encoder import VideoFeatEncoderPosembed
from ..models.layers import ResBlock, init_weights_, zero_init_
from ..models.unet import CLASSIFIER_BACKBONE, ClassifierBackbone, UNetConfig
from ..models.vae import AutoencoderKL
from ..parallel import collectives
from ..parallel.mesh import Mesh, draw_rows, global_rows
from ..pipeline import resolve_device
from .optim import AdamW, TrainState, global_norm

BCE_CLIP = 1e-7


@dataclasses.dataclass(frozen=True)
class ClassifierTrainConfig:
    lr: float = 5e-5                # Double_Guidance_Classifier.yaml:2
    scale_factor: float = 0.18215
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120


class AlignmentClassifier(nn.Module):
    """The cond encoder (raw 512-d CAVP features → the backbone's context,
    with positions) and the backbone, under the JAX tree's names
    (``backbone.*``, ``cond.*``). Its call takes the backbone's arguments
    with raw features as the context, so it stands where a backbone does:
    in guidance, it is the ``classifier_context="encoded"`` route."""

    def __init__(self, backbone_cfg: UNetConfig = CLASSIFIER_BACKBONE,
                 cond_seq_len: int = 40, feat_dim: int = 512):
        super().__init__()
        self.backbone = ClassifierBackbone(backbone_cfg)
        self.cond = VideoFeatEncoderPosembed(feat_dim,
                                             backbone_cfg.context_dim,
                                             cond_seq_len)

    def forward(self, x, timesteps, video_feat, return_logits: bool = False):
        return self.backbone(x, timesteps, self.cond(video_feat),
                             return_logits=return_logits)


def bce_and_accuracy(p: torch.Tensor, labels: torch.Tensor):
    """(mean BCE, accuracy) of probabilities p (B, 1) against {0, 1}
    labels (B,): the formula on p clipped to [1e-7, 1 − 1e-7] (not
    ``BCEWithLogits``, which differs at the clip); a hit is round(p) ==
    label."""
    labels = labels.float()[:, None]
    p = p.float().clamp(BCE_CLIP, 1.0 - BCE_CLIP)
    bce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p)).mean()
    acc = (torch.round(p) == labels).float().mean()
    return bce, acc


@torch.no_grad()
def init_classifier_weights_(model: AlignmentClassifier,
                             generator: torch.Generator):
    """flax's initialisation on the generator's device: lecun-normal
    kernels, zero biases, unit scales, N(0, 1) positions, and zeros in the
    layers the JAX backbone zero-inits (each ResBlock's ``out_conv``, each
    SpatialTransformer's ``proj_out``, the head's ``out_conv``)."""
    init_weights_(model, generator)
    model.cond.pos_emb.copy_(torch.randn(model.cond.pos_emb.shape,
                                         generator=generator,
                                         device=generator.device))
    model.backbone.out_conv.weight.zero_()
    zero_init_(model.backbone, ResBlock, SpatialTransformer)
    return model


class ClassifierTrainer:
    """The train step of the classifier against a frozen VAE, in float32.
    ``model`` (an :class:`AlignmentClassifier`) holds the trained weights;
    ``vae`` is frozen and kept in eval mode. On a ``mesh`` each rank takes
    its rows of the global batch, draws the global ε, t and noise and keeps
    its rows; the gradients and the metrics are the data group's means."""

    def __init__(self, backbone_cfg: UNetConfig = CLASSIFIER_BACKBONE,
                 vae: Optional[AutoencoderKL] = None,
                 cfg: ClassifierTrainConfig = ClassifierTrainConfig(),
                 cond_seq_len: int = 40, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.group = None if mesh is None else mesh.data_group
        self.model = AlignmentClassifier(backbone_cfg, cond_seq_len)
        self.vae = (vae or AutoencoderKL()).eval().requires_grad_(False)
        self.schedule = DiffusionSchedule.create(
            timesteps=cfg.timesteps, linear_start=cfg.linear_start,
            linear_end=cfg.linear_end)

    def init_train_state(self, seed: Optional[int] = 0,
                         device=None) -> TrainState:
        """The state on ``device`` (``None``: the first CUDA device, and
        without one it raises; pass "cpu" to train on the CPU), the VAE
        moved with it. ``seed`` draws flax's initialisation on the device;
        ``None`` keeps the weights the model has."""
        device = resolve_device(device)
        self.model.to(device).train()
        self.vae.to(device).eval()
        # the schedule's tables on the device now: a step then reads
        # nothing from the host (train/scan.py runs K steps without a wait)
        self.schedule.place(device)
        if seed is not None:
            init_classifier_weights_(
                self.model, torch.Generator(device).manual_seed(seed))
        params = dict(self.model.named_parameters())
        for p in params.values():
            if p.dtype != torch.float32:
                raise TypeError("the classifier trains in float32")
            p.requires_grad_(True)
        # weight decay 0.01 is torch AdamW's default, the reference's
        # optimizer (optax's default is 1e-4)
        opt = AdamW(list(params.values()), lambda count: self.cfg.lr,
                    weight_decay=0.01)
        return TrainState(0, params, opt, None)

    def _latents(self, batch: dict, generator, eps) -> torch.Tensor:
        """The scaled posterior sample of the frozen VAE, no gradient."""
        with torch.no_grad():
            if "z_mu" in batch:
                mu, sigma = batch["z_mu"], batch["z_sigma"]
                if eps is None:
                    eps = draw_rows(torch.randn, mu.shape,
                                    generator=generator, device=mu.device)
                z = mu + sigma * eps
            else:
                z = self.vae.encode(batch["spec"]).sample(generator, eps)
            return self.cfg.scale_factor * z

    def loss(self, batch: dict, generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        """(BCE, {"bce_loss", "acc"}) of one batch: "spec" (B, 128, T, 3)
        NHWC or "z_mu"/"z_sigma", "video_feat" (B, L, 512) and "labels"
        (B,). ``draws`` gives "eps", "t" and "noise"."""
        draws = draws or {}
        z = self._latents(batch, generator, draws.get("eps"))
        b = z.shape[0]
        t = draws.get("t")
        if t is None:
            t = draw_rows(self.schedule.draw_t, (b,), generator=generator,
                          device=z.device)
        noise = draws.get("noise")
        if noise is None:
            noise = draw_rows(torch.randn, z.shape, generator=generator,
                              device=z.device)
        t = t.to(z.device, torch.int64)
        z_noisy = self.schedule.q_sample(z, t, noise.to(z.device))
        p = self.model(z_noisy, t.float(), batch["video_feat"])
        bce, acc = bce_and_accuracy(p, batch["labels"])
        return bce, {"bce_loss": bce, "acc": acc}

    def gradients(self, state: TrainState, batch: dict,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None) -> dict:
        """The forward and backward of one step: the gradients land on the
        parameters' ``.grad`` (set anew), the metrics come back."""
        params = list(state.params.values())
        for p in params:
            p.grad = None
        with global_rows(self.mesh):
            loss, metrics = self.loss(batch, generator, draws)
        loss.backward(inputs=params)
        collectives.grad_mean_(params, self.group)
        return {k: collectives.all_reduce_mean(v.detach(), self.group)
                for k, v in metrics.items()}

    def train_step(self, state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None) -> dict:
        """One step in place on ``state`` → {"bce_loss", "acc",
        "grad_norm"} as 0-dim tensors; the gradients stay on ``.grad``."""
        metrics = self.gradients(state, batch, generator, draws)
        grads = [p.grad for p in state.params.values()]
        metrics["grad_norm"] = global_norm(grads)
        state.opt.step(grads)
        state.step += 1
        return metrics
