"""Stage-1 CAVP trainer (``diff_foley_tpu/train/stage1_cavp.py``):
contrastive pretraining of the video and audio towers.

- AdamW lr 8e-4, β (0.9, 0.999), ε 1e-8, weight decay 0.2 on weights only:
  tensors under 2 dimensions and BatchNorm, bias and ``logit_scale``
  leaves are left out (``decay_mask``); the rate is the cosine schedule
  with linear warmup; an optional clip of the global gradient norm.
- A step reshapes (B, clip_num, …) → (B·clip_num, …), runs the towers in
  train mode (BatchNorm on batch statistics, updating the running ones as
  flax does; CNN14's dropout from the step's generator), takes the
  intra-contrast loss in float32, updates, and clamps ``logit_scale`` to
  [0, ln 100].
- ``compute_dtype="bfloat16"``: the towers run bf16 against the float32
  masters (each product casts its parameters, so the gradients land on
  the masters; BatchNorm's statistics, scale and bias stay float32); the
  loss and ``logit_scale`` run float32.
- :meth:`Stage1Trainer.accum_train_step`: the feature-cache accumulation
  (the reference's ``--accum-freq``), whose gradient is the full K·B
  contrastive batch's.

On a ``mesh`` each rank takes its rows of each (micro-)batch and the step
is the one-process step on the global batch: the BatchNorms take their
statistics over the data group (the group ``CAVPConfig.axis_name``
names, "data" by default), CNN14's dropout masks are the global draw's
rows, the contrastive loss reads every rank's features through
``all_gather_with_grad`` (every rank computes the global loss), and the
gradients are averaged over the group before AdamW.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch

from ..models.cavp import CAVPModel
from ..models.cavp.cavp import check_dtype
from ..models.cavp.layers import frozen_statistics
from ..models.layers import init_weights_
from ..parallel import collectives
from ..parallel.mesh import Mesh, global_rows
from ..pipeline import resolve_device
from ..utils.lr_schedules import cosine_with_warmup
from .losses import intra_contrast_loss
from .optim import AdamW, TrainState, global_norm

LOG_100 = math.log(100.0)


@dataclasses.dataclass(frozen=True)
class Stage1TrainConfig:
    lr: float = 8e-4
    warmup_steps: int = 200
    total_steps: int = 710_000   # 300 epochs of the reference's data
    weight_decay: float = 0.2
    clip_num: int = 3
    intra_weight: float = 1.0
    grad_clip: Optional[float] = None
    accum_freq: int = 1          # > 1: the feature-cache accumulation
    compute_dtype: Optional[str] = None   # "bfloat16": mixed precision


def decay_mask(names: Sequence[str], params: Sequence[torch.Tensor]):
    """True where weight decay applies: not under 2 dimensions, and no
    ``bn``, ``bias`` or ``logit_scale`` in the lower-cased name
    (main_wds_intra_contrast.py:280-283; the port's names are the flax
    scopes')."""
    return [p.dim() >= 2 and not any(w in n.lower() for w in
                                     ("bn", "bias", "logit_scale"))
            for n, p in zip(names, params)]


def make_optimizer(cfg: Stage1TrainConfig,
                   params: Dict[str, torch.Tensor]) -> AdamW:
    return AdamW(list(params.values()),
                 cosine_with_warmup(cfg.lr, cfg.warmup_steps,
                                    cfg.total_steps),
                 weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip,
                 decay_mask=decay_mask(list(params), list(params.values())))


@dataclasses.dataclass
class CAVPTrainState(TrainState):
    """The train state and the towers' BatchNorm running statistics (the
    model's own buffers, by name)."""

    batch_stats: Optional[Dict[str, torch.Tensor]] = None

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["batch_stats"] = {k: v.detach()
                             for k, v in self.batch_stats.items()}
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        if set(sd["batch_stats"]) != set(self.batch_stats):
            raise ValueError("checkpoint BatchNorm statistics differ from "
                             "the model's")
        super().load_state_dict(sd)
        for k, b in self.batch_stats.items():
            b.copy_(sd["batch_stats"][k])


def batch_stats(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The running means and variances of ``model``'s BatchNorms."""
    return {k: b for k, b in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


# the ViT towers' free parameters and the σ of their flax initialisers:
# width^-0.5 (Spec-ViT) or 1 (ViViT)
_FREE = {"positional_embedding": "width", "class_embedding": "width",
         "proj": "width", "pos_embedding": 1.0, "spatial_cls_token": 1.0,
         "temporal_cls_token": 1.0}


@torch.no_grad()
def init_cavp_weights_(model: CAVPModel, generator: torch.Generator):
    """flax's initialisation on the generator's device: lecun-normal
    kernels, zero biases, unit BatchNorm and LayerNorm scales, zero means
    and unit variances, the ViT towers' free parameters N(0, σ²) (σ as
    their flax initialisers), ``logit_scale`` ln(1/0.07)."""
    init_weights_(model, generator)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _FREE:
            width = p.shape[-1] if leaf != "proj" else p.shape[0]
            std = width ** -0.5 if _FREE[leaf] == "width" else _FREE[leaf]
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * std)
        elif name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:   # BatchNorm and LayerNorm scales
            p.fill_(1.0)
    for name, b in batch_stats(model).items():
        b.fill_(0.0 if name.endswith("mean") else 1.0)
    model.logit_scale.fill_(math.log(1.0 / 0.07))
    return model


class Stage1Trainer:
    """The train steps of ``model`` under ``cfg``. Under mixed precision
    the model's compute type becomes bf16 (``CAVPConfig.dtype``).
    ``mesh``: the module docstring."""

    def __init__(self, model: CAVPModel,
                 cfg: Stage1TrainConfig = Stage1TrainConfig(),
                 mesh: Optional[Mesh] = None):
        if cfg.compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: "
                             "float32 or bfloat16")
        self.model, self.cfg = model, cfg
        self.mesh = mesh
        self.group = (None if mesh is None
                      else mesh.group(model.cfg.axis_name or "data"))
        collectives.sync_batchnorm_(model, self.group)
        if cfg.compute_dtype == "bfloat16" and model.cfg.dtype != "bfloat16":
            mixed = dataclasses.replace(model.cfg, dtype="bfloat16")
            check_dtype(mixed)   # the shipped towers only, as in JAX
            model.cfg = mixed

    def init_train_state(self, seed: Optional[int] = 0,
                         device=None) -> CAVPTrainState:
        """The state on ``device`` (``None``: the first CUDA device, and
        without one it raises; pass "cpu" to train on the CPU). ``seed``
        draws flax's initialisation on the device; ``None`` keeps the
        weights the model has."""
        device = resolve_device(device)
        self.model.to(device).train()
        if seed is not None:
            init_cavp_weights_(self.model,
                               torch.Generator(device).manual_seed(seed))
        params = dict(self.model.named_parameters())
        for p in params.values():
            if p.dtype != torch.float32:
                raise TypeError("the masters must be float32")
            p.requires_grad_(True)
        return CAVPTrainState(0, params, make_optimizer(self.cfg, params),
                              None, batch_stats(self.model))

    def _flat(self, batch: dict):
        """(B, clip_num, …) video and spec → (B·clip_num, …); uint8 video
        is divided by 255 here, in the compute type."""
        video = batch["video"].flatten(0, 1)
        spec = batch["spec"].flatten(0, 1)
        if video.dtype == torch.uint8:
            video = video.to(self.model.compute_dtype) / 255.0
        return video, spec

    def _features(self, batch: dict, generator) -> dict:
        with global_rows(self.mesh):
            out = self.model(*self._flat(batch), generator=generator)
        out["video_features"] = out["video_features"].float()
        out["spec_features"] = out["spec_features"].float()
        return out

    def _loss(self, v, s, logit_scale) -> dict:
        return intra_contrast_loss(v, s, logit_scale,
                                   clip_num=self.cfg.clip_num,
                                   intra_weight=self.cfg.intra_weight)

    def _update(self, state: CAVPTrainState, losses: dict) -> dict:
        """AdamW on the gradients in ``.grad``, the clamp, the metrics."""
        collectives.grad_mean_(list(state.params.values()), self.group)
        grads = [p.grad for p in state.params.values()]
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = global_norm(grads)
        state.opt.step(grads)
        with torch.no_grad():
            scale = self.model.logit_scale
            scale.clamp_(0.0, LOG_100)
            metrics["logit_scale"] = scale.detach().exp()
        state.step += 1
        return metrics

    def train_step(self, state: CAVPTrainState, batch: dict,
                   generator: Optional[torch.Generator] = None) -> dict:
        """One step in place on ``state``: batch {"video": (B, clip_num,
        T, H, W, 3) float or uint8, "spec": (B, clip_num, M, T')} on the
        state's device → the metrics as 0-dim tensors (total_loss,
        extra_contrast_loss, intra_contrast_loss, grad_norm before the
        clip, logit_scale after the clamp, exponentiated)."""
        self.model.train()
        params = list(state.params.values())
        for p in params:
            p.grad = None
        out = self._features(batch, generator)
        gather = lambda x: collectives.all_gather_with_grad(x, self.group)
        losses = self._loss(gather(out["video_features"]),
                            gather(out["spec_features"]), out["logit_scale"])
        losses["total_loss"].backward(inputs=params)
        return self._update(state, losses)

    def accum_train_step(self, state: CAVPTrainState, batches: dict,
                         generator: Optional[torch.Generator] = None,
                         train: bool = True) -> dict:
        """One step over K micro-batches ({"video": (K, B, clip_num, …),
        "spec": (K, B, clip_num, …)}) with the K·B-video contrastive batch
        of a full step, on the memory of B videos:

        - pass 1 encodes every micro-batch without gradients and caches
          the features; the BatchNorm statistics advance here, once;
        - pass 2 encodes micro-batch j again with gradients (BatchNorm on
          the batch's statistics, not updating them; the same dropout
          masks: the generator is rewound to pass 1's state for j), puts
          its features in place of its cached ones, takes the full
          batch's loss and accumulates the gradients. Their sum is the
          full-batch gradient of the towers; ``logit_scale``, live in
          every pass, has its sum divided by K.

        ``train=False`` runs both passes in eval mode (the running
        statistics normalise and stay as they are)."""
        self.model.train(train)
        k = batches["video"].shape[0]
        micro = [{name: batches[name][j] for name in ("video", "spec")}
                 for j in range(k)]
        rewind = []
        with torch.no_grad():
            cache_v, cache_s = [], []
            for mb in micro:
                rewind.append(None if generator is None
                              else generator.get_state())
                out = self._features(mb, generator)
                # every rank's rows of micro-batch j, in rank order
                cache_v.append(collectives.all_gather(out["video_features"],
                                                      self.group))
                cache_s.append(collectives.all_gather(out["spec_features"],
                                                      self.group))
        params = list(state.params.values())
        for p in params:
            p.grad = None
        with frozen_statistics(self.model):
            for j, mb in enumerate(micro):
                if generator is not None:
                    generator.set_state(rewind[j])
                out = self._features(mb, generator)
                live_v, live_s = (
                    collectives.all_gather_with_grad(out[k], self.group)
                    for k in ("video_features", "spec_features"))
                v = torch.cat(cache_v[:j] + [live_v] + cache_v[j + 1:])
                s = torch.cat(cache_s[:j] + [live_s] + cache_s[j + 1:])
                losses = self._loss(v, s, out["logit_scale"])
                losses["total_loss"].backward(inputs=params)
        self.model.logit_scale.grad.div_(k)
        return self._update(state, losses)
