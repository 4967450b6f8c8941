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

On a ``mesh`` (``parallel/mesh.py``) N ranks compute what one process
computes on the global batch, as the JAX package's meshed step does:

- data parallelism: each rank takes its rows, draws the global batch's
  ε, t, noise and keep mask from the shared generator and keeps its rows
  (``global_rows``); the gradients are averaged over the data group
  before AdamW, the metrics too; ``grad_norm`` is the global norm after
  the mean;
- ``fsdp``: the masters, AdamW's moments and the EMA are split over the
  data group (``sharding_rules.FsdpLayout``); a step gathers the whole
  compute copy into the model, runs the forward and backward,
  reduce-scatters the gradient, and AdamW and the EMA run on the parts;
  the clip's norm sums the parts' squares over the group;
- tensor parallelism when the mesh's model axis is over 1
  (``sharding_rules.tensor_parallel_``): the UNet's attention runs
  heads / n_model heads a rank, its feed-forward and time embedding
  split as the JAX rules split them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ..diffusion.latent_diffusion import LatentDiffusion
from ..models.attention import SpatialTransformer
from ..models.layers import ResBlock, init_weights_, zero_init_
from ..parallel import collectives, sharding_rules
from ..parallel.mesh import Mesh, draw_rows, global_rows
from ..parallel.sharding_rules import (FsdpLayout, gather_tp, param_specs,
                                       shard_tp, tensor_parallel_)
from ..pipeline import resolve_device
from ..utils.ema import EmaState, ema_init, ema_update
from ..utils.lr_schedules import lambda_linear
from ..utils.precision import cast_floating, swapped_parameters
from .optim import AdamW, TrainState, global_norm

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
                   params: Sequence[torch.Tensor],
                   norm=global_norm) -> AdamW:
    return AdamW(params, lambda_linear(cfg.base_lr, cfg.warmup_steps),
                 weight_decay=cfg.weight_decay,
                 mu_dtype=DTYPES[cfg.mu_dtype], grad_clip=cfg.grad_clip,
                 accum_steps=cfg.accum_steps, norm=norm)


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
    zero_init_(ldm.unet, ResBlock, SpatialTransformer)
    return ldm


def _map_state(sd: dict, names: Sequence[str], fn) -> dict:
    """``TrainState.state_dict()`` with ``fn(name, tensor)`` applied to
    the masters, AdamW's per-tensor lists (in the masters' order) and the
    EMA."""
    opt = dict(sd["opt"])
    for key in ("mu", "nu", "acc"):
        if opt[key] is not None:
            opt[key] = [fn(k, t) for k, t in zip(names, opt[key])]
    ema = sd["ema"]
    if ema is not None:
        ema = {"params": {k: fn(k, t) for k, t in ema["params"].items()},
               "num_updates": ema["num_updates"]}
    return {"step": sd["step"], "opt": opt, "ema": ema,
            "params": {k: fn(k, t) for k, t in sd["params"].items()}}


class Stage2Trainer:
    """The train and eval steps of ``ldm`` under ``cfg``. The first stage
    (``ldm.vae``) is frozen here, and under mixed precision cast to bf16
    once (the JAX step casts it inside every step: the same values); the
    UNet's compute type follows ``cfg.compute_dtype``. ``mesh`` and
    ``fsdp``: the module docstring."""

    def __init__(self, ldm: LatentDiffusion,
                 cfg: Stage2TrainConfig = Stage2TrainConfig(),
                 mesh: Optional[Mesh] = None, fsdp: bool = False):
        if cfg.compute_dtype not in DTYPES or cfg.mu_dtype not in DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r} / "
                             f"mu_dtype {cfg.mu_dtype!r}: float32 or "
                             "bfloat16")
        self.ldm, self.cfg = ldm, cfg
        if fsdp and mesh is None:   # a process alone: one rank, no group
            mesh = Mesh({"data": 1, "model": 1}, 0, 0, 0)
        self.mesh, self.fsdp = mesh, fsdp
        self.group = None if mesh is None else mesh.data_group
        self.specs = self.layout = None
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
        self.ldm.schedule.place(device)
        if seed is not None:
            init_ldm_weights_(self.ldm,
                              torch.Generator(device).manual_seed(seed))
        trained = lambda: {k: p for k, p in self.ldm.named_parameters()
                           if k.startswith(("unet.", "cond."))}
        mesh = self.mesh
        if mesh is not None:
            tp = mesh.shape["model"] > 1
            self.specs = param_specs(
                {k: p.shape for k, p in trained().items()},
                mesh.shape["data"], tp=tp, fsdp=self.fsdp,
                min_size=sharding_rules.FSDP_MIN_SIZE)
            if tp:
                tensor_parallel_(self.ldm.unet, mesh, "unet.", self.specs)
        self.full = trained()
        for p in self.full.values():
            if p.dtype != torch.float32:
                raise TypeError("the masters must be float32")
            p.requires_grad_(True)
        params = self.full
        if self.fsdp:
            self.layout = FsdpLayout(self.specs, mesh)
            params = {k: p if self.layout.dim(k) is None else
                      torch.nn.Parameter(self.layout.shard(k, p.detach()))
                      for k, p in self.full.items()}
        return TrainState(0, params,
                          make_optimizer(self.cfg, list(params.values()),
                                         self.norm),
                          ema_init(params) if self.cfg.use_ema else None)

    def _split_over(self, name: str) -> tuple:
        """The groups a master is split over (empty: whole)."""
        spec, mesh = self.specs[name], self.mesh
        return tuple(g for d, g in ((spec.fsdp_dim, mesh.data_group),
                                    (spec.tp_dim, mesh.model_group))
                     if d is not None and g is not None)

    def norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of the masters' gradients (in the masters'
        order), their parts on every rank counted once."""
        if self.specs is None:
            return global_norm(grads)
        return collectives.sharded_global_norm(
            grads, [self._split_over(k) for k in self.full])

    def _whole(self, params: Dict[str, torch.Tensor]):
        """The compute copy of FSDP parts (the parts themselves without
        FSDP)."""
        if self.layout is None:
            return params
        return {k: self.layout.gather(k, v) for k, v in params.items()}

    @torch.no_grad()
    def _gather_masters(self, state: TrainState) -> None:
        if self.layout is not None:
            for k, p in self.full.items():
                if self.layout.dim(k) is not None:
                    p.copy_(self.layout.gather(k, state.params[k]))

    @torch.no_grad()
    def _reduce_gradients(self, state: TrainState) -> None:
        """The gradients of the compute copy → the masters' ``.grad``, each
        the mean over the data group (reduce-scattered into FSDP parts)."""
        if self.group is None:
            return
        whole = list(self.full.values())
        if self.layout is not None:
            for k, p in self.full.items():
                if self.layout.dim(k) is not None:
                    state.params[k].grad = self.layout.reduce_scatter_mean(
                        k, p.grad)
                    p.grad = None
            whole = [p for k, p in self.full.items()
                     if self.layout.dim(k) is None]
        collectives.grad_mean_(whole, self.group)

    def _mean(self, metrics: dict) -> dict:
        return {k: collectives.all_reduce_mean(v, self.group)
                for k, v in metrics.items()}

    def state_dict(self, state: TrainState) -> dict:
        """``state.state_dict()`` with every part joined: the logdir's
        format at any world size and split. A collective under a mesh:
        every rank calls it, and each joined tensor goes to the host as
        it is made (the whole state would not fit beside the parts)."""
        sd = state.state_dict()
        if self.specs is None:
            return sd
        names = list(state.params)
        whole = lambda k, t: gather_tp(self.specs, k, self._whole({k: t})[k],
                                       self.mesh).cpu()
        return _map_state(sd, names, whole)

    @torch.no_grad()
    def load_state_dict(self, state: TrainState, sd: dict) -> None:
        """A ``state_dict`` (of any world size, on any device) into this
        rank's parts: each tensor is cut where it lies, and only the part
        moves to this rank's device."""
        if self.specs is not None:
            names = list(state.params)

            def part(k, t):
                t = shard_tp(self.specs, k, t, self.mesh)
                if self.layout is not None:
                    t = self.layout.shard(k, t)
                return t.to(self.full[k].device)
            sd = _map_state(sd, names, part)
        state.load_state_dict(sd)

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
                    eps = draw_rows(torch.randn, mu.shape,
                                    generator=generator, device=mu.device)
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
        masters' ``.grad`` (set anew), the loss's metrics come back. On a
        mesh the gradients and the metrics are the data group's means."""
        self._gather_masters(state)
        whole = list(self.full.values())
        for p in whole + list(state.params.values()):
            p.grad = None
        with self._compute_params(self.full), global_rows(self.mesh):
            loss, metrics = self._loss(batch, generator, draws)
            loss.backward(inputs=whole)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        self._reduce_gradients(state)
        return self._mean(metrics)

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
        metrics["grad_norm"] = self.norm(
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
        with self._compute_params(self._whole(params)), \
                global_rows(self.mesh):
            _, metrics = self._loss(batch, generator, draws)
        return self._mean(metrics)
