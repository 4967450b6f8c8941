"""The conditional ε-UNet and the half-UNet alignment classifier
(``diff_foley_tpu/models/unet.py``).

Shipped operating points:
- LDM UNet: in/out 4 ch, 320 base, mult (1, 2, 4, 4), 2 res blocks,
  attention at ds {1, 2, 4}, 8 heads, context 768, depth 1.
- Classifier: 128 base, mult (1, 2, 2), 1 res block, attention at ds
  {2, 4}, context 512 (the raw window features), one logit.

Inputs and outputs are NHWC, as in the JAX package; the layers run NCHW.
Children carry the flax scope names (``down_{level}_{i}_res``, …); each
model runs a flat plan of (child, kind) steps, where "push" saves the
current map for a skip and "cat" joins the last saved one.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn

from ..diffusion.schedule import timestep_embedding
from .attention import SpatialTransformer
from .layers import (Dense, Downsample, GroupNorm32, ResBlock,
                     TimestepEmbedMLP, Upsample, conv3x3)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    # training knobs: the shipped rate is 0, and ``use_checkpoint``
    # recomputes each BasicTransformerBlock in the backward
    # (torch.utils.checkpoint, the scope of the JAX package's nn.remat);
    # ``remat_policy`` names XLA save policies, which have no counterpart
    dropout: float = 0.0
    use_checkpoint: bool = False
    remat_policy: str = "none"
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


LDM_UNET = UNetConfig()
CLASSIFIER_BACKBONE = UNetConfig(
    out_channels=1, model_channels=128, num_res_blocks=1,
    attention_resolutions=(2, 4), channel_mult=(1, 2, 2), context_dim=512,
)


class _Trunk(nn.Module):
    """Time embedding, input conv, down path and middle, shared by both
    models; ``skips`` adds the pushes the UNet's up path consumes."""

    def __init__(self, cfg: UNetConfig, skips: bool):
        super().__init__()
        if cfg.dropout > 0:
            raise NotImplementedError(
                f"UNet dropout {cfg.dropout}: the port runs the shipped rate "
                "0 only (ROADMAP §1, the long tail)")
        if cfg.remat_policy != "none":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is an XLA save policy; "
                "the port recomputes whole blocks (use_checkpoint) only "
                "(ROADMAP §1, the long tail)")
        self.cfg = cfg
        mc = cfg.model_channels
        self.emb_dim = 4 * mc
        self.time_embed = TimestepEmbedMLP(mc, self.emb_dim)
        self.in_conv = conv3x3(cfg.in_channels, mc)
        self.skip_channels = [mc]
        self.down_plan, self.mid_plan = [], []
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            out = mult * mc
            for i in range(cfg.num_res_blocks):
                self._add(self.down_plan, f"down_{level}_{i}_res",
                          ResBlock(ch, out, self.emb_dim), "res")
                ch = out
                if ds in cfg.attention_resolutions:
                    self._add(self.down_plan, f"down_{level}_{i}_attn",
                              self.attn(ch), "attn")
                if skips:
                    self.down_plan.append((None, "push"))
                    self.skip_channels.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self._add(self.down_plan, f"down_{level}_ds", Downsample(ch),
                          "plain")
                if skips:
                    self.down_plan.append((None, "push"))
                    self.skip_channels.append(ch)
                ds *= 2
        for name, m, kind in (
                ("mid_res1", ResBlock(ch, ch, self.emb_dim), "res"),
                ("mid_attn", self.attn(ch), "attn"),
                ("mid_res2", ResBlock(ch, ch, self.emb_dim), "res")):
            self._add(self.mid_plan, name, m, kind)
        self.channels, self.ds = ch, ds

    def attn(self, ch: int) -> SpatialTransformer:
        cfg = self.cfg
        return SpatialTransformer(ch, cfg.context_dim, cfg.num_heads,
                                  ch // cfg.num_heads, cfg.transformer_depth,
                                  checkpoint=cfg.use_checkpoint)

    def _add(self, plan, name: str, module: nn.Module, kind: str):
        setattr(self, name, module)
        plan.append((name, kind))

    def run(self, plan, h, emb, context, hs):
        for name, kind in plan:
            if kind == "push":
                hs.append(h)
            elif kind == "cat":
                h = torch.cat([h, hs.pop()], dim=1)
            elif kind == "res":
                h = getattr(self, name)(h, emb)
            elif kind == "attn":
                h = getattr(self, name)(h, context)
            else:
                h = getattr(self, name)(h)
        return h

    def trunk(self, x, timesteps, context, hs):
        """NHWC input → (NCHW map after the middle block, emb, context)."""
        dt = self.cfg.compute_dtype
        emb = self.time_embed(
            timestep_embedding(timesteps, self.cfg.model_channels)).to(dt)
        if context is not None:
            context = context.to(dt)
        # contiguous NCHW maps throughout, as the GroupNorm kernels take them
        h = self.in_conv(x.permute(0, 3, 1, 2).to(dt).contiguous())
        hs.append(h)
        h = self.run(self.down_plan, h, emb, context, hs)
        return self.run(self.mid_plan, h, emb, context, hs), emb, context


class UNetModel(_Trunk):
    """ε-prediction UNet: (B, H, W, C) latents, (B,) times and (B, L,
    context_dim) tokens → (B, H, W, out) float32."""

    def __init__(self, cfg: UNetConfig = LDM_UNET):
        super().__init__(cfg, skips=True)
        mc = cfg.model_channels
        ch, ds = self.channels, self.ds
        skip_ch = list(self.skip_channels)
        self.up_plan = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            out = mult * mc
            for i in range(cfg.num_res_blocks + 1):
                self.up_plan.append((None, "cat"))
                self._add(self.up_plan, f"up_{level}_{i}_res",
                          ResBlock(ch + skip_ch.pop(), out, self.emb_dim),
                          "res")
                ch = out
                if ds in cfg.attention_resolutions:
                    self._add(self.up_plan, f"up_{level}_{i}_attn",
                              self.attn(ch), "attn")
                if i == cfg.num_res_blocks and level != 0:
                    self._add(self.up_plan, f"up_{level}_us", Upsample(ch),
                              "plain")
                    ds //= 2
        self.out_norm = GroupNorm32(ch, act="silu")
        self.out_conv = conv3x3(ch, cfg.out_channels)

    def forward(self, x, timesteps, context=None):
        hs = []
        h, emb, context = self.trunk(x, timesteps, context, hs)
        h = self.run(self.up_plan, h, emb, context, hs)
        assert not hs
        h = self.out_conv(self.out_norm(h))
        return h.float().permute(0, 2, 3, 1)


class ClassifierBackbone(_Trunk):
    """Half-UNet alignment classifier: the down path and middle, then
    GN·SiLU → conv3x3(ch → ch/2) → spatial mean → Dense(1); the logit, or
    its sigmoid."""

    def __init__(self, cfg: UNetConfig = CLASSIFIER_BACKBONE):
        super().__init__(cfg, skips=False)
        ch = self.channels
        self.out_norm = GroupNorm32(ch, act="silu")
        self.out_conv = conv3x3(ch, ch // 2)
        self.classifier = Dense(ch // 2, cfg.out_channels)

    def forward(self, x, timesteps, context, return_logits: bool = False):
        h, _, _ = self.trunk(x, timesteps, context, [])
        h = self.out_conv(self.out_norm(h)).mean(dim=(2, 3))
        logits = self.classifier(h.float())
        return logits if return_logits else torch.sigmoid(logits)
