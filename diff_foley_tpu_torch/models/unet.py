"""The conditional ε-UNet, the half-UNet alignment classifier and the
generic half-UNet encoder with a pooled head
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
import torch.nn.functional as F

from ..diffusion.schedule import timestep_embedding
from ..ops.attention import multi_head_attention
from .attention import SpatialTransformer
from .layers import (Dense, Downsample, GroupNorm32, ResBlock,
                     TimestepEmbedMLP, Upsample, conv1x1, conv3x3,
                     init_weights_, run_plan, zero_init_)


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
    # training knobs: dropout (the shipped rate is 0) acts only inside
    # ``layers.dropout_draws``, as in stage 2's loss; ``use_checkpoint``
    # recomputes each BasicTransformerBlock in the backward
    # (torch.utils.checkpoint, the scope of the JAX package's nn.remat),
    # keeping what ``remat_policy`` saves: "none", "dots" or
    # "dots_no_batch" (``attention.REMAT_SAVES``)
    dropout: float = 0.0
    use_checkpoint: bool = False
    remat_policy: str = "none"
    # > 0: class conditioning, a label embedding added to the time
    # embedding (the 'adm' mode); > 0: each ResBlock's learned positions
    # over the map's W axis (the openai_unetmodel_pos.py variant). The
    # UNet only: the classifier takes neither, as in the JAX package
    num_classes: int = 0
    pos_seq_len: int = 0
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
    models; ``skips`` adds the pushes the UNet's up path consumes. The
    UNet passes its class count, ResBlock positions and ``with_context``
    (False: each cross-attention reads the tokens, its key and value
    width the block's)."""

    def __init__(self, cfg: UNetConfig, skips: bool, num_classes: int = 0,
                 pos_seq_len: int = 0, with_context: bool = True):
        super().__init__()
        self.cfg = cfg
        self.pos_seq_len, self.with_context = pos_seq_len, with_context
        mc = cfg.model_channels
        self.emb_dim = 4 * mc
        self.time_embed = TimestepEmbedMLP(mc, self.emb_dim)
        self.label_emb = (nn.Embedding(num_classes, self.emb_dim)
                          if num_classes > 0 else None)
        self.in_conv = conv3x3(cfg.in_channels, mc)
        self.skip_channels = [mc]
        self.down_plan, self.mid_plan = [], []
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            out = mult * mc
            for i in range(cfg.num_res_blocks):
                self._add(self.down_plan, f"down_{level}_{i}_res",
                          self.res(ch, out), "res")
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
                ("mid_res1", self.res(ch, ch), "res"),
                ("mid_attn", self.attn(ch), "attn"),
                ("mid_res2", self.res(ch, ch), "res")):
            self._add(self.mid_plan, name, m, kind)
        self.channels, self.ds = ch, ds

    def res(self, in_ch: int, out_ch: int) -> ResBlock:
        return ResBlock(in_ch, out_ch, self.emb_dim, self.pos_seq_len,
                        self.cfg.dropout)

    def attn(self, ch: int) -> SpatialTransformer:
        cfg = self.cfg
        return SpatialTransformer(
            ch, cfg.context_dim if self.with_context else None,
            cfg.num_heads, ch // cfg.num_heads, cfg.transformer_depth,
            checkpoint=cfg.use_checkpoint, dropout=cfg.dropout,
            remat_policy=cfg.remat_policy)

    def _add(self, plan, name: str, module: nn.Module, kind: str):
        setattr(self, name, module)
        plan.append((name, kind))

    def run(self, plan, h, emb, context, hs):
        return run_plan(self, plan, h, emb, context, hs)

    def trunk(self, x, timesteps, context, hs, y=None):
        """NHWC input → (NCHW map after the middle block, emb, context);
        ``y`` the (B,) class ids of a class-conditional UNet."""
        dt = self.cfg.compute_dtype
        emb = self.time_embed(
            timestep_embedding(timesteps, self.cfg.model_channels))
        if self.label_emb is not None:
            if y is None:
                raise ValueError("a class-conditional UNet (num_classes > 0) "
                                 "needs y")
            emb = emb + self.label_emb(y)
        emb = emb.to(dt)
        if context is not None:
            context = context.to(dt)
        # contiguous NCHW maps throughout, as the GroupNorm kernels take them
        h = self.in_conv(x.permute(0, 3, 1, 2).to(dt).contiguous())
        hs.append(h)
        h = self.run(self.down_plan, h, emb, context, hs)
        return self.run(self.mid_plan, h, emb, context, hs), emb, context


class UNetModel(_Trunk):
    """ε-prediction UNet: (B, H, W, C) latents, (B,) times and (B, L,
    context_dim) tokens → (B, H, W, out) float32; with ``cfg.num_classes``
    also (B,) class ids ``y``. ``with_context=False`` builds the UNet the
    concat and adm modes call with no context: each cross-attention then
    reads the tokens themselves, its key and value width the block's, as
    flax infers it from a first call without one."""

    def __init__(self, cfg: UNetConfig = LDM_UNET, with_context: bool = True):
        super().__init__(cfg, skips=True, num_classes=cfg.num_classes,
                         pos_seq_len=cfg.pos_seq_len,
                         with_context=with_context)
        mc = cfg.model_channels
        ch, ds = self.channels, self.ds
        skip_ch = list(self.skip_channels)
        self.up_plan = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            out = mult * mc
            for i in range(cfg.num_res_blocks + 1):
                self.up_plan.append((None, "cat"))
                self._add(self.up_plan, f"up_{level}_{i}_res",
                          self.res(ch + skip_ch.pop(), out), "res")
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

    def forward(self, x, timesteps, context=None, y=None):
        hs = []
        h, emb, context = self.trunk(x, timesteps, context, hs, y)
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


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling over an NCHW map: tokens [mean |
    spatial] plus a learned position embedding, one multi-head attention
    whose only query is the mean token (against h·w + 1 keys), projected
    to ``out_dim``."""

    def __init__(self, channels: int, tokens: int, num_heads: int,
                 out_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.pos_emb = nn.Parameter(torch.zeros(tokens + 1, channels))
        self.qkv = Dense(channels, 3 * channels)
        self.proj = Dense(channels, out_dim)

    def forward(self, x):
        b, c = x.shape[:2]
        tokens = x.reshape(b, c, -1).transpose(1, 2)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        q, k, v = self.qkv(tokens + self.pos_emb[None]).chunk(3, dim=-1)
        dh = c // self.num_heads
        # slices of the packed qkv rows (row stride 3c), made dense
        # (B, H, L, D) for the per-head kernels
        split = lambda a: a.reshape(b, a.shape[1], self.num_heads,
                                    dh).transpose(1, 2).contiguous()
        out = multi_head_attention(split(q[:, :1]), split(k), split(v),
                                   scale=dh**-0.5)
        return self.proj(out.transpose(1, 2).reshape(b, c))


POOLS = ("adaptive", "attention", "spatial", "spatial_v2")


class EncoderUNetModel(nn.Module):
    """The generic half-UNet encoder with a pooled head (guided-diffusion's
    classifier): the trunk's down path with self-attention only (no
    context) and a middle of two ResBlocks (no attention; the ResBlocks
    take ``cfg.dropout``, the transformers none, as in the JAX model), then
    ``pool``:

    - "adaptive": GN·SiLU → spatial mean → 1×1 conv;
    - "attention": GN·SiLU → :class:`AttentionPool2d`, in float32;
    - "spatial": the spatial means of every hidden state concatenated →
      Dense(2048) → ReLU → Dense(out);
    - "spatial_v2": the same with GN32·SiLU between the Denses.

    (B, H, W, C) latents and (B,) times → (B, out_channels) float32.
    ``hw`` is the input's (H, W), which sizes the attention pool's
    position embedding (flax sizes it at the first call)."""

    def __init__(self, cfg: UNetConfig = CLASSIFIER_BACKBONE,
                 pool: str = "adaptive", hw: tuple = (16, 64)):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool {pool!r} is not one of {POOLS}")
        self.cfg, self.pool = cfg, pool
        mc = cfg.model_channels
        emb_dim = 4 * mc
        self.time_embed = TimestepEmbedMLP(mc, emb_dim)
        self.in_conv = conv3x3(cfg.in_channels, mc)
        # (child name, kind), in the forward's order; "mean" records the
        # spatial mean of the current map for the spatial pools
        spatial = pool.startswith("spatial")
        self.plan = [(None, "mean")] if spatial else []
        means, ch, ds = [mc], mc, 1

        def add(name, module, kind):
            setattr(self, name, module)
            self.plan.append((name, kind))

        for level, mult in enumerate(cfg.channel_mult):
            out = mult * mc
            for i in range(cfg.num_res_blocks):
                add(f"down_{level}_{i}_res",
                    ResBlock(ch, out, emb_dim, dropout=cfg.dropout), "res")
                ch = out
                if ds in cfg.attention_resolutions:
                    # no context: the cross-attention reads the tokens
                    add(f"down_{level}_{i}_attn", SpatialTransformer(
                        ch, ch, cfg.num_heads, ch // cfg.num_heads,
                        cfg.transformer_depth), "attn")
                if spatial:
                    self.plan.append((None, "mean"))
                    means.append(ch)
            if level != len(cfg.channel_mult) - 1:
                add(f"down_{level}_ds", Downsample(ch), "plain")
                if spatial:
                    self.plan.append((None, "mean"))
                    means.append(ch)
                ds *= 2
        add("mid_res1", ResBlock(ch, ch, emb_dim, dropout=cfg.dropout), "res")
        add("mid_res2", ResBlock(ch, ch, emb_dim, dropout=cfg.dropout), "res")
        if spatial:
            self.plan.append((None, "mean"))
            means.append(ch)
            self.head_fc1 = Dense(sum(means), 2048)
            if pool == "spatial_v2":
                self.head_norm = GroupNorm32(2048, act="silu")
            self.head_fc2 = Dense(2048, cfg.out_channels)
        else:
            self.out_norm = GroupNorm32(ch, act="silu")
            if pool == "attention":
                h, w = hw
                for _ in range(len(cfg.channel_mult) - 1):
                    h, w = -(-h // 2), -(-w // 2)   # stride-2 convs, pad 1
                tokens = h * w
                self.attn_pool = AttentionPool2d(ch, tokens, cfg.num_heads,
                                                 cfg.out_channels)
            else:
                self.out_conv = conv1x1(ch, cfg.out_channels)

    def forward(self, x, timesteps):
        dt = self.cfg.compute_dtype
        emb = self.time_embed(
            timestep_embedding(timesteps, self.cfg.model_channels)).to(dt)
        h = self.in_conv(x.permute(0, 3, 1, 2).to(dt).contiguous())
        results = []
        for name, kind in self.plan:
            if kind == "mean":
                results.append(h.mean(dim=(2, 3)))
            elif kind == "res":
                h = getattr(self, name)(h, emb)
            else:
                h = getattr(self, name)(h)
        if results:
            feats = self.head_fc1(torch.cat([r.float() for r in results],
                                            dim=-1))
            if self.pool == "spatial_v2":
                feats = self.head_norm(feats[:, :, None, None])[:, :, 0, 0]
            else:
                feats = F.relu(feats)
            return self.head_fc2(feats)
        h = self.out_norm(h)
        if self.pool == "attention":
            return self.attn_pool(h.float())
        h = self.out_conv(h.mean(dim=(2, 3), keepdim=True))
        return h[:, :, 0, 0].float()


@torch.no_grad()
def init_encoder_unet_weights_(model: EncoderUNetModel,
                               generator: torch.Generator) -> EncoderUNetModel:
    """flax's initialisation, drawn on the generator's device: lecun-normal
    kernels, zero biases, unit scales, the attention pool's positions
    N(0, 1/channels), and zeros in the layers the JAX model zero-inits
    (each ResBlock's ``out_conv``, each SpatialTransformer's ``proj_out``,
    the adaptive head's ``out_conv``)."""
    init_weights_(model, generator)
    zero_init_(model, ResBlock, SpatialTransformer)
    if model.pool == "attention":
        p = model.attn_pool.pos_emb
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=generator.device) * p.shape[1]**-0.5)
    if model.pool == "adaptive":
        model.out_conv.weight.zero_()
    return model
