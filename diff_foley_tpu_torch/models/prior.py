"""The stage-3 diffusion prior: video features → audio (CAVP spec)
features (``diff_foley_tpu/models/prior.py``).

- ``DiffusionPriorNetwork``: learned null embeddings replace the video or
  the noisy spec tokens of examples whose CFG mask drops them, a learned
  embedding per timestep, and a pre-LN Transformer (rotary positions on q
  and k, exact GELU) over the concatenation [noisy spec | video | time]
  projected from 3·dim to dim per token; out an x0 prediction.
- ``DiffusionPrior``: the cosine schedule, the x0-prediction loss with
  optional L2-norm clamping to √dim (``p_losses``), and strided ancestral
  sampling with CFG on x0 (``sample``).

Attention runs through ``ops/attention.py::multi_head_attention`` at
(B, heads, T, dim/heads): the per-head kernels 3 and 4 on the card.
Children carry the flax scope names (``block{i}.attn.qkv``,
``null_video_embeds``, …), so ``utils.convert.from_jax_params`` of the JAX
network's variables loads into ``DiffusionPrior.net`` with ``strict=True``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..diffusion.schedule import DiffusionSchedule
from ..ops.attention import multi_head_attention
from .layers import Dense, LayerNorm, init_weights_


def _rotary(x: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over (B, H, T, D); an odd D's last
    column passes through."""
    t, d = x.shape[2], x.shape[3]
    half = d // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = torch.arange(t, dtype=torch.float32,
                          device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)   # (T, half)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    parts = [x1 * cos - x2 * sin, x1 * sin + x2 * cos]
    if d % 2:
        parts.append(x[..., -1:])
    return torch.cat(parts, dim=-1)


class PriorSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim, bias=False)
        self.out = Dense(dim, dim)

    def forward(self, x):
        b, t, c = x.shape
        dh = c // self.heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        split = lambda a: a.reshape(b, t, self.heads, dh).transpose(1, 2)
        # q and k come out of the rotation dense; v is a strided slice of
        # the packed qkv rows (row stride 3c), made dense (B, H, T, D) for
        # the per-head kernels
        q, k, v = _rotary(split(q)), _rotary(split(k)), split(v).contiguous()
        out = multi_head_attention(q, k, v, scale=dh**-0.5)
        return self.out(out.transpose(1, 2).reshape(b, t, c))


class PriorBlock(nn.Module):
    """Pre-LN: x + attn(LN(x)), then x + fc2(GELU(fc1(LN(x))))."""

    def __init__(self, dim: int, heads: int = 8, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = PriorSelfAttention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Dense(dim, dim * mlp_ratio)
        self.fc2 = Dense(dim * mlp_ratio, dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)),
                                   approximate="none"))


class Embed(nn.Module):
    """flax nn.Embed: a (num, dim) table indexed by integers."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, dim))

    def forward(self, idx):
        return F.embedding(idx, self.weight)


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    dim: int = 512
    seq_len: int = 16          # T (feature tokens per clip)
    depth: int = 6
    heads: int = 8
    num_timesteps: int = 250


class DiffusionPriorNetwork(nn.Module):
    def __init__(self, cfg: PriorConfig = PriorConfig()):
        super().__init__()
        self.cfg = cfg
        self.null_video_embeds = nn.Parameter(
            torch.zeros(1, cfg.seq_len, cfg.dim))
        self.null_spec_embeds = nn.Parameter(
            torch.zeros(1, cfg.seq_len, cfg.dim))
        self.time_embed = Embed(cfg.num_timesteps, cfg.dim)
        self.proj_in = Dense(3 * cfg.dim, cfg.dim)
        for i in range(cfg.depth):
            setattr(self, f"block{i}", PriorBlock(cfg.dim, cfg.heads))
        self.norm_out = LayerNorm(cfg.dim)
        self.proj_out = Dense(cfg.dim, cfg.dim)

    def forward(self, spec_noisy, t, video_embed, video_keep, spec_keep):
        """(B, T, D) noisy spec features, (B,) times, (B, T, D) video
        features and (B,) bool CFG masks → (B, T, D) x0 prediction; a
        dropped example's video or spec tokens are the null embeddings."""
        cfg = self.cfg
        video = torch.where(video_keep[:, None, None], video_embed,
                            self.null_video_embeds)
        spec = torch.where(spec_keep[:, None, None], spec_noisy,
                           self.null_spec_embeds)
        time_tok = self.time_embed(t.to(torch.int64))[:, None].expand(
            -1, cfg.seq_len, -1)
        h = self.proj_in(torch.cat([spec, video, time_tok], dim=-1))
        for i in range(cfg.depth):
            h = getattr(self, f"block{i}")(h)
        return self.proj_out(self.norm_out(h))


class DiffusionPrior(nn.Module):
    """x0-prediction diffusion over feature sequences; ``net`` holds the
    network, ``init_params`` draws its initialisation."""

    def __init__(self, cfg: PriorConfig = PriorConfig(),
                 clamp_l2norm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.net = DiffusionPriorNetwork(cfg)
        self.schedule = DiffusionSchedule.create(
            timesteps=cfg.num_timesteps, beta_schedule="cosine")
        self.clamp_l2norm = clamp_l2norm
        self.embed_scale = float(np.sqrt(cfg.dim))

    @torch.no_grad()
    def init_params(self, seed: int = 0, device=None) -> "DiffusionPrior":
        """flax's initialisation from ``seed`` (lecun-normal kernels, zero
        biases, unit scales, the time table N(0, 1/dim), the null
        embeddings N(0, 1)), then the network on ``device``: None means
        the first CUDA device and raises without one; pass "cpu" for the
        CPU."""
        from ..pipeline import resolve_device

        g = torch.Generator().manual_seed(seed)
        init_weights_(self.net, g)
        for p in (self.net.null_video_embeds, self.net.null_spec_embeds):
            p.copy_(torch.randn(p.shape, generator=g))
        return self.to(resolve_device(device))

    def _maybe_clamp(self, x):
        if not self.clamp_l2norm:
            return x
        return x / torch.linalg.vector_norm(
            x, dim=-1, keepdim=True).clamp(min=1e-12) * self.embed_scale

    def p_losses(self, video_embed, spec_embed, *,
                 generator: Optional[torch.Generator] = None,
                 video_drop_prob: float = 0.1, spec_drop_prob: float = 0.1,
                 draws: Optional[Dict[str, torch.Tensor]] = None):
        """The x0-prediction L2 loss. Draws from ``generator``, in this
        order: t uniform in [0, T), the noise in spec_embed's dtype, and
        the video and spec keep masks (uniform ≥ the drop probability).
        ``draws`` gives them instead, as "t", "noise", "video_keep" and
        "spec_keep": the seam through which a test hands in the JAX
        package's draws."""
        b, dev = spec_embed.shape[0], spec_embed.device
        if draws is None:
            t = torch.randint(0, self.cfg.num_timesteps, (b,),
                              generator=generator, device=dev)
            noise = torch.randn(spec_embed.shape, generator=generator,
                                dtype=spec_embed.dtype, device=dev)
            video_keep = torch.rand((b,), generator=generator,
                                    device=dev) >= video_drop_prob
            spec_keep = torch.rand((b,), generator=generator,
                                   device=dev) >= spec_drop_prob
        else:
            t, noise, video_keep, spec_keep = (
                draws[k].to(dev) for k in ("t", "noise", "video_keep",
                                           "spec_keep"))
        t = t.to(torch.int64)
        noisy = self.schedule.q_sample(spec_embed, t, noise)
        pred = self._maybe_clamp(self.net(noisy, t.float(), video_embed,
                                          video_keep, spec_keep))
        return torch.mean((pred - spec_embed) ** 2)

    def coefficients(self, steps: int) -> dict:
        """The strided chain's timesteps and its posterior q(x_s | x_t, x0)
        coefficients for jumps t → s, in float64 numpy cast to float32
        (ᾱ = 1 past the last step, whose jump to x0 has σ 0)."""
        n = self.cfg.num_timesteps
        ts = np.arange(0, n, max(n // steps, 1))[::-1].copy()
        ts_prev = np.concatenate([ts[1:], [-1]])
        ac = np.asarray(self.schedule.alphas_cumprod, np.float64)
        a_t = ac[ts]
        a_s = np.where(ts_prev >= 0, ac[np.maximum(ts_prev, 0)], 1.0)
        alpha_eff = a_t / a_s
        beta_eff = 1.0 - alpha_eff
        sigma = np.sqrt(np.maximum(beta_eff * (1.0 - a_s) / (1.0 - a_t), 0.0))
        sigma[-1] = 0.0
        return {"t": ts.astype(np.float32),
                "c0": (np.sqrt(a_s) * beta_eff / (1.0 - a_t)).astype(
                    np.float32),
                "ct": (np.sqrt(alpha_eff) * (1.0 - a_s) / (1.0 - a_t)).astype(
                    np.float32),
                "sig": sigma.astype(np.float32)}

    @torch.no_grad()
    def sample(self, video_embed, *, generator: Optional[torch.Generator] = None,
               steps: int = 50, cond_scale: float = 1.0,
               draws: Optional[Dict[str, torch.Tensor]] = None):
        """Ancestral sampling over strided timesteps with CFG on x0
        (null + (cond − null)·cond_scale, one network call at scale 1).
        Draws from ``generator`` x_T in video_embed's dtype, then each
        step's noise; ``draws`` gives them instead, as "x_T" and "noise"
        (one tensor a step, stacked). The carry keeps its dtype."""
        cfg = self.cfg
        b, dev = video_embed.shape[0], video_embed.device
        tbl = self.coefficients(steps)
        shape = (b, cfg.seq_len, cfg.dim)
        x = (torch.randn(shape, generator=generator, dtype=video_embed.dtype,
                         device=dev) if draws is None
             else draws["x_T"].to(dev))
        ones = torch.ones((b,), dtype=torch.bool, device=dev)
        zeros = torch.zeros_like(ones)
        for i in range(len(tbl["t"])):
            t_vec = torch.full((b,), float(tbl["t"][i]), device=dev)
            x0 = self.net(x, t_vec, video_embed, ones, ones)
            if cond_scale != 1.0:
                null = self.net(x, t_vec, video_embed, zeros, zeros)
                x0 = null + (x0 - null) * cond_scale
            x0 = self._maybe_clamp(x0)
            noise = (torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                 device=dev) if draws is None
                     else draws["noise"][i].to(dev))
            # fp32 table scalars must not promote a lower-precision carry
            x = (float(tbl["c0"][i]) * x0 + float(tbl["ct"][i]) * x
                 + float(tbl["sig"][i]) * noise).to(x.dtype)
        return x
