"""The CAVP dual-tower model at inference (``diff_foley_tpu/models/cavp/cavp.py``):
SlowOnly-R50 video and CNN14 audio, 512-d embeddings.

- ``encode_video``: SlowOnly → per-frame 2048 → Linear(2048 → 512) →
  (optional) max over windows of 16 frames → (optional) L2 normalisation;
- ``encode_spec``: (B, 128 mel, T) → CNN14 → per-step 512 → the same pool
  and normalisation;
- ``logit_scale``, initialised to ln(1/0.07).

``pool=False`` gives the per-frame (4 FPS) features that condition the
latent diffusion. Public shapes are the JAX package's: video (B, T, H, W,
3), spec (B, n_mels, T); the towers run NCDHW / NCHW. Only the shipped
(slowonly, cnn14) pair is ported.

Training (``train/stage1_cavp.py``) runs the module in train mode:
BatchNorm on batch statistics, updating its running ones as flax does,
and CNN14's dropout, its masks drawn from the ``generator`` the forward
is given. ``CAVPConfig.dtype="bfloat16"`` runs the towers in bf16 against
float32 parameters (BatchNorm statistics float32); ``logit_scale`` stays
float32. ``axis_name="data"`` names the mesh axis over whose group a
meshed trainer takes the BatchNorm statistics (``train/stage1_cavp.py``);
None means "data" there too, since the JAX package's meshed step
normalises the global batch either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

from .cnn14 import Cnn14
from .layers import Linear
from .slowonly import ResNet3dSlowOnly


@dataclasses.dataclass(frozen=True)
class CAVPConfig:
    """The shipped towers are (slowonly, cnn14); the ``video_*`` and
    ``spec_channels`` overrides (None: the shipped R50 / CNN14 geometry)
    cut the towers for tests."""

    embed_dim: int = 512
    pool_kernel: int = 16
    video_arch: str = "slowonly"
    spec_arch: str = "cnn14"
    axis_name: Optional[str] = None   # cross-replica BatchNorm's axis
    dtype: Optional[str] = None       # "bfloat16": the towers' compute type
    video_stage_blocks: Optional[tuple] = None
    video_base_channels: Optional[int] = None
    spec_channels: Optional[tuple] = None


def _max_pool_time(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping max over the time axis of (B, T, C), the tail that
    fills no window dropped (torch MaxPool1d(kernel=k))."""
    b, t, c = x.shape
    n = t // k
    return x[:, :n * k].reshape(b, n, k, c).amax(dim=2)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def _pool_norm(feat, k: int, pool: bool, normalize: bool):
    if pool:
        feat = _max_pool_time(feat, k)
        feat = feat.squeeze(1) if feat.shape[1] == 1 else feat
    return _l2norm(feat) if normalize else feat


class CAVPModel(nn.Module):
    def __init__(self, cfg: CAVPConfig = CAVPConfig()):
        super().__init__()
        if (cfg.video_arch, cfg.spec_arch) != ("slowonly", "cnn14"):
            raise ValueError(
                f"towers ({cfg.video_arch!r}, {cfg.spec_arch!r}) are not "
                "ported: only (slowonly, cnn14); the other factory towers "
                "are on ROADMAP §1's long tail")
        if cfg.axis_name not in (None, "data"):
            raise ValueError(f"axis_name={cfg.axis_name!r}: the BatchNorm "
                             "statistics are taken over the 'data' axis")
        if cfg.dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"dtype {cfg.dtype!r}: float32 or bfloat16")
        self.cfg = cfg
        kw = {}
        if cfg.video_stage_blocks is not None:
            kw["stage_blocks"] = tuple(cfg.video_stage_blocks)
        if cfg.video_base_channels is not None:
            kw["base_channels"] = cfg.video_base_channels
        self.video_encoder = ResNet3dSlowOnly(**kw)
        self.video_project_head = Linear(self.video_encoder.out_channels,
                                         cfg.embed_dim)
        self.spec_encoder = Cnn14(embed_dim=cfg.embed_dim,
                                  channels=cfg.spec_channels)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.dtype == "bfloat16" \
            else torch.float32

    def encode_video(self, video: torch.Tensor, normalize: bool = False,
                     pool: bool = True) -> torch.Tensor:
        """(B, T, H, W, 3) → (B, 512) pooled or (B, T, 512) per frame."""
        x = video.permute(0, 4, 1, 2, 3).to(self.compute_dtype).contiguous()
        feat = self.video_project_head(self.video_encoder(x))
        return _pool_norm(feat, self.cfg.pool_kernel, pool, normalize)

    def encode_spec(self, spec: torch.Tensor, normalize: bool = False,
                    pool: bool = True,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """(B, n_mels, T) → (B, 512) pooled or (B, T/16, 512) per step; in
        train mode CNN14's dropout draws from ``generator``."""
        x = spec.transpose(1, 2)[:, None].to(self.compute_dtype)
        feat = self.spec_encoder(x, generator)
        return _pool_norm(feat, self.cfg.pool_kernel, pool, normalize)

    def forward(self, video: torch.Tensor, spec: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        """Contrastive forward: normalised pooled features and the scale."""
        return {
            "video_features": self.encode_video(video, True, True),
            "spec_features": self.encode_spec(spec, True, True, generator),
            "logit_scale": self.logit_scale.exp(),
        }

    def forward_temporal(self, video: torch.Tensor, spec: torch.Tensor,
                         generator: Optional[torch.Generator] = None
                         ) -> dict:
        """Per-frame and pooled features of one tower pass per modality
        (the temporal losses' inputs): the pooled ones are the unnormalised
        per-frame features max-pooled, then both are normalised."""
        k = self.cfg.pool_kernel
        vt = self.encode_video(video, normalize=False, pool=False)
        st = self.encode_spec(spec, normalize=False, pool=False,
                              generator=generator)
        return {
            "video_temporal_features": _l2norm(vt),
            "spec_temporal_features": _l2norm(st),
            "video_mean_features": _pool_norm(vt, k, True, True),
            "spec_mean_features": _pool_norm(st, k, True, True),
            "logit_scale": self.logit_scale.exp(),
        }
