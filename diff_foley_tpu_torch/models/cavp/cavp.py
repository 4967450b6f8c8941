"""The CAVP dual-tower model (``diff_foley_tpu/models/cavp/cavp.py``), the
factory of the reference's ``--video_encode`` / ``--spec_encode`` towers;
the shipped pair is SlowOnly-R50 video and CNN14 audio, 512-d embeddings.

- video: ``slowonly`` (per-frame 2048 → ``video_project_head``), ``x3d``,
  ``i3d``, ``r2plus1d`` (each projects to 512 inside, over 16 frames) and
  ``vivit`` (ViViT-mean's per-frame tokens → ``video_project_head``);
- audio: ``cnn14`` (512 inside), ``cnn10`` (2048 → ``spec_project_head``),
  ``resnet50``, ``spec_vit`` and ``spec_vit_mean`` (each →
  ``spec_project_head``);
- ``encode_video`` / ``encode_spec``: per-step features, then (optional)
  the pool over time — the max over windows of ``pool_kernel`` steps for
  the CNN and 3-D towers, the mean for ``vivit`` and ``spec_vit_mean``,
  the CLS token for ``spec_vit`` — then (optional) L2 normalisation;
- ``logit_scale``, initialised to ln(1/0.07).

``pool=False`` gives the per-frame (4 FPS) features that condition the
latent diffusion. Public shapes are the JAX package's: video (B, T, H, W,
3), spec (B, n_mels, T); the CNN towers run NCDHW / NCHW.

Training (``train/stage1_cavp.py``) runs the module in train mode:
BatchNorm on batch statistics, updating its running ones as flax does,
and the CNN towers' dropout, its masks drawn from the ``generator`` the
forward is given. ``CAVPConfig.dtype="bfloat16"`` runs the towers in bf16
against float32 parameters (BatchNorm statistics float32); ``logit_scale``
stays float32. As in the JAX package, a ``dtype`` is taken by the shipped
towers only (SlowOnly × CNN14/CNN10); the others run float32.
``axis_name="data"`` names the mesh axis over whose group a meshed
trainer takes the BatchNorm statistics (``train/stage1_cavp.py``); None
means "data" there too, since the JAX package's meshed step normalises
the global batch either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

from .cnn14 import Cnn10, Cnn14
from .layers import Linear
from .slowonly import ResNet3dSlowOnly


VIDEO_ARCHS = ("slowonly", "x3d", "i3d", "r2plus1d", "vivit")
SPEC_ARCHS = ("cnn14", "cnn10", "resnet50", "spec_vit", "spec_vit_mean")


@dataclasses.dataclass(frozen=True)
class CAVPConfig:
    """The shipped towers are (slowonly, cnn14); the ``video_*`` and
    ``spec_channels`` overrides (None: the shipped R50 / CNN14 geometry)
    cut those towers for tests. ``video_tower`` / ``spec_tower`` (None:
    the published geometry) override fields of the other towers' configs
    (``X3DConfig``, ``I3DConfig``, ``R2Plus1dConfig``, ``ViViTConfig``;
    ``SpecResNetConfig``, ``SpecViTConfig``; CNN10's ``channels``), the
    same cut for them."""

    embed_dim: int = 512
    pool_kernel: int = 16
    video_arch: str = "slowonly"
    spec_arch: str = "cnn14"
    axis_name: Optional[str] = None   # cross-replica BatchNorm's axis
    dtype: Optional[str] = None       # "bfloat16": the towers' compute type
    video_stage_blocks: Optional[tuple] = None
    video_base_channels: Optional[int] = None
    spec_channels: Optional[tuple] = None
    video_tower: Optional[dict] = None
    spec_tower: Optional[dict] = None


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


def _video_tower(cfg: CAVPConfig):
    """(encoder, project head or None) of ``cfg.video_arch``."""
    over = dict(cfg.video_tower or {})
    if cfg.video_arch == "slowonly":
        kw = {}
        if cfg.video_stage_blocks is not None:
            kw["stage_blocks"] = tuple(cfg.video_stage_blocks)
        if cfg.video_base_channels is not None:
            kw["base_channels"] = cfg.video_base_channels
        enc = ResNet3dSlowOnly(**kw)
        return enc, Linear(enc.out_channels, cfg.embed_dim)
    if cfg.video_arch == "vivit":
        # the 'mean_vivit_*' towers: per-frame tokens → a projection head
        from ..vivit import ViViTConfig, ViViTMean

        vcfg = ViViTConfig(**over)
        return ViViTMean(vcfg), Linear(vcfg.dim, cfg.embed_dim)
    over["out_dim"] = cfg.embed_dim
    if cfg.video_arch == "x3d":
        from .x3d import X3D, X3DConfig

        return X3D(X3DConfig(**over)), None
    if cfg.video_arch == "i3d":
        from .x3d import I3DConfig, I3DResNet

        return I3DResNet(I3DConfig(**over)), None
    if cfg.video_arch == "r2plus1d":
        from .r2plus1d import R2Plus1dConfig, ResNet2Plus1d

        return ResNet2Plus1d(R2Plus1dConfig(**over)), None
    raise ValueError(f"unknown video_arch {cfg.video_arch!r}")


def _spec_tower(cfg: CAVPConfig):
    """(encoder, project head or None) of ``cfg.spec_arch``."""
    over = dict(cfg.spec_tower or {})
    if cfg.spec_arch == "cnn14":
        return Cnn14(embed_dim=cfg.embed_dim, channels=cfg.spec_channels), None
    if cfg.spec_arch == "cnn10":
        # the factory's Cnn10(embed_dim=2048) + Linear(2048 → embed)
        return Cnn10(embed_dim=2048, **over), Linear(2048, cfg.embed_dim)
    if cfg.spec_arch == "resnet50":
        from .spec_towers import SpecResNet50, SpecResNetConfig

        enc = SpecResNet50(SpecResNetConfig(**over))
        return enc, Linear(enc.out_channels, cfg.embed_dim)
    if cfg.spec_arch in ("spec_vit", "spec_vit_mean"):
        from .spec_towers import SpecViT, SpecViTConfig, SpecViTMean

        if cfg.spec_arch == "spec_vit":
            enc = SpecViT(SpecViTConfig(**over))
        else:
            enc = SpecViTMean(SpecViTConfig(**{**over, "cls_token": False}))
        return enc, Linear(enc.cfg.output_dim, cfg.embed_dim)
    raise ValueError(f"unknown spec_arch {cfg.spec_arch!r}")


def check_dtype(cfg: CAVPConfig) -> None:
    """A compute ``dtype`` is taken by the shipped towers only, as in the
    JAX package (its other towers stay float32)."""
    if cfg.dtype and not (cfg.video_arch == "slowonly"
                          and cfg.spec_arch in ("cnn14", "cnn10")):
        raise ValueError(
            f"dtype={cfg.dtype!r} is only supported for the shipped "
            f"towers (slowonly × cnn14/cnn10), got "
            f"({cfg.video_arch!r}, {cfg.spec_arch!r})")


class CAVPModel(nn.Module):
    def __init__(self, cfg: CAVPConfig = CAVPConfig()):
        super().__init__()
        check_dtype(cfg)
        if cfg.axis_name not in (None, "data"):
            raise ValueError(f"axis_name={cfg.axis_name!r}: the BatchNorm "
                             "statistics are taken over the 'data' axis")
        if cfg.dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"dtype {cfg.dtype!r}: float32 or bfloat16")
        self.cfg = cfg
        self.video_encoder, head = _video_tower(cfg)
        if head is not None:
            self.video_project_head = head
        self.spec_encoder, head = _spec_tower(cfg)
        if head is not None:
            self.spec_project_head = head
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.dtype == "bfloat16" \
            else torch.float32

    def encode_video(self, video: torch.Tensor, normalize: bool = False,
                     pool: bool = True) -> torch.Tensor:
        """(B, T, H, W, 3) → (B, 512) pooled or (B, T', 512) per frame (T'
        16 for the x3d, i3d and r2plus1d heads)."""
        x = video.to(self.compute_dtype)
        if self.cfg.video_arch == "vivit":
            feat = self.video_project_head(self.video_encoder(x))
            if pool:
                feat = feat.mean(dim=1)
            return _l2norm(feat) if normalize else feat
        feat = self.video_encoder(x.permute(0, 4, 1, 2, 3).contiguous())
        if self.cfg.video_arch == "slowonly":
            feat = self.video_project_head(feat)
        return _pool_norm(feat, self.cfg.pool_kernel, pool, normalize)

    def encode_spec(self, spec: torch.Tensor, normalize: bool = False,
                    pool: bool = True,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """(B, n_mels, T) → (B, 512) pooled or (B, T', 512) per step; in
        train mode the CNN towers' dropout draws from ``generator``."""
        x = spec.to(self.compute_dtype)
        arch = self.cfg.spec_arch
        if arch == "spec_vit":
            pooled, tokens = self.spec_encoder(x)
            feat = self.spec_project_head(pooled if pool else tokens)
            return _l2norm(feat) if normalize else feat
        if arch == "spec_vit_mean":
            feat = self.spec_project_head(self.spec_encoder(x))
            if pool:
                feat = feat.mean(dim=1)
            return _l2norm(feat) if normalize else feat
        if arch == "resnet50":
            feat = self.spec_project_head(self.spec_encoder(x[:, None]))
        else:
            feat = self.spec_encoder(x.transpose(1, 2)[:, None], generator)
            if arch == "cnn10":
                feat = self.spec_project_head(feat)
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
        per-frame features pooled (max over windows, the mean for vivit
        and spec_vit_mean, the CLS token's for spec_vit), then both are
        normalised."""
        k = self.cfg.pool_kernel
        vt = self.encode_video(video, normalize=False, pool=False)
        v = vt.mean(dim=1) if self.cfg.video_arch == "vivit" \
            else _pool_norm(vt, k, True, False)
        if self.cfg.spec_arch == "spec_vit":
            # both from the one encoder call
            pooled, tokens = self.spec_encoder(spec.to(self.compute_dtype))
            st = self.spec_project_head(tokens)
            s = self.spec_project_head(pooled)
        else:
            st = self.encode_spec(spec, normalize=False, pool=False,
                                  generator=generator)
            s = st.mean(dim=1) if self.cfg.spec_arch == "spec_vit_mean" \
                else _pool_norm(st, k, True, False)
        return {
            "video_temporal_features": _l2norm(vt),
            "spec_temporal_features": _l2norm(st),
            "video_mean_features": _l2norm(v),
            "spec_mean_features": _l2norm(s),
            "logit_scale": self.logit_scale.exp(),
        }
