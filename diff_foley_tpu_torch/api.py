"""The user API, video in and foley audio out (``diff_foley_tpu/api.py``):
load the three reference checkpoints (or the port's own three training
logdirs, ``from_native_checkpoints``), extract CAVP features from a
video, generate.

    from diff_foley_tpu_torch.api import DiffFoley
    df = DiffFoley.from_checkpoints(cavp="cavp_epoch66.ckpt",
                                    ldm="ldm_epoch240.ckpt",
                                    classifier="double_guidance_classifier.ckpt")
    out = df.generate_for_video("video.mp4", seed=21)
    # out["wav"]: (sample_num, n_samples) float32 at 16 kHz

Everything runs on the first CUDA device unless a device is named. Seeds
seed the port's ``torch.Generator``: the same seed gives other noise than
the JAX package's ``PRNGKey``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .diffusion.latent_diffusion import LatentDiffusion, LDMConfig
from .models.cavp import CAVPModel
from .models.unet import ClassifierBackbone
from .pipeline import (DiffFoleyPipeline, GenerationConfig, continuation_mask,
                       resolve_device)
from .video.ingest import extract_cavp_features


class DiffFoley:
    """The LDM, the CAVP towers and the optional alignment classifier on one
    device. With ``bf16`` the UNet and the VAE run in bf16 (the modules are
    cast in place); the cond encoder, the CAVP towers and the classifier
    stay float32, as in the JAX package."""

    def __init__(self, ldm: LatentDiffusion, cavp: CAVPModel,
                 classifier: Optional[ClassifierBackbone] = None,
                 bf16: bool = True, frame_size: int = 224, device=None):
        self.device = resolve_device(device)
        self.frame_size = frame_size
        if bf16:
            ldm.cfg = dataclasses.replace(ldm.cfg, unet=dataclasses.replace(
                ldm.cfg.unet, dtype="bfloat16"))
            ldm.unet.cfg = ldm.cfg.unet
            ldm.unet.to(torch.bfloat16)
        self.cavp = cavp.to(self.device).eval().requires_grad_(False)
        self.pipe = DiffFoleyPipeline(
            ldm, classifier, vae_dtype="bfloat16" if bf16 else None,
            device=self.device)

    @classmethod
    def from_checkpoints(cls, cavp: str, ldm: str,
                         classifier: Optional[str] = None, bf16: bool = True,
                         device=None) -> "DiffFoley":
        """The shipped models from the reference checkpoints. The guidance
        classifier sees the raw CAVP features, so of the classifier
        checkpoint only the backbone is kept."""
        from .utils.checkpoint import (load_reference_cavp,
                                       load_reference_classifier,
                                       load_reference_ldm)

        device = resolve_device(device)
        ldm_model = load_reference_ldm(ldm, LatentDiffusion(LDMConfig()))
        clf = load_reference_classifier(classifier)["backbone"] \
            if classifier else None
        return cls(ldm_model, load_reference_cavp(cavp), clf, bf16=bf16,
                   device=device)

    @classmethod
    def from_native_checkpoints(cls, cavp: str, ldm: str,
                                classifier: Optional[str] = None,
                                vae_ckpt: Optional[str] = None,
                                bf16: bool = True,
                                frame_size: Optional[int] = None,
                                classifier_context: str = "raw",
                                device=None) -> "DiffFoley":
        """The API over this package's own training logdirs
        (``cli.train_cavp``, ``cli.train_stage2``, ``cli.train_classifier``).
        The LDM takes its EMA weights when the run trained them and the
        first stage from the stage-2 logdir, unless ``vae_ckpt`` (a
        ``cli.train_vae`` logdir or a reference checkpoint) overrides it.
        ``frame_size`` defaults to the frame size the CAVP towers trained
        at.

        ``classifier_context`` is what the guidance classifier sees as its
        cross-attention context: "raw" feeds the raw 512-d CAVP features
        to the backbone (the reference's shipped behaviour, which differs
        from how the classifier trained); "encoded" passes them through the
        classifier's own trained cond encoder first, as in its training."""
        from .utils.checkpoint import (is_port_logdir, load_native_cavp,
                                       load_native_classifier,
                                       load_native_ldm, load_native_vae,
                                       load_vae_checkpoint,
                                       native_cavp_ingest_size)

        if classifier_context not in ("raw", "encoded"):
            raise ValueError("classifier_context must be 'raw' or "
                             f"'encoded', got {classifier_context!r}")
        device = resolve_device(device)
        ldm_model = load_native_ldm(ldm)
        if is_port_logdir(vae_ckpt):
            ldm_model.vae.load_state_dict(load_native_vae(
                vae_ckpt, expect_cfg=ldm_model.cfg.vae).state_dict())
        elif vae_ckpt:
            load_vae_checkpoint(vae_ckpt, ldm_model.vae)
        clf = None
        if classifier:
            trainer, _, _ = load_native_classifier(classifier)
            clf = (trainer.model if classifier_context == "encoded"
                   else trainer.model.backbone)
        if frame_size is None:
            frame_size = native_cavp_ingest_size(cavp)
        return cls(ldm_model, load_native_cavp(cavp), clf, bf16=bf16,
                   frame_size=frame_size, device=device)

    def extract_features(self, video_path: str, start_second: float = 0.0,
                         truncate_second: Optional[float] = None
                         ) -> np.ndarray:
        """Video file → (T, 512) per-frame CAVP features at 4 FPS."""
        return extract_cavp_features(
            video_path, self.cavp, start_second=start_second,
            truncate_second=truncate_second, size=self.frame_size,
            device=self.device)

    def generate_for_video(self, video_path: str, seed: int = 21,
                           gen: GenerationConfig = GenerationConfig(),
                           start_second: float = 0.0,
                           truncate_second: Optional[float] = 8.2) -> dict:
        """Video file → {"wav": (S, w·131072), "spec": (S, 128, w·512)}."""
        feats = self.extract_features(video_path, start_second,
                                      truncate_second)
        return self.pipe.generate(feats, seed, gen)

    def generate_from_features(self, feats: np.ndarray, seed: int = 21,
                               gen: GenerationConfig = GenerationConfig(),
                               **noise) -> dict:
        """(T, 512) features → what ``generate_for_video`` returns;
        ``noise`` (``x_T``, ``gl_phase``) overrides the seeded draws."""
        return self.pipe.generate(feats, seed, gen, **noise)

    def continue_audio(self, feats: np.ndarray, known_spec: np.ndarray,
                       known_seconds: float, seed: int = 21,
                       gen: GenerationConfig = GenerationConfig(
                           sampler="ddim"), **noise) -> dict:
        """Keep the first ``known_seconds`` of ``known_spec`` (a mel image
        in [0, 1], a ``generate`` sample say) and regenerate the rest
        against the video features, by the masked DDIM path
        (``DiffFoleyPipeline.inpaint``); ``noise`` (``x_T``,
        ``mask_noise``, ``gl_phase``) overrides the seeded draws."""
        known_spec = np.asarray(known_spec, np.float32)
        frames = int(round(known_seconds * self.pipe.melspec.sr
                           / self.pipe.melspec.hop_length))
        mask = continuation_mask(known_spec.shape[1], frames)
        return self.pipe.inpaint(feats, known_spec, mask, seed, gen, **noise)
