"""End-to-end generation after feature extraction: CAVP features → latents
(DPM-Solver++ with CFG and alignment guidance) → VAE decode → mel →
Griffin-Lim → waveform (``diff_foley_tpu/pipeline.py``).

Operating point: 25 DPM-Solver++ steps, CFG 4.5, classifier guidance 50,
32 CAVP features per 8.192-s window (131072 samples at 16 kHz, a 128×512
mel, a 16×64×4 latent), 32 Griffin-Lim iterations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from .audio.transforms import DEFAULT_MELSPEC, MelSpec, mel_to_wav
from .diffusion.latent_diffusion import LatentDiffusion, LDMConfig

WINDOW_FEATS = 32
WINDOW_SAMPLES = 131072
LATENT_HW = (16, 64)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    steps: int = 25
    cfg_scale: float = 4.5
    classifier_scale: float = 50.0
    sample_num: int = 4
    gl_iters: int = 32
    # "float32" keeps Griffin-Lim's output; "int16" quantises as write_wav
    wav_dtype: str = "float32"


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device; with no GPU that raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _pack_wav(wavs: torch.Tensor, wav_dtype: str) -> torch.Tensor:
    """"int16" is write_wav's quantisation, clip(-1, 1)·32767 cast with C
    truncation (not rounding), so both give the same file bytes."""
    if wav_dtype == "float32":
        return wavs
    if wav_dtype == "int16":
        return (torch.clamp(wavs, -1.0, 1.0) * 32767.0).to(torch.int16)
    raise ValueError(f"unsupported wav_dtype {wav_dtype!r}: use 'float32' "
                     "or 'int16'")


def window_features(feats: np.ndarray, window: int = WINDOW_FEATS) -> np.ndarray:
    """(T, 512) feature stream → (num_windows, window, 512); the ragged tail
    is dropped."""
    n = feats.shape[0] // window
    assert n >= 1, f"need ≥{window} features, got {feats.shape[0]}"
    return feats[:n * window].reshape(n, window, feats.shape[-1])


class DiffFoleyPipeline:
    """The LDM, the optional alignment classifier and the mel inversion on
    one device. ``vae_dtype="bfloat16"`` decodes in bf16 (GroupNorm
    statistics stay float32)."""

    def __init__(self, ldm: Optional[LatentDiffusion] = None,
                 classifier: Optional[nn.Module] = None,
                 melspec: MelSpec = DEFAULT_MELSPEC,
                 vae_dtype: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.ldm = (ldm or LatentDiffusion(LDMConfig())).to(self.device)
        self.ldm.eval().requires_grad_(False)
        self.vae_compute = getattr(torch, vae_dtype) if vae_dtype else None
        if self.vae_compute is not None:
            self.ldm.vae.to(self.vae_compute)
        self.classifier = classifier
        if classifier is not None:
            classifier.to(self.device).eval().requires_grad_(False)
        self.melspec = melspec

    @torch.no_grad()
    def _sample_and_decode(self, feats_w: torch.Tensor, gen: GenerationConfig,
                           generator: Optional[torch.Generator] = None,
                           x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(w, f, 512) windows → (w·sample_num, 128, 512) specs in [0, 1].
        ``x_T`` (w·sample_num, 16, 64, 4) overrides the initial noise."""
        cond = feats_w.repeat_interleave(gen.sample_num, dim=0)
        use_clf = gen.classifier_scale > 0 and self.classifier is not None
        z = self.ldm.sample(
            cond, latent_hw=LATENT_HW, steps=gen.steps,
            cfg_scale=gen.cfg_scale,
            classifier=self.classifier if use_clf else None,
            classifier_scale=gen.classifier_scale if use_clf else 0.0,
            x_T=x_T, generator=generator)
        if self.vae_compute is not None:
            z = z.to(self.vae_compute)
        spec_img = self.ldm.decode_first_stage(z)
        return torch.clamp(spec_img[..., 0].float(), 0.0, 1.0)

    def generate(self, cavp_feats: np.ndarray, seed: int = 0,
                 gen: GenerationConfig = GenerationConfig(),
                 x_T: Optional[torch.Tensor] = None,
                 gl_phase: Optional[torch.Tensor] = None) -> dict:
        """(T, 512) CAVP features → {"wav": (S, w·131072), "spec": (S, 128,
        w·512)} numpy, S = sample_num, windows concatenated in time.

        Initial noise and Griffin-Lim's initial phase come from a generator
        seeded with ``seed``; ``x_T`` and ``gl_phase`` ((w·S, 513, 512)
        uniform [0, 1)) override them."""
        feats_w = torch.as_tensor(
            window_features(np.asarray(cavp_feats, np.float32)),
            device=self.device)
        generator = torch.Generator(self.device).manual_seed(seed)
        specs = self._sample_and_decode(feats_w, gen, generator, x_T)
        with torch.no_grad():
            wavs = mel_to_wav(specs, self.melspec, n_iter=gen.gl_iters,
                              length=WINDOW_SAMPLES, phase=gl_phase,
                              generator=generator)
            wavs = _pack_wav(wavs, gen.wav_dtype)
        w, s = feats_w.shape[0], gen.sample_num
        sp = specs.cpu().numpy().reshape(w, s, *specs.shape[1:])
        return {"wav": wavs.cpu().numpy().reshape(w, s, -1)
                .transpose(1, 0, 2).reshape(s, -1),
                "spec": sp.transpose(1, 2, 0, 3).reshape(s, sp.shape[2], -1)}
