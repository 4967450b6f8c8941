"""Training-time listening samples: the stage-2 trainer's ``SoundLogger``
(``diff_foley_tpu/train/callbacks.py``).

Every ``every_n_steps`` steps it takes the first ``n_samples`` items of
the batch and writes, under ``<log_dir>/step_XXXXXXXX/``, the ground
truth, the VAE's reconstruction (the posterior's mode) and a sample
(DPM-Solver++, ``sampler_steps`` steps, CFG ``cfg_scale``, no classifier)
of each: the clipped mel as ``{gt,rec,sample}_spec.npy`` and a
``gl_iters``-iteration Griffin-Lim 16-kHz wav per item. The batch comes
in as float32 whatever its dtype; the model computes in ``dtype`` with
``params`` (the trainer's raw float32 parameters, not the EMA) swapped
in. The frozen VAE computes with ``vae_params`` swapped in where given
(its float32 weights, as the JAX logger's ``vae_params``, while the
trainer holds a bf16 copy), else in the dtype it holds. The ground
truth and the reconstruction share one Griffin-Lim initial phase, the
sample has its own (as the JAX logger shares one key between them).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..audio.transforms import DEFAULT_MELSPEC, mel_to_wav
from ..parallel.mesh import draw_rows
from ..utils.precision import cast_floating, swapped_parameters
from ..utils.wav import write_wav


class SoundLogger:
    def __init__(self, log_dir: str, ldm, every_n_steps: int = 1000,
                 n_samples: int = 2, sampler_steps: int = 25,
                 cfg_scale: float = 6.5, gl_iters: int = 32,
                 sr: int = 16000, dtype: torch.dtype = torch.float32,
                 vae_params: Optional[Dict[str, torch.Tensor]] = None):
        self.dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.ldm = ldm
        self.every = every_n_steps
        self.n = n_samples
        self.steps = sampler_steps
        self.cfg_scale = cfg_scale
        self.gl_iters = gl_iters
        self.sr = sr
        self.dtype = dtype
        self.vae_params = vae_params

    def maybe_log(self, step: int, params: Dict[str, torch.Tensor],
                  batch: Dict, generator: Optional[torch.Generator] = None
                  ) -> Optional[str]:
        if step % self.every != 0:
            return None
        return self.log(step, params, batch, generator)

    @torch.no_grad()
    def log(self, step: int, params: Dict[str, torch.Tensor], batch: Dict,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Dict[str, torch.Tensor]] = None) -> str:
        """The three artifacts of ``step`` → their directory. ``draws``
        gives the sampler's ``x_T`` and the Griffin-Lim initial phases
        ``phase`` (gt and rec) and ``sample_phase`` instead of drawing them
        from ``generator`` (the tests' seam)."""
        ldm, draws = self.ldm, draws or {}
        n = min(self.n, batch["spec"].shape[0])
        spec_gt = batch["spec"][:n].float()
        if spec_gt.dim() == 3:   # single-channel mel: tiled ×3
            spec_gt = spec_gt[..., None].expand(*spec_gt.shape, 3)
        feat = batch["video_feat"][:n].float()
        swap = cast_floating(params, self.dtype)
        if self.vae_params is not None:
            swap.update({f"vae.{k}": v for k, v in self.vae_params.items()})
        with swapped_parameters(ldm, swap):
            vae_dtype = next(ldm.vae.parameters()).dtype
            z = ldm.encode_first_stage(spec_gt.to(vae_dtype).contiguous())
            rec = ldm.decode_first_stage(z)
            z_samp = ldm.sample(feat.to(self.dtype), sampler="dpm",
                                steps=self.steps, cfg_scale=self.cfg_scale,
                                x_T=draws.get("x_T"), generator=generator)
            samp = ldm.decode_first_stage(z_samp.to(vae_dtype))
        out_dir = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(out_dir, exist_ok=True)
        mels = [torch.clamp(s[..., 0].float(), 0.0, 1.0)
                for s in (spec_gt, rec, samp)]
        phase = lambda key, mel: draws[key] if key in draws else draw_rows(
            torch.rand, (n, DEFAULT_MELSPEC.n_fft // 2 + 1, mel.shape[-1]),
            generator=generator, device=mel.device)
        gt_rec_phase = phase("phase", mels[0])
        sample_phase = phase("sample_phase", mels[2])
        for name, mel, ph in (("gt", mels[0], gt_rec_phase),
                              ("rec", mels[1], gt_rec_phase),
                              ("sample", mels[2], sample_phase)):
            wav = mel_to_wav(mel, DEFAULT_MELSPEC, n_iter=self.gl_iters,
                             phase=ph).cpu().numpy()
            for i in range(n):
                write_wav(os.path.join(out_dir, f"{name}_{i}.wav"), wav[i],
                          self.sr)
            np.save(os.path.join(out_dir, f"{name}_spec.npy"),
                    mel.cpu().numpy())
        return out_dir
