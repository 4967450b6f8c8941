"""End-to-end generation after feature extraction
(``diff_foley_tpu/pipeline.py``):

- ``generate``: CAVP features → latents (DPM-Solver++ with CFG and
  alignment guidance) → VAE decode → mel → Griffin-Lim → waveform;
- ``inpaint``: the same, conditioned also on a known mel canvas and a keep
  mask (audio continuation): the canvas is VAE-encoded, masked DDIM (or
  the ancestral chain) re-imposes the known latents every step, and they
  are re-imposed once more before the decode.

``generate(..., bucket_windows=b)`` runs a window stream of any length
through fixed (b × sample_num) calls, its last chunk padded; serving
(``serving.py``) batches requests into such buckets. ``aot_warmup`` makes
one warm call per bucket. The JAX package serialises one compiled
executable per bucket (``utils/aot.py``) into a persistent compile cache
(``utils/compile_cache.py``); the port has no executable to serialise, so
neither module has a counterpart. What survives a restart here is the
hash-keyed kernel build directory (``ops/cuda_build.py``); the warm call
builds any kernel library still missing, lets cuDNN pick its algorithms
and grows the caching allocator to the bucket's size.

With a ``mesh`` (``parallel/mesh.py``) the ranks of its data group split
the windows, as the JAX package's meshed pipeline does: the windows are
padded to a multiple of the data degree, each rank samples, decodes and
inverts its rows, and the outputs are all-gathered, so every rank returns
the whole result. A rank draws the initial noise, DDIM's forward noise
and Griffin-Lim's phase at the stream's whole row count from the shared
generator and keeps its rows (``global_rows``): a meshed call equals the
one-process call. A bucket must divide over the data group.

Operating point: 25 DPM-Solver++ (or DDIM) steps, CFG 4.5, classifier
guidance 50, 32 CAVP features per 8.192-s window (131072 samples at
16 kHz, a 128×512 mel, a 16×64×4 latent), 32 Griffin-Lim iterations.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from .audio.transforms import DEFAULT_MELSPEC, MelSpec, mel_to_wav
from .diffusion.latent_diffusion import LatentDiffusion, LDMConfig
from .ops import cuda_build
from .parallel.collectives import all_gather
from .parallel.mesh import global_rows
from .utils.padding import pad_axis0, pad_axis0_to_multiple

WINDOW_FEATS = 32
WINDOW_SAMPLES = 131072
LATENT_HW = (16, 64)
SPEC_HW = (LATENT_HW[0] * 8, LATENT_HW[1] * 8)  # (128 mels, 512 frames)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    # "dpm" (DPM-Solver++), "ddim", "plms", "ancestral"/"ddpm" (the chain:
    # ``steps`` does not apply), as ``LatentDiffusion.sample`` takes them
    sampler: str = "dpm"
    steps: int = 25
    cfg_scale: float = 4.5
    classifier_scale: float = 50.0
    sample_num: int = 4
    gl_iters: int = 32
    # False skips the spec's copy to the host: no "spec" key (serving)
    return_spec: bool = True
    # "float32" keeps Griffin-Lim's output; "int16" quantises as write_wav
    wav_dtype: str = "float32"
    # the sampler's options as (key, value) pairs, handed to
    # ``LatentDiffusion.sample``: for "dpm" the whole DPM-Solver library,
    # e.g. (("order", 3), ("method", "singlestep")); for "ddim" η,
    # "quad" spacing …; for the chain ``timesteps``
    solver_opts: tuple = ()


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


def chunk_seed(seed: int, chunk: int) -> int:
    """The generator seed of chunk ``chunk`` of a bucketed ``generate``
    with ``seed``: a SeedSequence's 64-bit state of (seed, chunk), so no two
    chunks share noise (the JAX package folds the chunk into its key)."""
    return int(np.random.SeedSequence([seed, chunk]).generate_state(
        1, np.uint64)[0])


def _pack_outputs(wavs: np.ndarray, specs: Optional[np.ndarray], w: int,
                  s: int) -> dict:
    """(≥ w·S, n) wavs and (≥ w·S, 128, 512) specs (or None) on the host →
    {"wav": (S, w·n), "spec": (S, 128, w·512)}: the first w windows, each
    sample's windows concatenated in time."""
    wv = wavs.reshape(-1, s, wavs.shape[-1])[:w]
    out = {"wav": wv.transpose(1, 0, 2).reshape(s, -1)}
    if specs is not None:
        sp = specs.reshape(-1, s, *specs.shape[1:])[:w]
        out["spec"] = sp.transpose(1, 2, 0, 3).reshape(s, sp.shape[2], -1)
    return out


def window_features(feats: np.ndarray, window: int = WINDOW_FEATS) -> np.ndarray:
    """(T, 512) feature stream → (num_windows, window, 512); the ragged tail
    is dropped."""
    n = feats.shape[0] // window
    assert n >= 1, f"need ≥{window} features, got {feats.shape[0]}"
    return feats[:n * window].reshape(n, window, feats.shape[-1])


def continuation_mask(n_frames: int, known_frames: int,
                      n_mels: int = SPEC_HW[0]) -> np.ndarray:
    """Keep-mask for audio continuation: the first ``known_frames`` mel
    frames are known (1), the rest are generated (0)."""
    m = np.zeros((n_mels, n_frames), np.float32)
    m[:, :known_frames] = 1.0
    return m


def spec_mask_to_latent(mask_w: np.ndarray) -> np.ndarray:
    """(w, 128, 512) spec keep-mask → (w, 16, 64, 1) latent mask by 8×8
    min-pool: a latent cell is known only when its whole patch is."""
    w, h, f = mask_w.shape
    assert h % 8 == 0 and f % 8 == 0, (h, f)
    return mask_w.reshape(w, h // 8, 8, f // 8, 8).min(axis=(2, 4))[..., None]


class DiffFoleyPipeline:
    """The LDM, the optional alignment classifier and the mel inversion on
    one device a rank. ``vae_dtype="bfloat16"`` encodes and decodes in bf16
    (GroupNorm statistics stay float32). ``mesh``: the module docstring;
    every rank of it builds the pipeline from the same weights."""

    def __init__(self, ldm: Optional[LatentDiffusion] = None,
                 classifier: Optional[nn.Module] = None,
                 melspec: MelSpec = DEFAULT_MELSPEC,
                 vae_dtype: Optional[str] = None, device=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.group = None if mesh is None else mesh.data_group
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
        z = self.ldm.sample(cond, latent_hw=LATENT_HW, x_T=x_T,
                            generator=generator, **self.sampler_kwargs(gen))
        return self.decode_specs(z)

    def sampler_kwargs(self, gen: GenerationConfig) -> dict:
        """The sampler and guidance arguments of ``LatentDiffusion.sample``."""
        use_clf = gen.classifier_scale > 0 and self.classifier is not None
        return dict(sampler=gen.sampler, steps=gen.steps,
                    cfg_scale=gen.cfg_scale,
                    classifier=self.classifier if use_clf else None,
                    classifier_scale=gen.classifier_scale if use_clf else 0.0,
                    **dict(gen.solver_opts))

    @torch.no_grad()
    def encode_canvas(self, spec_w: torch.Tensor) -> torch.Tensor:
        """(w, 128, 512) mel canvases in [0, 1] → (w, 16, 64, 4) float32
        scaled latents, the posterior's mode (the canvas must not resample
        from call to call)."""
        x_img = spec_w[..., None].expand(*spec_w.shape, 3)
        if self.vae_compute is not None:
            x_img = x_img.to(self.vae_compute)
        return self.ldm.encode_first_stage(x_img).float()

    @torch.no_grad()
    def decode_specs(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents → specs in [0, 1], channel 0 of the image."""
        if self.vae_compute is not None:
            z = z.to(self.vae_compute)
        spec_img = self.ldm.decode_first_stage(z)
        return torch.clamp(spec_img[..., 0].float(), 0.0, 1.0)

    @torch.no_grad()
    def _invert(self, specs: torch.Tensor, gen: GenerationConfig,
                generator: torch.Generator,
                gl_phase: Optional[torch.Tensor]) -> torch.Tensor:
        """(n, 128, 512) specs → (n, 131072) waveforms in ``wav_dtype``."""
        wavs = mel_to_wav(specs, self.melspec, n_iter=gen.gl_iters,
                          length=WINDOW_SAMPLES, phase=gl_phase,
                          generator=generator)
        return _pack_wav(wavs, gen.wav_dtype)

    def _invert_and_pack(self, specs: torch.Tensor, gen: GenerationConfig,
                         w: int, generator: torch.Generator,
                         gl_phase: Optional[torch.Tensor]) -> dict:
        """(w·S, 128, 512) specs (this rank's rows on a mesh) → {"wav": (S,
        w·131072), "spec": (S, 128, w·512)} numpy, windows concatenated in
        time; no "spec" without ``gen.return_spec``."""
        wavs = self._invert(specs, gen, generator, gl_phase)
        return _pack_outputs(
            self._host(wavs), self._host(specs) if gen.return_spec else None,
            w, gen.sample_num)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """Every rank's rows (this rank's without a mesh), on the host.
        int16 waveforms cross as their bytes: neither NCCL nor gloo
        reduces or gathers int16."""
        t = t.contiguous()
        if t.dtype == torch.int16:
            return all_gather(t.view(torch.uint8), self.group).view(
                torch.int16).cpu().numpy()
        return all_gather(t, self.group).cpu().numpy()

    def _my_windows(self, w: int) -> tuple:
        """(padded window count, this rank's windows of it)."""
        if self.mesh is None:
            return w, slice(None)
        wp = -(-w // self.mesh.shape["data"]) * self.mesh.shape["data"]
        return wp, self.mesh.rows(wp)

    def _my_rows(self, t: Optional[torch.Tensor], rows: int, dim: int = 0):
        """This rank's rows of an override drawn for the whole stream
        (``rows`` padded rows, zeros past its end)."""
        if t is None or self.mesh is None:
            return t
        t = t.movedim(dim, 0)
        if t.shape[0] < rows:
            t = torch.cat([t, t.new_zeros((rows - t.shape[0],
                                           *t.shape[1:]))])
        return t[self.mesh.rows(rows)].movedim(0, dim)

    def _windows(self, cavp_feats) -> np.ndarray:
        return window_features(np.asarray(cavp_feats, np.float32))

    def generate(self, cavp_feats: np.ndarray, seed: int = 0,
                 gen: GenerationConfig = GenerationConfig(),
                 x_T: Optional[torch.Tensor] = None,
                 gl_phase: Optional[torch.Tensor] = None,
                 bucket_windows: Optional[int] = None) -> dict:
        """(T, 512) CAVP features → {"wav": (S, w·131072), "spec": (S, 128,
        w·512)} numpy, S = sample_num, windows concatenated in time.

        Initial noise and Griffin-Lim's initial phase come from a generator
        seeded with ``seed``; ``x_T`` and ``gl_phase`` ((w·S, 513, 512)
        uniform [0, 1)) override them.

        ``bucket_windows`` runs the stream in fixed chunks of that many
        windows (``_generate_bucketed``): any length reuses one shape."""
        if bucket_windows is not None:
            return self._generate_bucketed(cavp_feats, seed, gen,
                                           bucket_windows, x_T, gl_phase)
        feats_w = self._windows(cavp_feats)
        w, s = feats_w.shape[0], gen.sample_num
        wp, mine = self._my_windows(w)
        feats = torch.as_tensor(pad_axis0(feats_w, wp)[mine],
                                device=self.device)
        generator = torch.Generator(self.device).manual_seed(seed)
        with global_rows(self.mesh, w * s):
            specs = self._sample_and_decode(feats, gen, generator,
                                            self._my_rows(x_T, wp * s))
            return self._invert_and_pack(specs, gen, w, generator,
                                         self._my_rows(gl_phase, wp * s))

    def _generate_bucketed(self, cavp_feats, seed: int,
                           gen: GenerationConfig, bucket: int,
                           x_T: Optional[torch.Tensor],
                           gl_phase: Optional[torch.Tensor]) -> dict:
        """Pad the window stream to a multiple of ``bucket`` by repeating
        its last window, run one (bucket × S) call per chunk, each drawing
        from its own generator (``chunk_seed(seed, c)``), and trim the
        outputs back to the stream's w windows. ``x_T`` and ``gl_phase``
        of the padded length (n_chunks·bucket·S, …) override the draws."""
        if bucket < 1:
            raise ValueError(f"bucket_windows must be ≥ 1, got {bucket}")
        if self.mesh is not None and bucket % self.mesh.shape["data"]:
            raise ValueError(f"bucket {bucket} does not divide over the "
                             f"data group ({self.mesh.shape['data']})")
        feats_w = self._windows(cavp_feats)
        w = feats_w.shape[0]
        feats_w = pad_axis0_to_multiple(feats_w, bucket)
        n_chunks, rows = feats_w.shape[0] // bucket, bucket * gen.sample_num
        for name, t in (("x_T", x_T), ("gl_phase", gl_phase)):
            if t is not None and t.shape[0] != n_chunks * rows:
                raise ValueError(f"{name} must hold {n_chunks * rows} rows "
                                 f"({n_chunks} chunks of {rows}), got "
                                 f"{t.shape[0]}")
        part = lambda t, c: self._my_rows(
            None if t is None else t[c * rows:(c + 1) * rows], rows)
        _, mine = self._my_windows(bucket)
        wavs, specs = [], []
        for c in range(n_chunks):
            chunk = torch.as_tensor(feats_w[c * bucket:(c + 1) * bucket][mine],
                                    device=self.device)
            generator = torch.Generator(self.device).manual_seed(
                chunk_seed(seed, c))
            with global_rows(self.mesh):
                sp = self._sample_and_decode(chunk, gen, generator,
                                             part(x_T, c))
                wavs.append(self._host(self._invert(sp, gen, generator,
                                                    part(gl_phase, c))))
            if gen.return_spec:
                specs.append(self._host(sp))
        return _pack_outputs(np.concatenate(wavs),
                             np.concatenate(specs) if specs else None, w,
                             gen.sample_num)

    def aot_warmup(self, window_buckets, gen: GenerationConfig) -> dict:
        """One warm bucketed call (zero features, seed 0) per window
        bucket: it builds any kernel library still missing, lets cuDNN
        pick its algorithms at the bucket's shapes and grows the caching
        allocator (the module docstring says why there is no executable
        cache). Returns {bucket: (status, seconds)}, status "built" when
        the call compiled a kernel library, else "warm"."""
        report = {}
        for b in window_buckets:
            b = int(b)
            compiled = len(cuda_build.COMPILED)
            t0 = time.perf_counter()
            self.generate(np.zeros((b * WINDOW_FEATS, 512), np.float32), 0,
                          gen, bucket_windows=b)
            report[b] = ("built" if len(cuda_build.COMPILED) > compiled
                         else "warm", time.perf_counter() - t0)
        return report

    def inpaint(self, cavp_feats: np.ndarray, known_spec: np.ndarray,
                spec_mask: np.ndarray, seed: int = 0,
                gen: GenerationConfig = GenerationConfig(sampler="ddim"),
                x_T: Optional[torch.Tensor] = None,
                mask_noise: Optional[torch.Tensor] = None,
                gl_phase: Optional[torch.Tensor] = None,
                draws: Optional[dict] = None) -> dict:
        """Masked generation: continue or inpaint audio against a video.

        ``known_spec`` (128, ≥ w·512) is a mel image in [0, 1] (a prior
        ``generate`` sample, say); ``spec_mask`` of the same shape is 1
        where it is KEPT and 0 where it is generated
        (``continuation_mask``). The mask is min-pooled 8×8 to the latents;
        DDIM re-imposes the known latents before every model call, the
        ancestral chain ("ancestral"/"ddpm") after every step, and the
        pipeline re-imposes them once more before the decode, so the kept
        region is the VAE's roundtrip of the canvas. Returns what
        ``generate`` returns.

        A generator seeded with ``seed`` draws x_T, the per-step forward
        noise of the known region (and the chain's step noise) and
        Griffin-Lim's phase; ``x_T``, ``mask_noise`` ((n_steps, w·S, 16,
        64, 4), n_steps the DDIM steps or the chain's length),
        ``draws`` (the sampler's step draws, ``samplers.py``, each of
        mask_noise's shape) and ``gl_phase`` override them."""
        if gen.sampler not in ("ddim", "ancestral", "ddpm"):
            raise ValueError(f"inpainting needs sampler 'ddim' or "
                             f"'ancestral' (ddim.py:210, ddpm.py:1224), got "
                             f"{gen.sampler!r}")
        feats_w = self._windows(cavp_feats)
        w, s = feats_w.shape[0], gen.sample_num
        n_mels, frames = SPEC_HW[0], w * SPEC_HW[1]
        known_spec = np.asarray(known_spec, np.float32)
        spec_mask = np.asarray(spec_mask, np.float32)
        if known_spec.shape != spec_mask.shape:
            raise ValueError(f"known_spec {known_spec.shape} vs spec_mask "
                             f"{spec_mask.shape} shape mismatch")
        if known_spec.shape[0] != n_mels or known_spec.shape[1] < frames:
            raise ValueError(f"known_spec must be ({n_mels}, ≥{frames}) for "
                             f"{w} windows, got {known_spec.shape}")
        # (mels, w·512) → per window (w, mels, 512)
        to_w = lambda a: np.ascontiguousarray(
            a[:, :frames].reshape(n_mels, w, SPEC_HW[1]).transpose(1, 0, 2))
        wp, mine = self._my_windows(w)
        mine_of = lambda a: torch.as_tensor(pad_axis0(a, wp)[mine],
                                            device=self.device)
        spec_w = mine_of(to_w(known_spec))
        mask = mine_of(spec_mask_to_latent(to_w(spec_mask)))
        feats = mine_of(feats_w)
        generator = torch.Generator(self.device).manual_seed(seed)
        extra = {} if draws is None else {"draws": {
            k: self._my_rows(v, wp * s, dim=1) for k, v in draws.items()}}
        with torch.no_grad(), global_rows(self.mesh, w * s):
            z0 = self.encode_canvas(spec_w).repeat_interleave(s, dim=0)
            mask = mask.repeat_interleave(s, dim=0)
            z = self.ldm.sample(
                feats.repeat_interleave(s, dim=0), latent_hw=LATENT_HW,
                x_T=self._my_rows(x_T, wp * s), generator=generator,
                mask=mask, x0=z0,
                mask_noise=self._my_rows(mask_noise, wp * s, dim=1),
                **extra, **self.sampler_kwargs(gen))
            # the last update moves the known region by one denoising step:
            # re-impose the canvas exactly before the decode
            z = z0 * mask + (1.0 - mask) * z
            specs = self.decode_specs(z)
            return self._invert_and_pack(specs, gen, w, generator,
                                         self._my_rows(gl_phase, wp * s))
