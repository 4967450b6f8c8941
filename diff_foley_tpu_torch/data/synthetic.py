"""A synthetic, learnable audio-visual world
(``diff_foley_tpu/data/synthetic.py``): the port's own numpy copy, whose
writers write the same bytes as the JAX package's for the same arguments.

Parity with the reference proves the port computes the same function; it
cannot prove that it learns. This world can be learned by every stage of
the recipe at toy scale, with no download.

The world
---------
Each item carries a *class value* ``c ∈ [0, 1)`` and a *phase*
``φ ∈ [0, 1)``:

- **spectrogram**: a Gaussian energy band whose mel row is an affine
  function of ``c``, amplitude-modulated in time by
  ``m(τ) = 0.75 + 0.25·sin(2π(CYCLES·τ + φ))``;
- **video**: frames with a vertical bright bar whose column is the same
  affine function of ``c``, brightness modulated by the same ``m``;
- **feature**: an L2-normalised Fourier embedding of ``c`` (a stand-in for
  CAVP features when a stage is tested alone).

Cross-modal identity is keyed by ``c`` (the alignment signal), time
within an item by ``φ`` (the intra-contrastive signal).

The writers emit the two on-disk training layouts the port's loaders
read:

- :func:`write_cavp_shards`: stage-1 tar shards (``<key>.spec.npy`` and a
  ``<key>.video.jpg`` strip; ``data/cavp_shards.py``);
- :func:`write_ldm_data_dir`: the stage-2 and classifier directory tree
  (``Train/audio_npy_spec/<id>_mel.npy``, ``CAVP_feat/Train/<id>.npz``,
  ``Train.txt``; ``data/ldm_dataset.py``), with synthetic features or those
  of a given encoder.

``cv2`` (the JPEG strips) is imported only by the shard writer.
"""
from __future__ import annotations

import io
import os
import tarfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

CYCLES = 1.5          # amplitude-modulation cycles per item
BAND_SIGMA = 3.0      # mel-rows; width of the spec energy band
BAR_HALFWIDTH = 1     # pixels; half-width of the video bar


def modulation(tau: np.ndarray, phase: float) -> np.ndarray:
    """m(τ) ∈ [0.5, 1]: shared audio/visual amplitude envelope."""
    return 0.75 + 0.25 * np.sin(2 * np.pi * (CYCLES * tau + phase))


def synthetic_spec(
    c: float, phase: float, rng: np.random.Generator,
    frames: int = 640, mels: int = 128, noise: float = 0.08,
) -> np.ndarray:
    """(mels, frames) float32 in [0, 1]: band at row ∝ c, envelope m(τ)."""
    row = 10.0 + c * (mels - 20.0)
    rows = np.arange(mels, dtype=np.float32)
    band = np.exp(-0.5 * ((rows - row) / BAND_SIGMA) ** 2)  # (mels,)
    tau = np.arange(frames, dtype=np.float32) / frames
    spec = 0.85 * band[:, None] * modulation(tau, phase)[None, :]
    spec = spec + rng.normal(0.0, noise, spec.shape)
    return np.clip(spec, 0.0, 1.0).astype(np.float32)


def synthetic_frames(
    c: float, phase: float, rng: np.random.Generator,
    t: int = 40, size: int = 16, noise: float = 0.05,
) -> np.ndarray:
    """(t, size, size, 3) float32 in [0, 1]: bar at col ∝ c, envelope m."""
    col = int(round(BAR_HALFWIDTH + c * (size - 1 - 2 * BAR_HALFWIDTH)))
    tau = np.arange(t, dtype=np.float32) / t
    m = modulation(tau, phase)  # (t,)
    frames = np.full((t, size, size, 3), 0.1, np.float32)
    lo, hi = col - BAR_HALFWIDTH, col + BAR_HALFWIDTH + 1
    frames[:, :, lo:hi, :] = 0.15 + 0.8 * m[:, None, None, None]
    frames = frames + rng.normal(0.0, noise, frames.shape)
    return np.clip(frames, 0.0, 1.0).astype(np.float32)


def synthetic_feat(
    c: float, phase: float, rng: np.random.Generator,
    t: int = 32, dim: int = 512, noise: float = 0.05,
) -> np.ndarray:
    """(t, dim) unit-norm Fourier embedding of c, envelope-scaled + noise.

    Smooth in c (nearby classes are nearby embeddings) yet discriminable;
    per-frame the envelope m(τ) carries the φ signal like real per-frame
    CAVP features would.
    """
    k = np.arange(1, dim // 2 + 1, dtype=np.float32)
    base = np.concatenate(
        [np.sin(2 * np.pi * k * c), np.cos(2 * np.pi * k * c)]
    ) / np.sqrt(np.concatenate([k, k]))  # 1/√k decay: smooth yet sharp
    tau = np.arange(t, dtype=np.float32) / t
    feat = base[None, :] * modulation(tau, phase)[:, None]
    feat = feat + rng.normal(0.0, noise * np.abs(base).mean(), feat.shape)
    return (feat / np.linalg.norm(feat, axis=-1, keepdims=True)).astype(
        np.float32
    )


def item_params(
    n: int, seed: int, *, spread: bool = True,
    n_classes: Optional[int] = None,
) -> List[Tuple[float, float]]:
    """n (c, φ) pairs. `spread` stratifies c over [0,1) (low-discrepancy:
    every batch sees well-separated classes — no false-negative collisions
    in the contrastive loss). With `n_classes`, c is drawn from the discrete
    grid (k+0.5)/n_classes cycling over k — the categorical world (easier:
    alignment becomes prototype matching; held-out items are fresh noise/φ
    draws of SEEN classes, which is the right generalization test for the
    classifier/guidance gates)."""
    rng = np.random.default_rng(seed)
    if n_classes is not None:
        cs = ((np.arange(n) % n_classes) + 0.5) / n_classes
        cs = cs[rng.permutation(n)]
    elif spread:
        cs = (np.arange(n) + rng.uniform(0.05, 0.95, n)) / n
        cs = cs[rng.permutation(n)]
    else:
        cs = rng.uniform(0.0, 1.0, n)
    phases = rng.uniform(0.0, 1.0, n)
    return [(float(c), float(p)) for c, p in zip(cs, phases)]


# ---------------------------------------------------------------------------
# stage-1 webdataset shards
# ---------------------------------------------------------------------------
def write_cavp_shards(
    out_dir: str,
    *,
    n_shards: int = 2,
    items_per_shard: int = 16,
    frame_size: int = 16,
    video_len: int = 40,
    spec_frames: int = 640,
    seed: int = 0,
    noise: float = 0.05,
) -> List[Tuple[float, float]]:
    """Write `shard-%06d.tar` files of class-keyed AV pairs.

    Returns the (c, φ) list, index-aligned with keys ``s<shard>_<k>``.
    """
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    n = n_shards * items_per_shard
    params = item_params(n, seed)
    rng = np.random.default_rng(seed + 1)
    idx = 0
    for si in range(n_shards):
        with tarfile.open(
            os.path.join(out_dir, f"shard-{si:06d}.tar"), "w"
        ) as tf:
            for k in range(items_per_shard):
                c, phase = params[idx]
                idx += 1
                spec = synthetic_spec(
                    c, phase, rng, frames=spec_frames, noise=noise
                )
                buf = io.BytesIO()
                np.save(buf, spec)
                info = tarfile.TarInfo(f"s{si}_{k}.spec.npy")
                info.size = buf.getbuffer().nbytes
                buf.seek(0)
                tf.addfile(info, buf)

                frames = synthetic_frames(
                    c, phase, rng, t=video_len, size=frame_size, noise=noise
                )
                strip = (
                    frames.transpose(1, 0, 2, 3).reshape(
                        frame_size, video_len * frame_size, 3
                    )
                    * 255
                ).astype(np.uint8)
                # BGR for cv2 so decode_sample's BGR→RGB lands on RGB
                ok, enc = cv2.imencode(".jpg", strip[:, :, ::-1])
                assert ok
                info = tarfile.TarInfo(f"s{si}_{k}.video.jpg")
                info.size = len(enc)
                tf.addfile(info, io.BytesIO(enc.tobytes()))
    return params


def holdout_pairs(
    n: int,
    *,
    frame_size: int = 16,
    video_len: int = 40,
    spec_frames: int = 640,
    seed: int = 9000,
    noise: float = 0.05,
) -> Dict[str, np.ndarray]:
    """n UNSEEN (video, spec) pairs for retrieval eval: fresh c, φ and noise.

    Returns {"video": (n, T, S, S, 3), "spec": (n, 128, F), "c": (n,)}.
    """
    params = item_params(n, seed)
    rng = np.random.default_rng(seed + 1)
    videos, specs = [], []
    for c, phase in params:
        videos.append(
            synthetic_frames(c, phase, rng, t=video_len, size=frame_size,
                             noise=noise)
        )
        specs.append(
            synthetic_spec(c, phase, rng, frames=spec_frames, noise=noise)
        )
    return {
        "video": np.stack(videos),
        "spec": np.stack(specs),
        "c": np.asarray([c for c, _ in params], np.float32),
    }


# ---------------------------------------------------------------------------
# stage-2 / classifier data directory
# ---------------------------------------------------------------------------
def write_ldm_data_dir(
    data_dir: str,
    *,
    n_train: int = 64,
    n_test: int = 16,
    spec_frames: int = 512,
    feat_len: int = 32,
    feat_dim: int = 512,
    seed: int = 0,
    noise: float = 0.05,
    encode_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    frame_size: int = 16,
    n_classes: Optional[int] = None,
) -> Dict[str, List[Tuple[float, float]]]:
    """Write the reference data-dir layout with class-keyed items.

    `encode_fn(frames (T,S,S,3) float32) → (T, feat_dim)`: when given,
    features come from a trained CAVP tower (the composed gate); otherwise
    the synthetic Fourier embedding stands in. Test items use fresh (c, φ)
    and noise draws. Returns {"train": [(c, φ)…], "test": [(c, φ)…]}.
    """
    out = {}
    rng = np.random.default_rng(seed + 2)
    for split, n, split_seed in (
        ("Train", n_train, seed), ("Test", n_test, seed + 7000)
    ):
        params = item_params(n, split_seed, n_classes=n_classes)
        out[split.lower()] = params
        spec_dir = os.path.join(data_dir, split, "audio_npy_spec")
        feat_dir = os.path.join(data_dir, "CAVP_feat", split)
        os.makedirs(spec_dir, exist_ok=True)
        os.makedirs(feat_dir, exist_ok=True)
        ids = []
        for i, (c, phase) in enumerate(params):
            vid = f"{split.lower()}{i}"
            ids.append(vid)
            spec = synthetic_spec(
                c, phase, rng, frames=spec_frames, noise=noise
            )
            np.save(os.path.join(spec_dir, f"{vid}_mel.npy"), spec)
            if encode_fn is not None:
                frames = synthetic_frames(
                    c, phase, rng, t=feat_len, size=frame_size, noise=noise
                )
                feat = np.asarray(encode_fn(frames), np.float32)
                assert feat.shape == (feat_len, feat_dim), feat.shape
            else:
                feat = synthetic_feat(
                    c, phase, rng, t=feat_len, dim=feat_dim, noise=noise
                )
            np.savez(os.path.join(feat_dir, f"{vid}.npz"), feat=feat)
        with open(os.path.join(data_dir, f"{split}.txt"), "w") as f:
            f.write("\n".join(ids))
    return out
