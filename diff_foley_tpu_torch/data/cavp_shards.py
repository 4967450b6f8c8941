"""Stage-1 CAVP sharded tar dataset with intra-contrast clip sampling
(``diff_foley_tpu/data/cavp_shards.py``), numpy, cv2 and ``tarfile`` only.

Behavioural spec: reference webdataset pipeline
(`training/data.py:1499-1622, 2229-2298, 2624-2649`):

- tar shards each holding `<key>.spec.npy` (128-mel, hop 250) and
  `<key>.video.jpg` (a horizontal strip of 224×224 RGB frames at 4 FPS);
- deterministic shard shuffle keyed on (seed, epoch) (detshuffle2 :244-275);
- shards split across hosts then workers (split_by_node/worker);
- per sample: `clip_num` ∈ {2,3,4} 4-second windows with pairwise temporal
  offsets ≥ `shift_lb` frames (sample_temporal_index :2624-2649), spec slice
  `4 s · 16 kHz / hop 250 = 256` frames, video strip reshaped
  (224, -1, 224, 3) and normalised to [0,1] (transform_video :684-689).

Output per sample: video (clip_num, 16, 224, 224, 3) NDHWC,
spec (clip_num, 128, 256).
"""
from __future__ import annotations

import dataclasses
import io
import tarfile
from typing import Dict, Iterator, List, Sequence

import numpy as np



@dataclasses.dataclass(frozen=True)
class CAVPShardConfig:
    clip_num: int = 3
    shift_lb: int = 8            # ≥2 s at 4 FPS (launch_script.sh --shift_lb 8)
    truncate_sec: int = 4
    fps: int = 4
    sr: int = 16000
    hop_size: int = 250          # CAVP spec hop (data.py:2253)
    video_len: int = 40          # 10 s at 4 FPS
    frame_size: int = 224
    # True → emit video as raw uint8 [0, 255] and let the train step divide
    # by 255 on the device: 2× fewer bytes to the device than bf16 (4× than
    # fp32) and no 29 MB/sample float conversion on the host. The
    # reference converts to float on the host (transform_video,
    # data.py:684-689).
    uint8_video: bool = False


def sample_temporal_index(
    rng: np.random.Generator, cfg: CAVPShardConfig
) -> List[int]:
    """Ordered window starts with pairwise gaps ≥ shift_lb (data.py:2624-2649)."""
    n = cfg.clip_num
    truncate = cfg.truncate_sec * cfg.fps
    starts = []
    prev = 0
    for i in range(n):
        remaining = n - 1 - i
        lo = prev if i else 0
        hi = cfg.video_len - truncate - remaining * cfg.shift_lb
        assert hi >= lo, (lo, hi, cfg)
        s = int(rng.integers(lo, hi + 1))
        starts.append(s)
        prev = s + cfg.shift_lb
    return starts


def sample_rng(seed: int, epoch: int, key: str) -> np.random.Generator:
    """Per-sample deterministic RNG: crop selection depends only on
    (seed, epoch, sample key), not on arrival order."""
    import zlib

    return np.random.default_rng(
        np.random.SeedSequence([seed, epoch, zlib.crc32(key.encode())])
    )


def decode_sample(
    spec_npy: bytes, video_jpg: bytes, rng: np.random.Generator,
    cfg: CAVPShardConfig = CAVPShardConfig(),
) -> Dict[str, np.ndarray]:
    """Bytes → intra-contrast clips (cut_…_temporal_contrast, data.py:2229-2298)."""
    from ..video.ingest import _cv2

    spec = np.lib.format.read_array(io.BytesIO(spec_npy))
    cv2 = _cv2()
    strip = cv2.imdecode(
        np.frombuffer(video_jpg, np.uint8), cv2.IMREAD_COLOR
    )[:, :, ::-1]  # BGR→RGB
    # frames are square with side = strip height (the shard format); infer
    # rather than trusting cfg.frame_size so smoke-size shards decode too
    h = strip.shape[0]
    frames = strip.reshape(h, -1, h, 3).transpose(1, 0, 2, 3)  # (T, H, W, 3)

    starts = sample_temporal_index(rng, cfg)
    truncate_frame = cfg.truncate_sec * cfg.fps
    spec_truncate = int(cfg.truncate_sec * cfg.sr / cfg.hop_size)

    specs, videos = [], []
    for s in starts:
        spec_start = int(s / cfg.fps * cfg.sr / cfg.hop_size)
        sp = spec
        if sp.shape[-1] < spec_start + spec_truncate:
            sp = np.tile(sp, int((spec_start + spec_truncate) // sp.shape[-1]) + 1)
        specs.append(sp[:, spec_start : spec_start + spec_truncate])
        v = frames
        if v.shape[0] < s + truncate_frame:
            v = np.tile(v, (int((s + truncate_frame) // v.shape[0]) + 1, 1, 1, 1))
        videos.append(v[s : s + truncate_frame])
    video = np.stack(videos)                              # (n, 16, H, W, 3) u8
    if not cfg.uint8_video:
        video = video.astype(np.float32) / 255.0
    return {
        "video": video,                                   # (n, 16, 224, 224, 3)
        "spec": np.stack(specs).astype(np.float32),       # (n, 128, 256)
    }


def iter_shards(
    shard_paths: Sequence[str],
    *,
    seed: int = 0,
    epoch: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    worker_index: int = 0,
    worker_count: int = 1,
    cfg: CAVPShardConfig = CAVPShardConfig(),
    shuffle_buffer: int = 256,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream decoded samples from tar shards, host/worker-split."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    order = rng.permutation(len(shard_paths))
    mine = [
        shard_paths[i]
        for j, i in enumerate(order)
        if j % process_count == process_index
    ]
    mine = [p for j, p in enumerate(mine) if j % worker_count == worker_index]

    # the shuffle buffer holds RAW (key, spec_npy, video_jpg) byte pairs and
    # decodes at yield time: a decoded sample is ~29 MB (clip_num×16 224²
    # float32 frames) so a 256-deep decoded buffer would be ~7 GB of host
    # RAM; the jpg/npy bytes are ~100× smaller. Crops stay deterministic —
    # sample_rng is keyed on (seed, epoch, key), not arrival order.
    buf: List[tuple] = []

    def _decode(item):
        key, spec_bytes, video_bytes = item
        return decode_sample(
            spec_bytes, video_bytes, sample_rng(seed, epoch, key), cfg
        )

    for path in mine:
        with tarfile.open(path, "r") as tf:
            pending: Dict[str, Dict[str, bytes]] = {}
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                for suffix, slot in ((".spec.npy", "spec"), (".video.jpg", "video")):
                    if name.endswith(suffix):
                        key = name[: -len(suffix)]
                        pending.setdefault(key, {})[slot] = tf.extractfile(
                            member
                        ).read()
                        if len(pending[key]) == 2:
                            d = pending.pop(key)
                            buf.append((key, d["spec"], d["video"]))
                            if len(buf) >= shuffle_buffer:
                                i = int(rng.integers(0, len(buf)))
                                yield _decode(buf.pop(i))
    rng.shuffle(buf)
    for item in buf:
        yield _decode(item)
