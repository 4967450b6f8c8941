"""Dataset preprocessing: wav files → normalised mel-spec ``.npy`` files
(``diff_foley_tpu/cli/preprocess_audio.py``; the reference's
``data_preprocess/wav2spec.py``: zero-pad or cut to length − 1 samples,
the mel transform, one ``.npy`` a file).

Usage:
  python -m diff_foley_tpu_torch.cli.preprocess_audio --wav-dir wavs/ \\
      --out-dir audio_npy_spec/ --seconds 10 [--batch 32]

It writes ``<name>_mel.npy`` for each ``<name>.wav`` and refuses a file at
another sample rate than ``--sr``. The mel transform runs in batches on
the first CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; fails without a GPU) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..audio.transforms import wav_to_mel
    from ..pipeline import resolve_device
    from ..utils.wav import read_wav

    device = resolve_device(None if args.device == "cuda" else args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    length = int(args.sr * args.seconds)
    names = sorted(f for f in os.listdir(args.wav_dir) if f.endswith(".wav"))
    batch, keys = [], []

    def flush():
        if not batch:
            return
        with torch.no_grad():
            specs = wav_to_mel(torch.as_tensor(np.stack(batch),
                                               device=device)).cpu().numpy()
        for k, s in zip(keys, specs):
            np.save(os.path.join(args.out_dir, f"{k}_mel.npy"), s)
        batch.clear()
        keys.clear()

    for name in names:
        wav, sr = read_wav(os.path.join(args.wav_dir, name))
        if sr != args.sr:
            raise ValueError(f"{name}: sr {sr} != {args.sr} (resample first)")
        y = np.zeros(length, np.float32)
        y[:min(len(wav), length)] = wav[:length]
        batch.append(y[:length - 1])  # wav2spec.py:184's length − 1
        keys.append(os.path.splitext(name)[0])
        if len(batch) == args.batch:
            flush()
    flush()
    print(f"wrote {len(names)} specs to {args.out_dir}")
    return names


if __name__ == "__main__":
    main()
