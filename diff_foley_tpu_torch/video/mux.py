"""A/V muxing of generated foley onto the source video
(``diff_foley_tpu/video/mux.py``): the wav is written at 16 kHz, then
``ffmpeg -i <video> -i <wav> -c:v copy -c:a aac <out>``. Without ffmpeg on
PATH ``mux_audio_video`` raises; generation does not need it. ``write_wav``
is ``utils/wav.py``'s: the JAX package's two writers give the same bytes.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np

from ..utils.wav import write_wav


def which_ffmpeg() -> str:
    """Path to ffmpeg, '' if it is not installed."""
    return shutil.which("ffmpeg") or ""


def has_ffmpeg() -> bool:
    return which_ffmpeg() != ""


def mux_audio_video(video_path: str, wav: np.ndarray, out_path: str,
                    sr: int = 16000, tmp_wav: Optional[str] = None) -> str:
    """``wav`` onto ``video_path`` → ``out_path``: the video stream copied,
    the audio AAC-encoded."""
    ffmpeg = which_ffmpeg()
    if not ffmpeg:
        raise RuntimeError(
            "ffmpeg not found on PATH; install it to mux audio onto video "
            "(generation itself does not need it)")
    tmp_wav = tmp_wav or (os.path.splitext(out_path)[0] + "_audio.wav")
    write_wav(tmp_wav, wav, sr)
    subprocess.check_call([
        ffmpeg, "-hide_banner", "-loglevel", "error", "-y",
        "-i", video_path, "-i", tmp_wav,
        "-c:v", "copy", "-c:a", "aac", "-strict", "experimental",
        "-map", "0:v:0", "-map", "1:a:0", "-shortest", out_path])
    return out_path
