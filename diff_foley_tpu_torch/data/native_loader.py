"""ctypes binding of the C++ tar-shard reader ``native/shard_reader.cpp``
(``diff_foley_tpu/data/native_loader.py``): reader threads stream tar
members and pair each sample's spec and video bytes into a ring buffer;
Python decodes them (cv2 JPEG, numpy ``.npy``) and cuts the clips as
``data/cavp_shards.py`` does.

The library is built at first use with ``g++`` into ``build/native``
beside the package (listed in ``.gitignore``), named by a hash of the
source and the flags; ``native/`` itself is never written. Without a
compiler it raises: nothing falls back to the Python reader, which runs
without ``--native-loader``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterator, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "shard_reader.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return (Path(__file__).resolve().parents[2] / "build" / "native"
            / f"libshardreader-{h.hexdigest()[:12]}.so")


def build_native() -> Path:
    """Compile the reader unless a current library exists; its path."""
    path = library_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native shard reader needs a "
                           "C++ compiler (or set CXX)")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_native()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.shard_reader_open.restype = ctypes.c_void_p
    lib.shard_reader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.shard_reader_next.restype = ctypes.c_int
    lib.shard_reader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.shard_reader_free_sample.argtypes = [ctypes.c_void_p]
    lib.shard_reader_failed.restype = ctypes.c_int
    lib.shard_reader_failed.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_char_p)]
    lib.shard_reader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeShardReader:
    """Iterates (key, spec_bytes, video_bytes) from tar shards via C++."""

    def __init__(self, shard_paths: Sequence[str], n_threads: int = 4,
                 ring_capacity: int = 64):
        self._lib = _load_lib()
        arr = (ctypes.c_char_p * len(shard_paths))(
            *[p.encode() for p in shard_paths])
        self._h = self._lib.shard_reader_open(arr, len(shard_paths),
                                              n_threads, ring_capacity)
        self._closed = False

    def __iter__(self) -> Iterator[tuple]:
        lib = self._lib
        while True:
            sample, key = ctypes.c_void_p(), ctypes.c_char_p()
            spec_p = ctypes.POINTER(ctypes.c_uint8)()
            vid_p = ctypes.POINTER(ctypes.c_uint8)()
            spec_n, vid_n = ctypes.c_uint64(), ctypes.c_uint64()
            ok = lib.shard_reader_next(
                self._h, ctypes.byref(sample), ctypes.byref(key),
                ctypes.byref(spec_p), ctypes.byref(spec_n),
                ctypes.byref(vid_p), ctypes.byref(vid_n))
            if not ok:
                # the end of the stream, or a worker stopped on a corrupt
                # shard: the C++ side sets a failed flag for the latter
                msg = ctypes.c_char_p()
                if lib.shard_reader_failed(self._h, ctypes.byref(msg)):
                    raise RuntimeError("native shard reader failed: "
                                       f"{msg.value.decode()}")
                return
            try:
                yield (key.value.decode(),
                       ctypes.string_at(spec_p, spec_n.value),
                       ctypes.string_at(vid_p, vid_n.value))
            finally:
                lib.shard_reader_free_sample(sample)

    def close(self):
        if not self._closed:
            self._lib.shard_reader_close(self._h)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def iter_shards_native(shard_paths: Sequence[str], *, seed: int = 0,
                       epoch: int = 0, process_index: int = 0,
                       process_count: int = 1, cfg=None, n_threads: int = 4,
                       shuffle_buffer: int = 256
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """``data.cavp_shards.iter_shards`` over the C++ reader: the same
    samples, each cut from the generator of (seed, epoch, key). The C++
    threads deliver samples in no fixed order, so the order is not
    ``iter_shards``'s; a shuffle buffer of raw bytes decorrelates it from
    the tar order further."""
    from .cavp_shards import CAVPShardConfig, decode_sample, sample_rng

    cfg = cfg or CAVPShardConfig()
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    order = rng.permutation(len(shard_paths))
    mine = [shard_paths[i] for j, i in enumerate(order)
            if j % process_count == process_index]

    def decode(item):
        key, spec_bytes, video_bytes = item
        return decode_sample(spec_bytes, video_bytes,
                             sample_rng(seed, epoch, key), cfg)

    buf = []
    with NativeShardReader(mine, n_threads=n_threads) as reader:
        for item in reader:
            buf.append(item)
            if len(buf) >= shuffle_buffer:
                yield decode(buf.pop(int(rng.integers(0, len(buf)))))
    rng.shuffle(buf)
    for item in buf:
        yield decode(item)
