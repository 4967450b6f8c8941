"""Serving (``diff_foley_tpu/serving.py``): request batching over the
pipeline, and a stdlib HTTP front end.

- ``BatchingEngine`` collects the feature windows of concurrent requests,
  up to ``max_batch_windows`` or ``max_wait_ms``, and runs them as one
  bucketed ``generate``: the bucket is the smallest power of two that
  holds the batch, capped at ``max_batch_windows``, and a longer batch
  runs in chunks of the cap. Each request gets its slice of the output.
- ``FoleyServer`` wraps it in a ``ThreadingHTTPServer``:

    POST /generate        {"features": [[512 floats], ...]} (T × 512)
    POST /generate_video  raw video bytes, turned into features by the
                          server's ``feature_fn``; 501 without one
    POST /continue        {"features", "known_spec" (mels × frames) or
                          "known_wav" (at the pipeline's rate, "sr"),
                          "known_seconds"}
    GET  /healthz

  A reply is {"sr", "num_samples", "wav"} (floats in [-1, 1]); bad input
  answers 400, an unknown path 404, a failed generation 500.

Each batch, and each continuation, takes its seed from a lock-guarded
counter that starts at ``seed`` (the JAX package splits a PRNG key
instead). A batch that fails reports its exception to every request in it;
nothing falls back to the CPU or to a plain version.

On a meshed pipeline (``DiffFoleyPipeline(mesh=…)``) the buckets, and the
cap, are rounded up to a multiple of the data degree (JAX :53-58,
121-132, 152-154). The port is SPMD, so every rank must enter the same
collective calls: the engine and the ``FoleyServer`` run on rank 0, which
broadcasts each pipeline call (method and arguments) before it makes it,
and every other rank runs ``follow(pipe)``, which makes the same calls
until the engine's ``stop`` broadcasts the end. A failed call leaves the
ranks' collectives out of step: a follower re-raises its failure (its
process ends, and the launcher or the group's closed connections end the
others), and rank 0's engine, after reporting its failure to the batch,
refuses every later call without entering another collective.
"""
from __future__ import annotations

import dataclasses
import json
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

import torch.distributed as dist

from .audio.transforms import wav_to_mel
from .pipeline import (SPEC_HW, WINDOW_FEATS, DiffFoleyPipeline,
                       GenerationConfig, continuation_mask, window_features)


class _Request:
    def __init__(self, feats: np.ndarray):
        self.feats = feats  # (w, WINDOW_FEATS, 512)
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        # set by the batch that ran it: its seed and bucket, and this
        # request's first window in the batch's stream
        self.seed: Optional[int] = None
        self.bucket: Optional[int] = None
        self.offset: Optional[int] = None


class BatchingEngine:
    """Collect feature windows from many requests into one device batch."""

    def __init__(self, pipe: DiffFoleyPipeline,
                 gen: GenerationConfig = GenerationConfig(
                     sample_num=1, return_spec=False, wav_dtype="int16"),
                 max_batch_windows: int = 16, max_wait_ms: float = 30.0,
                 seed: int = 0):
        self.pipe = pipe
        self.gen = gen
        # a pipeline-like object without a mesh serves on one device
        self.mesh = getattr(pipe, "mesh", None)
        self.data = 1 if self.mesh is None else self.mesh.shape["data"]
        # _run rounds each bucket up to a multiple of the data degree:
        # the cap is rounded with it, so a bucket never exceeds it
        self.max_windows = self._round(max_batch_windows)
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue[_Request]" = queue.Queue()
        # the batcher thread and the HTTP threads' continuations draw seeds
        # and run on the one device: both under locks
        self._seed = seed
        self._seed_lock = threading.Lock()
        self._device_lock = threading.Lock()
        # on a mesh: the failure that put the ranks out of step
        self._failed: Optional[str] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _round(self, b: int) -> int:
        return -(-int(b) // self.data) * self.data

    def _call(self, method: str, *args):
        """``pipe.<method>(*args)``, announced to the followers first on a
        mesh; under the device lock, so that every rank makes the calls
        in one order. On a mesh, a call after a failed one raises."""
        with self._device_lock:
            if self.mesh is None:
                return getattr(self.pipe, method)(*args)
            if self._failed:
                raise RuntimeError(f"the meshed engine stopped after a "
                                   f"failed call: {self._failed}")
            dist.broadcast_object_list([(method, args)], src=0)
            try:
                return getattr(self.pipe, method)(*args)
            except Exception as e:
                self._failed = f"{method}: {type(e).__name__}: {e}"
                raise

    def _next_seed(self) -> int:
        with self._seed_lock:
            seed, self._seed = self._seed, self._seed + 1
        return seed

    def enqueue(self, feats: np.ndarray) -> _Request:
        """Queue (T, 512) features (the ragged tail dropped) and return
        the request: its ``event`` is set once ``result`` or ``error`` is
        in."""
        w = feats.shape[0] // WINDOW_FEATS
        if w < 1:
            raise ValueError(f"need ≥{WINDOW_FEATS} features, got "
                             f"{feats.shape[0]}")
        req = _Request(feats[:w * WINDOW_FEATS].reshape(
            w, WINDOW_FEATS, -1).astype(np.float32))
        self._q.put(req)
        return req

    def submit(self, feats: np.ndarray, timeout: float = 120.0) -> np.ndarray:
        """(T, 512) features → (n_windows·WINDOW_SAMPLES,) waveform."""
        req = self.enqueue(feats)
        if not req.event.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch: List[_Request] = [first]
            n_windows = first.feats.shape[0]
            deadline = time.monotonic() + self.max_wait
            while n_windows < self.max_windows and time.monotonic() < deadline:
                try:
                    nxt = self._q.get(
                        timeout=max(deadline - time.monotonic(), 0.001))
                except queue.Empty:
                    break
                batch.append(nxt)
                n_windows += nxt.feats.shape[0]
            self._run(batch)

    def aot_warmup(self, buckets=None) -> dict:
        """One warm call for every bucket this engine can hit (the
        power-of-two ladder up to ``max_batch_windows``):
        ``DiffFoleyPipeline.aot_warmup``'s {bucket: (status, seconds)}."""
        if buckets is None:
            buckets, b = [], 1
            while b < self.max_windows:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_windows)
        buckets = list(dict.fromkeys(self._round(b) for b in buckets))
        return self._call("aot_warmup", buckets, self.gen)

    @staticmethod
    def _bucket(n: int, max_windows: int) -> int:
        """Smallest power-of-two bucket ≥ n, capped at max_windows: small
        batches do not pay the largest bucket's cost, and a longer stream
        runs in chunks of the cap (``generate``'s ``bucket_windows``)."""
        b = 1
        while b < n and b < max_windows:
            b *= 2
        return min(b, max_windows)

    def _run(self, batch: List[_Request]):
        try:
            feats = np.concatenate([r.feats for r in batch], axis=0)
            n_windows = feats.shape[0]
            bucket = self._round(self._bucket(n_windows, self.max_windows))
            seed = self._next_seed()
            # the bucketed path pads, chunks and trims: the output covers
            # exactly n_windows
            out = self._call("generate", feats.reshape(-1, feats.shape[-1]),
                             seed, self.gen, None, None, bucket)
            wav = out["wav"][0]  # sample 0, every window in time
            win_len = wav.shape[-1] // n_windows
            i = 0
            for r in batch:
                w = r.feats.shape[0]
                r.seed, r.bucket, r.offset = seed, bucket, i
                r.result = wav[i * win_len:(i + w) * win_len]
                i += w
        except Exception as e:  # every request of the batch hears of it
            for r in batch:
                r.error = f"{type(e).__name__}: {e}"
        finally:
            for r in batch:
                r.event.set()

    def continue_audio(self, feats: np.ndarray, known_spec: np.ndarray,
                       known_seconds: float) -> np.ndarray:
        """Keep the first ``known_seconds`` of ``known_spec`` (a normalised
        mel image, tiled to the features' length) and regenerate the rest
        against ``feats``, by the masked path (``inpaint``): the engine's
        sampler when it is "ddim" or "ancestral", else DDIM. Runs
        unbatched: continuations are rare next to plain generation."""
        gen = self.gen
        if gen.sampler not in ("ddim", "ancestral"):
            gen = dataclasses.replace(gen, sampler="ddim")
        feats = np.asarray(feats, np.float32)
        need = window_features(feats).shape[0] * SPEC_HW[1]
        known_spec = np.asarray(known_spec, np.float32)
        if known_spec.ndim != 2 or known_spec.shape[0] != SPEC_HW[0]:
            raise ValueError(f"known_spec must be ({SPEC_HW[0]}, frames), "
                             f"got {known_spec.shape}")
        if known_spec.shape[1] < need:
            known_spec = np.tile(known_spec,
                                 (1, -(-need // known_spec.shape[1])))
        known_spec = known_spec[:, :need]
        frames = int(round(known_seconds * self.pipe.melspec.sr
                           / self.pipe.melspec.hop_length))
        mask = continuation_mask(need, min(frames, need))
        seed = self._next_seed()
        out = self._call("inpaint", feats, known_spec, mask, seed, gen)
        return out["wav"][0]

    def stop(self):
        """Stop the batcher, and on a mesh release the followers (unless a
        failed call has put them out of step)."""
        self._stop.set()
        self._thread.join(timeout=2)
        if self.mesh is not None:
            with self._device_lock:
                if not self._failed:
                    dist.broadcast_object_list([None], src=0)


def follow(pipe: DiffFoleyPipeline) -> int:
    """A rank > 0 of a meshed engine: make each pipeline call rank 0's
    engine announces, until its ``stop``. Returns the calls made. A call
    that fails raises: this rank's collectives are out of step with rank
    0's, so the loop cannot go on."""
    calls = 0
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] is None:
            return calls
        method, args = msg[0]
        calls += 1
        try:
            getattr(pipe, method)(*args)
        except Exception as e:
            raise RuntimeError(f"rank {dist.get_rank()}: announced call "
                               f"{calls} ({method}) failed") from e


def _wav_reply(sr: int, wav: np.ndarray) -> dict:
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32767.0
    return {"sr": sr, "num_samples": int(wav.shape[-1]),
            "wav": wav.astype(float).round(6).tolist()}


class FoleyServer:
    """Stdlib HTTP front end for the batching engine."""

    def __init__(self, engine: BatchingEngine, host="127.0.0.1", port=8787,
                 feature_fn=None):
        """``feature_fn(video_path) -> (T, 512) np.ndarray`` enables the
        /generate_video route (``DiffFoley.extract_features``, say)."""
        self.engine = engine
        eng = engine

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                else:
                    self._send(404, {"error": "not found"})

            def _body(self) -> bytes:
                return self.rfile.read(int(self.headers.get(
                    "Content-Length", 0)))

            def do_POST(self):
                try:
                    sr = eng.pipe.melspec.sr
                    if self.path == "/generate":
                        feats = np.asarray(json.loads(self._body())[
                            "features"], np.float32)
                        if feats.ndim != 2 or feats.shape[1] != 512:
                            raise ValueError(f"features must be (T, 512), "
                                             f"got {feats.shape}")
                    elif self.path == "/generate_video":
                        if feature_fn is None:
                            self._send(501, {"error": "server built without "
                                                      "a feature_fn"})
                            return
                        with tempfile.NamedTemporaryFile(suffix=".mp4") as tmp:
                            tmp.write(self._body())
                            tmp.flush()
                            feats = np.asarray(feature_fn(tmp.name),
                                               np.float32)
                    elif self.path == "/continue":
                        payload = json.loads(self._body())
                        feats = np.asarray(payload["features"], np.float32)
                        if "known_spec" in payload:
                            spec = np.asarray(payload["known_spec"],
                                              np.float32)
                        elif "known_wav" in payload:
                            if int(payload.get("sr", sr)) != sr:
                                raise ValueError(f"known_wav must be {sr} "
                                                 f"Hz, got {payload['sr']}")
                            wav = torch.as_tensor(np.asarray(
                                payload["known_wav"], np.float32),
                                device=eng.pipe.device)
                            spec = wav_to_mel(wav, eng.pipe.melspec).cpu(
                                ).numpy()
                        else:
                            raise KeyError("known_spec or known_wav")
                        self._send(200, _wav_reply(sr, eng.continue_audio(
                            feats, spec, float(payload["known_seconds"]))))
                        return
                    else:
                        self._send(404, {"error": "not found"})
                        return
                    self._send(200, _wav_reply(sr, eng.submit(feats)))
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    self._send(500, {"error": str(e)})

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
