"""Host-side batch loading (``diff_foley_tpu/data/loader.py``): per-process
index sharding and threaded prefetch, numpy only (``PrefetchLoader``), and
the staging of batches onto the device ahead of the step that reads them
(``DevicePrefetcher``).

Each process loads only its shard of the global batch (``shard_indices``),
worker threads overlap IO and augmentation with device compute, and
batches come out as stacked numpy arrays.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch


def shard_indices(
    n: int,
    batch_size: int,
    *,
    process_index: int = 0,
    process_count: int = 1,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = True,
) -> np.ndarray:
    """Deterministic per-epoch shuffle keyed on (seed, epoch), split by
    process; every process sees the same number of batches."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    order = rng.permutation(n)
    per_host = n // process_count
    mine = order[process_index * per_host : (process_index + 1) * per_host]
    if drop_last:
        mine = mine[: (len(mine) // batch_size) * batch_size]
    return mine


def _collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {
        k: np.stack([s[k] for s in samples]) for k in samples[0]
    }


class PrefetchLoader:
    """Threaded map-style loader: ``dataset[idx]`` in worker threads,
    collated batches out of a bounded queue, in order."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        num_workers: int = 4,
        prefetch: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        seed: int = 0,
        collate: Callable = _collate,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.seed = seed
        self.collate = collate

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        idx = shard_indices(
            len(self.dataset), self.batch_size,
            process_index=self.process_index, process_count=self.process_count,
            seed=self.seed, epoch=epoch,
        )
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        work_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            work_q.put((bi, b))
        results: Dict[int, Dict] = {}
        lock = threading.Lock()
        next_emit = [0]
        stop = threading.Event()

        emitting = [False]
        # bound on completed-but-unemitted batches: one slow head-of-line
        # batch must not let the other workers buffer the whole epoch
        window = self.prefetch + self.num_workers

        def _put(item) -> bool:
            # bounded put that never holds `lock` and honours early stop
            # (consumer abandoning the generator mid-epoch)
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                try:
                    bi, b = work_q.get_nowait()
                except queue.Empty:
                    return
                # throttle: wait until this ticket is within the emission
                # window (tickets are FIFO, so this bounds `results`)
                while not stop.is_set():
                    with lock:
                        if bi < next_emit[0] + window:
                            break
                    stop.wait(0.05)
                if stop.is_set():
                    return
                try:
                    batch = self.collate([self.dataset[int(i)] for i in b])
                except Exception as e:  # propagate instead of hanging the consumer
                    batch = e
                with lock:
                    results[bi] = batch
                # in-order drain; only one worker emits at a time, and the
                # blocking put happens OUTSIDE the lock
                while not stop.is_set():
                    with lock:
                        if emitting[0] or next_emit[0] not in results:
                            break
                        item = results.pop(next_emit[0])
                        emitting[0] = True
                    ok = _put(item)
                    with lock:
                        emitting[0] = False
                        if ok:
                            next_emit[0] += 1
                    if not ok:
                        return

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            for _ in range(len(batches)):
                item = out_q.get()
                if isinstance(item, Exception):
                    raise RuntimeError("dataset worker failed") from item
                yield item
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)

    def __len__(self):
        idx = shard_indices(
            len(self.dataset), self.batch_size,
            process_index=self.process_index, process_count=self.process_count,
            seed=self.seed, epoch=0,
        )
        return len(idx) // self.batch_size


class DevicePrefetcher:
    """Batch k + 1 staged on the device while the step runs on batch k.

    A feeder thread takes each dict-of-ndarray batch, casts its float32
    arrays to ``cast_dtype`` on the host (bf16 under mixed precision halves
    the bytes the copy moves; the trainer casts to its compute type
    anyway), copies them into pinned memory and issues the copies to
    ``device`` with ``non_blocking=True`` on a side stream, then records an
    event. The consumer's stream waits on that event before the batch is
    handed out, and each tensor is recorded on the consumer's stream, so
    the caching allocator does not reuse its memory while the step still
    reads it. On the CPU the batch is cast and handed out as is. A failure
    in the feeder is raised in the consumer; a consumer that stops early
    releases the feeder.

        for batch in DevicePrefetcher(loader.epoch(e), device="cuda",
                                      cast_dtype=torch.bfloat16):
            metrics = trainer.train_step(state, batch, generator)
    """

    depth = 2   # batches staged ahead

    def __init__(self, it: Iterator[Dict], *, device,
                 cast_dtype: Optional[torch.dtype] = None):
        self._it = it
        self._device = torch.device(device)
        self._dtype = cast_dtype

    def _host(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if self._dtype is not None and t.dtype == torch.float32:
                t = t.to(self._dtype)
            out[k] = t
        return out

    def _stage(self, batch, stream):
        host = self._host(batch)
        if stream is None:
            return host, None
        with torch.cuda.stream(stream):
            out = {k: t.pin_memory().to(self._device, non_blocking=True)
                   for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        done = object()
        stream = (torch.cuda.Stream(self._device)
                  if self._device.type == "cuda" else None)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            try:
                for batch in self._it:
                    if not put(self._stage(batch, stream)):
                        return
            except Exception as e:  # raised in the consumer, never a hang
                put(e)
                return
            put(done)

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise RuntimeError("device prefetch failed") from item
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self._device)
                    current.wait_event(event)
                    for v in batch.values():
                        v.record_stream(current)
                yield batch
        finally:
            stop.set()
            t.join(timeout=5.0)
