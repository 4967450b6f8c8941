"""Crash resilience (``diff_foley_tpu/utils/resilience.py``): the
preemption checkpointer, checkpoint-on-exception and a background mirror
of a directory.

``PreemptionCheckpointer`` installs SIGUSR1 and SIGTERM handlers that
only set a flag; the train loop polls
``should_checkpoint`` at each step boundary and saves there; ``close``
puts the previous handlers back.
``BackgroundSync`` copies a local directory to a destination every
``interval_s`` seconds (a local tree copy unless ``copy_fn`` says
otherwise).
"""
from __future__ import annotations

import os
import shutil
import signal
import threading
from typing import Callable, Optional


class PreemptionCheckpointer:
    def __init__(self):
        self._flag = threading.Event()
        self._previous = {s: signal.signal(s, self._handler)
                          for s in (signal.SIGUSR1, signal.SIGTERM)}

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def should_checkpoint(self) -> bool:
        return self._flag.is_set()

    def clear(self):
        self._flag.clear()

    def close(self):
        for signum, handler in self._previous.items():
            signal.signal(signum, handler)
        self._previous = {}


def checkpoint_on_exception(save_fn: Callable[[], None]):
    """Decorator: run fn, and save before re-raising its exception."""

    def deco(fn):
        def wrapped(*a, **k):
            try:
                return fn(*a, **k)
            except Exception:
                try:
                    save_fn()
                finally:
                    raise

        return wrapped

    return deco


class BackgroundSync:
    """Mirror ``src`` to ``dst`` every ``interval_s`` seconds in a daemon
    thread; ``copy_fn(src, dst)`` is pluggable (object stores)."""

    def __init__(self, src: str, dst: str, interval_s: float = 300.0,
                 copy_fn: Optional[Callable[[str, str], None]] = None):
        self.src, self.dst = src, dst
        self.interval = interval_s
        self.copy_fn = copy_fn or self._local_copy
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    @staticmethod
    def _local_copy(src: str, dst: str) -> None:
        os.makedirs(dst, exist_ok=True)
        shutil.copytree(src, dst, dirs_exist_ok=True)

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.copy_fn(self.src, self.dst)
            except Exception as e:   # keep syncing past a transient failure
                print(f"[BackgroundSync] {e}")

    def start(self):
        self._thread.start()
        return self

    def stop(self, final_sync: bool = True):
        # join before the final copy: two copies of one tree at once could
        # interleave their writes to the same files
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30)
        if final_sync:
            try:
                self.copy_fn(self.src, self.dst)
            except Exception as e:
                print(f"[BackgroundSync] final sync failed: {e}")
