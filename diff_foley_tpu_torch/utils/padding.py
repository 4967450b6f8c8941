"""Axis-0 padding (``diff_foley_tpu/utils/padding.py``): pad a batch to a
row count, or to a multiple of one, by repeating its last row, numpy
only. Bucketed generation and align-acc share these semantics."""
from __future__ import annotations

import numpy as np


def pad_axis0(x: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to exactly ``n`` rows by repeating the last row."""
    x = np.asarray(x)
    if x.shape[0] >= n:
        return x
    pad = np.repeat(x[-1:], n - x.shape[0], axis=0)
    return np.concatenate([x, pad], axis=0)


def pad_axis0_to_multiple(x: np.ndarray, k: int) -> np.ndarray:
    """Pad axis 0 up to the next multiple of ``k`` (repeat-last-row)."""
    x = np.asarray(x)
    return pad_axis0(x, -(-x.shape[0] // k) * k)
