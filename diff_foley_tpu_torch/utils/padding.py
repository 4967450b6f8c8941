"""Axis-0 padding (``diff_foley_tpu/utils/padding.py``): pad a batch to a
row count by repeating its last row, numpy only."""
from __future__ import annotations

import numpy as np


def pad_axis0(x: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to exactly ``n`` rows by repeating the last row."""
    x = np.asarray(x)
    if x.shape[0] >= n:
        return x
    pad = np.repeat(x[-1:], n - x.shape[0], axis=0)
    return np.concatenate([x, pad], axis=0)

