"""SpecAugment, time and frequency stripe dropout
(``diff_foley_tpu/ops/spec_augment.py``; the reference's DropStripes on
both axes, PANN's defaults).

Per sample and axis, ``stripes`` widths w ~ randint[0, drop_width) and
starts ⌊u·max(axis_len − w, 1)⌋ with u ~ U[0, 1): the start depends on
the sampled width, so a stripe can end at the axis edge, and a
drop_width over the axis length gives no negative start. A drop width or
stripe count of 0 leaves the axis unmasked. The draws come from the
caller's ``generator``, or are given as ``draws`` ({"time": (widths, u),
"freq": (widths, u)}, each (B, stripes)) to replay another stream's.
"""
from __future__ import annotations

from typing import Optional

import torch


def _cover(widths: torch.Tensor, u: torch.Tensor, axis_len: int):
    """(B, axis_len) True where a stripe covers the position."""
    starts = torch.floor(u * torch.clamp(axis_len - widths, min=1)).long()
    pos = torch.arange(axis_len, device=widths.device)
    return ((pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
            ).any(dim=1)


def spec_augment(spec: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 time_drop_width: int = 64, time_stripes: int = 2,
                 freq_drop_width: int = 8, freq_stripes: int = 2,
                 draws: Optional[dict] = None) -> torch.Tensor:
    """(B, n_mels, T) → the masked copy."""
    b, m, t = spec.shape
    keep = torch.ones_like(spec)
    for axis, (axis_len, width, n) in (
            ("time", (t, time_drop_width, time_stripes)),
            ("freq", (m, freq_drop_width, freq_stripes))):
        if width <= 0 or n <= 0:
            continue
        if draws is not None:
            widths, u = (torch.as_tensor(a, device=spec.device)
                         for a in draws[axis])
        else:
            widths = torch.randint(0, width, (b, n), generator=generator,
                                   device=spec.device)
            u = torch.rand((b, n), generator=generator, device=spec.device)
        cover = _cover(widths, u, axis_len)
        shape = (b, 1, axis_len) if axis == "time" else (b, axis_len, 1)
        keep = keep * (~cover).reshape(shape).to(spec.dtype)
    return spec * keep
