"""A big latent canvas in overlapping tiles (``diff_foley_tpu/diffusion/
tiled.py``): unfold into ks-tiles, run a function on all of them at once,
weight each tile by its distance to the border and fold with the folded
weights as the normalisation (the reference's ddpm.py:581-668, 749-786 and
936-1018).

Tensors are NCHW here. All L tiles of a batch go through the function as
ONE call on the batch axis (L·B rows); the fold adds the tiles back in
grid order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SplitInputParams:
    """The reference's split_input_params, at SD's defaults."""

    ks: Tuple[int, int] = (16, 16)
    stride: Tuple[int, int] = (8, 8)
    vqf: int = 8   # the first stage's upsampling factor
    clip_min_weight: float = 0.01
    clip_max_weight: float = 0.5
    tie_braker: bool = True
    clip_min_tie_weight: float = 0.01
    clip_max_tie_weight: float = 0.5


def delta_border(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w) float32 distance to the nearest border, normalised: 0 there,
    0.5 at the centre."""
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None] \
        / max(h - 1, 1)
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :] \
        / max(w - 1, 1)
    yy, xx = y.expand(h, w), x.expand(h, w)
    return torch.minimum(torch.minimum(yy, xx),
                         torch.minimum(1.0 - yy, 1.0 - xx))


def get_weighting(kh: int, kw: int, ly: int, lx: int, p: SplitInputParams,
                  device=None) -> torch.Tensor:
    """(ly·lx, kh, kw) blending weights: the tile's border distance clamped
    to [clip_min_weight, clip_max_weight], times, with ``tie_braker``, the
    tile's own position in the grid clamped to the tie range."""
    w = delta_border(kh, kw, device).clamp(p.clip_min_weight,
                                           p.clip_max_weight)
    w = w[None].expand(ly * lx, kh, kw)
    if p.tie_braker:
        tie = delta_border(ly, lx, device).clamp(
            p.clip_min_tie_weight, p.clip_max_tie_weight).reshape(ly * lx)
        w = w * tie[:, None, None]
    return w


def _grid(h: int, w: int, ks, stride):
    ly = (h - ks[0]) // stride[0] + 1
    lx = (w - ks[1]) // stride[1] + 1
    offsets = [(iy * stride[0], ix * stride[1])
               for iy in range(ly) for ix in range(lx)]
    return offsets, ly, lx


def unfold_patches(x: torch.Tensor, ks, stride) -> torch.Tensor:
    """(B, C, H, W) → (L, B, C, kh, kw) overlapping tiles (torch.nn.Unfold
    with padding 0 and dilation 1, tile-major)."""
    offsets, _, _ = _grid(x.shape[2], x.shape[3], ks, stride)
    return torch.stack([x[:, :, oy:oy + ks[0], ox:ox + ks[1]]
                        for oy, ox in offsets])


def fold_patches(patches: torch.Tensor, out_hw, ks, stride) -> torch.Tensor:
    """(L, B, C, kh, kw) → (B, C, H, W) overlap-add (torch.nn.Fold), the
    tiles added in grid order."""
    offsets, _, _ = _grid(out_hw[0], out_hw[1], ks, stride)
    _, b, c, kh, kw = patches.shape
    out = patches.new_zeros((b, c, out_hw[0], out_hw[1]))
    for i, (oy, ox) in enumerate(offsets):
        out[:, :, oy:oy + kh, ox:ox + kw] += patches[i]
    return out


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                p: SplitInputParams, uf: int = 1) -> torch.Tensor:
    """``fn`` over the overlapping ks-tiles of the NCHW canvas ``x``,
    blended by the border weighting; ``uf`` scales the output canvas (the
    decoder's vqf). ``fn`` maps (N, C, kh, kw) → (N, C', kh·uf, kw·uf)
    and is called once, on all L·B tiles (tile-major)."""
    b, _, h, w = x.shape
    # ks and stride clamped to the canvas, as the reference does
    ks = (min(p.ks[0], h), min(p.ks[1], w))
    stride = (min(p.stride[0], h), min(p.stride[1], w))
    # tiles that miss a strip would leave it 0/0 in the normalised fold
    if (h - ks[0]) % stride[0] or (w - ks[1]) % stride[1]:
        raise ValueError(f"canvas {h}x{w} is not covered by ks={ks}, "
                         f"stride={stride}: (dim - ks) must be divisible by "
                         "stride")
    offsets, ly, lx = _grid(h, w, ks, stride)
    n_tiles = len(offsets)
    tiles = unfold_patches(x, ks, stride)
    out = fn(tiles.reshape(n_tiles * b, *tiles.shape[2:]))
    out = out.reshape(n_tiles, b, *out.shape[1:])
    ks_o = (ks[0] * uf, ks[1] * uf)
    stride_o = (stride[0] * uf, stride[1] * uf)
    weighting = get_weighting(*ks_o, ly, lx, p, x.device)   # (L, kh', kw')
    out = out * weighting[:, None, None]
    out_hw = (h * uf, w * uf)
    folded = fold_patches(out, out_hw, ks_o, stride_o)
    norm = fold_patches(weighting[:, None, None], out_hw, ks_o, stride_o)
    return folded / norm
