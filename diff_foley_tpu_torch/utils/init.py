"""Seeded random weights, for runs and tests without a checkpoint.

A fresh flax init zeroes several output layers (ResBlock ``out_conv``,
SpatialTransformer ``proj_out``, the UNet's ``out_conv``), which makes a
model blind to its attention: a comparison on such weights passes without
testing anything. These helpers give every parameter seeded numpy values
instead: products' weights N(0, 1/fan_in), normalisation scales
1 + N(0, 0.1²), biases N(0, 0.1²), positional embeddings N(0, 1), and
BatchNorm's running statistics a mean N(0, 0.1²) and a positive variance
1 + 0.1·|N(0, 1)|.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _draw(rng: np.random.Generator, kind: str, shape, fan_in: int):
    z = rng.standard_normal(size=shape, dtype=np.float32)
    if kind == "weight":
        return z / np.float32(np.sqrt(max(fan_in, 1)))
    if kind == "scale":
        return 1.0 + np.float32(0.1) * z
    if kind in ("bias", "mean"):
        return np.float32(0.1) * z
    if kind == "var":
        return 1.0 + np.float32(0.1) * np.abs(z)
    return z


def random_flax_params(tree, seed: int = 0):
    """A flax params tree (or a ``batch_stats`` tree: its ``mean`` and
    ``var`` leaves) of the same structure with seeded float32 numpy values
    (fan-in of a kernel: all axes but the last)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for name, v in node.items():
            if isinstance(v, Mapping):
                out[name] = walk(v)
                continue
            shape = tuple(np.shape(v))
            kind = {"kernel": "weight", "scale": "scale", "bias": "bias",
                    "mean": "mean", "var": "var"}.get(name, "other")
            out[name] = _draw(rng, kind, shape, int(np.prod(shape[:-1])))
        return out

    return walk(tree)


@torch.no_grad()
def randomize_(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Give every parameter of ``module`` seeded values, in place (fan-in
    of a weight: all axes but the first), then BatchNorm's running
    statistics, drawn after all the parameters so that a model's
    parameters do not depend on its BatchNorms."""
    rng = np.random.default_rng(seed)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(p.shape)
        if leaf == "weight":
            kind = "weight" if p.dim() >= 2 else "scale"
        else:
            kind = "bias" if leaf == "bias" else "other"
        a = _draw(rng, kind, shape, int(np.prod(shape[1:])))
        p.copy_(torch.from_numpy(a))
    for name, b in module.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("running_mean", "running_var"):
            kind = "mean" if leaf == "running_mean" else "var"
            b.copy_(torch.from_numpy(_draw(rng, kind, tuple(b.shape), 1)))
    return module
