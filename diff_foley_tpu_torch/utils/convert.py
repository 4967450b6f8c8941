"""flax parameter trees → state dicts of this package's modules.

The port's modules carry the flax scope names, so conversion is a rename
and a transpose per leaf:

- ``kernel`` → ``weight``: Dense (in, out) → (out, in); Conv HWIO → OIHW;
- ``scale`` → ``weight`` and ``bias`` → ``bias`` (normalisations; a
  ``scale`` beside a ``shift``, the LPIPS scaling layer's, keeps its name);
- BatchNorm's ``batch_stats`` collection: ``mean`` → ``running_mean`` and
  ``var`` → ``running_var``, beside the parameters of the same scope;
- ``embedding`` → ``weight``; any other leaf (``pos_emb``) keeps its name;
- the ``GroupNorm_0`` scope that ``GroupNorm32`` opens for its flax
  GroupNorm is folded into its parent.

Covers the UNet, the classifier, ``VideoFeatEncoderPosembed``, the whole
VAE, the PatchGAN discriminator and LPIPS/LPAPS. Load with ``strict=True``.
The same function carries gradients and updated parameters of a JAX train
step into the port's layout, so a test compares them leaf by leaf under
the state dict's names.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_FOLDED_SCOPES = {"GroupNorm_0"}
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "mean": "running_mean", "var": "running_var"}
_COLLECTIONS = {"params", "batch_stats"}


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaf(name: str, a) -> tuple[str, torch.Tensor]:
    t = _to_tensor(a)
    if name == "kernel":
        if t.dim() == 2:
            t = t.T
        elif t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {t.dim()} has no rule")
    return name, t.contiguous()


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """flax variables ({"params": …}, with ``batch_stats`` where the model
    has BatchNorm) or a params tree of numpy arrays → state dict."""
    if isinstance(tree, Mapping) and tree and set(tree) <= _COLLECTIONS:
        trees = list(tree.values())
    else:
        trees = [tree]
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list[str]):
        for name, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path if name in _FOLDED_SCOPES else path + [name])
            else:
                leaf, t = _leaf(name, v)
                if not (leaf == "scale" and "shift" in node):
                    leaf = _LEAF_NAMES.get(leaf, leaf)
                key = ".".join(path + [leaf])
                if key in out:
                    raise ValueError(f"two leaves map to {key}")
                out[key] = t

    for t in trees:
        walk(t, [])
    return out

