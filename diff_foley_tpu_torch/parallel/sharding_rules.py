"""Which dim of each trained tensor is split, and over which mesh axis
(``diff_foley_tpu/parallel/sharding_rules.py``).

- Tensor parallelism over ``model`` (JAX :20-50): ``to_q``/``to_k``/
  ``to_v`` by column (output features, head-parallel), ``to_out`` by row
  (input features, summed over the group); GEGLU's ``proj_x``/
  ``proj_gate`` by column and the feed-forward's ``out`` by row; the time
  embedding's ``dense0`` by column and ``dense1`` by row. The rest, biases
  and norms included, is whole on every rank. ``tensor_parallel_`` slices
  those layers in place and puts the ``collectives`` pair around them.
- FSDP over ``data`` (JAX :83-145): a tensor of at least
  ``FSDP_MIN_SIZE`` elements is split on its largest dim that the data
  degree divides and the model axis does not own, ties to the higher
  index; masters, AdamW's moments and the EMA share the split
  (``FsdpLayout``).

Both rules are the JAX package's, on the flax layout: Dense kernels (in,
out), convolution kernels HWIO (tHWIO). The port stores (out, in) and
OIHW (``utils/convert.py``), where a square Dense would break the tie the
other way, so each spec is taken on the flax view of the tensor and mapped
back through the converter's transposes.

JAX's ``_spec_for``/``param_shardings`` are ``tp_spec``/``param_specs
(tp=True)`` here, ``fsdp_shardings`` is ``param_specs(fsdp=True)`` and
``shard_state_fsdp`` is ``FsdpLayout``, which ``train/stage2_ldm.py``
applies to the masters, AdamW's moments and the EMA alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.attention import CrossAttention
from ..models.layers import Dense, _cast, _promote
from .collectives import all_gather, copy_to_model, reduce_from_model

COL = {"to_q", "to_k", "to_v"}        # shard the kernel's output dim
ROW = {"to_out"}                      # shard the kernel's input dim
FSDP_MIN_SIZE = 2**15  # smaller tensors stay whole (the gather's overhead)

# torch dim of each flax dim of a kernel (flax = torch.permute(perm))
_KERNEL_PERMS = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def flax_view(name: str, shape: Sequence[int]):
    """A state-dict entry as the JAX package sees it → (path names, flax
    shape, perm), ``perm[i]`` the torch dim of flax dim i."""
    names = name.split(".")
    perm = tuple(range(len(shape)))
    if names[-1] == "weight" and len(shape) in _KERNEL_PERMS:
        names[-1], perm = "kernel", _KERNEL_PERMS[len(shape)]
    return names, tuple(int(shape[i]) for i in perm), perm


def tp_spec(names: Sequence[str], ndim: int) -> Tuple:
    """The flax-layout spec of one leaf under the TP rules (JAX
    ``_spec_for``): a tuple of ``ndim`` entries, "model" or None."""
    none = (None,) * ndim
    if ndim < 2 or names[-1] != "kernel":
        return none
    parent = names[-2] if len(names) >= 2 else ""
    col, row = (None, "model"), ("model", None)
    if parent in COL:
        return col
    if parent in ROW:
        return row
    if parent in ("proj_x", "proj_gate") and "geglu" in names:
        return col
    if parent == "out" and "ff" in names:
        return row
    if parent == "dense0" and "time_embed" in names:
        return col
    if parent == "dense1" and "time_embed" in names:
        return row
    return none


def fsdp_spec(shape: Sequence[int], n_shard: int, axis: str = "data",
              min_size: int = FSDP_MIN_SIZE,
              base: Optional[Sequence] = None) -> Tuple:
    """``base`` (a TP spec, or all None) with ``axis`` on the largest free
    dim that ``n_shard`` divides, ties to the higher index; unchanged for a
    tensor under ``min_size`` elements, at ``n_shard`` 1, or with no such
    dim (JAX ``fsdp_spec``)."""
    dims = list(base) if base is not None else []
    dims += [None] * (len(shape) - len(dims))
    size = 1
    for s in shape:
        size *= int(s)
    if size < min_size or n_shard <= 1:
        return tuple(dims)
    cands = [(int(shape[i]), i) for i in range(len(shape))
             if dims[i] is None and shape[i] % n_shard == 0]
    if cands:
        dims[max(cands)[1]] = axis
    return tuple(dims)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One tensor's split: the flax-layout spec, and the torch dims the
    ``model`` and ``data`` axes own (None: whole)."""

    flax: Tuple
    tp_dim: Optional[int]
    fsdp_dim: Optional[int]


def param_specs(shapes: Dict[str, Sequence[int]], n_data: int,
                tp: bool = False, fsdp: bool = False,
                min_size: int = FSDP_MIN_SIZE) -> Dict[str, LeafSpec]:
    """The split of each tensor of ``shapes`` (name → the whole tensor's
    shape): the TP rules when ``tp``, then FSDP over ``n_data`` on a dim
    they leave free when ``fsdp`` (JAX ``fsdp_shardings`` with
    ``base_specs=param_shardings``)."""
    out = {}
    for name, shape in shapes.items():
        names, fshape, perm = flax_view(name, shape)
        spec = tp_spec(names, len(fshape)) if tp else (None,) * len(fshape)
        if fsdp:
            spec = fsdp_spec(fshape, n_data, "data", min_size, spec)
        dim = lambda axis: (perm[spec.index(axis)] if axis in spec
                            else None)
        out[name] = LeafSpec(spec, dim("model"), dim("data"))
    return out


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of a tensor split on ``dim``, joined."""
    moved = all_gather(x.movedim(dim, 0).contiguous(), group)
    return moved.movedim(0, dim).contiguous()


def _shard_dim(x: torch.Tensor, dim: int, n: int, index: int):
    k = x.shape[dim] // n
    return x.narrow(dim, index * k, k).contiguous()


class FsdpLayout:
    """The data-axis split of the trained tensors by name: ``shard`` cuts
    this rank's part of a whole (TP-local) tensor, ``gather`` joins the
    parts, ``reduce_scatter_mean`` turns a whole gradient into this rank's
    part of its mean over the data group. Tensors the rule leaves whole
    pass through."""

    def __init__(self, specs: Dict[str, LeafSpec], mesh):
        self.specs = specs
        self.group = mesh.data_group
        self.n, self.index = mesh.shape["data"], mesh.data_index

    def dim(self, name: str) -> Optional[int]:
        return self.specs[name].fsdp_dim

    def shard(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        d = self.dim(name)
        return whole if d is None else _shard_dim(whole, d, self.n,
                                                  self.index)

    def gather(self, name: str, part: torch.Tensor) -> torch.Tensor:
        d = self.dim(name)
        return part if d is None else _gather_dim(part, d, self.group)

    def reduce_scatter_mean(self, name: str, grad: torch.Tensor):
        d = self.dim(name)
        moved = grad.movedim(d, 0).contiguous()
        out = moved.new_empty((moved.shape[0] // self.n, *moved.shape[1:]))
        dist.reduce_scatter_tensor(out, moved, group=self.group)
        return out.div_(self.n).movedim(0, d).contiguous()


def gather_tp(specs: Dict[str, LeafSpec], name: str, local: torch.Tensor,
              mesh) -> torch.Tensor:
    """The whole tensor of a TP-split one (the model group's slices)."""
    d = specs[name].tp_dim
    if d is None or mesh is None or mesh.model_group is None:
        return local
    return _gather_dim(local, d, mesh.model_group)


def shard_tp(specs: Dict[str, LeafSpec], name: str, whole: torch.Tensor,
             mesh) -> torch.Tensor:
    d = specs[name].tp_dim
    if d is None or mesh is None or mesh.shape["model"] == 1:
        return whole
    return _shard_dim(whole, d, mesh.shape["model"], mesh.model_index)


class ColumnParallelDense(Dense):
    """A Dense holding its rank's slice of the output features' weight and
    the whole bias (biases stay whole under the JAX rules): the input and
    the bias copied to the model group (their gradients summed over it:
    each rank's bias gradient is its slice's), this rank's slice of the
    bias added."""

    def forward(self, x):
        x = copy_to_model(x, self.group)
        dt = _promote(x, self.weight, self.bias)
        b = self.bias
        if b is not None:
            k = self.weight.shape[0]
            b = copy_to_model(b, self.group).narrow(0, self.index * k, k)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(b, dt))


class RowParallelDense(Dense):
    """A Dense holding its rank's slice of the input features: the partial
    products summed over the model group, then the whole bias."""

    def forward(self, x):
        dt = _promote(x, self.weight, self.bias)
        y = reduce_from_model(F.linear(x.to(dt), self.weight.to(dt)),
                              self.group)
        return y if self.bias is None else y + _cast(self.bias, dt)


def tensor_parallel_(module: nn.Module, mesh, prefix: str = "",
                     specs: Optional[Dict[str, LeafSpec]] = None) -> dict:
    """Split ``module``'s TP layers over ``mesh``'s model group in place:
    each matching Dense becomes a Column/RowParallelDense with this rank's
    slice of its weight (the bias stays whole), and each CrossAttention
    runs heads / n_model local heads.
    ``prefix`` is the module's name in the trained state (``"unet."``).
    ``specs`` (``param_specs(tp=True)`` of the whole tensors, taken here
    when None) decide the split; they are returned."""
    n = mesh.shape["model"]
    if specs is None:
        shapes = {prefix + k: p.shape for k, p in module.named_parameters()}
        specs = param_specs(shapes, mesh.shape["data"], tp=True)
    for name, child in list(module.named_modules()):
        if isinstance(child, CrossAttention):
            if child.heads % n:
                raise ValueError(f"{name}: {child.heads} heads do not "
                                 f"divide over model {n}")
            child.heads //= n
        if type(child) is not Dense:
            continue
        spec = specs[prefix + name + ".weight"].flax
        if "model" not in spec:
            continue
        col = spec[1] == "model"
        w = child.weight.detach()
        b = None if child.bias is None else child.bias.detach()
        new = (ColumnParallelDense if col else RowParallelDense)(
            w.shape[1] // (1 if col else n), w.shape[0] // (n if col else 1),
            bias=b is not None)
        if b is not None:
            new.bias = torch.nn.Parameter(torch.empty_like(b))
        new.group, new.index = mesh.model_group, mesh.model_index
        with torch.no_grad():
            new.to(w.device)
            new.weight.copy_(_shard_dim(w, 0 if col else 1, n,
                                        mesh.model_index))
            if b is not None:
                new.bias.copy_(b)
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, new)
    return specs
