"""The ``data`` × ``model`` process mesh
(``diff_foley_tpu/parallel/mesh.py``).

Ranks are laid out as the JAX package lays out devices,
``devices.reshape(n_data, n_model)``: rank = d·n_model + m. A rank's
``data`` group holds the ranks of its model index (they split the batch),
its ``model`` group those of its data index (they split the tensor-parallel
layers and see the same rows).

The port is SPMD: each rank's loader already yields its local batch (the
JAX package's multi-process branch), so ``shard_batch`` takes this rank's
rows of a batch every rank holds whole, and ``replicate`` broadcasts from
rank 0. ``data_sharding``/``replicated_sharding`` name XLA layouts and have
no counterpart: a tensor here lives on its rank's device.

Random draws of a meshed step are the one-process draws: inside
``global_rows`` every ``draw_rows`` draws the global batch's rows from the
(shared) generator and keeps this rank's.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """``shape`` {"data": n_data, "model": n_model}, this rank's
    coordinates and its two groups (None without a process group: the
    collectives of ``parallel/`` are then skipped)."""

    shape: dict
    rank: int
    data_index: int
    model_index: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    def group(self, axis: str):
        return {"data": self.data_group, "model": self.model_group}[axis]

    def rows(self, n: int) -> slice:
        """This rank's rows of an n-row global batch (n divides)."""
        d = self.shape["data"]
        if n % d:
            raise ValueError(f"{n} rows do not divide over data {d}")
        k = n // d
        return slice(self.data_index * k, (self.data_index + 1) * k)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh over the process group (one device a rank), or the
    one-rank mesh without one. Every rank must call it: it creates the
    groups in the same order everywhere."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model}"
                         f" ranks, the group has {world}")
    mesh = Mesh({"data": n_data, "model": n_model}, rank, rank // n_model,
                rank % n_model)
    if dist.is_initialized():
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == mesh.model_index:
                mesh.data_group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == mesh.data_index:
                mesh.model_group = g
    return mesh


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every leaf (a dict or a tensor) of a global
    batch."""
    take = lambda x: x[mesh.rows(x.shape[0])]
    return {k: take(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else take(tree)


def replicate(mesh: Mesh, tree):
    """Rank 0's values of every tensor of ``tree``, in place."""
    if mesh.data_group is None and mesh.model_group is None:
        return tree
    leaves = tree.values() if isinstance(tree, dict) else [tree]
    for t in leaves:
        dist.broadcast(t, 0)
    return tree


_ROWS = contextvars.ContextVar("global_rows", default=None)


@contextlib.contextmanager
def global_rows(mesh: Optional[Mesh], total: Optional[int] = None):
    """Inside the block ``draw_rows`` draws a batch's global rows and keeps
    this rank's. A local batch of k rows is rows [d·k, (d + 1)·k) of the
    global one, d the data index; ``total`` (default n_data·k) is the
    global row count when the batch was padded to divide, the padded rows
    then draw zeros. No-op without a mesh or at data degree 1."""
    if mesh is None or mesh.shape["data"] == 1:
        yield
        return
    token = _ROWS.set((mesh.shape["data"], mesh.data_index, total))
    try:
        yield
    finally:
        _ROWS.reset(token)


def draw_rows(fn, shape, **kw) -> torch.Tensor:
    """``fn(shape, **kw)`` (``torch.randn``, ``torch.rand``, …) or, inside
    ``global_rows``, this rank's rows of ``fn`` at the global row count."""
    spec = _ROWS.get()
    if spec is None:
        return fn(tuple(shape), **kw)
    n, index, total = spec
    k = shape[0]
    total = n * k if total is None else total
    full = fn((total, *shape[1:]), **kw)
    mine = full[index * k:(index + 1) * k]
    if mine.shape[0] < k:
        mine = torch.cat([mine, mine.new_zeros((k - mine.shape[0],
                                                *shape[1:]))])
    return mine
