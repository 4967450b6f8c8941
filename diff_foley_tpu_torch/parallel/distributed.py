"""Multi-process bootstrap (``diff_foley_tpu/parallel/distributed.py``).

The environment names the group, as the JAX package reads it: torchrun's
``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` (with
``LOCAL_RANK``), or SLURM's ``SLURM_PROCID``/``SLURM_NTASKS``/
``SLURM_NODELIST`` (port 1234, ``SLURM_LOCALID``). With neither, the
process runs alone and no process group is formed: every collective of
``parallel/`` is then skipped. With either, the group forms or the call
raises, at world size 1 too. The JAX version's TPU-pod autodetection
(an ``initialize()`` whose failure it swallows) has no counterpart.

One process drives one device: NCCL on ``cuda:LOCAL_RANK`` by default,
gloo only when the caller asks for the CPU.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _from_environment():
    """(address, port, rank, world, local rank) or None."""
    env = os.environ
    if "MASTER_ADDR" in env and "RANK" in env:
        rank = int(env["RANK"])
        return (env["MASTER_ADDR"], int(env.get("MASTER_PORT", "1234")),
                rank, int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", rank)))
    if "SLURM_PROCID" in env:
        host = env.get("SLURM_NODELIST", "localhost").split(",")[0]
        return (host.split("[")[0], 1234, int(env["SLURM_PROCID"]),
                int(env["SLURM_NTASKS"]), int(env.get("SLURM_LOCALID", 0)))
    return None


def init_distributed(device=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> dict:
    """Join (or reuse) the process group the environment names →
    {process_index, process_count, local_devices, global_devices, device}.

    ``device`` None means CUDA: the process takes ``cuda:LOCAL_RANK`` and
    NCCL, and raises without a GPU; "cpu" takes gloo. A group that
    already exists is reused. ``timeout`` bounds the rendezvous."""
    env = _from_environment()
    local = 0 if env is None else env[4]
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        index = (local if env is not None
                 else torch.device(device or "cuda").index or 0)
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
        backend, n_local = "nccl", torch.cuda.device_count()
    else:
        device, backend, n_local = torch.device(device), "gloo", 1
    if env is not None and not dist.is_initialized():
        addr, port, rank, world, _ = env
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                rank=rank, world_size=world,
                                timeout=timeout)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return {"process_index": rank, "process_count": world,
            "local_devices": n_local, "global_devices": world,
            "device": device}


def is_master() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def setup(device: str = "cuda"):
    """A CLI's process group and mesh from its ``--device`` ("cuda" or
    "cpu") → (device, mesh, rank, world). ``init_distributed`` then the
    one-axis data mesh over every rank (a process alone gets the one-rank
    mesh, whose collectives are skipped)."""
    from .mesh import make_mesh

    info = init_distributed(None if device == "cuda" else device)
    return (info["device"], make_mesh(), info["process_index"],
            info["process_count"])
