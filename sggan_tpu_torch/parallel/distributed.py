"""The process group of a multi-card job, port of
``sggan_tpu/parallel/distributed.py``.

The JAX package calls ``jax.distributed.initialize`` once per process and
lets XLA run the collectives.  The port runs one process (a rank) per
card and its collectives through ``torch.distributed``: NCCL on the
cards, gloo on the CPU.  ``initialize`` reads the environment that
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``):

    torchrun --nproc_per_node 4 -m sggan_tpu_torch.main --phase train \\
        --mesh_data 4 ...

A rank's device is ``cuda:LOCAL_RANK``; a ``LOCAL_RANK`` with no card
behind it is an error, never mapped onto another card.  Nothing is
substituted silently: a named backend is used as named, and
``initialize`` with no CUDA device and the CUDA backend raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS

# a rank that waits longer than this on a collective raises, so a lost
# peer ends the job instead of hanging it
TIMEOUT_S = 600


def _env_int(name: str, default: Optional[int]) -> int:
    val = os.environ.get(name)
    if val is None:
        if default is None:
            raise RuntimeError(
                f"{name} is not set: launch one process per card with "
                "torchrun --nproc_per_node N, or set RANK, WORLD_SIZE, "
                "LOCAL_RANK, MASTER_ADDR and MASTER_PORT")
        return default
    return int(val)


def local_rank() -> int:
    return _env_int("LOCAL_RANK", 0)


def device(kind="cuda") -> torch.device:
    """This rank's device: the CPU for ``kind`` "cpu", else
    ``cuda:LOCAL_RANK``, which must exist."""
    if torch.device(kind).type != "cuda":
        return torch.device(kind)
    lr = local_rank()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= lr < n:
        raise RuntimeError(f"LOCAL_RANK={lr} has no CUDA device behind it: "
                           f"{n} visible")
    return torch.device("cuda", lr)


def initialize(backend: Optional[str] = None, device_kind="cuda",
               timeout_s: float = TIMEOUT_S) -> None:
    """Join the default process group from ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``, once: a second call is a no-op,
    as ``jax.distributed.initialize``'s is.  ``backend`` defaults to
    NCCL for ``device_kind`` "cuda" and gloo for "cpu"."""
    if dist.is_initialized():
        return
    rank = _env_int("RANK", None)
    world_size = _env_int("WORLD_SIZE", None)
    cuda = torch.device(device_kind).type == "cuda"
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        torch.cuda.set_device(device("cuda"))
    elif backend == "nccl":
        raise RuntimeError("the NCCL backend needs CUDA devices; the CPU "
                           "runs gloo")
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def world_size(group=None) -> int:
    """The ranks of ``group`` (the default group's when None); 1 outside
    a process group."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return rank() == 0


def global_mesh(device_kind="cuda"):
    """A 1-D ``DeviceMesh`` named ``data`` over every rank, one card a
    rank: the JAX mesh's ``data`` axis.  The step averages over the
    process group itself (``parallel/dp.py``); the mesh names the
    layout."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device_kind).type, (world_size(),),
                            mesh_dim_names=(DATA_AXIS,))


def shutdown() -> None:
    """Leave the default process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
