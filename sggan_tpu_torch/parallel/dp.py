"""Data parallelism, port of ``sggan_tpu/parallel/dp.py``: one rank per
card over ``torch.distributed``.

The JAX package shard_maps its step over the mesh's ``data`` axis: the
batch sharded on its leading dimension, the parameters, optimizer states,
EMA and step count replicated, the gradients, losses and batch-norm
moving stats ``pmean``'d inside the step, the image pool kept per shard
(its buffer sharded on the slot dimension, its count replicated) and the
randomness decorrelated per shard (``fold_in(rng, axis_index)``).  The
port keeps those semantics with one process per card:

* ``data_group`` is the group the step averages over: ``--mesh_data``
  must equal its size (JAX may put several devices in one process, the
  port never does);
* ``mean_`` replaces tensors by their mean over the ranks, through one
  flat f32 bucket (one all-reduce of the sum, then a division: gloo has
  no average, and NCCL's would round otherwise), so the step makes two
  collectives, one per net, each holding that net's gradients, its batch
  norms' moving stats and its loss; over NCCL they are captured in the
  step's CUDA graph with the rest of the step (``train/fused.py``), the
  bucket allocated from the graph's pool;
* each rank keeps ``max_size`` pool slots, rows ``[r * max_size, (r + 1)
  * max_size)`` of the JAX package's global buffer (``gather_pool`` puts
  them back together for a checkpoint; ``gather_blocks`` any layout of
  blocks, the spatial step's too);
* ``own_shard`` draws every shard's draws from the generator the ranks
  share and keeps this rank's, so the generators stay in step and one
  process can rebuild any shard's draws;
* ``own_rows`` is this rank's block of a global batch assembled on every
  rank (the resident split's, ``train/fused.py``), the rows that
  ``with_sharding_constraint(batch, P(data))`` gives device r of the JAX
  mesh; ``agree`` makes one decision of every rank's (the resident
  split: all ranks take it or none; the step's graph: all ranks capture
  it again or none);
* ``broadcast_state`` copies rank 0's replicated state to every rank
  after an init or a load, as DDP does;
* ``wait_group`` and ``barrier``: while the coordinator evaluates, the
  other ranks wait at a barrier of a gloo group with a timeout of its own
  (``WAIT_TIMEOUT_S``), as the JAX processes wait out the coordinator's
  eval: an eval (``--eval_crf`` over the test split on one host thread)
  may outlast the collectives' timeout.

An all-reduce of the sum gives every rank the same bits (the ring and
tree algorithms of NCCL and gloo reduce each element once and send the
result), so the replicas stay bitwise equal step after step.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, List, Optional, Tuple, TypeVar

import torch
import torch.distributed as dist

from .distributed import rank, world_size
from .mesh import block

T = TypeVar("T")

# how long the other ranks wait for the coordinator's eval
WAIT_TIMEOUT_S = 24 * 3600

# bytes and calls of the all-reduces ``mean_`` makes, for a reader who
# measures them (chip_smoke.py, beside its profiler range
# "dp.all_reduce"); never read by the program.  A CUDA graph's replays
# pass no counter: StepGraph records a step's at its capture
bytes_reduced = 0
reductions = 0


def data_group(cfg, group=None, keep_one: bool = False):
    """The process group over which ``cfg``'s steps average: None for
    one process; else ``group`` (the default group when None), whose
    size must be ``--mesh_data`` (a spatial job's groups are
    ``mesh.grid``'s).  ``keep_one``: a group of one rank is kept, so that
    a step over it makes its collectives (a measurement of a one-rank
    NCCL group; the trainer never asks for it)."""
    n = world_size(group)
    if n != cfg.mesh_data:
        raise ValueError(
            f"--mesh_data {cfg.mesh_data} must equal the world size, {n}: "
            "the port runs one rank a card (torchrun --nproc_per_node "
            f"{cfg.mesh_data} ... --mesh_data {cfg.mesh_data})")
    if n == 1 and not (keep_one and dist.is_initialized()):
        return None
    return dist.group.WORLD if group is None else group


def backend(group) -> Optional[str]:
    """The backend of ``group``'s collectives ("nccl", "gloo"); None for
    no group (one process)."""
    return None if group is None else dist.get_backend(group)


@torch.no_grad()
def mean_(tensors: List[torch.Tensor], group) -> None:
    """Each tensor of ``tensors`` replaced, in place, by its mean over the
    ranks of ``group``, through one flat f32 bucket."""
    global bytes_reduced, reductions
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    # a profiler window's range for the collective and its wait
    with torch.profiler.record_function("dp.all_reduce"):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group))
    bytes_reduced += flat.numel() * flat.element_size()
    reductions += 1
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()


def bn_leaves(bn: Dict[str, Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
    """The moving-stat tensors of a batch-norm state, in a fixed order."""
    return [t for v in bn.values() for t in v.values()]


def own_shard(draw: Callable[[], T], group) -> T:
    """``draw()`` made once for each rank of ``group`` in rank order, from
    the generator it reads; this rank's draw is kept (the only one for
    one process)."""
    draws = [draw() for _ in range(world_size(group))]
    return draws[rank(group)]


def own_rows(total: int, group) -> Optional[Tuple[int, int]]:
    """This rank's block of a global batch of ``total`` rows (None for one
    process: every row; ``mesh.block``)."""
    if group is None:
        return None
    return block(total, world_size(group), rank(group))


def agree(ok: bool, group) -> bool:
    """Whether ``ok`` holds on every rank of ``group``: one all-reduce
    (MIN) of a flag, so that all ranks take the same path (``ok`` itself
    for one process)."""
    if group is None:
        return ok
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    flag = torch.tensor([int(ok)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


def _src(group) -> int:
    return dist.get_global_rank(group, 0) if group is not dist.group.WORLD \
        else 0


@torch.no_grad()
def broadcast_state(state, group) -> None:
    """Rank 0's parameters, batch-norm stats, Adam states and EMA copied
    into every rank's, in place; each rank's pool rows stay its own."""
    from ..train.step import state_tensors
    for name, t in state_tensors(state).items():
        if not name.startswith("pool."):
            dist.broadcast(t, _src(group), group=group)


@torch.no_grad()
def gather_blocks(buffer: Dict[str, torch.Tensor], group,
                  block: Callable) -> Dict[str, torch.Tensor]:
    """Every rank's blocks of global buffers, on every rank (a collective
    over ``group``): ``block(t)`` gives a buffer's global shape and the
    index of this rank's tensor ``t`` in it; each is summed into zeros in
    f32, exact where every element has one rank's value."""
    out = {}
    for k, buf in buffer.items():
        shape, index = block(buf)
        full = torch.zeros(shape, dtype=torch.float32, device=buf.device)
        full[index] = buf
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
        out[k] = full.to(buf.dtype)
    return out


def gather_pool(buffer: Dict[str, torch.Tensor],
                group) -> Dict[str, torch.Tensor]:
    """Every rank's pool rows in the JAX package's global layout, rank
    after rank, on every rank (a collective)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)

    def block(t):
        s = t.shape[0]
        return (n * s, *t.shape[1:]), slice(r * s, (r + 1) * s)
    return gather_blocks(buffer, group, block)


def wait_group(group):
    """A gloo group of ``group``'s ranks (None for one process) whose
    barrier waits up to ``WAIT_TIMEOUT_S``: every rank of the default
    group makes it, in the same order."""
    if group is None:
        return None
    ranks = None if group is dist.group.WORLD else \
        dist.get_process_group_ranks(group)
    return dist.new_group(
        ranks, timeout=datetime.timedelta(seconds=WAIT_TIMEOUT_S),
        backend="gloo")


def barrier(group: Optional[object]) -> None:
    if group is not None:
        dist.barrier(group=group)
