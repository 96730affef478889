"""The mesh of a multi-card job, port of ``sggan_tpu/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` with a ``data`` axis (the
batch sharded, gradients averaged), a ``space`` axis (the image's rows
sharded, with halo exchange) and an optional ``wspace`` axis (its
columns).  The port runs one rank per card (``parallel/dp.py``) and lays
the ranks out as ``make_mesh`` lays out devices (mesh.py:35-53): a job of
``D x S x W`` ranks (``--mesh_data D --mesh_space S --mesh_space_w W``)
puts rank ``(d * S + s) * W + w`` at data row ``d``, row shard ``s``,
column shard ``w``.

``grid`` builds that layout's process groups once, every rank making
every group in the same order: the ``space`` group (same d and w: the H
halos and gathers), the ``wspace`` group (same d and s: the W halos and
gathers), the plane group (same d: the instance-norm and batch-norm
moments over both spatial axes), the ``data`` group (same s and w: the
pix2pix nets' batch-norm states, averaged over the data rows) and the
world (gradients and losses).  The groups are made with
``dist.new_group``: the plane group spans two dims of the layout, which
a 3-D ``DeviceMesh`` gives only through its dims' flattening, an API that
is private in the torch versions the port meets.

``check_space`` refuses what the JAX trainer refuses of a grid
(sggan_tpu/train/trainer.py:55-77), with its errors: a job over several
hosts whose hosts do not each hold whole data rows of the grid, or has
one data row, or a batch that the hosts cannot split.  The JAX package
counts a host's devices (``jax.local_device_count``); the port runs one
rank a card, so a host's ranks (``LOCAL_WORLD_SIZE``, as torchrun sets
it) take their place, and the hosts are the world's ranks over a
host's.  A data-parallel job meets the last two by its own checks
(``--mesh_data`` is the world size, and the trainer splits the batch
over it).
"""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional, Tuple, TypeVar

import torch.distributed as dist

DATA_AXIS = "data"

T = TypeVar("T")


def is_spatial(cfg) -> bool:
    """Whether ``cfg`` shards the image plane (``--mesh_space`` or
    ``--mesh_space_w`` above 1)."""
    return cfg.mesh_space > 1 or cfg.mesh_space_w > 1


def check_space(cfg, world: int) -> None:
    """The spatial job ``cfg`` asks for against a world of ``world``
    ranks: ``D x S x W`` ranks in the world, then the reference's
    multi-host conditions (``check_hosts``)."""
    if not is_spatial(cfg):
        return
    need = cfg.mesh_data * cfg.mesh_space * cfg.mesh_space_w
    if need != world:
        raise ValueError(
            f"--mesh_data {cfg.mesh_data} x --mesh_space {cfg.mesh_space} x "
            f"--mesh_space_w {cfg.mesh_space_w} = {need} ranks must equal "
            f"the world size, {world}: the port runs one rank a card "
            f"(torchrun --nproc_per_node {need} ...)")
    check_hosts(cfg, world)


def check_hosts(cfg, world: int) -> None:
    """The JAX trainer's checks of a spatial job over several hosts
    (trainer.py:55-77), in its order and words, with a host's ranks
    (``LOCAL_WORLD_SIZE``) for its local devices: the space grid must
    divide them (torchrun numbers a host's ranks together, so a data
    row's ranks are then on one host), ``--mesh_data`` must be above 1,
    and the batch must divide by the hosts.  Nothing for one host."""
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_proc = world // per_host
    if n_proc <= 1:
        return
    sp_grid = cfg.mesh_space * cfg.mesh_space_w
    if per_host % sp_grid:
        raise ValueError(
            f"multi-host spatial sharding needs the space grid ({sp_grid}) "
            f"to divide the local device count ({per_host}) so every host "
            "owns whole data rows of the mesh")
    if cfg.mesh_data <= 1:
        raise ValueError("multi-host training needs --mesh_data > 1 (the "
                         "data axis spans hosts)")
    if cfg.batch_size % n_proc:
        raise ValueError(
            f"batch_size={cfg.batch_size} must divide by "
            f"process_count={n_proc} (each process feeds its contiguous "
            "slice of the global batch)")


def block(total: int, n: int, i: int) -> Tuple[int, int]:
    """Block ``i`` of ``n`` of ``total`` rows, ``[i * total / n, (i + 1) *
    total / n)``: the rows a mesh axis of ``n`` devices gives device
    ``i`` (``total`` divides by ``n``)."""
    size = total // n
    return i * size, (i + 1) * size


class Axis(NamedTuple):
    """One spatial axis of a rank: its ``group`` (None when the axis is
    not sharded) and the global ranks of its neighbours (None at the
    plane's edge)."""
    group: Optional[object]
    prev: Optional[int]
    next: Optional[int]

    @property
    def first(self) -> bool:
        return self.prev is None

    @property
    def last(self) -> bool:
        return self.next is None


class Grid(NamedTuple):
    """A rank's place in the (data, space, wspace) layout and its groups."""
    data: int
    space: int
    wspace: int
    rank: int
    d: int
    s: int
    w: int
    world: object          # every rank: gradients and losses
    plane: Optional[object]  # the ranks of data row d: the moments
    h: Axis                # the space axis: H halos and gathers
    wax: Axis              # the wspace axis: W halos and gathers
    across: Optional[object]  # this block in every data row: BN states

    @property
    def size(self) -> int:
        return self.data * self.space * self.wspace

    def own_row(self, draw: Callable[[], T]) -> T:
        """``draw()`` once for each data row in order, this rank's row's
        kept: the draws every spatial rank of a row shares (the pool's)."""
        return [draw() for _ in range(self.data)][self.d]

    def own_rows(self, total: int) -> Tuple[int, int]:
        """This rank's data row's block of a global batch of ``total``
        rows (``block``), as ``_batch_spec`` places the batch's leading
        dimension over ``data``; ``spatial_step.shard_batch`` then cuts
        its block of the plane."""
        return block(total, self.data, self.d)

    def own_shard(self, draw: Callable[[], T]) -> T:
        """``draw()`` once for each rank in rank order, this rank's kept
        (``dp.own_shard`` over the world): per-shard draws (dropout)."""
        return [draw() for _ in range(self.size)][self.rank]


def rank_of(d: int, s: int, w: int, space: int, wspace: int) -> int:
    """The rank at data row ``d``, row shard ``s``, column shard ``w``."""
    return (d * space + s) * wspace + w


def coords(rank: int, space: int, wspace: int) -> tuple:
    """``rank``'s (d, s, w): the inverse of ``rank_of``."""
    return (rank // (space * wspace), (rank // wspace) % space,
            rank % wspace)


_GRIDS: dict = {}


def grid(cfg, group=None) -> Grid:
    """This rank's ``Grid`` for ``cfg`` in the default process group (a
    collective the first time: every rank makes every group in the same
    order; later calls return the same groups).  ``group``, where given,
    must be the default group."""
    world = dist.group.WORLD if dist.is_initialized() else None
    n = dist.get_world_size() if world is not None else 1
    check_space(cfg, n)
    if group is not None and group is not world:
        raise ValueError("the spatial step runs over the default process "
                         "group")
    key = (id(world), cfg.mesh_data, cfg.mesh_space, cfg.mesh_space_w)
    hit = _GRIDS.get(key)
    if hit is not None and hit[0] is world:
        return hit[1]
    D, S, W = cfg.mesh_data, cfg.mesh_space, cfg.mesh_space_w
    r = dist.get_rank()
    d, s, w = coords(r, S, W)

    def groups(rank_lists: List[List[int]], mine: List[int]):
        out = None
        for ranks in rank_lists:
            g = dist.new_group(ranks)
            if ranks == mine:
                out = g
        return out

    space_lists = [[rank_of(dd, ss, ww, S, W) for ss in range(S)]
                   for dd in range(D) for ww in range(W)]
    wspace_lists = [[rank_of(dd, ss, ww, S, W) for ww in range(W)]
                    for dd in range(D) for ss in range(S)]
    plane_lists = [[rank_of(dd, ss, ww, S, W) for ss in range(S)
                    for ww in range(W)] for dd in range(D)]
    gh = groups(space_lists, [rank_of(d, ss, w, S, W) for ss in range(S)]) \
        if S > 1 else None
    gw = groups(wspace_lists, [rank_of(d, s, ww, S, W) for ww in range(W)]) \
        if W > 1 else None
    gp = groups(plane_lists, plane_lists[d]) if S * W > 1 else None
    across_lists = [[rank_of(dd, ss, ww, S, W) for dd in range(D)]
                    for ss in range(S) for ww in range(W)]
    ga = groups(across_lists, [rank_of(dd, s, w, S, W) for dd in range(D)]) \
        if D > 1 else None
    h = Axis(gh, rank_of(d, s - 1, w, S, W) if s > 0 else None,
             rank_of(d, s + 1, w, S, W) if s < S - 1 else None)
    wax = Axis(gw, rank_of(d, s, w - 1, S, W) if w > 0 else None,
               rank_of(d, s, w + 1, S, W) if w < W - 1 else None)
    out = Grid(D, S, W, r, d, s, w, world, gp, h, wax, ga)
    _GRIDS[key] = (world, out)
    return out
