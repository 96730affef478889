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
halos), the ``wspace`` group (same d and s: the W halos), the plane group
(same d: the instance-norm moments over both spatial axes) and the world
(gradients and losses).  The groups are made with ``dist.new_group``:
the plane group spans two dims of the layout, which a 3-D ``DeviceMesh``
gives only through its dims' flattening, an API that is private in the
torch versions the port meets.

What stays refused raises with the title of its open item (ROADMAP
Queue 1, item 10): "parallel: spatial pix2pix" (the pix2pix nets'
spatial step, ``batch_norm_sp`` and the gather at depth) and "parallel:
spatial multi-host" (the spatial ranks of one data row on more than one
host).
"""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional, TypeVar

import torch.distributed as dist

DATA_AXIS = "data"

T = TypeVar("T")

SPATIAL_P2P_TODO = (
    "parallel: spatial pix2pix (--mesh_space > 1 with --use_pix2pix: the "
    "batch norm with moments across shards and the gather at depth of "
    "sggan_tpu/parallel/spatial.py) is not ported yet (ROADMAP Queue 1, "
    "item 10); the spatial step runs the semantic nets")
SPATIAL_MULTIHOST_TODO = (
    "parallel: spatial multi-host (the spatial ranks of one data row on "
    "more than one host) is not ported yet (ROADMAP Queue 1, item 10): "
    "--mesh_space x --mesh_space_w must divide the ranks of a host")


def is_spatial(cfg) -> bool:
    """Whether ``cfg`` shards the image plane (``--mesh_space`` or
    ``--mesh_space_w`` above 1)."""
    return cfg.mesh_space > 1 or cfg.mesh_space_w > 1


def check_space(cfg, world: int) -> None:
    """The spatial job ``cfg`` asks for against a world of ``world`` ranks:
    the pix2pix nets and a data row across hosts raise with their open
    items' titles, and ``D x S x W`` must be the world size."""
    if not is_spatial(cfg):
        return
    if cfg.use_pix2pix:
        raise NotImplementedError(SPATIAL_P2P_TODO)
    plane = cfg.mesh_space * cfg.mesh_space_w
    need = cfg.mesh_data * plane
    if need != world:
        raise ValueError(
            f"--mesh_data {cfg.mesh_data} x --mesh_space {cfg.mesh_space} x "
            f"--mesh_space_w {cfg.mesh_space_w} = {need} ranks must equal "
            f"the world size, {world}: the port runs one rank a card "
            f"(torchrun --nproc_per_node {need} ...)")
    # torchrun numbers a host's ranks together, so a data row's ranks are
    # on one host exactly when the plane divides the host's ranks
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host % plane:
        raise NotImplementedError(
            f"{SPATIAL_MULTIHOST_TODO} ({plane} ranks a data row, "
            f"{per_host} on this host)")


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
    h: Axis                # the space axis: H halos
    wax: Axis              # the wspace axis: W halos

    @property
    def size(self) -> int:
        return self.data * self.space * self.wspace

    def own_row(self, draw: Callable[[], T]) -> T:
        """``draw()`` once for each data row in order, this rank's row's
        kept: the draws every spatial rank of a row shares (the pool's)."""
        return [draw() for _ in range(self.data)][self.d]

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
    h = Axis(gh, rank_of(d, s - 1, w, S, W) if s > 0 else None,
             rank_of(d, s + 1, w, S, W) if s < S - 1 else None)
    wax = Axis(gw, rank_of(d, s, w - 1, S, W) if w > 0 else None,
               rank_of(d, s, w + 1, S, W) if w < W - 1 else None)
    out = Grid(D, S, W, r, d, s, w, world, gp, h, wax)
    _GRIDS[key] = (world, out)
    return out
