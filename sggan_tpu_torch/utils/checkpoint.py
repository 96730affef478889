"""Checkpoints of the port's train state, with the JAX package's layout
and policy (``sggan_tpu/utils/checkpoint.py``) in PyTorch's format.

One composite checkpoint per save, in three files with the reference's
public layout ``<checkpoint_dir>/<dataset name>/{gen,disc,train}/
cp-NNNN.pt`` (model.py:450-503): the generator's parameters, its batch
norms' moving stats (``bn``, {} for a net without batch norm), its Adam
state and the EMA shadow; the discriminator's parameters, moving stats
and Adam state; the pool's buffers and count and the step (under
``--compat_fake_history`` the fake history and its count, so a resumed
run continues the count's sequence).
``MAX_TO_KEEP = 3`` as the JAX package keeps.  Tensors are saved as they are (device and dtype) and
loaded onto the template's device, so a round trip is exact.

The ``.pt`` suffix keeps these apart from the JAX package's Orbax
directories ``cp-NNNN`` in the same tree, which ``latest_epoch`` and
``load`` read as well (``utils/orbax.py``, no JAX needed): a run pointed
at a JAX run's ``--checkpoint_dir`` resumes, tests and serves from it.
The newest number wins, the ``.pt`` at a tie; ``source`` names the one
that ``load`` takes (`` [*] Load SUCCESS (JAX Orbax cp-0007)``).  The
JAX state becomes the port's through the bridge's converters
(``utils/bridge.py``), the pool as a ``.pt`` pool does.  The port writes
only ``.pt`` files and prunes only its own: it never deletes or rewrites
a JAX ``cp-NNNN`` directory.

A data-parallel job (``--mesh_data N``, ``parallel/dp.py``) saves as the
JAX package's multi-process save does (trainer.py:215-227): every rank
takes part in gathering the pool rows into the global layout (N *
max_size rows, rank after rank), rank 0 alone writes, and no rank goes on
before the files are in place.  On a load every rank reads the same
files and keeps its own pool rows (``pool.rank_rows``).  A spatial job
(``--mesh_space``, ``parallel/spatial_step.py``) saves the same way with
its pool blocks put in the JAX package's global layout (slots over data,
H over space, W over wspace; spatial_step.py:415-430), and on a load each
rank takes its slots, rows and columns.
"""

from __future__ import annotations

import os
import re
from types import SimpleNamespace
from typing import Optional

import torch

from . import orbax
from .bridge import (_adam_from_jax, _bn_from_jax, params_from_jax,
                     tensor_from_numpy)
from ..parallel import dp
from ..parallel.distributed import rank, world_size
from ..parallel.spatial_step import global_shape, global_pool, pool_block
from ..train.pool import PoolState, rank_rows
from ..train.step import AdamState, TrainState

_CP_RE = re.compile(r"cp-(\d+)\.pt$")
_JAX_RE = re.compile(r"cp-(\d+)$")  # the JAX package's Orbax directories
MAX_TO_KEEP = 3  # parity with the dormant CheckpointManager (model.py:88-89)
PARTS = ("gen", "disc", "train")


def _ckpt_root(checkpoint_dir: str, dataset_dir: str) -> str:
    # the dataset's NAME, not its path: an absolute dataset_dir would
    # otherwise put the checkpoints inside the dataset (checkpoint.py:27)
    name = os.path.basename(os.path.normpath(dataset_dir))
    return os.path.abspath(os.path.join(checkpoint_dir, name))


def _path(root: str, part: str, epoch: int) -> str:
    return os.path.join(root, part, f"cp-{epoch:04d}.pt")


def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_CP_RE.match,
                                                os.listdir(path)) if m)


def _adam(opt: AdamState) -> dict:
    return {"count": opt.count, "mu": opt.mu, "nu": opt.nu}


def _adam_state(d, device) -> AdamState:
    if isinstance(d, AdamState):  # a JAX checkpoint's, bridged
        return d
    # a count saved as a Python int (before it became a tensor) is read too
    return AdamState(torch.as_tensor(d["count"], dtype=torch.int32,
                                     device=device), d["mu"], d["nu"])


def save(state: TrainState, checkpoint_dir: str, dataset_dir: str,
         epoch: int, group=None, grid=None) -> None:
    """Write the three parts of ``state`` under cp-``epoch`` (replacing a
    checkpoint of that number), then drop those older than the last
    ``MAX_TO_KEEP`` numbers.  With the process group of a data-parallel
    job, a collective: rank 0 writes, with every rank's pool rows; with a
    spatial job's ``mesh.Grid``, every rank's pool blocks."""
    buffer = state.pool.buffer
    if grid is not None:
        group = grid.world
        buffer = global_pool(buffer, grid)
    elif group is not None:
        buffer = dp.gather_pool(buffer, group)
    if group is not None and rank(group) != 0:
        dp.barrier(group)
        return
    _write(state, buffer, _ckpt_root(checkpoint_dir, dataset_dir), epoch)
    dp.barrier(group)


def _write(state: TrainState, buffer: dict, root: str, epoch: int) -> None:
    gen = {"params": state.gen_params.state_dict(), "bn": state.gen_bn,
           "opt": _adam(state.g_opt)}
    if state.ema is not None:
        gen["ema"] = state.ema
    parts = {"gen": gen,
             "disc": {"params": state.disc_params.state_dict(),
                      "bn": state.disc_bn, "opt": _adam(state.d_opt)},
             "train": {"pool_buffer": buffer,
                       "pool_count": state.pool.count,
                       "step": state.step}}
    for name, tree in parts.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        path = _path(root, name, epoch)
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)  # a reader never sees half a file
        for old in _steps(d):
            if old <= epoch - MAX_TO_KEEP:
                os.remove(_path(root, name, old))


def _jax_steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_JAX_RE.match,
                                                os.listdir(path))
                  if m and os.path.isdir(os.path.join(path, m.group(0))))


def _complete(root: str, steps) -> set:
    return set.intersection(*(set(steps(os.path.join(root, p)))
                              for p in PARTS))


def _find(checkpoint_dir: str, dataset_dir: str,
          epoch: Optional[int] = None):
    """(epoch, is_jax) of the checkpoint to load: ``epoch``'s, else the
    newest number that has all three parts in either format; the port's
    ``.pt`` at a tie.  None when there is none."""
    root = _ckpt_root(checkpoint_dir, dataset_dir)
    pt, jx = _complete(root, _steps), _complete(root, _jax_steps)
    if epoch is None:
        if not pt | jx:
            return None
        epoch = max(pt | jx)
    if epoch in pt:
        return epoch, False
    return (epoch, True) if epoch in jx else None


def latest_epoch(checkpoint_dir: str, dataset_dir: str) -> Optional[int]:
    found = _find(checkpoint_dir, dataset_dir)
    return found[0] if found else None


def source(checkpoint_dir: str, dataset_dir: str,
           epoch: Optional[int] = None) -> Optional[str]:
    """What ``load`` reads: "cp-0007.pt" or "JAX Orbax cp-0007"."""
    found = _find(checkpoint_dir, dataset_dir, epoch)
    if found is None:
        return None
    return f"JAX Orbax cp-{found[0]:04d}" if found[1] \
        else f"cp-{found[0]:04d}.pt"


def _read_jax(root: str, epoch: int, device):
    """The three parts of the JAX package's Orbax checkpoint ``epoch`` in
    the ``.pt`` parts' form: state dicts, BN and Adam states on
    ``device``, the pool buffers by name (a JAX pool of one array holds
    the "fake" one), the pool count and the step as ints."""
    gen, disc, tr = (orbax.read(os.path.join(root, p, f"cp-{epoch:04d}"))
                     for p in PARTS)

    def net(part):
        return {"params": params_from_jax(part["params"]),
                "bn": _bn_from_jax(part.get("bn", {}), device),
                "opt": _adam_from_jax(SimpleNamespace(**part["opt"]),
                                      device)}

    g, d = net(gen), net(disc)
    if "ema" in gen:
        g["ema"] = {k: v.to(device)
                    for k, v in params_from_jax(gen["ema"]).items()}
    buf = tr["pool_buffer"]
    if not isinstance(buf, dict):
        buf = {"fake": buf}
    t = {"pool_buffer": {k: tensor_from_numpy(v).to(device)
                         for k, v in buf.items()},
         "pool_count": int(tr["pool_count"]), "step": int(tr["step"])}
    return g, d, t


def load(template: TrainState, checkpoint_dir: str, dataset_dir: str,
         epoch: Optional[int] = None, group=None,
         pool: bool = True, grid=None) -> Optional[TrainState]:
    """The latest (or the given) checkpoint loaded into ``template``'s
    nets (in place) and returned as a new ``TrainState`` on their device;
    None when there is none (the reference's load() -> False,
    model.py:498-503).  The pool is this rank's rows of the saved one
    (``group``: the data-parallel job's, whose ranks must be those that
    wrote it; ``grid``: a spatial job's, whose rank takes its block);
    ``pool=False`` keeps the template's, for a process that
    does not train (the test phase, the service), whatever job wrote
    it."""
    root = _ckpt_root(checkpoint_dir, dataset_dir)
    found = _find(checkpoint_dir, dataset_dir, epoch)
    if found is None:
        return None
    epoch, is_jax = found
    dev = next(template.gen_params.parameters()).device

    def read(part):
        return torch.load(_path(root, part, epoch), map_location=dev,
                          weights_only=True)

    gen, disc, tr = _read_jax(root, epoch, dev) if is_jax else \
        (read("gen"), read("disc"), read("train"))
    template.gen_params.load_state_dict(gen["params"])
    template.disc_params.load_state_dict(disc["params"])
    ema = gen.get("ema")
    if (ema is None) != (template.ema is None):
        raise ValueError(f"checkpoint cp-{epoch:04d} "
                         f"{'has no' if ema is None else 'has an'} EMA "
                         "shadow; pass the --gen_ema it was trained with")
    new_pool = template.pool
    if pool:
        buf = _block_pool(tr["pool_buffer"], template, grid, epoch) \
            if grid is not None else \
            _rank_pool(tr["pool_buffer"], template, group, epoch)
        new_pool = PoolState(buf, tr["pool_count"])
    # checkpoints of the IN nets written before "bn" was saved have none
    return template._replace(
        gen_bn=gen.get("bn", {}), disc_bn=disc.get("bn", {}),
        g_opt=_adam_state(gen["opt"], dev),
        d_opt=_adam_state(disc["opt"], dev), pool=new_pool,
        step=tr["step"], ema=ema)


def _block_pool(buffer: dict, template: TrainState, grid,
                epoch: int) -> dict:
    """This rank's block of a saved spatial pool in the global layout."""
    sizes = (grid.data, grid.space, grid.wspace)
    out = {}
    for k, mine in template.pool.buffer.items():
        want = global_shape(mine.shape, sizes)
        if tuple(buffer[k].shape) != want:
            raise ValueError(
                f"checkpoint cp-{epoch:04d} holds a {k} pool of "
                f"{tuple(buffer[k].shape)}; this grid's is {want} "
                f"(--mesh_data {grid.data} --mesh_space {grid.space} "
                f"--mesh_space_w {grid.wspace})")
        out[k] = buffer[k][pool_block(want, sizes, (grid.d, grid.s,
                                                    grid.w))].clone()
    return out


def _rank_pool(buffer: dict, template: TrainState, group,
               epoch: int) -> dict:
    """This rank's rows of a saved pool buffer of one or more ranks'."""
    slots = next(iter(template.pool.buffer.values())).shape[0]
    saved = next(iter(buffer.values())).shape[0]
    n = 1 if group is None else world_size(group)
    if saved != slots * n:
        raise ValueError(
            f"checkpoint cp-{epoch:04d} holds a pool of {saved} rows, "
            f"{saved // slots} ranks of {slots} slots; this run has {n} "
            "ranks (--mesh_data)")
    if n == 1:
        return buffer
    return {k: v.clone() for k, v in rank_rows(
        buffer, rank(group), slots).items()}
