"""JAX parameter trees <-> the port's ``state_dict``.

The JAX package keeps parameters as nested dicts of arrays in TF layout
(``sggan_tpu/ops/layers.py``): conv kernels HWIO ``(kh, kw, cin, cout)``,
conv-transpose kernels ``(kh, kw, cout, cin)``.  PyTorch wants
``(cout, cin, kh, kw)`` for ``F.conv2d`` and ``(cin, cout, kh, kw)`` for
``F.conv_transpose2d``; both are ``permute(3, 2, 0, 1)`` of the TF layout,
with no spatial flip (both frameworks' transposed conv is the adjoint of
the forward conv with the same kernel).  Every other leaf (``gamma``,
``beta``, biases) is copied as it is.  Names are the tree's keys joined by
dots: ``c1.w``, ``r1.conv1.w``, ``r1.in1.gamma``, ... ``out.b``.

A whole JAX ``TrainState`` (``sggan_tpu/train/step.py``) with its leaves
as numpy arrays (``jax.tree.map(np.asarray, state)``) becomes the port's
``TrainState`` with ``train_state_from_jax``: both nets' parameters (of
the nets the config selects), their batch norms' moving stats (the same
nested dicts, ``{"down1_bn": {"moving_mean": ..., "moving_var": ...}}``),
optax's ``ScaleByAdamState`` (count, mu, nu) of both optimizers in the same
torch layouts, the pool's buffers and count (under
``--compat_fake_history`` the JAX ``PoolState(buffer (k, h, w, c) f32,
count)`` of the fake history, as ``{"fake": buffer}``), the step and the
EMA.
``train_state_to_jax`` is the way back for the parameters, the moving
stats, the Adam state, the pool, the step and the EMA.

A data-parallel JAX state (``init_state(..., n_data=N)``) holds the N
shards' pools as one buffer of N times the slots, sharded on the slot
axis; one rank of the port holds its own rows
(``train_state_from_jax(..., rank=r, n_data=N)``), and
``train_state_to_jax(state, group)`` gathers every rank's back into that
layout.  Under ``--loss_mode cycle`` the JAX state
(``sggan_tpu/train/cycle.py::init_cycle_state``) nests the nets as
{"a2b", "b2a"} and {"da", "db"} and pools (fake, mask) pairs; the port's
``nn.ModuleDict`` of the same keys flattens to the same names
(``a2b.c1.w``), so both directions take it as they take any state.

A spatial JAX state (``sggan_tpu/parallel/spatial_step.py::
init_sp_state`` or ``init_sp_cycle_state``, ``n_data=D``) has patch-head
discriminators and a pool whose slots run over the data rows and whose
rows and columns over the ``space`` and ``wspace`` shards; under a config
with ``--mesh_space`` the rank ``(d * S + s) * W + w`` takes its block
(``train_state_from_jax(..., rank, n_data=D)``), and
``train_state_to_jax(state, grid=grid)`` puts every rank's back.

Takes anything ``np.asarray`` reads, so it needs no JAX import.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..parallel import dp, mesh
from ..parallel.spatial_step import global_pool, pool_block
from ..train.cycle import new_cycle_nets
from ..train.pool import PoolState, rank_rows
from ..train.step import (AdamState, TrainState, new_discriminator,
                          new_generator)

_TF_TO_TORCH = (3, 2, 0, 1)
_TORCH_TO_TF = (2, 3, 1, 0)


def params_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a JAX parameter tree into a ``state_dict`` in torch layout."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(params_from_jax(val, name + "."))
            continue
        t = torch.from_numpy(np.array(val))
        if t.dim() == 4:
            t = t.permute(*_TF_TO_TORCH).contiguous()
        out[name] = t
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``params_from_jax``: nested dict of numpy arrays in TF
    layout."""
    tree: dict = {}
    for name, t in state_dict.items():
        a = t.detach().cpu()
        if a.dim() == 4:
            a = a.permute(*_TORCH_TO_TF)
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.array(a.numpy())  # a copy: params change in place
    return tree


def _adam_from_jax(opt, device) -> AdamState:
    return AdamState(torch.tensor(int(np.asarray(opt.count)),
                                  dtype=torch.int32, device=device),
                     {k: v.to(device) for k, v in
                      params_from_jax(opt.mu).items()},
                     {k: v.to(device) for k, v in
                      params_from_jax(opt.nu).items()})


def _bn_from_jax(tree: Mapping, device) -> dict:
    return {k: {n: torch.from_numpy(np.array(a)).to(device)
                for n, a in v.items()} for k, v in tree.items()}


def _bn_to_jax(state: Mapping) -> dict:
    return {k: {n: t.detach().cpu().numpy().copy() for n, t in v.items()}
            for k, v in state.items()}


def train_state_from_jax(cfg, state, device="cpu", rank: int = 0,
                         n_data: int = 1, head=None) -> TrainState:
    """The port's ``TrainState`` on ``device`` from a JAX ``TrainState``
    whose leaves are numpy arrays, for the config that made it (the nets
    it selects; the semantic discriminator with the "global" head, the
    "patch" head under ``--mesh_space``; both pairs under ``--loss_mode
    cycle``).  Of a data-parallel state of ``n_data`` shards, rank
    ``rank``'s: its rows of the pool; of a spatial one, its block.
    ``head`` overrides the discriminators' (a spatial state on one
    process: "patch")."""
    if cfg.loss_mode == "cycle":
        gen, disc = new_cycle_nets(cfg, head=head)
    else:
        gen, disc = new_generator(cfg), new_discriminator(cfg, head=head)
    gen.load_state_dict(params_from_jax(state.gen_params))
    disc.load_state_dict(params_from_jax(state.disc_params))
    buf = state.pool.buffer
    if not isinstance(buf, Mapping):  # the p2p/simple pool is one array
        buf = {"fake": buf}
    rows = next(iter(buf.values())).shape[0]
    if rows % n_data:
        raise ValueError(f"a pool of {rows} rows does not split into "
                         f"{n_data} shards")
    if mesh.is_spatial(cfg):
        S, W = cfg.mesh_space, cfg.mesh_space_w
        at = mesh.coords(rank, S, W)
        buf = {k: np.asarray(v)[pool_block(np.shape(v), (n_data, S, W), at)]
               for k, v in buf.items()}
    else:
        buf = rank_rows({k: np.asarray(v) for k, v in buf.items()}, rank,
                        rows // n_data)
    pool = PoolState({k: torch.from_numpy(np.array(v)).to(device)
                      for k, v in buf.items()},
                     int(np.asarray(state.pool.count)))
    ema = None
    if state.ema is not None:
        ema = {k: v.to(device) for k, v in params_from_jax(state.ema).items()}
    return TrainState(gen.to(device), _bn_from_jax(state.gen_bn, device),
                      disc.to(device), _bn_from_jax(state.disc_bn, device),
                      _adam_from_jax(state.g_opt, device),
                      _adam_from_jax(state.d_opt, device), pool,
                      int(np.asarray(state.step)), ema)


def train_state_to_jax(state: TrainState, group=None, grid=None) -> dict:
    """A port ``TrainState`` as nested dicts of numpy arrays in the JAX
    layouts: ``gen_params``, ``gen_bn``, ``disc_params``, ``disc_bn``,
    ``g_opt``/``d_opt`` with ``count``, ``mu``, ``nu``, ``pool`` with its
    ``buffer`` by name (a JAX pool of one array holds the "fake" one) and
    ``count``, ``step`` and ``ema`` (None without one).  With the process
    group of a data-parallel job, a collective: the pool holds every
    rank's rows, rank after rank, as the JAX state of that many shards
    does; with a spatial job's ``mesh.Grid``, every rank's block in the
    JAX package's global layout."""
    def adam(opt: AdamState) -> dict:
        return {"count": np.int32(int(opt.count)),
                "mu": params_to_jax(opt.mu),
                "nu": params_to_jax(opt.nu)}

    buf = state.pool.buffer
    if grid is not None:
        buf = global_pool(buf, grid)
    elif group is not None:
        buf = dp.gather_pool(buf, group)
    return {"gen_params": params_to_jax(state.gen_params.state_dict()),
            "gen_bn": _bn_to_jax(state.gen_bn),
            "disc_params": params_to_jax(state.disc_params.state_dict()),
            "disc_bn": _bn_to_jax(state.disc_bn),
            "g_opt": adam(state.g_opt), "d_opt": adam(state.d_opt),
            "pool": {"buffer": {k: v.detach().float().cpu().numpy()
                                for k, v in buf.items()},
                     "count": np.int32(state.pool.count)},
            "step": np.int32(state.step),
            "ema": None if state.ema is None else params_to_jax(state.ema)}
