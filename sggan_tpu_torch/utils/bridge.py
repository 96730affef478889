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
stats and the Adam state.  Under ``--loss_mode cycle`` the JAX state
(``sggan_tpu/train/cycle.py::init_cycle_state``) nests the nets as
{"a2b", "b2a"} and {"da", "db"} and pools (fake, mask) pairs; the port's
``nn.ModuleDict`` of the same keys flattens to the same names
(``a2b.c1.w``), so both directions take it as they take any state.

Takes anything ``np.asarray`` reads, so it needs no JAX import.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..train.cycle import new_cycle_nets
from ..train.pool import PoolState
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


def train_state_from_jax(cfg, state, device="cpu") -> TrainState:
    """The port's ``TrainState`` on ``device`` from a JAX ``TrainState``
    whose leaves are numpy arrays, for the config that made it (the nets
    it selects; the semantic discriminator with the "global" head; both
    pairs under ``--loss_mode cycle``)."""
    if cfg.loss_mode == "cycle":
        gen, disc = new_cycle_nets(cfg)
    else:
        gen, disc = new_generator(cfg), new_discriminator(cfg)
    gen.load_state_dict(params_from_jax(state.gen_params))
    disc.load_state_dict(params_from_jax(state.disc_params))
    buf = state.pool.buffer
    if not isinstance(buf, Mapping):  # the p2p/simple pool is one array
        buf = {"fake": buf}
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


def train_state_to_jax(state: TrainState) -> dict:
    """The parameters, moving stats and Adam states of a port
    ``TrainState`` as nested dicts of numpy arrays in the JAX layouts:
    ``gen_params``, ``gen_bn``, ``disc_params``, ``disc_bn``, and
    ``g_opt``/``d_opt`` with ``count``, ``mu``, ``nu``."""
    def adam(opt: AdamState) -> dict:
        return {"count": np.int32(int(opt.count)),
                "mu": params_to_jax(opt.mu),
                "nu": params_to_jax(opt.nu)}

    return {"gen_params": params_to_jax(state.gen_params.state_dict()),
            "gen_bn": _bn_to_jax(state.gen_bn),
            "disc_params": params_to_jax(state.disc_params.state_dict()),
            "disc_bn": _bn_to_jax(state.disc_bn),
            "g_opt": adam(state.g_opt), "d_opt": adam(state.d_opt)}
