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

Takes anything ``np.asarray`` reads, so it needs no JAX import.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

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
        node[leaf] = np.ascontiguousarray(a.numpy())
    return tree
