"""Wrappers of the hand-written CUDA instance-norm kernels (K1).

Forward: replaces ``sggan_tpu/ops/pallas_in.py::instance_norm_pallas``.
Backward: replaces ``sggan_tpu/ops/norm.py::_in_fused_bwd``, the custom
VJP of the JAX package's instance norm.  Both are ``csrc/instance_norm.cu``
and have the same shape: a stats launch writes f32 partial sums per
(sample, spatial split, channel), an apply launch combines them and writes
the output.  They take f32 or bf16, any C and any H*W; there is no channel
gate like the TPU kernel's C % 128.

``launches`` and ``bwd_launches`` count the calls that launched each
kernel, so a run can show that its path went through them.  The kernels
are built by nvcc at the first call (``_build``), never at import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

launches = 0
bwd_launches = 0

_ACTS = {None: 0, "relu": 1, "leaky_relu": 2}
_LANES = 32             # channels per block (kLanes in the source)
_TARGET_BLOCKS = 4 * 132  # a few blocks on each of the H100's 132 SMs
_MIN_ROWS = 64          # rows per block, at least: 8 per warp


def check_act(act: Optional[str]) -> None:
    if act not in _ACTS:
        raise ValueError(f"act={act!r} — must be None, 'relu' or "
                         "'leaky_relu'")


def split_rows(n: int, s: int, c: int) -> Tuple[int, int]:
    """(rows per split, number of splits) of the S = H*W axis: enough
    blocks to fill the card at batch 1, at least ``_MIN_ROWS`` rows each,
    and no empty split."""
    tiles = -(-c // _LANES)
    want = -(-_TARGET_BLOCKS // (n * tiles))
    n_split = max(1, min(want, s // _MIN_ROWS))
    rows = -(-s // n_split)
    return rows, -(-s // rows)


@functools.cache
def _kernels():
    lib = _build.load("instance_norm")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.sggan_instance_norm_fwd, lib.sggan_instance_norm_bwd
    fwd.argtypes = [p] * 7 + [i] * 7 + [f, f, p]
    bwd.argtypes = [p] * 8 + [i] * 7 + [f, p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the instance-norm kernels need CUDA tensors, got "
                         f"{name} on {x.device}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name} must be a non-empty (N, H, W, C) tensor, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous NHWC (channels_last)")
    n, h, w, _ = x.shape
    if n > 65535 or h * w >= 2 ** 31:  # grid z and the kernel's int sizes
        raise ValueError(f"shape {tuple(x.shape)} out of the kernel's range")


def _check_f32(x: torch.Tensor, **params: torch.Tensor) -> None:
    for name, p in params.items():
        shape = (x.shape[-1],) if name in ("gamma", "beta") \
            else (x.shape[0], x.shape[-1])
        if (p.device != x.device or p.dtype != torch.float32
                or tuple(p.shape) != shape or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {x.device}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")


def _launch(fn, *args) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err:
        raise RuntimeError(f"instance norm kernel launch failed: CUDA error "
                           f"{err}")


def instance_norm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-3,
                       act: Optional[str] = None, alpha: float = 0.3,
                       save_stats: bool = False):
    """Instance norm of a contiguous NHWC CUDA tensor (f32 or bf16) with
    f32 ``gamma``/``beta`` of shape (C,).  Returns y in x's dtype, or with
    ``save_stats`` the tuple (y, mean, rstd), the moments as (N, C) f32 for
    the backward.  Launches on the current stream without synchronising;
    raises on any input the kernel does not take."""
    global launches
    check_act(act)
    _check_x("x", x)
    _check_f32(x, gamma=gamma, beta=beta)
    n, h, w, c = x.shape
    rows, n_split = split_rows(n, h * w, c)
    part = torch.empty((n, n_split, 2, c), dtype=torch.float32,
                       device=x.device)
    y = torch.empty_like(x)
    mean = rstd = None
    if save_stats:
        mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    _launch(_kernels()[0], x, gamma, beta, y, part, mean, rstd, n, h * w,
            c, rows, n_split, int(x.dtype == torch.bfloat16), _ACTS[act],
            eps, alpha)
    launches += 1
    return (y, mean, rstd) if save_stats else y


def instance_norm_bwd_cuda(x: torch.Tensor, dy: torch.Tensor,
                           gamma: torch.Tensor, beta: torch.Tensor,
                           mean: torch.Tensor, rstd: torch.Tensor,
                           act: Optional[str] = None, alpha: float = 0.3
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dx, dgamma, dbeta) of ``instance_norm_cuda`` given its input x,
    the gradient dy of its output (same shape and dtype, contiguous), and
    the (N, C) f32 moments it saved.  dx is in x's dtype, dgamma and dbeta
    f32.  Launches on the current stream without synchronising; raises on
    any input the kernel does not take."""
    global bwd_launches
    check_act(act)
    _check_x("x", x)
    _check_x("dy", dy)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x: got {dy.dtype} "
                         f"{tuple(dy.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}")
    _check_f32(x, gamma=gamma, beta=beta, mean=mean, rstd=rstd)
    n, h, w, c = x.shape
    rows, n_split = split_rows(n, h * w, c)
    part = torch.empty((n, n_split, 2, c), dtype=torch.float32,
                       device=x.device)
    dx = torch.empty_like(x)
    _launch(_kernels()[1], x, dy, gamma, beta, mean, rstd, part, dx,
            n, h * w, c, rows, n_split, int(x.dtype == torch.bfloat16),
            _ACTS[act], alpha)
    bwd_launches += 1
    sums = part.sum((0, 1))  # (2, C): sum dy_g, sum dy_g * xhat
    return dx, sums[1], sums[0]
