"""Wrapper of the hand-written CUDA instance-norm kernel (K1 forward).

Replaces ``sggan_tpu/ops/pallas_in.py::instance_norm_pallas`` (forward).
The kernel is ``csrc/instance_norm.cu``: a stats launch writes f32 partial
sums per (sample, spatial split, channel), an apply launch combines them
and writes the normalized, activated output.  It takes f32 or bf16, any
C and any H*W; there is no channel gate like the TPU kernel's C % 128.

``launches`` counts the calls that launched the kernel, so a run can show
that its path went through it.  The kernel is built by nvcc at the first
call (``_build``), never at import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

launches = 0

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
def _kernel():
    fn = _build.load("instance_norm").sggan_instance_norm_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                   ctypes.c_float, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def instance_norm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-3,
                       act: Optional[str] = None,
                       alpha: float = 0.3) -> torch.Tensor:
    """Instance norm of a contiguous NHWC CUDA tensor (f32 or bf16) with
    f32 ``gamma``/``beta`` of shape (C,).  Launches on the current stream
    without synchronising; raises on any input the kernel does not take."""
    global launches
    check_act(act)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (N, H, W, C) tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (channels_last)")
    n, h, w, c = x.shape
    s = h * w
    if n > 65535 or s >= 2 ** 31:  # grid z and the kernel's int sizes
        raise ValueError(f"shape {tuple(x.shape)} out of the kernel's range")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if (p.device != x.device or p.dtype != torch.float32
                or tuple(p.shape) != (c,) or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {x.device}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    rows, n_split = split_rows(n, s, c)
    fn = _kernel()
    part = torch.empty((n, n_split, 2, c), dtype=torch.float32,
                       device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 y.data_ptr(), part.data_ptr(), n, s, c, rows, n_split,
                 int(x.dtype == torch.bfloat16), _ACTS[act], eps, alpha,
                 stream)
    if err:
        raise RuntimeError(f"instance norm kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y
