"""Instance norm (tfa InstanceNormalization semantics) on NHWC tensors.

Port of ``sggan_tpu/ops/norm.py``: per-sample, per-channel moments over
the spatial plane, eps 1e-3, affine gamma/beta, then an optional relu or
leaky_relu (Keras alpha 0.3).  Not ``nn.InstanceNorm2d``: its eps is 1e-5.

``instance_norm`` runs the hand-written CUDA kernel (``cuda_in``) on a
CUDA tensor, and the plain version ``instance_norm_ref`` only on a CPU
tensor.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from . import cuda_in

IN_EPS = 1e-3  # tfa GroupNormalization default


def instance_norm_init(c: int, dtype=torch.float32) -> dict:
    return {"gamma": torch.ones(c, dtype=dtype),
            "beta": torch.zeros(c, dtype=dtype)}


def instance_norm_ref(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float = IN_EPS,
                      act: Optional[str] = None,
                      alpha: float = 0.3) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, following ``norm._in_fused``:
    f32 sum and sum of squares, var = max(E[x^2] - mean^2, 0), output in
    ``x.dtype``."""
    cuda_in.check_act(act)
    xf = x.float()
    n = x.shape[1] * x.shape[2]
    mean = xf.sum((1, 2), keepdim=True) / n
    var = torch.clamp_min((xf * xf).sum((1, 2), keepdim=True) / n
                          - mean * mean, 0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    if act == "relu":
        y = torch.clamp_min(y, 0)
    elif act == "leaky_relu":
        y = torch.where(y >= 0, y, alpha * y)
    return y.to(x.dtype)


def instance_norm(params: Mapping, x: torch.Tensor, act: Optional[str] = None,
                  alpha: float = 0.3, eps: float = IN_EPS) -> torch.Tensor:
    """Instance norm with optional fused activation; x is NHWC.

    act: None | 'relu' | 'leaky_relu'."""
    gamma, beta = params["gamma"], params["beta"]
    if x.device.type == "cpu":
        return instance_norm_ref(x, gamma, beta, eps, act, alpha)
    return cuda_in.instance_norm_cuda(x, gamma, beta, eps, act, alpha)
