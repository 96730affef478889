"""Image-derivative filters of the SG-GAN losses, port of
``sggan_tpu/ops/deriv.py``.

* ``sobel_xy``: Sobel (dx, dy) from zero-padded shifts, equal to the SAME
  depthwise conv ``tf_deriv`` (module.py:325-334), which the
  gradient-sensitive loss uses;
* ``seg_boundary_weight``: the class-boundary map ``|sign(sum |grad
  seg|)|`` of a REFLECT-padded seg map under central differences
  (model.py:115-119);
* ``tf_deriv`` / ``depthwise_conv2d``: the depthwise-conv form, with TF's
  ``(kh, kw, C, mult)`` kernel layout and channel-major output
  (out = c * mult + m).

Plain tensor code on NHWC tensors, computed in f32: the JAX package
computes these outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import reflect_pad

_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)
_DIFF_X = np.array([[0, 0, 0], [-1, 0, 1], [0, 0, 0]], np.float32)
_DIFF_Y = np.array([[0, -1, 0], [0, 0, 0], [0, 1, 0]], np.float32)


def _stack_tf(kx: np.ndarray, ky: np.ndarray, n_ch: int) -> torch.Tensor:
    """TF depthwise layout (kh, kw, C, 2): per-channel copies of (kx, ky)."""
    k = np.stack([np.repeat(kx[:, :, None], n_ch, 2),
                  np.repeat(ky[:, :, None], n_ch, 2)], axis=-1)
    return torch.from_numpy(k)


def deriv_kernel_sobel(n_ch: int) -> torch.Tensor:
    return _stack_tf(_SOBEL_X, _SOBEL_Y, n_ch)


def deriv_kernel_diff(n_ch: int) -> torch.Tensor:
    return _stack_tf(_DIFF_X, _DIFF_Y, n_ch)


def depthwise_conv2d(x: torch.Tensor, w_tf: torch.Tensor,
                     padding: str = "SAME") -> torch.Tensor:
    """tf.nn.depthwise_conv2d parity in f32: x NHWC, w_tf (kh, kw, C,
    mult) with odd kernels; returns (N, H', W', C * mult)."""
    kh, kw, c, mult = w_tf.shape
    w = w_tf.permute(2, 3, 0, 1).reshape(c * mult, 1, kh, kw)
    if padding == "SAME":
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding={padding!r} — must be 'SAME' or 'VALID'")
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.to(device=x.device, dtype=torch.float32), padding=pad,
                 groups=c)
    return y.permute(0, 2, 3, 1)


def tf_deriv(x: torch.Tensor, padding: str = "SAME") -> torch.Tensor:
    """Sobel derivative stack: (N, H, W, C) -> (N, H, W, 2C), channel-major
    (dx, dy per channel)."""
    return depthwise_conv2d(x, deriv_kernel_sobel(x.shape[-1]), padding)


def _shift(x: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """out[i, j] = x[i + di, j + dj], zeros outside."""
    h, w = x.shape[1], x.shape[2]
    x = F.pad(x, (0, 0, max(-dj, 0), max(dj, 0), max(-di, 0), max(di, 0)))
    return x[:, max(di, 0):max(di, 0) + h, max(dj, 0):max(dj, 0) + w, :]


def sobel_xy(x: torch.Tensor):
    """(dx, dy) Sobel derivatives in f32, equal to ``tf_deriv``'s SAME
    depthwise conv."""
    xf = x.float()
    left, right = _shift(xf, 0, -1), _shift(xf, 0, 1)
    up, down = _shift(xf, -1, 0), _shift(xf, 1, 0)
    ul, ur = _shift(xf, -1, -1), _shift(xf, -1, 1)
    dl, dr = _shift(xf, 1, -1), _shift(xf, 1, 1)
    dx = (ur - ul) + 2.0 * (right - left) + (dr - dl)
    dy = (dl - ul) + 2.0 * (down - up) + (dr - ur)
    return dx, dy


def seg_boundary_weight(seg: torch.Tensor) -> torch.Tensor:
    """Class-boundary weight map: reflect-pad 1, central differences,
    ``|sign(sum_c |dx| + sum_c |dy|)|`` -> (N, H, W, 1) in {0, 1}."""
    segp = reflect_pad(seg.float(), 1)
    hp, wp = segp.shape[1], segp.shape[2]

    def inner(di, dj):
        return segp[:, 1 + di:hp - 1 + di, 1 + dj:wp - 1 + dj, :]

    dx = inner(0, 1) - inner(0, -1)
    dy = inner(1, 0) - inner(-1, 0)
    total = dx.abs().sum(-1, keepdim=True) + dy.abs().sum(-1, keepdim=True)
    return torch.sign(total).abs()
