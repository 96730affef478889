"""Space-to-depth convolution for tiny output-channel counts, port of
``sggan_tpu/ops/s2d.py``.

The ResNet generator's 7x7 64 -> 3 output conv computes all rh x rw output
pixels of a block at once as a STRIDE-(rh, rw) conv with an expanded
(k+rh-1) x (k+rw-1) kernel and rh*rw*cout output channels:

    y[b, rh*u+pi, rw*v+pj, o]
      = conv(x, W2, stride=(rh, rw))[b, u, v, (pi, pj, o)],
        W2[(pi, pj, o), c, P, Q] = w[o, c, P-pi, Q-pj]  (zero outside),

the kernels in torch's OIHW layout.  Only the small (H/rh, W/rw,
rh*rw*cout) output is depth-to-space'd back; the input needs no relayout.
The same math as the direct conv up to f32 summation order.

``best_block`` is the JAX package's choice, a cost model of the TPU's
128-lane matrix tile, copied as it is and held to the JAX function by
``tests/test_torch_s2d.py``.  The port's head takes ``head_block``, whose
rule comes from ``chip_smoke.py`` phase 31's measurement on the H100.
"""

from __future__ import annotations

from typing import Mapping, Tuple, Union

import torch
import torch.nn.functional as F

from .layers import (_add_bias, _nchw, _nhwc, conv2d, reflect_strips,
                     set_reflect_frame)

Block = Union[int, Tuple[int, int]]


def _rhw(r: Block) -> Tuple[int, int]:
    return (r, r) if isinstance(r, int) else tuple(r)


def _block_cost(k: int, cout: int, rh: int, rw: int) -> float:
    """taps x lane-padding factor: relative MXU time per output pixel."""
    lanes = rh * rw * cout
    return (k + rh - 1) * (k + rw - 1) * 128.0 / lanes


def best_block(k: int, cout: int, h: int, w: int) -> Tuple[int, int]:
    """Cheapest (rh, rw) with rh|h, rw|w and rh*rw*cout <= 128 lanes by
    the TPU's cost model; rh is scanned descending so cost ties resolve
    to the taller block."""
    best, best_c = None, float("inf")
    for rh in (16, 8, 4, 2, 1):
        for rw in (1, 2, 4, 8, 16):
            if rh * rw * cout > 128 or h % rh or w % rw:
                continue
            if rh > h or rw > w:
                continue
            c = _block_cost(k, cout, rh, rw)
            if c < best_c:
                best, best_c = (rh, rw), c
    return best or (1, 1)


def head_block(k: int, cout: int, h: int, w: int) -> Tuple[int, int]:
    """The output block of the port's head: (4, 4) where it divides the
    image and its rh*rw*cout channels fit one 128-wide tile, else (1, 1),
    cuDNN's direct conv.  From ``chip_smoke.py`` phase 31 on an H100
    (NVIDIA H100 80GB HBM3, 700 W): the 7x7 64 -> 3 head at 256x512 bf16,
    forward + backward, device time at b=16, pre-padded / pad-free:
    (4, 4) 2.904 / 3.041 ms, (8, 4) 3.068 / 3.184, (4, 8) 3.056 / 3.176,
    (2, 2) 3.451 / 3.873, the direct conv 8.635 / 8.589; (4, 4) was the
    fastest at b=8 too.  ``best_block``'s (8, 4), the TPU's pick, is
    within 6% of (4, 4) there."""
    if h % 4 or w % 4 or 16 * cout > 128:
        return (1, 1)
    return (4, 4)


def applicable(x_padded: torch.Tensor, w: torch.Tensor, r: Block = 4) -> bool:
    """conv2d_valid_s2d's applicability on the padded NHWC input, for an
    OIHW kernel."""
    rh, rw = _rhw(r)
    cout, k = w.shape[0], w.shape[2]
    h, wd = x_padded.shape[1] - (k - 1), x_padded.shape[2] - (k - 1)
    return (cout * rh * rw <= 128 and h % rh == 0 and wd % rw == 0
            and h >= rh and wd >= rw)


def applicable_reflect(x: torch.Tensor, w: torch.Tensor,
                       r: Block = 4) -> bool:
    """conv2d_reflect_s2d's applicability on the UNPADDED input."""
    rh, rw = _rhw(r)
    cout, k = w.shape[0], w.shape[2]
    h, wd = x.shape[1], x.shape[2]
    return (k % 2 == 1 and cout * rh * rw <= 128 and h % rh == 0
            and wd % rw == 0 and h > 2 * k and wd > 2 * k)


def _d2s(y: torch.Tensor, rh: int, rw: int, cout: int) -> torch.Tensor:
    b, hb, wb, _ = y.shape
    y = y.reshape(b, hb, wb, rh, rw, cout)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, hb * rh, wb * rw, cout)


def _s2d_weights(w: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    """W2[(pi, pj, o), c, P, Q] = w[o, c, P-pi, Q-pj], zero outside the
    kernel; P in [0, k+rh-1), Q in [0, k+rw-1).  One gather from the
    kernel zero-padded by rh-1 rows and rw-1 columns on each side."""
    cout, cin, k, _ = w.shape
    kph, kpw = k + rh - 1, k + rw - 1
    wz = F.pad(w, (rw - 1, rw - 1, rh - 1, rh - 1))
    ar = lambda n: torch.arange(n, device=w.device)  # noqa: E731
    ih = ar(kph) - ar(rh)[:, None] + rh - 1  # (pi, P) -> row of wz
    iw = ar(kpw) - ar(rw)[:, None] + rw - 1  # (pj, Q) -> column of wz
    w2 = wz[:, :, ih[:, None, :, None], iw[None, :, None, :]]
    # (o, c, pi, pj, P, Q) -> ((pi, pj, o), c, P, Q)
    return w2.permute(2, 3, 0, 1, 4, 5).reshape(rh * rw * cout, cin, kph,
                                                kpw)


def _strided(x: torch.Tensor, w: torch.Tensor, rh: int, rw: int, cd,
             padding: int) -> torch.Tensor:
    yb = F.conv2d(_nchw(x.to(cd)), _s2d_weights(w, rh, rw).to(cd),
                  stride=(rh, rw), padding=padding)
    return _d2s(_nhwc(yb), rh, rw, w.shape[0])


def conv2d_valid_s2d(params: Mapping, x_padded: torch.Tensor, r: Block = 4,
                     compute_dtype=None) -> torch.Tensor:
    """``conv2d(params, x_padded, 1, "VALID")`` on a pre-padded input, via
    a stride-(rh, rw) conv over rh x rw output blocks."""
    rh, rw = _rhw(r)
    cd = compute_dtype or x_padded.dtype
    y = _strided(x_padded, params["w"], rh, rw, cd, 0)
    return _add_bias(y, params, True, cd)


def conv2d_reflect_s2d(params: Mapping, x: torch.Tensor, r: Block = 4,
                       compute_dtype=None) -> torch.Tensor:
    """``conv2d_valid_s2d(params, reflect_pad(x, k // 2))`` without the
    padded activation: the pad rides the strided conv's own zero padding
    (interior outputs never read it), and the k//2-pixel output frame is
    recomputed with reflect sources by four direct strip convs, the
    strided analogue of ``layers.conv2d_reflect_pad_free``.  Autograd
    differentiates it, as the JAX package's autodiff does."""
    rh, rw = _rhw(r)
    cd = compute_dtype or x.dtype
    p = params["w"].shape[2] // 2
    xcd = x.to(cd)
    y = _add_bias(_strided(xcd, params["w"], rh, rw, cd, p), params, True,
                  cd)
    return set_reflect_frame(y, [conv2d(params, s, 1, "VALID", cd)
                                 for s in reflect_strips(xcd, p)], p)
