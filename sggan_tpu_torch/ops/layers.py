"""Core layer ops with TF/Keras semantics, as functions on NHWC tensors.

Port of ``sggan_tpu/ops/layers.py``.  Parameters are dicts (or
``nn.ParameterDict``s) with the JAX names ``w`` and ``b``, with kernels in
torch layout (``utils/bridge.py``): conv ``(cout, cin, kh, kw)``,
conv-transpose ``(cin, cout, kh, kw)``.

Activations are NHWC at every boundary.  In memory that is channels_last,
so ``x.permute(0, 3, 1, 2)`` is the NCHW view the convs take without a
copy, and cuDNN returns channels_last, which permutes back to contiguous
NHWC.

Dtype policy as in the JAX package: convs cast input and kernel to the
compute dtype and return it; bf16 convs accumulate in f32 (cuDNN's and
XLA's default).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Stride = Union[int, Tuple[int, int]]
Pad = Union[int, Sequence[Tuple[int, int]]]


def _pair(s: Stride) -> Tuple[int, int]:
    return (s, s) if isinstance(s, int) else tuple(s)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    # a no-op for the channels_last outputs the convs give
    return y.permute(0, 2, 3, 1).contiguous()


# ----------------------------------------------------------------------
# initializers (Keras defaults, drawn from an explicit torch.Generator)
# ----------------------------------------------------------------------

def glorot_uniform(shape: Sequence[int], generator: torch.Generator,
                   dtype=torch.float32) -> torch.Tensor:
    """Keras glorot_uniform for a kernel of TF ``shape``: fans from the
    last two axes times the receptive field (keras _compute_fans)."""
    rf = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in, fan_out = rf * shape[-2], rf * shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
    return u * (2 * limit) - limit


def normal_init(stddev: float = 0.02):
    """Keras RandomNormal(0, stddev), the pix2pix nets' kernel init."""
    def init(shape: Sequence[int], generator: torch.Generator,
             dtype=torch.float32) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator,
                           dtype=dtype) * stddev
    return init


def conv2d_init(kh: int, kw: int, cin: int, cout: int,
                generator: torch.Generator, use_bias: bool = True,
                dtype=torch.float32, kernel_init=glorot_uniform) -> dict:
    w = kernel_init((kh, kw, cin, cout), generator, dtype)
    p = {"w": w.permute(3, 2, 0, 1).contiguous()}
    if use_bias:
        p["b"] = torch.zeros(cout, dtype=dtype)
    return p


def conv2d_transpose_init(kh: int, kw: int, cin: int, cout: int,
                          generator: torch.Generator, use_bias: bool = True,
                          dtype=torch.float32,
                          kernel_init=glorot_uniform) -> dict:
    # drawn in TF Conv2DTranspose layout (kh, kw, cout, cin), as the JAX
    # package draws it, then moved to torch's (cin, cout, kh, kw)
    w = kernel_init((kh, kw, cout, cin), generator, dtype)
    p = {"w": w.permute(3, 2, 0, 1).contiguous()}
    if use_bias:
        p["b"] = torch.zeros(cout, dtype=dtype)
    return p


# ----------------------------------------------------------------------
# convolutions
# ----------------------------------------------------------------------

def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF SAME: output ceil(size / s), the extra pad going after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _add_bias(y: torch.Tensor, params: Mapping, bias: bool, cd) -> torch.Tensor:
    if bias and "b" in params:
        y = y + params["b"].to(cd)
    return y


def conv2d(params: Mapping, x: torch.Tensor, stride: Stride = 1,
           padding: str = "SAME", compute_dtype=None,
           bias: bool = True) -> torch.Tensor:
    """NHWC conv with TF 'SAME'/'VALID' padding.

    TF SAME pads asymmetrically when the total is odd (stride 2 and an
    odd kernel on an even size: (0, 1)), which ``F.conv2d(padding=...)``
    cannot express; such pads go through ``F.pad`` before a VALID conv.

    bias=False skips the add for convs that feed instance norm (the
    per-channel shift is removed exactly by the norm); ``b`` stays in the
    parameters for layout parity."""
    cd = compute_dtype or x.dtype
    w = params["w"].to(cd)
    sh, sw = _pair(stride)
    xc = _nchw(x.to(cd))
    pad: Union[int, Tuple[int, int]] = 0
    if padding == "SAME":
        kh, kw = w.shape[2], w.shape[3]
        (ht, hb) = _same_pads(x.shape[1], kh, sh)
        (wl, wr) = _same_pads(x.shape[2], kw, sw)
        if ht == hb and wl == wr:
            pad = (ht, wl)
        else:
            xc = F.pad(xc, (wl, wr, ht, hb))
    elif padding != "VALID":
        raise ValueError(f"padding={padding!r} — must be 'SAME' or 'VALID'")
    y = F.conv2d(xc, w, stride=(sh, sw), padding=pad)
    return _add_bias(_nhwc(y), params, bias, cd)


def conv2d_transpose(params: Mapping, x: torch.Tensor, stride: Stride = 1,
                     padding: str = "SAME", compute_dtype=None,
                     bias: bool = True) -> torch.Tensor:
    """TF ``Conv2DTranspose``: the adjoint of the forward conv with the
    same stride and padding.  SAME gives ``in * stride``: the full
    transposed conv, cropped by the forward conv's SAME pads (for k=3,
    s=2 that drops the last row and column; ``padding=1,
    output_padding=1`` would crop the wrong side).  Where those pads are
    symmetric and the output is ``in`` (stride 1, odd k), they go to
    ``F.conv_transpose2d(padding=...)``, which crops nothing: no full-size
    intermediate and no copy of the crop."""
    cd = compute_dtype or x.dtype
    w = params["w"].to(cd)
    sh, sw = _pair(stride)
    kh, kw = w.shape[2], w.shape[3]
    if kh < sh or kw < sw:
        raise ValueError(f"kernel {(kh, kw)} smaller than stride {(sh, sw)}")
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding={padding!r} — must be 'SAME' or 'VALID'")
    xc = _nchw(x.to(cd))
    if padding == "VALID":
        y = F.conv_transpose2d(xc, w, stride=(sh, sw))
        return _add_bias(_nhwc(y), params, bias, cd)
    h, wd = x.shape[1] * sh, x.shape[2] * sw
    (ht, hb), (wl, wr) = _same_pads(h, kh, sh), _same_pads(wd, kw, sw)
    if (sh, sw) == (1, 1) and ht == hb and wl == wr:
        y = F.conv_transpose2d(xc, w, padding=(ht, wl))
    else:
        y = F.conv_transpose2d(xc, w, stride=(sh, sw))
        y = y[:, :, ht:ht + h, wl:wl + wd]
    return _add_bias(_nhwc(y), params, bias, cd)


# ----------------------------------------------------------------------
# activations / padding
# ----------------------------------------------------------------------

def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def leaky_relu(x: torch.Tensor, alpha: float = 0.3) -> torch.Tensor:
    """Keras LeakyReLU: default alpha 0.3, not torch's 0.01.  alpha is
    rounded to x's dtype first, as JAX rounds the weakly typed scalar."""
    a = torch.tensor(alpha, dtype=x.dtype).item()
    return torch.where(x >= 0, x, x * a)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def dropout(x: torch.Tensor, rate: float,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverted dropout (Keras semantics) with an explicit keep mask: ``x /
    keep`` where ``mask`` holds, else 0, in x's dtype, as the JAX
    package's ``dropout`` does after its ``jax.random.bernoulli`` draw.
    ``mask`` None (no draw: deterministic) or ``rate`` 0 is the
    identity."""
    if mask is None or rate == 0.0:
        return x
    if mask.shape != x.shape:
        raise ValueError(f"dropout mask {tuple(mask.shape)} for an input "
                         f"of {tuple(x.shape)}")
    return torch.where(mask, x / (1.0 - rate), 0.0)


def dropout_masks(generator: torch.Generator, shapes: Sequence[Sequence[int]],
                  rate: float) -> Tuple[torch.Tensor, ...]:
    """One keep mask per shape, True with probability ``1 - rate``
    (``jax.random.bernoulli``'s uniform < p), drawn from ``generator`` on
    its own device."""
    return tuple(torch.rand(tuple(s), generator=generator,
                            device=generator.device) < 1.0 - rate
                 for s in shapes)


_reflect_index_cache: dict = {}


def _reflect_index(n: int, lo: int, hi: int,
                   device: torch.device) -> torch.Tensor:
    """The rows a reflect pad (lo, hi) of a size-n axis reads, cached per
    (n, lo, hi, device).  Under torch.export a missing index is built but
    not cached: it is the trace's fake tensor.  A cached one is a constant
    of the exported graph, and of a captured CUDA graph, whose warm-up
    fills the cache: a miss inside a capture raises."""
    key = (n, lo, hi, device)
    index = _reflect_index_cache.get(key)
    if index is not None:
        return index
    if not (0 <= lo < n and 0 <= hi < n):
        raise ValueError(f"reflect pad ({lo}, {hi}) needs a size > pad, "
                         f"got {n}")
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"reflect pad index ({n}, {lo}, {hi}) missing in "
                           "a CUDA graph capture: run the captured function "
                           "once before capturing it")
    # a normal tensor even when first asked for under inference_mode: the
    # cached index is reused by forwards that autograd records
    with torch.inference_mode(False):
        i = torch.arange(-lo, n + hi).abs()
        index = torch.where(i >= n, 2 * (n - 1) - i, i).to(device)
    if not torch.compiler.is_exporting():
        _reflect_index_cache[key] = index
    return index


def _reflect_pad(x: torch.Tensor, ht: int, hb: int, wl: int,
                 wr: int) -> torch.Tensor:
    # One gather into a new NHWC tensor.  F.pad(mode="reflect") would give
    # the CUDA convs an NCHW-contiguous tensor: cuDNN then transposes in
    # and out of NHWC around every reflect conv.
    hi = _reflect_index(x.shape[1], ht, hb, x.device)
    wi = _reflect_index(x.shape[2], wl, wr, x.device)
    return x[:, hi[:, None], wi]


def reflect_pad(x: torch.Tensor, pad: Pad) -> torch.Tensor:
    """tf.pad(..., "REFLECT") on the spatial axes of NHWC.  ``pad`` is an
    int or the four (lo, hi) pairs of NHWC, whose N and C pairs must be
    zero."""
    if isinstance(pad, int):
        return _reflect_pad(x, pad, pad, pad, pad)
    (n0, n1), (ht, hb), (wl, wr), (c0, c1) = pad
    if n0 or n1 or c0 or c1:
        raise ValueError(f"reflect_pad pads only H and W, got {pad}")
    return _reflect_pad(x, ht, hb, wl, wr)


def unpad_reflect_transpose(dy: torch.Tensor, lo: int, hi: int,
                            axis: int) -> torch.Tensor:
    """Adjoint of a reflect pad (lo, hi) of one axis: the core slice of
    ``dy`` plus the two border strips, flipped, added onto the rows they
    mirror (``layers._unpad_reflect_transpose`` of the JAX package).
    Returns a new tensor; ``dy`` is not changed."""
    n = dy.shape[axis] - lo - hi
    core = dy.narrow(axis, lo, n).clone()
    if lo:
        core.narrow(axis, 1, lo).add_(dy.narrow(axis, 0, lo).flip(axis))
    if hi:
        core.narrow(axis, n - hi - 1, hi).add_(
            dy.narrow(axis, lo + n, hi).flip(axis))
    return core


def conv2d_reflect(params: Mapping, x: torch.Tensor, compute_dtype=None,
                   bias: bool = True) -> torch.Tensor:
    """``conv2d(params, reflect_pad(x, k // 2), 1, "VALID")``, the
    reference's reflect-padded conv (odd kernels only)."""
    k = params["w"].shape[2]
    if k % 2 != 1:
        raise ValueError(f"conv2d_reflect needs an odd kernel, got k={k}")
    cd = compute_dtype or x.dtype
    return conv2d(params, reflect_pad(x.to(cd), k // 2), 1, "VALID", cd,
                  bias)
