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

The reflect pad and conv come in the JAX package's forms, each an
``autograd.Function`` where an input needs a gradient and its forward
body otherwise (so ``torch.export`` records plain ops): ``reflect_pad``,
the gather with the strip-add adjoint as its backward, and
``conv2d_reflect_pad_free``, the pad-free conv with its hand-written
backward; beside them the gather + VALID form ``conv2d_reflect_gather``
and the plain twins ``reflect_pad_ref`` and ``conv2d_reflect_ref``
(autograd's index adjoint).  ``conv2d_reflect``, the nets' reflect conv,
is the form that measured faster on the H100 (``chip_smoke.py`` phase
30).
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


def _pads(pad: Pad) -> Tuple[int, int, int, int]:
    if isinstance(pad, int):
        return pad, pad, pad, pad
    (n0, n1), (ht, hb), (wl, wr), (c0, c1) = pad
    if n0 or n1 or c0 or c1:
        raise ValueError(f"reflect_pad pads only H and W, got {pad}")
    return ht, hb, wl, wr


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


def reflect_pad_adjoint(dy: torch.Tensor, ht: int, hb: int, wl: int,
                        wr: int) -> torch.Tensor:
    """Adjoint of the reflect pad (ht, hb, wl, wr) of NHWC: the W fold,
    then the H fold, the reverse order of the forward's composition, as
    the JAX package's custom VJP (``layers._reflect_pad_bwd``) applies
    ``unpad_reflect_transpose`` per axis.  Here with one copy of the core:
    the H border rows are W-folded as strips before they are added, which
    makes the same sums in the same order.  Returns a new tensor."""
    n, m = dy.shape[1] - ht - hb, dy.shape[2] - wl - wr
    dx = dy[:, ht:ht + n, wl:wl + m].clone(
        memory_format=torch.contiguous_format)
    rows = dy[:, ht:ht + n]
    if wl:
        dx[:, :, 1:wl + 1] += rows[:, :, :wl].flip(2)
    if wr:
        dx[:, :, m - wr - 1:m - 1] += rows[:, :, wl + m:].flip(2)
    if ht:
        dx[:, 1:ht + 1] += unpad_reflect_transpose(
            dy[:, :ht], wl, wr, 2).flip(1)
    if hb:
        dx[:, n - hb - 1:n - 1] += unpad_reflect_transpose(
            dy[:, ht + n:], wl, wr, 2).flip(1)
    return dx


class _ReflectPad(torch.autograd.Function):
    """The gather forward, the strip-add adjoint as its backward."""

    @staticmethod
    def forward(ctx, x, ht, hb, wl, wr):
        ctx.pads = (ht, hb, wl, wr)
        return _reflect_pad(x, ht, hb, wl, wr)

    @staticmethod
    def backward(ctx, dy):
        return (reflect_pad_adjoint(dy, *ctx.pads), None, None, None, None)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def reflect_pad(x: torch.Tensor, pad: Pad) -> torch.Tensor:
    """tf.pad(..., "REFLECT") on the spatial axes of NHWC.  ``pad`` is an
    int or the four (lo, hi) pairs of NHWC, whose N and C pairs must be
    zero.

    Where ``x`` needs a gradient, an ``autograd.Function`` whose backward
    is ``reflect_pad_adjoint`` (one copy of the core plus strip adds, as
    the JAX package's custom VJP) in place of autograd's scatter-add of
    the gather's index; else the gather alone, which ``torch.export``
    records as plain ops."""
    pads = _pads(pad)
    if _needs_grad(x):
        return _ReflectPad.apply(x, *pads)
    return _reflect_pad(x, *pads)


def reflect_pad_ref(x: torch.Tensor, pad: Pad) -> torch.Tensor:
    """The plain twin of ``reflect_pad``: the gather, with autograd's
    adjoint of its index."""
    return _reflect_pad(x, *_pads(pad))


def _odd_kernel(w: torch.Tensor) -> int:
    k = w.shape[2]
    if k % 2 != 1:
        raise ValueError(f"conv2d_reflect needs an odd kernel, got k={k}")
    return k


class _BorderSlabs(torch.autograd.Function):
    """x's first and last 2p rows and columns.  The backward writes the
    four slabs' gradients into one zero tensor of x's shape, where
    autograd's slice adjoint would make a full-size zero tensor per slice
    and add them up (ten full-size adds and sixteen fills in the s2d
    head's backward at (16, 256, 512, 64), phase 31)."""

    @staticmethod
    def forward(ctx, x, p):
        ctx.p, ctx.shape = p, x.shape
        h, w = x.shape[1], x.shape[2]
        return (x[:, :2 * p], x[:, h - 2 * p:], x[:, :, :2 * p],
                x[:, :, w - 2 * p:])

    @staticmethod
    def backward(ctx, gt, gb, gl, gr):
        p, (_, h, w, _) = ctx.p, ctx.shape
        dx = gt.new_zeros(ctx.shape)
        dx[:, :2 * p] += gt
        dx[:, h - 2 * p:] += gb
        dx[:, :, :2 * p] += gl
        dx[:, :, w - 2 * p:] += gr
        return dx, None


def reflect_strips(x: torch.Tensor, p: int) -> tuple:
    """The sources of a reflect-padded conv's p-pixel output frame, for a
    VALID conv each (``layers._conv_reflect_fwd_body``): the top and
    bottom 3p rows reflect-padded in W (outputs rows [0, p) and [H-p, H),
    every column), the left and right 3p columns (rows [p, H-p)).  They
    read only x's 2p-wide border slabs (``_BorderSlabs`` where x needs a
    gradient)."""
    if _needs_grad(x):
        top, bot, left, right = _BorderSlabs.apply(x, p)
    else:
        h, w = x.shape[1], x.shape[2]
        top, bot = x[:, :2 * p], x[:, h - 2 * p:]
        left, right = x[:, :, :2 * p], x[:, :, w - 2 * p:]
    wpad = lambda t: torch.cat(  # noqa: E731
        [t[:, :, 1:p + 1].flip(2), t, t[:, :, -p - 1:-1].flip(2)], 2)
    top = torch.cat([top[:, 1:p + 1].flip(1), top], 1)
    bot = torch.cat([bot, bot[:, -p - 1:-1].flip(1)], 1)
    left = torch.cat([left[:, :, 1:p + 1].flip(2), left], 2)
    right = torch.cat([right, right[:, :, -p - 1:-1].flip(2)], 2)
    return wpad(top), wpad(bot), left, right


def set_reflect_frame(y: torch.Tensor, strips: Sequence[torch.Tensor],
                      p: int) -> torch.Tensor:
    """Write the frame outputs of ``reflect_strips``'s four sources into
    ``y`` (NHWC), in place; returns ``y``."""
    h = y.shape[1]
    top, bot, left, right = strips
    y[:, :p] = top
    y[:, h - p:] = bot
    y[:, p:h - p, :p] = left
    y[:, p:h - p, y.shape[2] - p:] = right
    return y


def _conv_reflect_forward(w: torch.Tensor, x: torch.Tensor,
                          cd) -> torch.Tensor:
    """conv(reflect_pad(x, p), w, VALID) without the padded input: the
    zero-pad SAME conv, whose outputs at least p from every edge read no
    pad, then the p-pixel frame recomputed from reflect sources by four
    strip convs and written over it (``_conv_reflect_fwd_body``).  The
    SAME conv keeps NHWC in and out (channels_last for cuDNN)."""
    p = _odd_kernel(w) // 2
    xc, wc = x.to(cd), w.to(cd)
    y = _nhwc(F.conv2d(_nchw(xc), wc, padding=p))
    if p == 0:
        return y
    return set_reflect_frame(y, [_nhwc(F.conv2d(_nchw(s), wc))
                                 for s in reflect_strips(xc, p)], p)


def _conv_reflect_backward(w, x, dy, cd, need_dw: bool, need_dx: bool):
    """(dw, dx) of ``_conv_reflect_forward`` (``_conv_reflect_cv_bwd``):
    dx is the SAME dgrad, which is the padded domain's gradient g without
    its frame, plus the reflect-pad adjoint's mirror folds of g's p-wide
    frame, recomputed from dy's edge strips (W first, then the H strips
    W-folded); dw the wgrad over a transient padded input.  Both are the
    library's conv backward on real NHWC tensors, whose layout it keeps
    (``torch.nn.grad``'s helpers pass an expanded stand-in for the other
    operand, and cuDNN then transposes in and out)."""
    p = w.shape[2] // 2
    wc, dyc, xc = w.to(cd), dy.to(cd), x.to(cd)

    def conv_bwd(inp, pad, mask):
        return torch.ops.aten.convolution_backward(
            _nchw(dyc), _nchw(inp), wc, None, [1, 1], [pad, pad], [1, 1],
            False, [0, 0], 1, mask)

    dw = dx = None
    if need_dx:
        h, wd = x.shape[1], x.shape[2]
        dx = _nhwc(conv_bwd(xc, p, [True, False, False])[0])
        if p:
            w_rot = wc.flip(2, 3).transpose(0, 1)  # (Cin, Cout, k, k)

            def g(t, ph, pw):  # frame of g from a zero-padded dy strip
                return _nhwc(F.conv2d(F.pad(_nchw(t), (*pw, *ph)), w_rot))

            dx[:, :, 1:p + 1] += g(dyc[:, :, :p], (p, p), (2 * p, 0)).flip(2)
            dx[:, :, wd - p - 1:wd - 1] += g(
                dyc[:, :, wd - p:], (p, p), (0, 2 * p)).flip(2)
            dx[:, 1:p + 1] += unpad_reflect_transpose(
                g(dyc[:, :p], (2 * p, 0), (2 * p, 2 * p)), p, p, 2).flip(1)
            dx[:, h - p - 1:h - 1] += unpad_reflect_transpose(
                g(dyc[:, h - p:], (0, 2 * p), (2 * p, 2 * p)), p, p,
                2).flip(1)
        dx = dx.to(x.dtype)
    if need_dw:
        dw = conv_bwd(_reflect_pad(xc, p, p, p, p), 0,
                      [False, True, False])[1].to(w.dtype)
    return dw, dx


class _ConvReflect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x, cd):
        ctx.cd = cd
        ctx.save_for_backward(w, x)
        return _conv_reflect_forward(w, x, cd)

    @staticmethod
    def backward(ctx, dy):
        w, x = ctx.saved_tensors
        dw, dx = _conv_reflect_backward(w, x, dy, ctx.cd,
                                        *ctx.needs_input_grad[:2])
        return dw, dx, None


def conv2d_reflect_pad_free(params: Mapping, x: torch.Tensor,
                            compute_dtype=None,
                            bias: bool = True) -> torch.Tensor:
    """``conv2d(params, reflect_pad(x, k // 2), 1, "VALID")`` without the
    padded activation, forward or backward (``layers.conv2d_reflect`` of
    the JAX package): an ``autograd.Function`` where an input needs a
    gradient, its forward body alone otherwise.  Odd kernels, stride 1."""
    cd = compute_dtype or x.dtype
    w = params["w"]
    _odd_kernel(w)
    if _needs_grad(w, x):
        y = _ConvReflect.apply(w, x, cd)
    else:
        y = _conv_reflect_forward(w, x, cd)
    return _add_bias(y, params, bias, cd)


def conv2d_reflect_gather(params: Mapping, x: torch.Tensor,
                          compute_dtype=None,
                          bias: bool = True) -> torch.Tensor:
    """The reflect conv as the padded input (``reflect_pad``: the gather,
    the strip-add adjoint) and a VALID conv."""
    cd = compute_dtype or x.dtype
    k = _odd_kernel(params["w"])
    return conv2d(params, reflect_pad(x.to(cd), k // 2), 1, "VALID", cd,
                  bias)


def conv2d_reflect_ref(params: Mapping, x: torch.Tensor, compute_dtype=None,
                       bias: bool = True) -> torch.Tensor:
    """The plain twin: the gather with autograd's adjoint, a VALID conv."""
    cd = compute_dtype or x.dtype
    k = _odd_kernel(params["w"])
    return conv2d(params, reflect_pad_ref(x.to(cd), k // 2), 1, "VALID", cd,
                  bias)


# The nets' reflect conv (odd kernels only): the gather + VALID form, the
# faster on an H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 30,
# forward + backward, bf16, device time by the profiler): 1.829 against the
# pad-free form's 1.962 ms at c1 (16,256,512,3 -> 64, k7), 0.999 against
# 1.112 ms at a resblock conv (16,64,128,256 -> 256, k3); a ResNet sggan
# step at b=16 busy 48.97 against 51.20 ms, a cycle step at b=8 142.75
# against 157.72.  The pad-free form's strip convs and frame writes cost
# more than the padded copy they save there.
conv2d_reflect = conv2d_reflect_gather
