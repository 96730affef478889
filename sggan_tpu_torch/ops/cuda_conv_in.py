"""Fused reflect-pad(1) -> conv3x3 -> instance norm -> act (K2), the
resblock body as one op.

Port of ``sggan_tpu/ops/pallas_conv_in.py``.  The forward on a CUDA tensor
is the hand-written kernel ``csrc/conv3_in.cu``; on a CPU tensor it is the
plain twin ``conv3_in_ref``.  There is no fallback from one to the other.
The backward follows ``pallas_conv_in._bwd`` line by line, with no forward
recompute: the norm part is K1's backward on the saved ``y16`` (the kernel
``cuda_in.instance_norm_bwd_cuda``, on the CPU ``instance_norm_bwd_ref``),
dgrad and wgrad are library convolutions as the JAX package leaves them to
XLA, and the dgrad over the padded plane is folded through the reflect
pad's adjoint.

Weights are in the layout the port's ``conv2d`` takes, ``(cout, cin, 3,
3)``, so a resblock's ``conv1.w`` feeds ``conv3_in`` as it is; the wrapper
packs them for the kernel.  ``conv3_in_unfused`` is the library path K2 is
measured against (``conv3_in_xla`` in the JAX package).

Not carried over from the TPU module: ``interpret``, ``tile_h`` and
``im2col`` pick among TPU implementations of the one function; the row-tile
divisibility of ``supported``, the 128-lane channel padding and the
8-aligned width are properties of Mosaic, not of the function.

``conv_plan`` is the launch plan of one call, pure Python: the conv
route, its tile, ring depth, shared bytes and grid, and the spatial tile
count that sizes the kernel's scratch of partial sums.  The wrapper
allocates from it and passes it to the kernel, which refuses a plan that
is not its route's own.

``launches`` counts the calls that launched the kernel and
``route_launches`` the conv kernel each ran: ``k2_conv_wgmma`` (bf16, Cin
and Cout multiples of 16: warpgroup MMA) or ``k2_conv_scalar`` (f32, and
bf16 at any other channel count).  Both are kernels of the same source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, cuda_in
from .layers import (_nchw, _nhwc, conv2d_reflect, reflect_pad,
                     unpad_reflect_transpose)
from .norm import (IN_EPS, _ref_forward, instance_norm,
                   instance_norm_bwd_ref)

launches = 0
route_launches = {"k2_conv_wgmma": 0, "k2_conv_scalar": 0}

# csrc/conv3_in.cu's conv routes by the entry's route code
_ROUTE_CODE = {"scalar": 0, "wgmma": 1}
SMEM_OPTIN = 232448     # shared bytes a block may use on the H100
STATIC_SMEM = 4096      # the wgmma kernel's static epilogue sums
# wgmma route: two warpgroups a block, each 4 output rows of 64 pixels, by
# 64 output channels; chunks of 16 input channels in a ring of 4 stages;
# the f32 accumulator tile's row stride is bn + 8.  The one tile the source
# builds (kWgBN, kWgR, kWgStages), the fastest of those measured at both
# shapes of perf_conv_in (PERF.md)
_WG_TW, _WG_BN, _WG_ROWS, _WG_STAGES = 64, 64, 8, 4


class ConvPlan(NamedTuple):
    """How the conv pass of one call runs: ``route`` ("wgmma" or
    "scalar"); a block's tile of ``tile_h`` x ``tile_w`` output pixels by
    ``bn`` output channels; ``stages`` chunks in its cp.async ring;
    ``smem`` dynamic shared bytes a block; ``tiles`` spatial tiles a
    sample (the second dimension of the partial sums); ``grid`` the
    launch's (tiles x Cout tiles, N)."""
    route: str
    tile_h: int
    tile_w: int
    bn: int
    stages: int
    smem: int
    tiles: int
    grid: Tuple[int, int]

    @property
    def kernel(self) -> str:
        """The conv kernel's name in csrc/conv3_in.cu."""
        return f"k2_conv_{self.route}"


def wgmma_smem(bn: int, rows: int, stages: int) -> int:
    """Dynamic shared bytes of ``k2_conv_wgmma`` with a tile of ``rows``
    x 64 pixels by ``bn`` channels: the ring of halo + weight stages, or
    the f32 accumulator tile that reuses it."""
    halo = (rows + 2) * (_WG_TW + 2) * 16 * 2
    stage = halo + 9 * bn * 16 * 2
    return max(stages * stage, rows * _WG_TW * (bn + 8) * 4)


def conv_plan(n: int, h: int, w: int, cin: int, cout: int,
              dtype: torch.dtype) -> ConvPlan:
    """The conv pass of one K2 forward on an (n, h, w, cin) tensor of
    ``dtype`` to ``cout`` channels: wgmma for bf16 with Cin and Cout
    multiples of 16, else scalar.  Raises on a shape the kernel does not
    take."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_plan: dtype must be float32 or bfloat16, "
                         f"got {dtype}")
    # a sample's plane is indexed in 32 bits
    if (min(h, w) < 2 or not 1 <= n <= 65535 or min(cin, cout) < 1
            or h * w * max(cin, cout) >= 2 ** 31):
        raise ValueError(f"conv_plan: shape {(n, h, w, cin, cout)} out of "
                         "the kernel's range")
    if dtype == torch.bfloat16 and cin % 16 == 0 and cout % 16 == 0:
        route, th, tw, bn, stages = ("wgmma", _WG_ROWS, _WG_TW, _WG_BN,
                                     _WG_STAGES)
        smem = wgmma_smem(bn, th, stages)
    else:
        route, th, tw, bn, stages, smem = "scalar", 8, 16, 64, 1, 0
    tiles = -(-h // th) * -(-w // tw)
    return ConvPlan(route, th, tw, bn, stages, smem, tiles,
                    (tiles * -(-cout // bn), n))


def supported(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Shapes the op takes: NHWC x, a 3x3 kernel ``(cout, cin, 3, 3)``
    whose cin is x's, and a plane of at least 2x2 (reflect pad 1)."""
    return (x.dim() == 4 and w.dim() == 4 and tuple(w.shape[2:]) == (3, 3)
            and w.shape[1] == x.shape[3] and x.shape[1] >= 2
            and x.shape[2] >= 2)


def _check(x: torch.Tensor, w: torch.Tensor, act: Optional[str]) -> None:
    cuda_in.check_act(act)
    if not supported(x, w):
        raise ValueError(f"conv3_in takes NHWC x with H, W >= 2 and a "
                         f"(cout, cin, 3, 3) kernel with x's cin, got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")


def conv3_in_ref(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, eps: float = IN_EPS,
                 act: Optional[str] = "relu", alpha: float = 0.3
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Plain PyTorch twin of the forward kernel, step by step: reflect pad,
    conv of x and the kernel cast to x's dtype with f32 accumulation,
    rounded once to x's dtype (``y16``), f32 moments of the rounded
    ``y16``, normalize, gamma/beta, act.  Returns (y, y16, mean, rsig),
    the moments as (N, Cout) f32."""
    _check(x, w, act)
    # f32 products of bf16 values are exact, so an f32 conv of the upcast
    # operands is the f32 accumulation the kernel does
    xp = reflect_pad(x, 1).float()
    acc = F.conv2d(_nchw(xp), w.to(x.dtype).float())
    y16 = _nhwc(acc).to(x.dtype)
    y, mean, rsig = _ref_forward(y16, gamma, beta, eps, act, alpha)
    return y, y16, mean, rsig


@functools.cache
def _kernel():
    lib = _build.load("conv3_in")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.sggan_conv3_in_fwd
    fwd.argtypes = [p] * 9 + [i] * 16 + [f, f, p]
    fwd.restype = ctypes.c_int
    return fwd


def pack_weights(w: torch.Tensor, dtype: torch.dtype,
                 p: ConvPlan) -> torch.Tensor:
    """The kernel's layout of a ``(cout, cin, 3, 3)`` kernel, in
    ``dtype``: on the wgmma route ``(cin / 16, 3, 3, cout, 16)``, one
    chunk's weights K-major as its descriptor reads them; else ``(3, 3,
    cin, cout)``."""
    cout, cin = w.shape[:2]
    if p.route == "wgmma":
        src = w.detach().view(cout, cin // 16, 16, 3, 3).permute(1, 3, 4, 0, 2)
    else:
        src = w.detach().permute(2, 3, 1, 0)
    return torch.empty(src.shape, dtype=dtype, device=w.device).copy_(src)


def conv3_in_cuda(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, eps: float = IN_EPS,
                  act: Optional[str] = "relu", alpha: float = 0.3
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The kernel on a contiguous NHWC CUDA tensor (f32 or bf16), a
    ``(cout, cin, 3, 3)`` kernel of any float dtype (cast to x's, as
    ``conv2d`` casts it) and f32 ``gamma``/``beta`` of shape (cout,).
    Returns (y, y16, mean, rsig): y and the conv output y16 in x's dtype,
    the moments as (N, cout) f32, the conv route and tile from
    ``conv_plan``.  Launches on the current stream without synchronising;
    raises on any input the kernel does not take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the conv3_in kernel needs CUDA tensors, got x on "
                         f"{x.device}")
    _check(x, w, act)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("x must be non-empty, contiguous NHWC")
    if w.device != x.device or not w.is_floating_point():
        raise ValueError(f"w must be a float tensor on {x.device}, got "
                         f"{w.dtype} on {w.device}")
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    cuda_in._check_f32(y, gamma=gamma, beta=beta)
    p = conv_plan(n, h, wd, cin, cout, x.dtype)
    if p.route != "scalar" and x.data_ptr() % 16:
        raise ValueError(f"the {p.route} route reads x in 16-byte packets; "
                         "x does not start on 16 bytes")
    wk = pack_weights(w, x.dtype, p)
    part = torch.empty((n, p.tiles, 2, cout), dtype=torch.float32,
                       device=x.device)
    y16 = torch.empty_like(y)
    mean = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    rsig = torch.empty_like(mean)
    # the normalize pass splits the plane as K1 does for one channel tile
    rows, n_split = cuda_in.split_rows(n, h * wd, cuda_in._LANES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), wk.data_ptr(), gamma.data_ptr(),
                        beta.data_ptr(), y.data_ptr(), y16.data_ptr(),
                        mean.data_ptr(), rsig.data_ptr(), part.data_ptr(),
                        n, h, wd, cin, cout, int(x.dtype == torch.bfloat16),
                        _ROUTE_CODE[p.route], p.tile_h, p.tile_w, p.bn,
                        p.stages, p.smem, p.tiles, rows, n_split,
                        cuda_in._ACTS[act], eps, alpha, stream)
    if err:
        raise RuntimeError(f"conv3_in kernel launch failed: CUDA error {err}")
    launches += 1
    route_launches[p.kernel] += 1
    return y, y16, mean, rsig


def conv_grads(x: torch.Tensor, w: torch.Tensor, d_y16: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``conv(reflect_pad(x, 1), w)`` given the gradient of its
    output in the compute dtype: dgrad over the padded (H + 2, W + 2)
    plane, folded through the pad's adjoint on both axes, and wgrad on the
    padded input.  Both are library convolutions."""
    cd = x.dtype
    wc = w.to(cd)
    g = _nchw(d_y16)
    dxp = _nhwc(F.conv_transpose2d(g, wc))  # (N, H + 2, W + 2, cin)
    dx = unpad_reflect_transpose(dxp, 1, 1, axis=1)
    dx = unpad_reflect_transpose(dx, 1, 1, axis=2)
    xp = _nchw(reflect_pad(x, 1))
    dw = torch.nn.grad.conv2d_weight(xp, wc.shape, g)
    return dx.to(cd), dw.to(w.dtype)


class _Conv3In(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, eps, act, alpha):
        fwd = conv3_in_ref if x.device.type == "cpu" else conv3_in_cuda
        y, y16, mean, rsig = fwd(x, w, gamma, beta, eps, act, alpha)
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(x, w, gamma, beta, y16, mean, rsig)
            ctx.act, ctx.alpha = act, alpha
        return y

    @staticmethod
    def backward(ctx, dy):
        # pallas_conv_in._bwd: the norm part on the saved y16, then the
        # conv's gradients from d_y16 in the compute dtype
        x, w, gamma, beta, y16, mean, rsig = ctx.saved_tensors
        norm_bwd = (instance_norm_bwd_ref if y16.device.type == "cpu"
                    else cuda_in.instance_norm_bwd_cuda)
        d_y16, dgamma, dbeta = norm_bwd(y16, dy.contiguous(), gamma, beta,
                                        mean, rsig, ctx.act, ctx.alpha)
        dx, dw = conv_grads(x, w, d_y16)
        return (dx, dw, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None,
                None, None)


def conv3_in(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
             beta: torch.Tensor, eps: float = IN_EPS,
             act: Optional[str] = "relu", alpha: float = 0.3) -> torch.Tensor:
    """reflect_pad(1) -> conv3x3 VALID -> instance norm -> act, fused.

    x: (N, H, W, Cin) activation in the compute dtype; w: (Cout, Cin, 3,
    3), any float dtype; gamma, beta: (Cout,).  The same real function as
    ``instance_norm(in_params, conv2d_reflect(conv_params, x, bias=False),
    act=act)``, the resblock body."""
    return _Conv3In.apply(x, w, gamma, beta, eps, act, alpha)


def conv3_in_unfused(conv_params: Mapping, in_params: Mapping,
                     x: torch.Tensor, eps: float = IN_EPS,
                     act: Optional[str] = "relu", alpha: float = 0.3,
                     compute_dtype=None) -> torch.Tensor:
    """The library composition the kernel competes with, the resblock body
    as ``GeneratorResnet._res_block`` runs it: reflect-pad gather, cuDNN
    conv, K1."""
    y = conv2d_reflect(conv_params, x, compute_dtype or x.dtype, bias=False)
    return instance_norm(in_params, y, act=act, alpha=alpha, eps=eps)
