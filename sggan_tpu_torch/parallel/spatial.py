"""Spatial sharding of the semantic nets, port of
``sggan_tpu/parallel/spatial.py`` (its semantic half): the image's rows
split over the ``space`` ranks of a data row, optionally its columns over
the ``wspace`` ranks (``parallel/mesh.py``), one rank per card.

* ``halo_exchange``: a local block extended along H (or W) with rows
  from its neighbours, sent and received over ``torch.distributed``
  (spatial.py:53-81).  At the plane's edge it receives zeros (a SAME
  conv's padding) or nothing, and the caller reflects locally (a REFLECT
  pad, spatial.py:251-265).  Its backward sends the gradient of each
  received row back to the rank that sent it, which adds it into its
  edge rows.  NCCL moves device tensors (``dist.batch_isend_irecv``);
  gloo's point-to-point takes CPU tensors only, so on a gloo group the
  rows go through host buffers, by the group's backend.
* H is exchanged before W, so the columns a rank sends carry the halo
  rows it received from its H neighbours: the corners (spatial.py:26-31).
* ``instance_norm_sp`` (``ops/norm.py``): the moments summed over the
  plane's ranks, K1's two passes with the all-reduce between them.
* The convs: TF-SAME pads from the global size with halo rows and a
  VALID conv (``conv2d_sp``), a VALID conv after a sharded reflect pad,
  and the transpose conv on a block extended by one row each way, then
  cropped (``conv2d_transpose_sp``).
* The nets: the ResNet and U-Net generators with the parameters of the
  port's modules, and the semantic discriminator with its patch head.

Compute dtypes as the JAX functions set them: the convs in the compute
dtype, the norms' moments in f32, the derivative filters in f32.
``halo_bytes`` and ``halo_calls`` count the exchanges (forward and
backward), for a reader who measures them; the program never reads them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.deriv import deriv_kernel_diff, deriv_kernel_sobel
from ..ops.deriv import depthwise_conv2d
from ..ops.layers import (_same_pads, conv2d, conv2d_transpose, dropout,
                          leaky_relu, reflect_pad, relu, tanh)
from ..ops.norm import instance_norm_sp as _in_sp
from .mesh import Axis, Grid

halo_bytes = 0
halo_calls = 0


# ------------------------------------------------------------ halo exchange

def _p2p(axis: Axis, sends, recvs, like: torch.Tensor):
    """Point-to-point over ``axis.group``: ``sends`` [(tensor, peer)] and
    ``recvs`` [(shape, peer)] (global ranks), all posted, then waited;
    returns the received tensors on ``like``'s device, in its dtype.  A
    gloo group's point-to-point takes CPU tensors only, so on a card the
    rows go through the host there; NCCL's moves the device tensors in
    one ``batch_isend_irecv``."""
    global halo_bytes, halo_calls
    if not sends and not recvs:
        return []
    gloo = dist.get_backend(axis.group) == dist.Backend.GLOO
    dev = torch.device("cpu") if gloo else like.device
    out = [t.to(dev).contiguous() for t, _ in sends]  # alive until waited
    bufs = [torch.empty(s, dtype=like.dtype, device=dev) for s, _ in recvs]
    with torch.profiler.record_function("sp.halo"):
        if gloo:
            works = [dist.isend(t, peer, axis.group)
                     for t, (_, peer) in zip(out, sends)]
            works += [dist.irecv(b, peer, axis.group)
                      for b, (_, peer) in zip(bufs, recvs)]
        else:
            works = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, t, peer, axis.group)
                 for t, (_, peer) in zip(out, sends)]
                + [dist.P2POp(dist.irecv, b, peer, axis.group)
                   for b, (_, peer) in zip(bufs, recvs)])
        for w in works:
            w.wait()
    halo_bytes += sum(t.numel() for t in out) * like.element_size()
    halo_calls += 1
    return [b.to(like.device) for b in bufs]


class _Halo(torch.autograd.Function):
    """x extended along ``dim`` by ``top`` slices of the previous rank's
    block and ``bot`` of the next's; at the plane's edge zeros with
    ``fill``, else nothing there (the caller pads)."""

    @staticmethod
    def forward(ctx, x, top, bot, axis, dim, fill):
        n = x.shape[dim]
        if top > n or bot > n:
            raise ValueError(f"a halo of ({top}, {bot}) over a local block "
                             f"of {n}")
        sends, recvs = [], []
        if axis.next is not None and top:
            sends.append((x.narrow(dim, n - top, top), axis.next))
        if axis.prev is not None and bot:
            sends.append((x.narrow(dim, 0, bot), axis.prev))
        shape = list(x.shape)

        def part(k):
            shape[dim] = k
            return tuple(shape)
        if axis.prev is not None and top:
            recvs.append((part(top), axis.prev))
        if axis.next is not None and bot:
            recvs.append((part(bot), axis.next))
        got = iter(_p2p(axis, sends, recvs, x))
        parts = []
        lo = top if (axis.prev is not None or fill) else 0
        hi = bot if (axis.next is not None or fill) else 0
        if lo:
            parts.append(next(got) if axis.prev is not None
                         else x.new_zeros(part(top)))
        parts.append(x)
        if hi:
            parts.append(next(got) if axis.next is not None
                         else x.new_zeros(part(bot)))
        ctx.args = (top, bot, axis, dim, lo, hi)
        return torch.cat(parts, dim) if len(parts) > 1 else x.clone()

    @staticmethod
    def backward(ctx, dy):
        top, bot, axis, dim, lo, hi = ctx.args
        n = dy.shape[dim] - lo - hi
        dx = dy.narrow(dim, lo, n).clone()
        sends, recvs = [], []
        # the rows received from a neighbour send their gradient back
        if axis.prev is not None and top:
            sends.append((dy.narrow(dim, 0, top), axis.prev))
        if axis.next is not None and bot:
            sends.append((dy.narrow(dim, lo + n, bot), axis.next))
        shape = list(dx.shape)

        def part(k):
            shape[dim] = k
            return tuple(shape)
        if axis.next is not None and top:
            recvs.append((part(top), axis.next))
        if axis.prev is not None and bot:
            recvs.append((part(bot), axis.prev))
        got = iter(_p2p(axis, sends, recvs, dy))
        # and the gradient of the rows this rank sent is added into them
        if axis.next is not None and top:
            dx.narrow(dim, n - top, top).add_(next(got))
        if axis.prev is not None and bot:
            dx.narrow(dim, 0, bot).add_(next(got))
        return dx, None, None, None, None, None


def halo_exchange(x: torch.Tensor, top: int, bot: int, axis: Axis,
                  dim: int = 1, fill: bool = True) -> torch.Tensor:
    """The local block extended along ``dim`` (1 = H, 2 = W) with ``top``
    slices from the previous rank and ``bot`` from the next (zeros at the
    plane's edges, or nothing there without ``fill``); an axis of one rank
    pads zeros (or nothing)."""
    if axis.group is None:
        if not fill or not (top or bot):
            return x
        pad = [0, 0] * (x.dim() - 1 - dim) + [top, bot]
        return F.pad(x, pad)
    return _Halo.apply(x, top, bot, axis, dim, fill)


# ------------------------------------------------------------- sharded ops

def conv2d_sp(params, x: torch.Tensor, stride: int, grid: Grid,
              compute_dtype=None, bias: bool = True) -> torch.Tensor:
    """TF-SAME conv of a sharded block (spatial.py:92-114): the pads of the
    global size as halo rows (and columns), then a VALID conv.  The local
    H (and W) must divide by the stride."""
    cd = compute_dtype or x.dtype
    k = params["w"].shape[2]
    top, bot = _same_pads(x.shape[1] * grid.space, k, stride)
    xh = halo_exchange(x.to(cd), top, bot, grid.h, 1)
    wl, wr = _same_pads(x.shape[2] * grid.wspace, k, stride)
    xh = halo_exchange(xh, wl, wr, grid.wax, 2)
    return conv2d(params, xh, stride, "VALID", cd, bias=bias)


def conv2d_valid_after_reflect_sp(params, x_padded: torch.Tensor,
                                  compute_dtype=None,
                                  bias: bool = True) -> torch.Tensor:
    """VALID conv of a block that ``reflect_pad_sp`` extended
    (spatial.py:117-128)."""
    return conv2d(params, x_padded, 1, "VALID",
                  compute_dtype or x_padded.dtype, bias=bias)


def conv2d_transpose_sp(params, x: torch.Tensor, stride: int, grid: Grid,
                        compute_dtype=None, bias: bool = True
                        ) -> torch.Tensor:
    """TF Conv2DTranspose (SAME) of a sharded block (spatial.py:131-164):
    one real row (and column) each way, the port's SAME transpose conv on
    the extended block, ``stride`` rows cropped on each side.  One row is
    enough where pad_top <= stride and k - pad_top - stride <= stride,
    true for the 3x3 s1 and s2 decoders."""
    cd = compute_dtype or x.dtype
    k = params["w"].shape[2]
    pt = max(k - stride, 0) // 2
    assert pt <= stride and k - pt - stride <= stride, (
        f"one-row halo insufficient for k={k}, stride={stride}")
    xh = halo_exchange(x.to(cd), 1, 1, grid.h, 1)
    w_sharded = grid.wax.group is not None
    if w_sharded:
        xh = halo_exchange(xh, 1, 1, grid.wax, 2)
    y = conv2d_transpose(params, xh, stride, "SAME", cd, bias=False)
    y = y[:, stride:-stride]
    if w_sharded:
        y = y[:, :, stride:-stride]
    if bias and "b" in params:
        y = y + params["b"].to(cd)
    return y.contiguous()


def instance_norm_sp(params, x: torch.Tensor, grid: Grid,
                     act: Optional[str] = None,
                     alpha: float = 0.3) -> torch.Tensor:
    """Instance norm of a sharded block, the moments summed over the
    plane's ranks (spatial.py:167-189; ``ops.norm.instance_norm_sp``)."""
    count = x.shape[1] * grid.space * x.shape[2] * grid.wspace
    return _in_sp(params, x, count, grid.plane, act, alpha)


def reflect_pad_sp(x: torch.Tensor, p: int, grid: Grid) -> torch.Tensor:
    """REFLECT pad of a sharded block (spatial.py:251-276): neighbour rows
    (columns) at interior boundaries, a local reflection at the plane's
    edges, through the port's reflect pad.  The halos come first, H then
    W; the pad's gathers commute with them, so the corners are the JAX
    package's."""
    y = halo_exchange(x, p, p, grid.h, 1, fill=False)
    pads = [p if grid.h.first else 0, p if grid.h.last else 0]
    if grid.wax.group is not None:
        y = halo_exchange(y, p, p, grid.wax, 2, fill=False)
        pads += [p if grid.wax.first else 0, p if grid.wax.last else 0]
    else:
        pads += [p, p]
    if not any(pads):
        return y
    return reflect_pad(y, [(0, 0), tuple(pads[:2]), tuple(pads[2:]),
                           (0, 0)])


def depthwise_conv2d_sp(x: torch.Tensor, w_tf: torch.Tensor, grid: Grid,
                        padding: str = "SAME") -> torch.Tensor:
    """tf.nn.depthwise_conv2d of a sharded block in f32
    (spatial.py:279-298): SAME exchanges the kernel's halo; VALID expects
    the rows already there (``reflect_pad_sp``)."""
    kh, kw = w_tf.shape[0], w_tf.shape[1]
    xf = x.float()
    if padding == "SAME":
        xf = halo_exchange(xf, (kh - 1) // 2, kh // 2, grid.h, 1)
        if grid.wax.group is not None:
            xf = halo_exchange(xf, (kw - 1) // 2, kw // 2, grid.wax, 2)
        else:
            wl, wr = _same_pads(x.shape[2], kw, 1)
            xf = F.pad(xf, (0, 0, wl, wr))
    return depthwise_conv2d(xf, w_tf, "VALID")


def tf_deriv_sp(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Sobel derivative stack of a sharded block (``ops.deriv.tf_deriv``)."""
    return depthwise_conv2d_sp(x, deriv_kernel_sobel(x.shape[-1]), grid)


def seg_boundary_weight_sp(seg: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Class-boundary weight map of a sharded seg block
    (``ops.deriv.seg_boundary_weight``)."""
    segp = reflect_pad_sp(seg.float(), 1, grid)
    conved = depthwise_conv2d_sp(segp, deriv_kernel_diff(seg.shape[-1]),
                                 grid, padding="VALID").abs()
    return torch.sign(conved.sum(-1, keepdim=True)).abs()


def gradloss_criterion_sp(in_: torch.Tensor, target: torch.Tensor,
                          weight: torch.Tensor, grid: Grid) -> torch.Tensor:
    """``losses.gradloss_criterion`` with sharded derivatives
    (spatial.py:320-327); the mean is local: the step averages it."""
    d = (tf_deriv_sp(in_, grid).abs() - tf_deriv_sp(target, grid).abs()
         ).abs()
    return (weight * d.mean(-1, keepdim=True)).mean()


# --------------------------------------------- spatially-sharded forwards

def _res_block_sp(b, y: torch.Tensor, grid: Grid, cd) -> torch.Tensor:
    z = reflect_pad_sp(y, 1, grid)
    z = conv2d_valid_after_reflect_sp(b["conv1"], z, cd, bias=False)
    z = instance_norm_sp(b["in1"], z, grid, act="relu")
    z = reflect_pad_sp(z, 1, grid)
    z = conv2d_valid_after_reflect_sp(b["conv2"], z, cd, bias=False)
    z = instance_norm_sp(b["in2"], z, grid)
    return z + y


def generator_resnet_sp(gen, x: torch.Tensor, grid: Grid,
                        compute_dtype=None) -> torch.Tensor:
    """``GeneratorResnet``'s forward on a sharded block, with its
    parameters (spatial.py:332-370).  As the JAX sp forward, the head is
    the reflect pad and a VALID conv (no space-to-depth head) and nothing
    is recomputed: ``--pad_free_head`` and ``--remat`` do not reach it
    (the JAX function has neither, spatial.py:332-370)."""
    from ..models.generator_resnet import N_BLOCKS
    cd = compute_dtype or x.dtype
    y = reflect_pad_sp(x.to(cd), 3, grid)
    # bias=False where an IN follows: the norm removes it exactly
    y = conv2d_valid_after_reflect_sp(gen.c1, y, cd, bias=False)
    y = instance_norm_sp(gen.c1_in, y, grid, act="relu")
    y = conv2d_sp(gen.c2, y, 2, grid, cd, bias=False)
    y = instance_norm_sp(gen.c2_in, y, grid, act="relu")
    y = conv2d_sp(gen.c3, y, 2, grid, cd, bias=False)
    y = instance_norm_sp(gen.c3_in, y, grid, act="relu")
    for i in range(N_BLOCKS):
        y = _res_block_sp(getattr(gen, f"r{i + 1}"), y, grid, cd)
    y = conv2d_transpose_sp(gen.d1, y, 2, grid, cd, bias=False)
    y = instance_norm_sp(gen.d1_in, y, grid, act="relu")
    y = conv2d_transpose_sp(gen.d2, y, 2, grid, cd, bias=False)
    y = instance_norm_sp(gen.d2_in, y, grid, act="relu")
    y = reflect_pad_sp(y, 3, grid)
    y = conv2d_valid_after_reflect_sp(gen.out, y, cd)
    return tanh(y.float())


def generator_unet_sp(gen, x: torch.Tensor, grid: Grid, compute_dtype=None,
                      drop_masks: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
    """``GeneratorUnet``'s forward on a sharded block (spatial.py:373-412):
    every conv 3x3 stride 1, so one halo row each way.  ``drop_masks``:
    this shard's d1-d3 keep masks (local shapes), or None (no dropout)."""
    from ..models.generator_unet import N_DROP
    cd = compute_dtype or x.dtype
    y = x.to(cd)
    enc = []
    for i in range(1, 9):
        y = conv2d_sp(getattr(gen, f"e{i}"), y, 1, grid, cd, bias=False)
        y = instance_norm_sp(getattr(gen, f"e{i}_in"), y, grid,
                             act="relu" if i == 8 else "leaky_relu")
        enc.append(y)
    for i in range(1, 8):
        # d1-d3 keep the bias (dropout between the convT and IN); d4-d7
        # feed IN directly, which removes it exactly
        y = conv2d_transpose_sp(getattr(gen, f"d{i}"), y, 1, grid, cd,
                                bias=i <= N_DROP)
        if i <= N_DROP and drop_masks is not None:
            y = dropout(y, gen.drop_rate, drop_masks[i - 1])
        y = instance_norm_sp(getattr(gen, f"d{i}_in"), y, grid)
        y = y + enc[7 - i]
        if i in (3, 7):
            y = relu(y)
    y = conv2d_transpose_sp(gen.d8, y, 1, grid, cd)
    return tanh(y.float())


def generator_sp(gen, x: torch.Tensor, grid: Grid, compute_dtype=None,
                 drop_masks=None) -> torch.Tensor:
    """The sharded forward of the port's ResNet or U-Net ``gen``."""
    from ..models.generator_resnet import GeneratorResnet
    if isinstance(gen, GeneratorResnet):
        return generator_resnet_sp(gen, x, grid, compute_dtype)
    return generator_unet_sp(gen, x, grid, compute_dtype, drop_masks)


def discriminator_sp(disc, x: torch.Tensor, mask: torch.Tensor, grid: Grid,
                     compute_dtype=None) -> torch.Tensor:
    """The semantic discriminator with its patch head
    (``models/discriminator.py``, ``head="patch"``) on a sharded block:
    the class map stays on the H/8 x W/8 grid, judged against this
    block's rows of the mask (spatial.py:415-435)."""
    if disc.head != "patch":
        raise ValueError("the spatial step's discriminator has the patch "
                         "head: the global VALID chain does not split")
    cd = compute_dtype or x.dtype
    y = leaky_relu(conv2d_sp(disc.h0, x.to(cd), 2, grid, cd))
    y = conv2d_sp(disc.h1, y, 2, grid, cd, bias=False)
    y = instance_norm_sp(disc.h1_in, y, grid, act="leaky_relu")
    y = conv2d_sp(disc.h2, y, 2, grid, cd, bias=False)
    y = instance_norm_sp(disc.h2_in, y, grid, act="leaky_relu")
    y = conv2d_sp(disc.h3, y, 1, grid, cd, bias=False)
    y = instance_norm_sp(disc.h3_in, y, grid, act="leaky_relu")
    y = conv2d_sp(disc.h4, y, 1, grid, cd).float()
    return (y * mask.float()).sum(-1, keepdim=True)
