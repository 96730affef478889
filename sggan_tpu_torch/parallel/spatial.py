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
  edge rows.  The rows move as the tensors they are, in one
  ``dist.batch_isend_irecv`` (NCCL's on the card, inside the step's CUDA
  graph; gloo's on the CPU); gloo takes no CUDA tensor, so on a gloo
  group a card's rows go through host buffers (``_via_host``).
* H is exchanged before W, so the columns a rank sends carry the halo
  rows it received from its H neighbours: the corners (spatial.py:26-31).
* ``instance_norm_sp`` (``ops/norm.py``): the moments summed over the
  plane's ranks, K1's two passes with the all-reduce between them.
* The convs: TF-SAME pads from the global size with halo rows and a
  VALID conv (``conv2d_sp``), a VALID conv after a sharded reflect pad,
  and the transpose conv on a block extended by one row each way, then
  cropped (``conv2d_transpose_sp``).
* ``batch_norm_sp`` (the pix2pix nets'): the batch's f32 sum and sum of
  squares over the block, all-reduced over the plane's ranks, so the
  moments are the data row's whole batch's (spatial.py:192-222); its
  backward all-reduces their cotangents over the same ranks, as the
  transpose of JAX's ``psum`` is a ``psum``.
* ``all_gather_h``/``_w`` put the plane together on every rank of the
  axis (a tiled all-gather); the backward gives each rank the sum of
  every rank's cotangent of its block (JAX's transpose, ``psum_scatter``):
  the loss terms of the other ranks that flow through the replicated
  layers come back that way.  ``scatter_h``/``_w`` take this rank's
  slice of a replicated block (spatial.py:225-248); the backward pads
  with zeros.
* The nets: the ResNet and U-Net generators with the parameters of the
  port's modules, the semantic discriminator with its patch head, and
  the pix2pix pair, whose deep middle runs replicated once the plane is
  too small to split (``pix2pix_sharded``, spatial.py:438-583).

Compute dtypes as the JAX functions set them: the convs in the compute
dtype, the norms' moments in f32, the derivative filters in f32.
``halo_bytes`` and ``halo_calls`` count the exchanges (forward and
backward), ``gather_bytes`` and ``gather_calls`` the gathers and their
backwards' reductions, for a reader who measures them; the program never
reads them.  A CUDA graph's replays pass neither the counters nor the
profiler ranges: ``train/fused.py``'s ``StepGraph`` records a step's
counts at its capture, and under a graph the collectives' time is NCCL's
kernels' in a trace.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.deriv import deriv_kernel_diff, deriv_kernel_sobel
from ..ops.deriv import depthwise_conv2d
from ..ops.layers import (_same_pads, conv2d, conv2d_transpose, dropout,
                          leaky_relu, reflect_pad, relu, tanh)
from ..ops.norm import BN_EPS, BN_MOMENTUM, batch_norm
from ..ops.norm import instance_norm_sp as _in_sp
from ..ops.norm import moments_all_reduce
from .mesh import Axis, Grid

halo_bytes = 0
halo_calls = 0
gather_bytes = 0
gather_calls = 0


# ------------------------------------------------------------ halo exchange

def _via_host(group, like: torch.Tensor) -> bool:
    """Whether a collective over ``group`` of tensors like ``like`` goes
    through host buffers: gloo takes no CUDA tensor, so a card's tensors
    on a gloo group do; NCCL's, and the CPU's on gloo, run the
    device-tensor code."""
    return like.device.type == "cuda" and \
        dist.get_backend(group) == dist.Backend.GLOO


def _p2p(axis: Axis, sends, recvs, like: torch.Tensor):
    """Point-to-point over ``axis.group``: ``sends`` [(tensor, peer)] and
    ``recvs`` [(shape, peer)] (global ranks), all posted, then waited;
    returns the received tensors on ``like``'s device, in its dtype.  The
    tensors move in one ``batch_isend_irecv``, but through the host one by
    one where ``_via_host``."""
    global halo_bytes, halo_calls
    if not sends and not recvs:
        return []
    host = _via_host(axis.group, like)
    dev = torch.device("cpu") if host else like.device
    out = [t.to(dev).contiguous() for t, _ in sends]  # alive until waited
    bufs = [torch.empty(s, dtype=like.dtype, device=dev) for s, _ in recvs]
    with torch.profiler.record_function("sp.halo"):
        if host:
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


class _SumOver(torch.autograd.Function):
    """``x`` summed over the ranks of ``group``; the backward sums the
    cotangents over the same ranks (JAX's transpose of ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return moments_all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return moments_all_reduce(dy.contiguous().clone(), ctx.group), None


def batch_norm_sp(params, state, x: torch.Tensor, grid: Grid,
                  training: bool, momentum: float = BN_MOMENTUM,
                  eps: float = BN_EPS):
    """Keras batch norm of a sharded block (spatial.py:192-222), as
    ``ops.norm.batch_norm`` but for the moments in training: the block's
    f32 sums over (N, H, W) all-reduced over the plane's ranks, n the data
    row's count, var = max(Q / n - mean^2, 0) (the JAX spatial form, not
    ``batch_norm``'s two passes); on the moving stats ``batch_norm``
    itself.  Returns ``(y, new_state)``."""
    if not training:  # the moving stats: no moments to sum
        return batch_norm(params, state, x, False, momentum, eps)
    xf = x.float()
    n = x.shape[0] * x.shape[1] * x.shape[2] * grid.space * grid.wspace
    sums = _SumOver.apply(torch.stack([xf.sum((0, 1, 2)),
                                       xf.square().sum((0, 1, 2))]),
                          grid.plane)
    mean = sums[0] / n
    # jnp.maximum: a tie's gradient is halved, as torch.maximum's
    var = torch.maximum(sums[1] / n - mean.square(), xf.new_zeros(()))
    m_mean, m_var = state["moving_mean"], state["moving_var"]
    new = {"moving_mean": (momentum * m_mean + (1 - momentum)
                           * mean.detach()).to(m_mean.dtype),
           "moving_var": (momentum * m_var + (1 - momentum)
                          * var.detach()).to(m_var.dtype)}
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["gamma"].float() + params["beta"].float()
    return y.to(x.dtype), new


class _Gather(torch.autograd.Function):
    """Every rank's block of ``axis`` put together along ``dim`` (a tiled
    all-gather, through the host where ``_via_host``); the backward gives
    this rank (``index`` in the axis) the sum of every rank's cotangent of
    its block."""

    @staticmethod
    def forward(ctx, x, axis, dim, index):
        global gather_bytes, gather_calls
        group = axis.group
        xs = (x.cpu() if _via_host(group, x) else x).contiguous()
        parts = [torch.empty_like(xs)
                 for _ in range(dist.get_world_size(group))]
        with torch.profiler.record_function("sp.gather"):
            dist.all_gather(parts, xs, group=group)
        gather_bytes += xs.numel() * xs.element_size()
        gather_calls += 1
        ctx.args = (group, dim, index, x.shape[dim])
        return torch.cat(parts, dim).to(x.device)

    @staticmethod
    def backward(ctx, dy):
        global gather_bytes, gather_calls
        group, dim, index, k = ctx.args
        total = dy.contiguous().clone()
        with torch.profiler.record_function("sp.gather"):
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        gather_bytes += total.numel() * total.element_size()
        gather_calls += 1
        return total.narrow(dim, index * k, k).contiguous(), None, None, None


def all_gather_h(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The whole H of the plane on every rank of the space axis
    (spatial.py:225-227)."""
    if grid.h.group is None:
        return x
    return _Gather.apply(x, grid.h, 1, grid.s)


def all_gather_w(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The whole W of the plane on every rank of the wspace axis
    (spatial.py:230-232)."""
    if grid.wax.group is None:
        return x
    return _Gather.apply(x, grid.wax, 2, grid.w)


def scatter_h(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """This rank's rows of a replicated block (spatial.py:243-248)."""
    k = x.shape[1] // grid.space
    return x.narrow(1, grid.s * k, k)


def scatter_w(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """This rank's columns of a replicated block (spatial.py:235-240)."""
    k = x.shape[2] // grid.wspace
    return x.narrow(2, grid.w * k, k)


def _gather(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    return all_gather_w(all_gather_h(x, grid), grid)


def _scatter(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    return scatter_w(scatter_h(x, grid), grid).contiguous()


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


# ------------------------------------------------ the pix2pix pair, sharded

def _too_small(h: int, w: int, grid: Grid) -> bool:
    """Whether a block of ``h`` x ``w`` is too small for a sharded
    stride-2 conv: a local dim below 2 (spatial.py:469-470)."""
    return h < 2 or (grid.wspace > 1 and w < 2)


def pix2pix_sharded(n_down: int, h: int, w: int, grid: Grid) -> list:
    """Whether each of the pix2pix generator's ``n_down`` down blocks
    runs on the sharded plane, for a block of ``h`` x ``w``: the plane is
    gathered before the first whose input is too small
    (``_too_small``), and the rest run replicated.  Up block ``i`` runs
    sharded where its skip, down block ``n_down - 2 - i``'s output, is."""
    out, sharded = [], True
    for _ in range(n_down):
        if sharded and _too_small(h, w, grid):
            sharded = False
            h, w = h * grid.space, w * grid.wspace
        out.append(sharded)
        h, w = -(-h // 2), -(-w // 2)
    return out


def _bn(net, name: str, state, new: dict, v: torch.Tensor, grid: Grid,
        sharded: bool, train: bool) -> torch.Tensor:
    """``net``'s batch norm ``name`` on ``v``: the sharded one on a block,
    the one-card one on a replicated plane; its new state into ``new``."""
    if sharded:
        y, new[name] = batch_norm_sp(getattr(net, name), state[name], v,
                                     grid, train)
    else:
        y, new[name] = batch_norm(getattr(net, name), state[name], v, train)
    return y


def generator_pix2pix_sp(gen, state, x: torch.Tensor, grid: Grid,
                         compute_dtype=None,
                         drop_masks: Optional[Sequence[torch.Tensor]] = None,
                         train: bool = False):
    """``GeneratorPix2pix``'s forward on a sharded block
    (spatial.py:438-531): the down blocks sharded until the plane is too
    small to split, then gathered, the deep middle replicated on the
    one-card layers; the up blocks scatter back at the first whose skip
    is sharded (or the last conv-transpose scatters its output).  The
    sharded batch norms' moments are the data row's (``batch_norm_sp``),
    the replicated ones' the whole plane's.  ``drop_masks``: the keep
    masks of up blocks 0-2, this rank's block's where the block is
    sharded, its data row's whole plane's where it is replicated
    (``spatial_step.sp_dropout_masks``), or None.  Returns ``(y, new
    state)``."""
    cd = compute_dtype or x.dtype
    gen._check_state(state)
    n_down = len(gen.down_ch)
    if int(math.log2(x.shape[1] * grid.space)) != n_down:
        raise ValueError(f"a plane of height {x.shape[1] * grid.space} "
                         "needs another depth than this net was built for")
    at = pix2pix_sharded(n_down, x.shape[1], x.shape[2], grid)
    new: dict = {}
    y = x.to(cd)
    sharded = True
    skips = []
    for i in range(n_down):
        if sharded and not at[i]:
            y = _gather(y, grid)
            sharded = False
        p = getattr(gen, f"down{i}")
        y = conv2d_sp(p, y, 2, grid, cd) if sharded \
            else conv2d(p, y, 2, "SAME", cd)
        if i > 0:
            y = _bn(gen, f"down{i}_bn", state, new, y, grid, sharded, train)
        y = leaky_relu(y)
        skips.append((y, sharded))
    skips = list(reversed(skips[:-1]))
    for i in range(len(gen.up_ch)):
        skip, skip_sharded = skips[i]
        p = getattr(gen, f"up{i}")
        if sharded:
            y = conv2d_transpose_sp(p, y, 2, grid, cd)
        else:
            y = conv2d_transpose(p, y, 2, "SAME", cd)
            if skip_sharded:  # back in the sharded part of the net
                y = _scatter(y, grid)
                sharded = True
        y = _bn(gen, f"up{i}_bn", state, new, y, grid, sharded, train)
        if i < 3 and drop_masks is not None:
            y = dropout(y, gen.drop_rate, drop_masks[i])
        y = relu(y)
        y = torch.cat([y, skip], dim=-1)
    if sharded:
        y = conv2d_transpose_sp(gen.last, y, 2, grid, cd)
    else:
        y = _scatter(conv2d_transpose(gen.last, y, 2, "SAME", cd), grid)
    return tanh(y.float()), new


def discriminator_pix2pix_sp(disc, state, inp: torch.Tensor,
                             tar: torch.Tensor, grid: Grid,
                             compute_dtype=None, train: bool = False):
    """``DiscriminatorPix2pix``'s forward on sharded blocks
    (spatial.py:532-583): the three stride-2 down blocks sharded (the
    plane gathered early if it gets too small), then the plane gathered
    and the zero-pad + VALID tail replicated, its batch norm the
    one-card one.  Returns the replicated patch logits (f32) and the new
    state."""
    from ..models.discriminator_pix2pix import _zero_pad
    cd = compute_dtype or inp.dtype
    disc._check_state(state)
    new: dict = {}
    y = torch.cat([inp.to(cd), tar.to(cd)], dim=-1)
    sharded = True
    for i in range(3):
        if sharded and _too_small(y.shape[1], y.shape[2], grid):
            y = _gather(y, grid)
            sharded = False
        p = getattr(disc, f"down{i}")
        y = conv2d_sp(p, y, 2, grid, cd) if sharded \
            else conv2d(p, y, 2, "SAME", cd)
        if i > 0:
            y = _bn(disc, f"down{i}_bn", state, new, y, grid, sharded, train)
        y = leaky_relu(y)
    if sharded:
        y = _gather(y, grid)
    y = conv2d(disc.conv, _zero_pad(y), 1, "VALID", cd)
    y = _bn(disc, "conv_bn", state, new, y, grid, False, train)
    y = leaky_relu(y)
    y = conv2d(disc.last, _zero_pad(y), 1, "VALID", cd)
    return y.float(), new
