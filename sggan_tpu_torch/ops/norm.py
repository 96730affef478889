"""Instance norm (tfa InstanceNormalization semantics) and batch norm
(Keras BatchNormalization semantics) on NHWC tensors.

Port of ``sggan_tpu/ops/norm.py``: per-sample, per-channel moments over
the spatial plane, eps 1e-3, affine gamma/beta, then an optional relu or
leaky_relu (Keras alpha 0.3).  Not ``nn.InstanceNorm2d``: its eps is 1e-5.

``instance_norm`` takes one of two routes.  Where an input needs a
gradient it is a ``torch.autograd.Function`` whose backward follows the
JAX package's custom VJP (``norm._in_fused_bwd``).  Otherwise (inference,
eval, the service, ``torch.export``) it is the registered op
``torch.ops.sggan_tpu_torch.instance_norm``: ``torch.export`` keeps it as
one graph node per call, where it would trace through the Function into
the plain version's ops.  On a CUDA tensor both routes run the
hand-written kernels (``cuda_in``); on a CPU tensor they run the plain
versions ``instance_norm_ref`` and ``instance_norm_bwd_ref``.  The op has
no implementation for any other device, and there is no fallback from
one to the other.

``instance_norm_sp`` is the spatial path's (``parallel/spatial.py``,
port of ``sggan_tpu/parallel/spatial.py::instance_norm_sp``): the plane is
split across ranks, so the moments are the local block's sums
all-reduced over the plane's ranks, divided by the global H * W.  On a
CUDA tensor it runs K1's two passes (``cuda_in.sp_stats`` /
``sp_apply``, backward ``sp_bwd_stats`` / ``sp_bwd_apply``) with the
all-reduce between them; on a CPU tensor its plain twin
(``instance_norm_sp_ref``, ``instance_norm_sp_bwd_ref``).  Each rank's
dgamma and dbeta are its own block's, as JAX's per-shard gradient is;
the step averages them.

``batch_norm`` (the pix2pix nets') is plain torch ops in f32, as the JAX
package's is XLA code: no kernel of its own.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from . import cuda_in

IN_EPS = 1e-3  # tfa GroupNormalization default
BN_EPS = 1e-3  # Keras BatchNormalization default
BN_MOMENTUM = 0.99


def instance_norm_init(c: int, dtype=torch.float32) -> dict:
    return {"gamma": torch.ones(c, dtype=dtype),
            "beta": torch.zeros(c, dtype=dtype)}


def _act(y: torch.Tensor, act: Optional[str], alpha: float) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(y, 0)
    if act == "leaky_relu":
        return torch.where(y >= 0, y, alpha * y)
    return y


def _ref_forward(x, gamma, beta, eps, act, alpha):
    """(y, mean, rstd) with the moments as (N, C) f32: f32 sum and sum of
    squares, var = max(E[x^2] - mean^2, 0), as ``norm._in_fused``."""
    cuda_in.check_act(act)
    xf = x.float()
    n = x.shape[1] * x.shape[2]
    mean = xf.sum((1, 2), keepdim=True) / n
    var = torch.clamp_min((xf * xf).sum((1, 2), keepdim=True) / n
                          - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    y = _act(y * gamma.float() + beta.float(), act, alpha)
    return y.to(x.dtype), mean[:, 0, 0], rstd[:, 0, 0]


def instance_norm_ref(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float = IN_EPS,
                      act: Optional[str] = None,
                      alpha: float = 0.3) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel, output in ``x.dtype``."""
    return _ref_forward(x, gamma, beta, eps, act, alpha)[0]


def instance_norm_bwd_ref(x: torch.Tensor, dy: torch.Tensor,
                          gamma: torch.Tensor, beta: torch.Tensor,
                          mean: torch.Tensor, rstd: torch.Tensor,
                          act: Optional[str] = None, alpha: float = 0.3
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain PyTorch twin of the backward kernel, line by line
    ``norm._in_fused_bwd``: the act gate recomputed from x, one reduction
    of (dy, dy * xhat) per (n, c), then dgamma, dbeta and dx.  ``mean`` and
    ``rstd`` are the forward's (N, C) f32 moments."""
    cuda_in.check_act(act)
    mean, rstd = mean[:, None, None, :], rstd[:, None, None, :]
    xf = x.float()
    dyf = dy.float()
    gf = gamma.float()
    xhat = (xf - mean) * rstd
    if act is not None:
        pre = xhat * gf + beta.float()
        if act == "relu":
            dyf = torch.where(pre > 0, dyf, 0.0)
        else:
            dyf = torch.where(pre >= 0, dyf, alpha * dyf)
    n = x.shape[1] * x.shape[2]
    s_dy = dyf.sum((1, 2))
    s_dyx = (dyf * xhat).sum((1, 2))
    dgamma = s_dyx.sum(0).to(gamma.dtype)
    dbeta = s_dy.sum(0).to(beta.dtype)
    m_dy = (s_dy / n)[:, None, None, :]
    m_dyx = (s_dyx / n)[:, None, None, :]
    dx = (rstd * gf) * (dyf - m_dy - xhat * m_dyx)
    return dx.to(x.dtype), dgamma, dbeta


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act, alpha):
        if x.device.type == "cpu":
            y, mean, rstd = _ref_forward(x, gamma, beta, eps, act, alpha)
        else:
            y, mean, rstd = cuda_in.instance_norm_cuda(
                x, gamma, beta, eps, act, alpha, save_stats=True)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.act, ctx.alpha = act, alpha
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = instance_norm_bwd_ref(x, dy, gamma, beta, mean, rstd,
                                          ctx.act, ctx.alpha)
        else:
            grads = cuda_in.instance_norm_bwd_cuda(
                x, dy.contiguous(), gamma, beta, mean, rstd, ctx.act,
                ctx.alpha)
        return (*grads, None, None, None)


# ----------------------------------------------------------------------
# the spatial path: moments summed across the ranks of one plane
# ----------------------------------------------------------------------

# bytes and calls of the moments' all-reduces, for a reader who measures
# them (chip_smoke.py, beside its profiler range "sp.moments"); never read
# by the program.  A CUDA graph's replays pass no counter: StepGraph
# records a step's at its capture (``fused.comm_counts``)
moments_bytes = 0
moments_calls = 0


def moments_all_reduce(sums: torch.Tensor, group) -> torch.Tensor:
    """``sums`` summed in place over the ranks of ``group`` (the plane's;
    nothing for None), returned."""
    global moments_bytes, moments_calls
    if group is not None:
        with torch.profiler.record_function("sp.moments"):
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        moments_bytes += sums.numel() * sums.element_size()
        moments_calls += 1
    return sums


def _sp_gate(dyf, pre, act, alpha):
    # instance_norm_sp's acts are jnp.maximum and jnp.where: JAX's
    # gradient of maximum(y, 0) at y == 0 exactly is half of dy (the
    # one-card path's norm._in_fused_bwd passes none there: pre > 0)
    if act == "relu":
        return torch.where(pre > 0, dyf, torch.where(pre == 0, 0.5 * dyf,
                                                     0.0))
    if act == "leaky_relu":
        return torch.where(pre >= 0, dyf, alpha * dyf)
    return dyf


def instance_norm_sp_ref(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, count: int, group=None,
                         eps: float = IN_EPS, act: Optional[str] = None,
                         alpha: float = 0.3):
    """Plain twin of the spatial forward: the local block's f32 sum and
    sum of squares (n, 2, c), all-reduced over ``group``, then mean =
    S / count, var = max(Q / count - mean^2, 0), normalize, affine, act.
    Returns (y in x's dtype, mean, rstd), the moments (n, c) f32."""
    cuda_in.check_act(act)
    xf = x.float()
    sums = torch.stack([xf.sum((1, 2)), (xf * xf).sum((1, 2))], 1)
    sums = moments_all_reduce(sums.contiguous(), group)
    mean = sums[:, 0] / count
    var = torch.clamp_min(sums[:, 1] / count - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean[:, None, None]) * rstd[:, None, None]
    y = _act(y * gamma.float() + beta.float(), act, alpha)
    return y.to(x.dtype), mean, rstd


def instance_norm_sp_bwd_ref(x, dy, gamma, beta, mean, rstd, count: int,
                             group=None, act: Optional[str] = None,
                             alpha: float = 0.3):
    """Plain twin of the spatial backward: the gated dy (relu's tie gated
    by half), the local (S1, S2) = (sum dy, sum dy * xhat), this shard's
    dgamma and dbeta from them, then the sums all-reduced over ``group``
    and dx from the global ones and ``count``."""
    cuda_in.check_act(act)
    m, r = mean[:, None, None, :], rstd[:, None, None, :]
    xf, gf = x.float(), gamma.float()
    xhat = (xf - m) * r
    dyf = _sp_gate(dy.float(), xhat * gf + beta.float(), act, alpha)
    sums = torch.stack([dyf.sum((1, 2)), (dyf * xhat).sum((1, 2))], 1)
    dgamma = sums[:, 1].sum(0).to(gamma.dtype)
    dbeta = sums[:, 0].sum(0).to(beta.dtype)
    sums = moments_all_reduce(sums.contiguous(), group)
    m_dy = (sums[:, 0] / count)[:, None, None, :]
    m_dyx = (sums[:, 1] / count)[:, None, None, :]
    dx = (r * gf) * (dyf - m_dy - xhat * m_dyx)
    return dx.to(x.dtype), dgamma, dbeta


class _InstanceNormSp(torch.autograd.Function):
    """The spatial instance norm: K1's split passes on a CUDA tensor (never
    its cluster route), the plain twin on a CPU one; the moments'
    all-reduce between the passes, both ways."""

    @staticmethod
    def forward(ctx, x, gamma, beta, count, group, eps, act, alpha):
        if x.device.type == "cpu":
            y, mean, rstd = instance_norm_sp_ref(x, gamma, beta, count, group,
                                                 eps, act, alpha)
        else:
            sums = moments_all_reduce(cuda_in.sp_stats(x), group)
            y, mean, rstd = cuda_in.sp_apply(x, sums, gamma, beta, count,
                                             eps, act, alpha)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.args = (count, group, act, alpha)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        count, group, act, alpha = ctx.args
        if x.device.type == "cpu":
            dx, dgamma, dbeta = instance_norm_sp_bwd_ref(
                x, dy, gamma, beta, mean, rstd, count, group, act, alpha)
        else:
            dy = dy.contiguous()
            sums, dgamma, dbeta = cuda_in.sp_bwd_stats(
                x, dy, gamma, beta, mean, rstd, act, alpha)
            moments_all_reduce(sums, group)
            dx = cuda_in.sp_bwd_apply(x, dy, gamma, beta, mean, rstd, sums,
                                      count, act, alpha)
        return dx, dgamma, dbeta, None, None, None, None, None


def instance_norm_sp(params: Mapping, x: torch.Tensor, count: int, group,
                     act: Optional[str] = None, alpha: float = 0.3,
                     eps: float = IN_EPS) -> torch.Tensor:
    """Instance norm of a local block of a plane of ``count`` = H * W
    elements split over the ranks of ``group`` (None: one rank holds it),
    x NHWC; ``act`` as ``instance_norm``'s, relu's gradient at an exact 0
    that of ``jnp.maximum``."""
    return _InstanceNormSp.apply(x.contiguous(), params["gamma"],
                                 params["beta"], count, group, eps, act,
                                 alpha)


# K1's forward as a registered op, for calls that need no gradient: the
# plain version on a CPU tensor, the kernel on a CUDA one.  Defined
# through ``torch.library.Library`` and not ``custom_op``: a custom op's
# first call imports ``torch._dynamo`` (seconds in every process that
# serves or evaluates), and each call goes through its Python wrappers.
_LIB = torch.library.Library("sggan_tpu_torch", "DEF")
_LIB.define("instance_norm(Tensor x, Tensor gamma, Tensor beta, float eps, "
            "str? act, float alpha) -> Tensor")
_LIB.impl("instance_norm", instance_norm_ref, "CPU")
_LIB.impl("instance_norm", cuda_in.instance_norm_cuda, "CUDA")


@torch.library.register_fake("sggan_tpu_torch::instance_norm", lib=_LIB)
def _(x, gamma, beta, eps, act, alpha):
    cuda_in.check_act(act)
    return torch.empty_like(x)


instance_norm_op = torch.ops.sggan_tpu_torch.instance_norm.default


def instance_norm(params: Mapping, x: torch.Tensor, act: Optional[str] = None,
                  alpha: float = 0.3, eps: float = IN_EPS) -> torch.Tensor:
    """Instance norm with optional fused activation; x is NHWC.

    act: None | 'relu' | 'leaky_relu'.  The autograd Function where grad
    mode is on and an input requires a gradient, else the registered op."""
    gamma, beta = params["gamma"], params["beta"]
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _InstanceNorm.apply(x, gamma, beta, eps, act, alpha)
    return instance_norm_op(x, gamma, beta, eps, act, alpha)


def batch_norm_init(c: int, dtype=torch.float32) -> Tuple[dict, dict]:
    """(params, state): gamma 1 and beta 0, and the moving stats (mean 0,
    var 1) that the train step threads as explicit state."""
    return ({"gamma": torch.ones(c, dtype=dtype),
             "beta": torch.zeros(c, dtype=dtype)},
            {"moving_mean": torch.zeros(c, dtype=dtype),
             "moving_var": torch.ones(c, dtype=dtype)})


def batch_norm(params: Mapping, state: Mapping, x: torch.Tensor,
               training: bool, momentum: float = BN_MOMENTUM,
               eps: float = BN_EPS) -> Tuple[torch.Tensor, dict]:
    """Returns ``(y, new_state)``, port of ``norm.batch_norm``.  Not
    ``nn.BatchNorm2d``: eps is 1e-3; the statistics are f32 over (N, H, W);
    training normalizes by the batch's mean and *biased* variance and
    moves the stats as ``m * old + (1 - m) * batch`` with m = 0.99 (the
    inverse of torch's momentum, and torch keeps the unbiased variance);
    inference normalizes by the moving stats and returns ``state`` as it
    is.  The new state carries no gradient."""
    xf = x.float()
    if training:
        mean = xf.mean((0, 1, 2))
        var = (xf - mean).square().mean((0, 1, 2))
        m_mean, m_var = state["moving_mean"], state["moving_var"]
        new = {"moving_mean": (momentum * m_mean + (1 - momentum)
                               * mean.detach()).to(m_mean.dtype),
               "moving_var": (momentum * m_var + (1 - momentum)
                              * var.detach()).to(m_var.dtype)}
    else:
        mean = state["moving_mean"].float()
        var = state["moving_var"].float()
        new = state
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["gamma"].float() + params["beta"].float()
    return y.to(x.dtype), new
