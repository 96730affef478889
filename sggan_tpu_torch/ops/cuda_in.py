"""Wrappers of the hand-written CUDA instance-norm kernels (K1).

Forward: replaces ``sggan_tpu/ops/pallas_in.py::instance_norm_pallas``.
Backward: replaces ``sggan_tpu/ops/norm.py::_in_fused_bwd``, the custom
VJP of the JAX package's instance norm.  Both are ``csrc/instance_norm.cu``.
They take f32 or bf16, any C and any H*W; there is no channel gate like the
TPU kernel's C % 128.

``plan`` picks one of three routes per call from shape, dtype and
alignment, before the launch (the source's header says what each does):
``cluster`` (one launch; a thread block cluster holds the plane in shared
memory), ``stream`` (two passes with 16-byte packets, for planes no
cluster holds) and ``scalar`` (two passes, one element per thread, for C
that is no multiple of a packet or a pointer that is not 16-byte
aligned).  ``plan`` is pure Python, so the CPU tests hold it at every
site.

``launches`` and ``bwd_launches`` count the calls that launched each
kernel, whatever the number of CUDA launches inside, so a run can show
that its path went through them; ``route_launches`` counts them by
(direction, route).  A CUDA graph records a call once, at its capture,
and its replays launch it again without the wrapper: the counters count
the capture, not the replays.  The kernels are built by nvcc at the
first call (``_build``), never at import.

The spatial path (``--mesh_space``, ``parallel/spatial.py``) reaches the
two-pass routes through entries of their own, one per pass, so that the
caller can sum the moments across ranks between the passes:
``sp_stats`` (the local block's per-(n, c) sum and sum of squares),
``sp_apply`` (y, mean and rstd from the global sums and the plane's
global count), ``sp_bwd_stats`` (the local gated (S1, S2) and this
shard's dgamma and dbeta from them) and ``sp_bwd_apply`` (dx from the
global sums).  ``sp_plan`` picks the stream or scalar route, never the
cluster route, whose one launch has no point between its passes.  Each
counts its calls in ``sp_launches`` by pass.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

launches = 0
bwd_launches = 0
route_launches = {(d, r): 0 for d in ("fwd", "bwd")
                  for r in ("cluster", "stream", "scalar")}

_ACTS = {None: 0, "relu": 1, "leaky_relu": 2}
# the spatial path's relu gates half of dy at an exact 0 (kReluTie)
_SP_ACTS = {None: 0, "relu": 3, "leaky_relu": 2}
sp_launches = {"stats": 0, "apply": 0, "bwd_stats": 0, "bwd_apply": 0}
_ROUTES = {"scalar": 0, "stream": 1, "cluster": 2}
_LANES = 32             # channels per block (kLanes in the source)
_THREADS = 256          # threads per block (kThreads)
_SMS = 132              # the H100's SMs: one wave of one block each
_TARGET_BLOCKS = 4 * _SMS  # scalar route: a few blocks on each SM
_MIN_ROWS = 64          # rows per block of the scalar route, at least
# stream route: more, shorter blocks cut the last wave's tail, but every
# apply block combines all its splits' partials, so a split keeps at least
# _STREAM_MIN_ROWS rows (both measured on an H100 by perf_in.py)
_STREAM_BLOCKS = 16 * _SMS
_STREAM_MIN_ROWS = 512
# cluster route: a CTA's slab rows in shared memory.  Up to _SMEM_PAIR two
# CTAs share an SM (and one's loads overlap the other's stores); beyond it
# one CTA takes an SM, up to the opt-in 232,448 bytes less the kernel's
# static shared memory (under 3 KiB)
_SMEM_PAIR = 96 * 1024
_SMEM_MAX = 232448 - 4096
_MAX_CLUSTER = 16  # above 8 needs cudaFuncAttributeNonPortableClusterSizeAllowed


class Plan(NamedTuple):
    """How one call runs: ``route``; ``tile`` channels per block;
    ``cluster`` CTAs per cluster (1 on the two-pass routes); ``ctas`` per
    launch; ``smem`` dynamic shared bytes per CTA; ``rows`` per CTA
    (cluster) or per split; ``splits`` of the plane (two-pass routes, 1
    on the cluster route)."""
    route: str
    tile: int
    cluster: int
    ctas: int
    smem: int
    rows: int
    splits: int


def check_act(act: Optional[str]) -> None:
    if act not in _ACTS:
        raise ValueError(f"act={act!r} — must be None, 'relu' or "
                         "'leaky_relu'")


def split_rows(n: int, s: int, c: int, blocks: int = _TARGET_BLOCKS,
               min_rows: int = _MIN_ROWS) -> Tuple[int, int]:
    """(rows per split, number of splits) of the S = H*W axis: about
    ``blocks`` blocks on the card, at least ``min_rows`` rows each, and no
    empty split."""
    tiles = -(-c // _LANES)
    want = -(-blocks // (n * tiles))
    n_split = max(1, min(want, s // min_rows))
    rows = -(-s // n_split)
    return rows, -(-s // rows)


@functools.lru_cache(maxsize=256)
def plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
         direction: str, aligned: bool = True,
         route: Optional[str] = None) -> Plan:
    """The route of one call on an (n, h, w, c) tensor of ``dtype``,
    ``direction`` "fwd" or "bwd"; ``aligned``: every tensor the kernel
    reads or writes starts on 16 bytes.  ``route`` forces a route (for
    measuring one against another) and raises where it cannot run.

    cluster, where it fits: the smallest cluster whose CTAs hold their
    rows of x (and dy) in ``_SMEM_PAIR``, else a cluster of 8 or 16 in
    ``_SMEM_MAX``; doubled up to 16 while the launch has fewer CTAs
    than the card's SMs and each CTA keeps a thread step of rows; taken
    unless it leaves the card short of a wave where the stream route
    fills one.  Otherwise stream, or scalar when C is no multiple of a
    16-byte packet or a tensor is misaligned."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction={direction!r} — must be 'fwd' or 'bwd'")
    s = h * w
    esize = torch.finfo(dtype).bits // 8
    vec = 16 // esize  # channels in one 16-byte packet
    tiles = -(-c // _LANES)

    def two_pass(name, blocks, min_rows):
        rows, splits = split_rows(n, s, c, blocks, min_rows)
        return Plan(name, _LANES, 1, n * tiles * splits, 0, rows, splits)

    if not aligned or c % vec or route == "scalar":
        if route not in (None, "scalar"):
            raise ValueError(f"route {route!r} needs C % {vec} == 0 and "
                             "16-byte aligned tensors")
        return two_pass("scalar", _TARGET_BLOCKS, _MIN_ROWS)
    stream = two_pass("stream", _STREAM_BLOCKS, _STREAM_MIN_ROWS)
    if route == "stream":
        return stream

    row_bytes = _LANES * esize * (1 if direction == "fwd" else 2)
    step = _THREADS // (_LANES // vec)  # rows of one thread step

    def fits(k, limit):
        return -(-s // k) * row_bytes <= limit

    k = next((k for k in (1, 2, 4, 8, 16) if fits(k, _SMEM_PAIR)), None)
    if k is None:
        k = next((k for k in (8, 16) if fits(k, _SMEM_MAX)), None)
    if k is not None:
        while (n * tiles * k < _SMS and k < _MAX_CLUSTER
               and -(-s // (2 * k)) >= step):
            k *= 2
        ctas = n * tiles * k
        if route == "cluster" or ctas >= _SMS or stream.ctas < _SMS:
            rows = -(-s // k)
            return Plan("cluster", _LANES, k, ctas, rows * row_bytes, rows, 1)
    if route == "cluster":
        raise ValueError(f"no cluster of at most {_MAX_CLUSTER} CTAs holds "
                         f"a ({h}, {w}) plane of {dtype} for {direction}")
    return stream


@functools.cache
def _kernels():
    lib = _build.load("instance_norm")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.sggan_instance_norm_fwd, lib.sggan_instance_norm_bwd
    fwd.argtypes = [p] * 5 + [i] * 9 + [f, f, p]
    bwd.argtypes = [p] * 9 + [i] * 9 + [f, p]
    lib.sggan_instance_norm_init.argtypes = []
    lib.sggan_instance_norm_max_clusters.argtypes = [i] * 4
    sp = (lib.sggan_instance_norm_sp_stats, lib.sggan_instance_norm_sp_apply,
          lib.sggan_instance_norm_sp_bwd_stats,
          lib.sggan_instance_norm_sp_bwd_apply)
    sp[0].argtypes = [p] * 3 + [i] * 7 + [p]
    sp[1].argtypes = [p] * 7 + [i] * 8 + [f, f, f, p]
    sp[2].argtypes = [p] * 11 + [i] * 8 + [f, p]
    sp[3].argtypes = [p] * 8 + [i] * 8 + [f, f, p]
    for fn in (fwd, bwd, lib.sggan_instance_norm_init,
               lib.sggan_instance_norm_max_clusters, *sp):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _init(device: int) -> None:
    """Per device, once: the cluster kernels' shared-memory and cluster
    size attributes."""
    with torch.cuda.device(device):
        err = _kernels().sggan_instance_norm_init()
    if err:
        raise RuntimeError(f"instance norm kernel set-up failed: CUDA error "
                           f"{err}")


_counters = {}  # (device, stream) -> the backward's arrival counter


def _counter(device: int) -> torch.Tensor:
    """One int32 per (device, current stream), zero between backward
    calls: the kernel's last block resets it, and calls on one stream do
    not overlap.  A graph's replays reuse the one of its capture stream,
    which ``prepare_capture`` makes before the capture."""
    key = (device, _stream(device))
    t = _counters.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the instance-norm backward has no counter "
                               "for the capturing stream: call "
                               "cuda_in.prepare_capture(stream) before the "
                               "capture")
        t = _counters[key] = torch.zeros(1, dtype=torch.int32,
                                         device=torch.device("cuda", device))
    return t


def prepare_capture(stream: torch.cuda.Stream) -> None:
    """Before a CUDA graph is captured on ``stream``: build the kernels,
    set their cluster attributes (``_init``) and make the backward's
    counter of that stream.  Made inside the capture, the counter would
    be a tensor of the graph's private memory pool; the launches
    themselves allocate nothing and go to the current stream, so a
    capture records them."""
    dev = stream.device.index
    _kernels()
    _init(dev)
    with torch.cuda.stream(stream):
        _counter(dev)


def max_active_clusters(p: Plan, direction: str, dtype: torch.dtype) -> int:
    """cudaOccupancyMaxActiveClusters of a cluster plan on the current
    device (needs CUDA)."""
    _init(torch.cuda.current_device())
    return _kernels().sggan_instance_norm_max_clusters(
        int(direction == "bwd"), int(dtype == torch.bfloat16), p.cluster,
        p.rows)


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the instance-norm kernels need CUDA tensors, got "
                         f"{name} on {x.device}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name} must be a non-empty (N, H, W, C) tensor, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous NHWC (channels_last)")
    n, h, w, _ = x.shape
    if n > 65535 or h * w >= 2 ** 31:  # grid z and the kernel's int sizes
        raise ValueError(f"shape {tuple(x.shape)} out of the kernel's range")


def _check_f32(x: torch.Tensor, **params: torch.Tensor) -> None:
    for name, p in params.items():
        shape = (x.shape[-1],) if name in ("gamma", "beta") \
            else (x.shape[0], x.shape[-1])
        if (p.device != x.device or p.dtype != torch.float32
                or tuple(p.shape) != shape or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {x.device}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")


def _stream(device: int) -> int:
    """The handle of the device's current stream, without building a
    ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device)


def _launch(fn, x: torch.Tensor, *args) -> None:
    """fn(*args, stream) on x's device, entering it only when it is not
    the current one."""
    dev = x.device.index
    _init(dev)
    if dev == torch.cuda.current_device():
        err = fn(*args, _stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, _stream(dev))
    if err:
        raise RuntimeError(f"instance norm kernel launch failed: CUDA error "
                           f"{err}")


def _forward(x, gamma, beta, eps, act, alpha, p: Plan):
    """One forward call on plan ``p``: (y, mean, rstd)."""
    n, h, w, c = x.shape
    y = torch.empty_like(x)
    # rows of C floats: mean (n), rstd (n), then the partials (n, splits, 2)
    ws = torch.empty((2 * n + 2 * n * p.splits * (p.route != "cluster"), c),
                     dtype=torch.float32, device=x.device)
    _launch(_kernels().sggan_instance_norm_fwd, x, x.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), ws.data_ptr(),
            n, h * w, c, _ROUTES[p.route], p.cluster, p.rows, p.splits,
            int(x.dtype == torch.bfloat16), _ACTS[act], eps, alpha)
    return y, ws[:n], ws[n:2 * n]


def _backward(x, dy, gamma, beta, mean, rstd, act, alpha, p: Plan):
    """One backward call on plan ``p``: (dx, dgamma, dbeta)."""
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    # rows of C floats: dgamma, dbeta, the sums (n, 2), the partials (n,
    # splits, 2)
    ws = torch.empty((2 + 2 * n + 2 * n * p.splits * (p.route != "cluster"),
                      c), dtype=torch.float32, device=x.device)
    _launch(_kernels().sggan_instance_norm_bwd, x, x.data_ptr(),
            dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), ws.data_ptr(),
            _counter(x.device.index).data_ptr(), n, h * w, c,
            _ROUTES[p.route], p.cluster, p.rows, p.splits,
            int(x.dtype == torch.bfloat16), _ACTS[act], alpha)
    return dx, ws[0], ws[1]


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def instance_norm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-3,
                       act: Optional[str] = None, alpha: float = 0.3,
                       save_stats: bool = False):
    """Instance norm of a contiguous NHWC CUDA tensor (f32 or bf16) with
    f32 ``gamma``/``beta`` of shape (C,).  Returns y in x's dtype, or with
    ``save_stats`` the tuple (y, mean, rstd), the moments as (N, C) f32 for
    the backward.  Launches on the current stream without synchronising;
    raises on any input the kernel does not take."""
    global launches
    check_act(act)
    _check_x("x", x)
    _check_f32(x, gamma=gamma, beta=beta)
    p = plan(*x.shape, x.dtype, "fwd", _aligned(x))
    y, mean, rstd = _forward(x, gamma, beta, eps, act, alpha, p)
    launches += 1
    route_launches["fwd", p.route] += 1
    return (y, mean, rstd) if save_stats else y


def instance_norm_bwd_cuda(x: torch.Tensor, dy: torch.Tensor,
                           gamma: torch.Tensor, beta: torch.Tensor,
                           mean: torch.Tensor, rstd: torch.Tensor,
                           act: Optional[str] = None, alpha: float = 0.3
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dx, dgamma, dbeta) of ``instance_norm_cuda`` given its input x,
    the gradient dy of its output (same shape and dtype, contiguous), and
    the (N, C) f32 moments it saved.  dx is in x's dtype, dgamma and dbeta
    f32.  Launches on the current stream without synchronising; raises on
    any input the kernel does not take."""
    global bwd_launches
    check_act(act)
    _check_x("x", x)
    _check_x("dy", dy)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x: got {dy.dtype} "
                         f"{tuple(dy.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}")
    _check_f32(x, gamma=gamma, beta=beta, mean=mean, rstd=rstd)
    p = plan(*x.shape, x.dtype, "bwd", _aligned(x, dy))
    grads = _backward(x, dy, gamma, beta, mean, rstd, act, alpha, p)
    bwd_launches += 1
    route_launches["bwd", p.route] += 1
    return grads


# ----------------------------------------------------------------------
# the spatial path: one entry per pass
# ----------------------------------------------------------------------

def sp_plan(x: torch.Tensor, direction: str, *others: torch.Tensor) -> Plan:
    """The two-pass route of a local block: stream where C is a multiple
    of a packet and every tensor is 16-byte aligned, else scalar; never
    the cluster route (asserted)."""
    vec = 16 // x.element_size()
    aligned = _aligned(x, *others) and x.shape[-1] % vec == 0
    p = plan(*x.shape, x.dtype, direction, aligned,
             route="stream" if aligned else "scalar")
    assert p.route != "cluster", p
    return p


def _check_sums(x: torch.Tensor, sums: torch.Tensor) -> None:
    n, c = x.shape[0], x.shape[-1]
    if (sums.device != x.device or sums.dtype != torch.float32
            or tuple(sums.shape) != (n, 2, c) or not sums.is_contiguous()):
        raise ValueError(f"sums must be a contiguous float32 {(n, 2, c)} "
                         f"tensor on {x.device}, got {sums.dtype} "
                         f"{tuple(sums.shape)} on {sums.device}")


def _check_dy(x: torch.Tensor, dy: torch.Tensor) -> None:
    _check_x("dy", dy)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x: got {dy.dtype} "
                         f"{tuple(dy.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}")


def _bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


def sp_stats(x: torch.Tensor) -> torch.Tensor:
    """Pass 1 of the forward: (n, 2, c) f32, the local block's sum and
    sum of squares over its rows, [S | Q] per sample."""
    _check_x("x", x)
    n, h, w, c = x.shape
    p = sp_plan(x, "fwd")
    sums = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
    part = torch.empty((n, p.splits, 2, c), dtype=torch.float32,
                       device=x.device)
    _launch(_kernels().sggan_instance_norm_sp_stats, x, x.data_ptr(),
            part.data_ptr(), sums.data_ptr(), n, h * w, c, _ROUTES[p.route],
            p.rows, p.splits, _bf16(x))
    sp_launches["stats"] += 1
    return sums


def sp_apply(x: torch.Tensor, sums: torch.Tensor, gamma: torch.Tensor,
             beta: torch.Tensor, count: int, eps: float = 1e-3,
             act: Optional[str] = None, alpha: float = 0.3):
    """Pass 2 of the forward: (y, mean, rstd) of the local block from the
    global ``sums`` (``sp_stats`` summed over the ranks of the plane) and
    ``count``, the plane's global H * W; mean and rstd (n, c) f32."""
    check_act(act)
    _check_x("x", x)
    _check_f32(x, gamma=gamma, beta=beta)
    _check_sums(x, sums)
    n, h, w, c = x.shape
    p = sp_plan(x, "fwd")
    y = torch.empty_like(x)
    ms = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    _launch(_kernels().sggan_instance_norm_sp_apply, x, x.data_ptr(),
            sums.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            ms[0].data_ptr(), ms[1].data_ptr(), n, h * w, c,
            _ROUTES[p.route], p.rows, p.splits, _bf16(x), _SP_ACTS[act], eps,
            alpha, float(count))
    sp_launches["apply"] += 1
    return y, ms[0], ms[1]


def sp_bwd_stats(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                 act: Optional[str] = None, alpha: float = 0.3):
    """Pass 1 of the backward: (sums, dgamma, dbeta), the local block's
    gated (S1, S2) as (n, 2, c) f32 and this shard's own dgamma and dbeta,
    (c,) f32, from them (the sums over n of S2 and of S1)."""
    check_act(act)
    _check_x("x", x)
    _check_dy(x, dy)
    _check_f32(x, gamma=gamma, beta=beta, mean=mean, rstd=rstd)
    n, h, w, c = x.shape
    p = sp_plan(x, "bwd", dy)
    sums = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
    dgb = torch.empty((2, c), dtype=torch.float32, device=x.device)
    part = torch.empty((n, p.splits, 2, c), dtype=torch.float32,
                       device=x.device)
    _launch(_kernels().sggan_instance_norm_sp_bwd_stats, x, x.data_ptr(),
            dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), part.data_ptr(),
            sums.data_ptr(), dgb[0].data_ptr(), dgb[1].data_ptr(),
            _counter(x.device.index).data_ptr(), n, h * w, c,
            _ROUTES[p.route], p.rows, p.splits, _bf16(x), _SP_ACTS[act],
            alpha)
    sp_launches["bwd_stats"] += 1
    return sums, dgb[0], dgb[1]


def sp_bwd_apply(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                 sums: torch.Tensor, count: int, act: Optional[str] = None,
                 alpha: float = 0.3) -> torch.Tensor:
    """Pass 2 of the backward: dx of the local block, in x's dtype, from
    the global (S1, S2) ``sums`` and ``count``."""
    check_act(act)
    _check_x("x", x)
    _check_dy(x, dy)
    _check_f32(x, gamma=gamma, beta=beta, mean=mean, rstd=rstd)
    _check_sums(x, sums)
    n, h, w, c = x.shape
    p = sp_plan(x, "bwd", dy)
    dx = torch.empty_like(x)
    _launch(_kernels().sggan_instance_norm_sp_bwd_apply, x, x.data_ptr(),
            dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), sums.data_ptr(), dx.data_ptr(),
            n, h * w, c, _ROUTES[p.route], p.rows, p.splits, _bf16(x),
            _SP_ACTS[act], alpha, float(count))
    sp_launches["bwd_apply"] += 1
    return dx
