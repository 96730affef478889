"""What the K1 launch plan (``ops/cuda_in.py::plan``) rests on, measured on
the card: at the train step's largest instance-norm sites, bf16, every
cluster size whose slab fits in shared memory and the stream route at
several block counts, forward and backward, each by torch.profiler's
device time (with how many clusters the card holds at once); then the
wrapper's host cost per call at a small discriminator site.  The row the
plan picks is marked ``chosen``.

    python -m sggan_tpu_torch.perf_in [iters]     (prints one JSON line)

Runs on the card and fails without one: the kernels have no CPU mode.
``alternatives`` is pure Python, so the CPU tests hold what it sweeps.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch

from .ops import cuda_in

# (N, H, W, C): the resblock site, the discriminator's widest two, the
# 16-CTA forward site, the widest plane at b=16 and at b=1
SITES = [(16, 64, 128, 256), (32, 64, 128, 128), (16, 32, 64, 512),
         (16, 128, 256, 128), (16, 256, 512, 64), (1, 256, 512, 64)]
CLUSTERS = (1, 2, 4, 8, 16)
STREAM_WAVES = (4, 16, 64)  # blocks per launch, in units of the 132 SMs
HOST_SITE = (16, 1, 5, 512)


def alternatives(n: int, h: int, w: int, c: int, dtype: torch.dtype,
                 direction: str) -> List[cuda_in.Plan]:
    """Every cluster size whose CTAs hold their rows in shared memory, and
    the stream route at each of ``STREAM_WAVES`` (64 rows a split at
    least), for one site."""
    s, tiles = h * w, -(-c // cuda_in._LANES)
    row_bytes = (cuda_in._LANES * (torch.finfo(dtype).bits // 8)
                 * (1 if direction == "fwd" else 2))
    out = []
    for k in CLUSTERS:
        rows = -(-s // k)
        if rows * row_bytes <= cuda_in._SMEM_MAX:
            out.append(cuda_in.Plan("cluster", cuda_in._LANES, k,
                                    n * tiles * k, rows * row_bytes, rows, 1))
    for waves in STREAM_WAVES:
        rows, splits = cuda_in.split_rows(n, s, c, waves * cuda_in._SMS)
        out.append(cuda_in.Plan("stream", cuda_in._LANES, 1,
                                n * tiles * splits, 0, rows, splits))
    return out


# (iters, keys) of each device_ms call that the profiler left empty in
# every trace, so that its number is a CUDA-event time (see device_ms)
EVENT_TIMED: List[tuple] = []
_last_empty = [False]


def events_ms(fn: Callable, iters: int) -> float:
    """Time of one call of ``fn`` by CUDA events around ``iters`` calls
    (host wrapper included where it is slower than the device)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn: Callable, iters: int, tries: int = 6,
              keys: Sequence[str] = ()) -> float:
    """Device time of one call of ``fn``, which launches each of its
    kernels once (as every K1 call does): the mean time torch.profiler
    records for each kernel over ``iters`` calls after a warm-up call,
    summed over the kernels whose names hold one of ``keys`` (all of them
    if empty).  A trace taken right after another may drop or add an
    event; a mean per kernel is immune to that.

    Now and then, late in a long process, the profiler records no kernel
    in a short trace, even of kernels that ran.  Such a trace is taken
    again up to ``tries`` times, with CPU activity on as well and the
    capture window padded on both sides by a pause that grows (kernels
    whose converted times fall outside the window are dropped).  If every
    trace is empty, the calls are timed by CUDA events instead: that is
    said on stderr and noted in ``EVENT_TIMED``, and the next call that
    finds an empty trace tries only twice."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    if _last_empty[0]:
        tries = min(tries, 2)
    for attempt in range(tries):
        pad = 0.0 if attempt == 0 else 0.025 * 2 ** attempt
        acts = [ProfilerActivity.CUDA] if attempt == 0 else [
            ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            time.sleep(pad)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        total = 0.0
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA") \
                    and e.count and (not keys
                                     or any(k in e.key for k in keys)):
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = getattr(e, "self_cuda_time_total", 0.0)
                total += us / e.count
        if total > 0:
            if attempt:
                print(f"  profiler: a kernel recorded at try {attempt + 1} "
                      f"(window padded by {pad:.3f} s)", file=sys.stderr)
            _last_empty[0] = False
            return total / 1e3
    _last_empty[0] = True
    EVENT_TIMED.append((iters, tuple(keys)))
    print(f"  profiler: no kernel {'of ' + str(keys) + ' ' if keys else ''}"
          f"in {tries} traces of {iters} calls; timed by CUDA events "
          "instead", file=sys.stderr)
    return events_ms(fn, iters)


def host_us(fn: Callable, iters: int) -> float:
    """Host time per call of ``fn`` when calls are enqueued back to back
    (after a warm-up and a synchronise), in microseconds."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return dt


def _inputs(site, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = site[-1]
    x = (torch.randn(site, generator=g, device=dev) * 2 + 0.5).to(dtype)
    dy = torch.randn(site, generator=g, device=dev).to(dtype)
    gamma = torch.rand(c, generator=g, device=dev) + 0.5
    beta = torch.randn(c, generator=g, device=dev) * 0.1
    _, mean, rstd = cuda_in.instance_norm_cuda(x, gamma, beta, 1e-3, "relu",
                                               save_stats=True)
    return x, dy, gamma, beta, mean, rstd


def run(iters: int, dev: torch.device, dtype=torch.bfloat16) -> dict:
    rows = []
    for i, site in enumerate(SITES):
        x, dy, g, b, mean, rstd = _inputs(site, dtype, dev, i)
        for d in ("fwd", "bwd"):
            chosen = cuda_in.plan(*site, dtype, d)
            plans = alternatives(*site, dtype, d)
            if chosen not in plans:
                plans.append(chosen)
            for p in plans:
                if d == "fwd":
                    def fn(p=p):
                        cuda_in._forward(x, g, b, 1e-3, "relu", 0.3, p)
                else:
                    def fn(p=p):
                        cuda_in._backward(x, dy, g, b, mean, rstd, "relu",
                                          0.3, p)
                row = {"site": list(site), "direction": d, "route": p.route,
                       "cluster": p.cluster, "ctas": p.ctas, "smem": p.smem,
                       "splits": p.splits, "chosen": p == chosen,
                       "device_ms": device_ms(fn, iters)}
                if p.route == "cluster":
                    row["clusters_at_once"] = cuda_in.max_active_clusters(
                        p, d, dtype)
                rows.append(row)
                print(f"  {site} {d} {p.route}"
                      f"{' of ' + str(p.cluster) if p.route == 'cluster' else ''}"
                      f", {p.ctas} CTAs, {p.smem} B shared: "
                      f"{row['device_ms']:.4f} ms"
                      f"{'  <- plan' if row['chosen'] else ''}", flush=True)
        del x, dy, mean, rstd
    x, dy, g, b, mean, rstd = _inputs(HOST_SITE, dtype, dev, 99)
    p = cuda_in.plan(*HOST_SITE, dtype, "fwd")
    fwd = cuda_in._kernels().sggan_instance_norm_fwd
    y = torch.empty_like(x)
    ws = torch.empty((2 * x.shape[0], x.shape[-1]), device=dev)
    args = (x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            ws.data_ptr(), x.shape[0], x.shape[1] * x.shape[2], x.shape[3],
            cuda_in._ROUTES[p.route], p.cluster, p.rows, p.splits,
            int(dtype == torch.bfloat16), 1, 1e-3, 0.3)
    stream = torch.cuda.current_stream().cuda_stream
    host = {
        "instance_norm_cuda": host_us(lambda: cuda_in.instance_norm_cuda(
            x, g, b, 1e-3, "relu", save_stats=True), 20 * iters),
        "instance_norm_bwd_cuda": host_us(
            lambda: cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean, rstd,
                                                   "relu"), 20 * iters),
        "ctypes_launch_alone": host_us(lambda: fwd(*args, stream),
                                       20 * iters),
        "torch_cuda_current_stream": host_us(
            lambda: torch.cuda.current_stream().cuda_stream, 20 * iters),
        "two_allocations": host_us(lambda: (torch.empty_like(x),
                                            torch.empty_like(ws)),
                                   20 * iters),
    }
    print(f"  host us per call at {HOST_SITE}: "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items()), flush=True)
    return {"device": torch.cuda.get_device_name(dev),
            "dtype": str(dtype)[6:], "iters": iters, "rows": rows,
            "host_us": host, "host_site": list(HOST_SITE)}


def main(argv: Optional[Sequence[str]] = None, device: str = "cuda") -> dict:
    """Prints the sweep as one JSON line and returns it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("perf_in measures the CUDA kernels and needs a "
                           "CUDA device")
    out = run(int(argv[0]) if argv else 20, dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
