"""Forward and forward+backward table of the fused conv3x3 + instance norm
kernel (K2, ``ops/cuda_conv_in.py``) against the library composition
(reflect-pad gather -> cuDNN conv -> K1 instance norm), at the two shapes
that dominate the train step:

  (16,  64, 128, 256 -> 256)   the resblock body (18 of the 24 generator convs)
  (16, 256, 512,  64 ->  64)   the wide, narrow-channel encoder shape

Port of the repository's root ``perf_conv_in.py``.  The numerics
cross-check runs first (max |K2 - unfused| printed; above 0.05 it raises),
so the table is of a verified-equivalent kernel.  Timings are CUDA events
around ``iters`` calls after a warm-up; beside them, torch.profiler's
device time of K2's conv pass alone (``conv_pass_ms``, with its TF/s) and
of the cuDNN conv alone (``conv_only_device_ms``), each kernel's mean
summed as ``perf_in.device_ms`` takes it.  A failed check raises: nothing
is recorded and skipped over.

    python -m sggan_tpu_torch.perf_conv_in [iters]     (prints one JSON line)

Runs on the card, bf16, and fails without one.  ``main(device="cpu")`` is
the CPU tests' smoke at (2, 16, 16, 8 -> 8) in f32: the plain twins, timed
on the host clock, which says nothing about the card.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Callable, Optional, Sequence

import torch

from .ops import cuda_conv_in as cci
from .ops.layers import _nchw, conv2d_reflect, reflect_pad
from .perf_in import device_ms

SHAPES = [(16, 64, 128, 256, 256), (16, 256, 512, 64, 64)]
CPU_SHAPES = [(2, 16, 16, 8, 8)]
CHECK_LIMIT = 0.05  # bf16: an ulp of y16 is up to 2^-8 of a value near 4 sigma


def _bench(fn: Callable, iters: int, device: torch.device,
           warmup: int = 3) -> float:
    """Seconds per call: CUDA events on the card, the host clock on the
    CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters / 1e3


def inputs(shape: Sequence[int], dtype: torch.dtype, device: torch.device,
           seed: int = 0):
    """x ~ N(0, 1) in ``dtype``, an f32 kernel ~ N(0, 1 / (9 cin)) in the
    port's (cout, cin, 3, 3) layout, gamma 1 and beta 0, from a seed."""
    n, h, w, cin, cout = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=g, device=device).to(dtype)
    wk = torch.randn((cout, cin, 3, 3), generator=g, device=device) \
        / math.sqrt(9 * cin)
    return (x, wk, torch.ones(cout, device=device),
            torch.zeros(cout, device=device))


def run(iters: int, device: torch.device, shapes, dtype: torch.dtype,
        act: Optional[str] = "relu") -> dict:
    rows = []
    for shape in shapes:
        n, h, w, cin, cout = shape
        x, wk, gamma, beta = inputs(shape, dtype, device)
        gflop = 2 * 9 * cin * cout * n * h * w / 1e9
        xp = _nchw(reflect_pad(x, 1))
        wc = wk.to(dtype)

        def k2_f():
            return cci.conv3_in(x, wk, gamma, beta, act=act)

        def unfused_f():
            return cci.conv3_in_unfused({"w": wk}, {"gamma": gamma,
                                                    "beta": beta}, x, act=act)

        def grads(fwd):
            leaves = [t.detach().requires_grad_(True)
                      for t in (x, wk, gamma, beta)]

            def step():
                y = fwd(*leaves)
                return torch.autograd.grad(y.float().square().sum(), leaves)
            return step

        k2_g = grads(lambda x, wk, g, b: cci.conv3_in(x, wk, g, b, act=act))
        unfused_g = grads(lambda x, wk, g, b: cci.conv3_in_unfused(
            {"w": wk}, {"gamma": g, "beta": b}, x, act=act))

        row = {"shape": list(shape)}
        with torch.no_grad():
            dmax = (k2_f().float() - unfused_f().float()).abs().max().item()
        print(f"shape {n}x{h}x{w}x{cin}->{cout}: max|K2-unfused| = "
              f"{dmax:.3e}", file=sys.stderr, flush=True)
        if not dmax < CHECK_LIMIT:
            raise AssertionError(f"K2 / unfused forward mismatch at {shape}: "
                                 f"{dmax}")
        row["max_abs_diff"] = dmax

        variants = [
            ("fwd_k2", k2_f, gflop, False),
            ("fwd_unfused", unfused_f, gflop, False),
            ("fwd_conv_reflect", lambda: conv2d_reflect(
                {"w": wk}, x, dtype, bias=False), gflop, False),
            ("fwd_conv_only", lambda: torch.nn.functional.conv2d(xp, wc),
             gflop, False),
            ("fwdbwd_k2", k2_g, 3 * gflop, True),
            ("fwdbwd_unfused", unfused_g, 3 * gflop, True),
        ]
        for name, fn, fl, grad in variants:
            with torch.set_grad_enabled(grad):
                dt = _bench(fn, iters, device)
            row[name + "_ms"] = dt * 1e3
            row[name + "_tfs"] = fl / dt / 1e3
            print(f"  {name:>16}: {dt * 1e3:8.3f} ms  ({fl / dt / 1e3:6.1f} "
                  "TF/s)", file=sys.stderr, flush=True)
        if device.type == "cuda":
            with torch.no_grad():
                ms = device_ms(k2_f, iters, keys=("k2_conv",))
                row["conv_pass_ms"], row["conv_pass_tflops"] = ms, gflop / ms
                row["conv_only_device_ms"] = device_ms(
                    lambda: torch.nn.functional.conv2d(xp, wc), iters)
            print(f"  {'conv pass':>16}: {ms:8.3f} ms  ({gflop / ms:6.1f} "
                  f"TF/s, device); cuDNN conv alone "
                  f"{row['conv_only_device_ms']:.3f} ms device",
                  file=sys.stderr, flush=True)
        rows.append(row)
        del x, xp, k2_g, unfused_g
    return {"backend": device.type,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "timer": "cuda events" if device.type == "cuda" else "host clock",
            "compute_dtype": str(dtype)[6:], "iters": iters, "rows": rows}


def main(argv: Optional[Sequence[str]] = None, device: str = "cuda") -> dict:
    """Prints the table as one JSON line and returns it.  ``device`` is
    "cuda" unless the caller asks for the CPU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("perf_conv_in needs a CUDA device")
        iters = int(argv[0]) if argv else 48
        out = run(iters, dev, SHAPES, torch.bfloat16)
    else:
        out = run(2, dev, CPU_SHAPES, torch.float32)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
