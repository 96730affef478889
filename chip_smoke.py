#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sggan_tpu_torch``).

Drives the port's serving path once on one NVIDIA GPU at full width:
the ResNet generator (ngf 64) at 256x512 behind the HTTP service, with
random weights from a seed.  Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build the instance-norm kernel (csrc/instance_norm.cu) with nvcc;
  3. the kernel against its plain PyTorch version on the card, at the
     four (shape, act) pairs of the generator's 23 instance-norm sites,
     batch 1 and 16, f32 and bf16;
  4. the whole generator at 256x512: the f32 card forward (TF32 off)
     against the same module's f32 CPU forward, and the bf16 card forward;
  5. the HTTP service on the card: /healthz, four PNG translations (one
     1024x2048, so the resize runs), one garbage body answered 400; the
     kernel's launch count must grow by 23 per generator forward;
  6. timings with CUDA events: generator forward, kernel against plain
     version, and a device-time breakdown from torch.profiler.

Prints a JSON line of the kernels, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing neither,
when no CUDA device is visible or any phase fails.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

SITES = [((256, 512, 64), "relu"), ((128, 256, 128), "relu"),
         ((64, 128, 256), "relu"), ((64, 128, 256), None)]
SITE_COUNT = [2, 2, 10, 9]  # per generator forward: 23 instance norms
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # tests/test_pallas.py
SLICE_ATOL = 1e-3
H, W, NGF = 256, 512, 64


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def site_inputs(n, hwc, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = hwc[-1]
    x = (torch.randn((n, *hwc), generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = torch.rand(c, generator=g, device=dev) + 0.5
    beta = torch.randn(c, generator=g, device=dev) * 0.1
    return x, gamma, beta


def png(arr: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def post(port: int, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/translate",
                                 data=body,
                                 headers={"Content-Type": "image/png"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


CATEGORIES = [("K1 instance norm", ("in_stats", "in_apply")),
              ("convolutions", ("xmma", "conv", "cutlass", "gemm")),
              ("reflect-pad gathers", ("index_elementwise",)),
              ("copies and casts", ("copy",)),
              ("residual adds", ("CUDAFunctor_add",))]


def profile_forward(gen, n: int, wall_ms: float, card: str) -> None:
    """Device time of one bf16 forward by kernel and by category
    (torch.profiler over 3 forwards)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.round(torch.rand(n, H, W, 3, device="cuda") * 255.0)
    with torch.inference_mode():
        gen(x, torch.bfloat16)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                gen(x, torch.bfloat16)
            torch.cuda.synchronize()
    kern = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            kern.append((us / 3 / 1e3, e.count // 3, e.key))
    kern.sort(reverse=True)
    total = sum(k[0] for k in kern)
    print(f"  [{card}] profiler, b={n} bf16 forward: device busy "
          f"{total:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * (1 - total / wall_ms):.1f}% idle)")
    left = list(kern)
    for cat, keys in CATEGORIES:
        mine = [k for k in left if any(t in k[2] for t in keys)]
        left = [k for k in left if k not in mine]
        print(f"    {cat:22s} {sum(k[0] for k in mine):8.4f} ms "
              f"in {sum(k[1] for k in mine)} launches")
    print(f"    {'other':22s} {sum(k[0] for k in left):8.4f} ms "
          f"in {sum(k[1] for k in left)} launches")
    for ms, cnt, name in kern[:10]:
        print(f"      {ms:8.4f} ms  x{cnt:<3d} {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from PIL import Image

    from sggan_tpu_torch import serve as srv
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.models.generator_resnet import GeneratorResnet
    from sggan_tpu_torch.ops import _build, cuda_in
    from sggan_tpu_torch.ops.norm import instance_norm_ref

    dev = torch.device("cuda")

    phase("1 card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    phase("2 build")
    t0 = time.perf_counter()
    lib, log = _build.build("instance_norm")
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s "
          f"({'compiled' if log else 'already built'})")
    for line in log.splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            print("  " + line.strip())

    phase("3 kernel vs plain")
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n in (1, 16):
        for dtype in (torch.float32, torch.bfloat16):
            for i, (hwc, act) in enumerate(SITES):
                x, g, b = site_inputs(n, hwc, dtype, dev, seed=i)
                got = cuda_in.instance_norm_cuda(x, g, b, 1e-3, act, 0.3)
                ref = instance_norm_ref(x, g, b, 1e-3, act, 0.3)
                if got.dtype != dtype or got.shape != x.shape:
                    raise AssertionError(f"kernel output {got.dtype} "
                                         f"{tuple(got.shape)}")
                d = (got.float() - ref.float()).abs()
                tol = TOL[dtype]
                n_bad = int((d > tol + tol * ref.float().abs()).sum())
                err = d.max().item()
                errs[dtype] = max(errs[dtype], err)
                print(f"  ({n},{','.join(map(str, hwc))}) act={act} "
                      f"{str(dtype)[6:]}: max abs diff {err:.3g} "
                      f"(tol {tol} abs + rel), {n_bad} outside")
                if n_bad:
                    raise AssertionError("kernel disagrees with plain IN")
                del x, got, ref, d
    torch.cuda.empty_cache()

    phase("4 whole generator at 256x512, ngf 64")
    gen = GeneratorResnet(ngf=NGF, generator=torch.Generator().manual_seed(0))
    gx = torch.Generator().manual_seed(1)
    x_cpu = torch.round(torch.rand(1, H, W, 3, generator=gx) * 255.0)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = gen(x_cpu, torch.float32)
        print(f"  cpu f32 forward {time.perf_counter() - t0:.2f} s")
        gen = gen.to(dev)
        before = cuda_in.launches
        out32 = gen(x_cpu.to(dev), torch.float32).cpu()
        if cuda_in.launches - before != 23:
            raise AssertionError("card forward did not run 23 kernel IN")
        out16 = gen(x_cpu.to(dev), torch.bfloat16).cpu()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    d32 = (out32 - ref).abs().max().item()
    d16 = (out16 - ref).abs().max().item()
    print(f"  card f32 vs cpu f32: max abs diff {d32:.3g} "
          f"(atol {SLICE_ATOL})")
    print(f"  card bf16 vs cpu f32: max abs diff {d16:.3g}; "
          f"bf16 range [{out16.min().item():.4f}, {out16.max().item():.4f}]")
    if not (out32.shape == ref.shape == (1, H, W, 3)
            and torch.isfinite(out32).all() and d32 <= SLICE_ATOL):
        raise AssertionError("f32 card forward disagrees with the CPU")
    if not (torch.isfinite(out16).all() and out16.abs().max() <= 1.0):
        raise AssertionError("bf16 card forward not finite or outside "
                             "[-1, 1]")
    del gen, ref, out32, out16
    torch.cuda.empty_cache()

    phase("5 HTTP service on the card")
    cfg = Config(use_resnet=True, image_height=H, image_width=W, ngf=NGF,
                 compute_dtype="bfloat16")
    cuda_in.launches = 0  # the main path's count starts here
    httpd = srv.serve(cfg, port=0, block=False, device="cuda")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    latencies = []
    try:
        port = httpd.server_address[1]
        if cuda_in.launches != 23:
            raise AssertionError(f"warm-up forward launched the kernel "
                                 f"{cuda_in.launches} times, not 23")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        print(f"  healthz {health}")
        if not (health["ok"] and health["backend"] == "cuda"
                and health["image_size"] == [H, W]):
            raise AssertionError("bad /healthz")
        rng = np.random.default_rng(0)
        sizes = [(H, W), (1024, 2048), (H, W), (H, W)]
        for i, (ih, iw) in enumerate(sizes):
            body = png(rng.integers(0, 256, (ih, iw, 3), np.uint8))
            before = cuda_in.launches
            t0 = time.perf_counter()
            status, data = post(port, body)
            latencies.append((time.perf_counter() - t0) * 1e3)
            out = np.asarray(Image.open(io.BytesIO(data)))
            print(f"  POST {ih}x{iw}: {status}, {out.shape} {out.dtype}, "
                  f"{latencies[-1]:.1f} ms, "
                  f"+{cuda_in.launches - before} kernel launches")
            if status != 200 or out.shape != (H, W, 3) \
                    or out.dtype != np.uint8 or out.std() == 0:
                raise AssertionError("bad translation")
            if cuda_in.launches - before != 23:
                raise AssertionError("request did not run 23 kernel IN")
        try:
            post(port, b"this is not an image")
            raise AssertionError("garbage body was not refused")
        except urllib.error.HTTPError as e:
            print(f"  POST garbage: {e.code}")
            if e.code != 400:
                raise
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    main_launches = cuda_in.launches
    if main_launches != 23 * (1 + len(sizes)):
        raise AssertionError(f"main path launched the kernel "
                             f"{main_launches} times")
    print(f"  main path: {main_launches} kernel launches "
          f"(1 warm-up + {len(sizes)} requests, 23 each)")

    phase("6 timings")
    gen = GeneratorResnet(ngf=NGF, generator=torch.Generator().manual_seed(0))
    gen = gen.to(dev)
    fwd_ms = {}
    with torch.inference_mode():
        for n, iters in ((1, 20), (16, 5)):
            x = torch.round(torch.rand(n, H, W, 3, device=dev) * 255.0)
            fwd_ms[n] = cuda_ms(lambda: gen(x, torch.bfloat16), iters)
            print(f"  [{card}] generator forward bf16 b={n}: "
                  f"{fwd_ms[n]:.3f} ms ({fwd_ms[n] / n:.3f} ms/image)")
    k_ms, p_ms = {}, {}
    for n in (1, 16):
        for i, (hwc, act) in enumerate(SITES):
            x, g, b = site_inputs(n, hwc, torch.bfloat16, dev, seed=i)
            iters = 50 if n == 1 else 10
            k_ms[n, i] = cuda_ms(
                lambda: cuda_in.instance_norm_cuda(x, g, b, 1e-3, act), iters)
            p_ms[n, i] = cuda_ms(
                lambda: instance_norm_ref(x, g, b, 1e-3, act), iters)
            gbs = 3 * x.numel() * x.element_size() / k_ms[n, i] / 1e6
            print(f"  [{card}] IN ({n},{','.join(map(str, hwc))}) "
                  f"act={act} bf16: kernel {k_ms[n, i]:.4f} ms "
                  f"({gbs:.0f} GB/s at 2R+1W), plain {p_ms[n, i]:.4f} ms")
            del x
    per_fwd = {n: (sum(c * k_ms[n, i] for i, c in enumerate(SITE_COUNT)),
                   sum(c * p_ms[n, i] for i, c in enumerate(SITE_COUNT)))
               for n in (1, 16)}
    for n, (k, p) in per_fwd.items():
        print(f"  [{card}] 23 IN sites of one b={n} bf16 forward: kernel "
              f"{k:.3f} ms, plain {p:.3f} ms")
    for i, ms in enumerate(latencies):
        print(f"  [{card}] request {i} ({sizes[i][0]}x{sizes[i][1]} PNG) "
              f"latency {ms:.1f} ms")
    # the request's parts, host clock, median of 5: the service's whole
    # translation (decode, resize, generate, PNG encode) and its generate
    # call alone (input convention, H2D, forward, D2H)
    svc = srv._Service(cfg, device="cuda")
    body = png(np.random.default_rng(1).integers(0, 256, (H, W, 3),
                                                  np.uint8))
    x01 = np.asarray(Image.open(io.BytesIO(body)), np.float32)[None] / 255.0
    parts = {}
    for name, fn in (("translate_png", lambda: svc.translate_png(body)),
                     ("generate", lambda: svc._fn(x01))):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        parts[name] = sorted(ts)[2]
    print(f"  [{card}] request parts, 256x512: translate_png "
          f"{parts['translate_png']:.1f} ms, of which generate "
          f"{parts['generate']:.1f} ms; HTTP adds "
          f"{sorted(latencies)[1] - parts['translate_png']:.1f} ms")
    del svc

    for n in (1, 16):
        profile_forward(gen, n, fwd_ms[n], card)

    print(json.dumps({"kernels": [{
        "name": "instance_norm_fwd",
        "route": "cuda",
        "source": "sggan_tpu_torch/csrc/instance_norm.cu",
        "replaces": "sggan_tpu/ops/pallas_in.py:107",
        "launches": main_launches,
        "max_abs_err": max(errs.values()),
        "max_abs_err_f32": errs[torch.float32],
        "ms": per_fwd[1][0],
        "plain_ms": per_fwd[1][1],
        "ms_is": "sum over the 23 IN sites of one b=1 bf16 forward",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
