#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sggan_tpu_torch``).

Drives the port's two paths on one NVIDIA GPU at full width, with random
weights from a seed: the serving path (the ResNet generator, ngf 64, at
256x512 behind the HTTP service) and the sggan train step (ResNet
generator, semantic discriminator ndf 64, 34 classes, pool 50, bf16,
batch 16).  Run from the repository root:

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
     version, and a device-time breakdown from torch.profiler;
  7. both instance-norm kernels against their plain versions at the
     train step's sites (the generator's four at batch 16, the
     discriminator's seven, leaky_relu, at batch 16 and 32), f32 and bf16:
     the forward's output and saved moments, then the backward fed the
     kernel's own moments;
  8. one f32 sggan step, card (kernels, TF32 off) against CPU (plain
     versions) from the same seeded state, batch and pool draws: losses
     and every gradient, at the CPU tests' size (32x64, b=2) and at full
     width (256x512, b=1), where the card is also run with cuDNN off to
     show the gradients' f32 noise floor;
  9. the train step at full width, bf16, batch 16, >= 12 steps: finite
     losses, and exactly 37 forward and 37 backward kernel launches per
     step;
  10. timings: step time, img/s and peak memory at batch 16 and 24; both
     kernels at every site of the step against their plain versions and
     PyTorch's F.instance_norm; a torch.profiler breakdown of one step.

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
# the discriminator's 7 instance norms at 256x512 (ndf 64): h1, h2, h3,
# then the VALID chain [2, 2, 2, 1] on the 32x64 h3 grid; all leaky_relu
D_SITES = [((64, 128, 128), "leaky_relu"), ((32, 64, 256), "leaky_relu"),
           ((32, 64, 512), "leaky_relu"), ((15, 31, 512), "leaky_relu"),
           ((7, 15, 512), "leaky_relu"), ((3, 7, 512), "leaky_relu"),
           ((1, 5, 512), "leaky_relu")]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # tests/test_pallas.py
SLICE_ATOL = 1e-3
# phase 8 at 256x512: largest |diff| over a gradient's largest element, and
# |diff| / |g| in norm.  f32 whole-net gradients at init are sums with deep
# cancellation, and any two summation orders differ by a few percent of a
# tensor's largest element (PERF.md section 6); the planted faults of
# tests/test_torch_step.py move them by far more than these limits.
STEP_MAX_REL, STEP_NORM_REL = 0.1, 2e-2
H, W, NGF = 256, 512, 64
B_TRAIN, N_STEPS, N_CLASS = 16, 12, 34
LAUNCHES_PER_STEP = 37  # 23 generator + 7 (D for the gen loss) + 7 (D call)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores


def step_sites():
    """(N, (H, W, C), act, calls per step) of every instance norm of one
    b=16 train step: the generator's 23, the discriminator's 7 in the
    generator loss (batch 16) and in the one call over [real; fake]
    (batch 32)."""
    return ([(B_TRAIN, hwc, act, c) for (hwc, act), c in zip(SITES, SITE_COUNT)]
            + [(B_TRAIN, hwc, act, 1) for hwc, act in D_SITES]
            + [(2 * B_TRAIN, hwc, act, 1) for hwc, act in D_SITES])


def bound_ms(n, hwc, dtype_bytes, tensors, flops_per_elt):
    """Least time for one call: ``tensors`` activation-sized arrays moved
    once each at HBM rate, or the f32 operations at the f32 rate."""
    elts = n * hwc[0] * hwc[1] * hwc[2]
    return 1e3 * max(tensors * elts * dtype_bytes / HBM_BYTES_PER_S,
                     flops_per_elt * elts / F32_FLOPS_PER_S)


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


def print_breakdown(prof, n_runs: int, wall_ms: float, title: str,
                    categories) -> None:
    """Device time per run from a torch.profiler trace of ``n_runs`` runs,
    by category and by kernel, and the device idle share against the
    event-timed ``wall_ms`` of one run."""
    kern = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            kern.append((us / n_runs / 1e3, e.count // n_runs, e.key))
    kern.sort(reverse=True)
    total = sum(k[0] for k in kern)
    print(f"  {title}: device busy {total:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * (1 - total / wall_ms):.1f}% idle)")
    left = list(kern)
    for cat, keys in categories:
        mine = [k for k in left if any(t in k[2] for t in keys)]
        left = [k for k in left if k not in mine]
        print(f"    {cat:30s} {sum(k[0] for k in mine):8.4f} ms "
              f"in {sum(k[1] for k in mine)} launches")
    print(f"    {'other':30s} {sum(k[0] for k in left):8.4f} ms "
          f"in {sum(k[1] for k in left)} launches")
    for ms, cnt, name in kern[:12]:
        print(f"      {ms:8.4f} ms  x{cnt:<4d} {name[:90]}")


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
    print_breakdown(prof, 3, wall_ms, f"[{card}] profiler, b={n} bf16 "
                    "forward", CATEGORIES)


STEP_CATEGORIES = [
    ("K1 backward", ("in_bwd_stats", "in_bwd_apply")),
    ("K1 forward", ("in_stats", "in_apply")),
    ("convolutions", ("xmma", "conv", "cutlass", "gemm", "cudnn")),
    ("reflect pads and their adjoints", ("index_elementwise",
                                         "indexing_backward", "index_put",
                                         "RadixSort", "radix_sort")),
    ("pool gathers and concats", ("index_select", "indexSelect",
                                  "CatArray")),
    ("Adam and EMA (foreach)", ("multi_tensor_apply",)),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce_kernel",)),
]


def train_batch(cfg, b: int, dev, seed: int) -> dict:
    """A synthetic batch like bench.py's: uniform photo and seg map, a
    one-hot mask of random classes on the mask grid."""
    g = torch.Generator().manual_seed(seed)
    h, w = cfg.image_size
    hm, wm = cfg.mask_hw
    ids = torch.randint(0, cfg.segment_class, (b, hm, wm), generator=g)
    return {"real_a": torch.rand(b, h, w, 3, generator=g).to(dev),
            "seg_a": torch.rand(b, h, w, 3, generator=g).to(dev),
            "mask_a": torch.eye(cfg.segment_class)[ids].to(dev)}


def grad_rows(ref: dict, got: dict) -> list:
    """(max |diff| / max |g|, |diff| / |g|, name) for every gradient of
    ``ref`` that is not all zero, sorted, the worst max last."""
    return sorted(((got[k] - ref[k]).abs().max().item()
                   / ref[k].abs().max().item(),
                   ((got[k] - ref[k]).norm() / ref[k].norm()).item(), k)
                  for k in ref if ref[k].any())


def print_rows(title: str, rows: list) -> None:
    print(f"    {title}: median max |diff| / max |g| "
          f"{rows[len(rows) // 2][0]:.3g}; largest |diff| / |g| "
          f"{max(r[1] for r in rows):.3g}")
    for mx, nr, k in rows[::-1][:3]:
        print(f"      {k}: max |diff| / max |g| {mx:.3g}, |diff| / |g| "
              f"{nr:.3g}")


def step_grads(cfg, b: int, dev: str):
    """One f32 step's losses and gradients on ``dev`` from the seeded
    state, batch and pool draws that every call shares; gradients on the
    CPU, keyed "gen.*" and "disc.*"."""
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    batch = train_batch(cfg, b, dev, seed=3)
    draws = tpool.pool_draws(torch.Generator().manual_seed(4), b,
                             cfg.max_size)
    st = tstep.init_state(cfg, torch.Generator().manual_seed(0), dev)
    t0 = time.perf_counter()
    m, gg, dg, _ = tstep.losses_and_grads(cfg, st, batch, draws)
    m = {k: v.item() for k, v in m.items()}
    print(f"  {cfg.image_size}, ngf {cfg.ngf}, ndf {cfg.ndf}, b={b}, {dev}: "
          f"losses and grads in {time.perf_counter() - t0:.2f} s, {m}")
    return m, {**{f"gen.{k}": v.cpu() for k, v in gg.items()},
               **{f"disc.{k}": v.cpu() for k, v in dg.items()}}


def step_card_vs_cpu(cfg, b: int):
    """One f32 step's losses and gradients on the CPU (plain versions) and
    on the card (kernels).  Prints and returns the losses' largest
    relative difference, the ``grad_rows`` of the card against the CPU,
    the CPU's gradients, and whether a gradient that is zero on the CPU (a
    dead bias) is not zero on the card."""
    (mc, gc), (mg, gg) = step_grads(cfg, b, "cpu"), step_grads(cfg, b, "cuda")
    loss_err = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in mc)
    dead = [k for k in gc if not gc[k].any()]
    rows = grad_rows(gc, gg)
    print(f"    losses max rel diff {loss_err:.3g}; {len(rows)} gradients, "
          f"{len(dead)} dead biases zero on the CPU")
    print_rows("card vs CPU", rows)
    return loss_err, rows, gg, any(gg[k].any() for k in dead)


def library_in(x, gamma, beta, act):
    """PyTorch's own instance norm (eps 1e-3) and activation on the NCHW
    view of an NHWC tensor: the yardstick, never called by the port."""
    import torch.nn.functional as F
    y = F.instance_norm(x.permute(0, 3, 1, 2), weight=gamma, bias=beta,
                        eps=1e-3)
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, 0.3)
    return y


def time_sites(card: str, dev) -> dict:
    """Both K1 kernels, their plain versions and PyTorch's instance norm at
    every instance-norm site of one b=16 bf16 train step; returns the sums
    over the step's 37 calls."""
    from sggan_tpu_torch.ops import cuda_in
    from sggan_tpu_torch.ops import norm as tnorm
    tot = {(d, k): 0.0 for d in ("fwd", "bwd") for k in (
        "ms", "plain_ms", "bound_ms", "floor_ms", "library_ms")}
    for i, (n, hwc, act, calls) in enumerate(step_sites()):
        x, g, b = site_inputs(n, hwc, torch.bfloat16, dev, seed=i)
        dy = torch.randn(x.shape, device=dev).to(torch.bfloat16)
        _, mean, rstd = cuda_in.instance_norm_cuda(x, g, b, 1e-3, act,
                                                   save_stats=True)
        it = 20 if n * hwc[0] * hwc[1] < 2 ** 20 else 5
        ms = {
            ("fwd", "ms"): cuda_ms(lambda: cuda_in.instance_norm_cuda(
                x, g, b, 1e-3, act, save_stats=True), it),
            ("fwd", "plain_ms"): cuda_ms(lambda: tnorm._ref_forward(
                x, g, b, 1e-3, act, 0.3), it),
            ("fwd", "library_ms"): cuda_ms(lambda: library_in(x, g, b, act),
                                           it),
            ("bwd", "ms"): cuda_ms(lambda: cuda_in.instance_norm_bwd_cuda(
                x, dy, g, b, mean, rstd, act), it),
            ("bwd", "plain_ms"): cuda_ms(lambda: tnorm.instance_norm_bwd_ref(
                x, dy, g, b, mean, rstd, act), it),
        }
        xr, gr, br = (t.detach().requires_grad_(True) for t in (x, g, b))
        y = library_in(xr, gr, br, act)
        dyp = dy.permute(0, 3, 1, 2)
        ms["bwd", "library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            y, (xr, gr, br), dyp, retain_graph=True), it)
        # bound: each input read once, each output written once; floor:
        # what the algorithm must move, since the sums need the whole
        # plane before the first output (fwd 2R+1W, bwd 2x(x, dy) + dx)
        ms["fwd", "bound_ms"] = bound_ms(n, hwc, 2, 2, 8)
        ms["bwd", "bound_ms"] = bound_ms(n, hwc, 2, 3, 14)
        ms["fwd", "floor_ms"] = bound_ms(n, hwc, 2, 3, 8)
        ms["bwd", "floor_ms"] = bound_ms(n, hwc, 2, 5, 14)
        for key, v in ms.items():
            tot[key] += calls * v
        print(f"  [{card}] K1 ({n},{','.join(map(str, hwc))}) act={act} "
              f"bf16 x{calls}: fwd {ms['fwd', 'ms']:.4f} ms (plain "
              f"{ms['fwd', 'plain_ms']:.4f}, F.instance_norm "
              f"{ms['fwd', 'library_ms']:.4f}, bound "
              f"{ms['fwd', 'bound_ms']:.4f}); bwd {ms['bwd', 'ms']:.4f} ms "
              f"(plain {ms['bwd', 'plain_ms']:.4f}, autograd of "
              f"F.instance_norm {ms['bwd', 'library_ms']:.4f}, bound "
              f"{ms['bwd', 'bound_ms']:.4f})")
        del x, dy, y, xr, mean, rstd
    torch.cuda.empty_cache()
    for d in ("fwd", "bwd"):
        print(f"  [{card}] K1 {d}, the 37 calls of one b=16 step: kernel "
              f"{tot[d, 'ms']:.3f} ms, plain {tot[d, 'plain_ms']:.3f} ms, "
              f"F.instance_norm {tot[d, 'library_ms']:.3f} ms, bound "
              f"{tot[d, 'bound_ms']:.3f} ms, floor {tot[d, 'floor_ms']:.3f} "
              "ms")
    return tot


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from PIL import Image

    from sggan_tpu_torch import serve as srv
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.models.generator_resnet import GeneratorResnet
    from sggan_tpu_torch.ops import _build, cuda_in
    from sggan_tpu_torch.ops import norm as tnorm
    from sggan_tpu_torch.ops.norm import instance_norm_ref
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep

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
        cpu_fwd_s = time.perf_counter() - t0
        print(f"  cpu f32 forward {cpu_fwd_s:.2f} s")
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
    del gen
    torch.cuda.empty_cache()

    phase("7 K1 forward and backward vs plain at the step's sites")
    bwd_errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = ([(B_TRAIN, hwc, act) for hwc, act in SITES]
             + [(n, hwc, act) for n in (B_TRAIN, 2 * B_TRAIN)
                for hwc, act in D_SITES])
    for dtype in (torch.float32, torch.bfloat16):
        for i, (n, hwc, act) in enumerate(cases):
            x, g, b = site_inputs(n, hwc, dtype, dev, seed=i)
            gd = torch.Generator(device=dev).manual_seed(100 + i)
            dy = torch.randn(x.shape, generator=gd, device=dev).to(dtype)
            # the forward as the train step calls it: output and moments
            y, mean, rstd = cuda_in.instance_norm_cuda(x, g, b, 1e-3, act,
                                                       0.3, save_stats=True)
            ry, rmean, rrstd = tnorm._ref_forward(x, g, b, 1e-3, act, 0.3)
            if y.dtype != dtype or mean.shape != (n, hwc[-1]):
                raise AssertionError(f"forward output {y.dtype}, moments "
                                     f"{tuple(mean.shape)}")
            dy_ = (y.float() - ry.float()).abs()
            tol = TOL[dtype]
            # saved moments: tests/test_torch_cuda.py's tolerances
            n_bad = (int((dy_ > tol + tol * ry.float().abs()).sum())
                     + int(((mean - rmean).abs()
                            > 1e-5 + 1e-5 * rmean.abs()).sum())
                     + int(((rstd - rrstd).abs()
                            > 1e-5 + 1e-4 * rrstd.abs()).sum()))
            f_err = max(dy_.max().item(), (mean - rmean).abs().max().item(),
                        (rstd - rrstd).abs().max().item())
            errs[dtype] = max(errs[dtype], f_err)
            print(f"  ({n},{','.join(map(str, hwc))}) act={act} "
                  f"{str(dtype)[6:]}: fwd y/mean/rstd max abs diff "
                  f"{f_err:.3g}, {n_bad} outside")
            if n_bad:
                raise AssertionError("forward kernel or its moments "
                                     "disagree with plain")
            # both backwards fed the kernel's own moments, as the step
            # feeds them: moments that differ by an ulp flip the act gate
            # of the few elements whose pre-activation is that near 0, and
            # each flip moves its whole plane's dx by ~|dy| / (H * W)
            dx, dg, db = cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean,
                                                        rstd, act)
            rdx, rdg, rdb = tnorm.instance_norm_bwd_ref(x, dy, g, b, mean,
                                                        rstd, act)
            if dx.dtype != dtype or dx.shape != x.shape:
                raise AssertionError(f"backward output {dx.dtype} "
                                     f"{tuple(dx.shape)}")
            d = (dx.float() - rdx.float()).abs()
            err = d.max().item()
            scale = rdx.float().abs().max().item()
            if dtype == torch.float32:  # tests/test_pallas.py's grad tol
                n_bad = int((d > 1e-5 + 1e-4 * rdx.abs()).sum())
            else:
                n_bad = int(err > 2e-2 * scale)
            e_g = max((dg - rdg).abs().max().item()
                      / max(rdg.abs().max().item(), 1e-30),
                      (db - rdb).abs().max().item()
                      / max(rdb.abs().max().item(), 1e-30))
            bwd_errs[dtype] = max(bwd_errs[dtype], err)
            print(f"  ({n},{','.join(map(str, hwc))}) act={act} "
                  f"{str(dtype)[6:]}: bwd dx max abs diff {err:.3g} "
                  f"(max |dx| {scale:.3g}), {n_bad} outside; dgamma/dbeta "
                  f"max rel diff {e_g:.3g} (tol 1e-4)")
            if n_bad or e_g > 1e-4:
                raise AssertionError("backward kernel disagrees with plain")
            del x, dy, y, ry, dy_, dx, rdx, d
    torch.cuda.empty_cache()

    phase("8 train step f32, card vs CPU")
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    # at the CPU tests' size (32x64, ngf = ndf = 4, 8 classes, b=2) every
    # gradient within 1e-3 of its tensor's largest, as
    # tests/test_torch_cuda.py holds it
    small = Config(image_height=32, image_width=64, ngf=4, ndf=4,
                   segment_class=8, batch_size=2, max_size=2,
                   compute_dtype="float32", loss_mode="sggan",
                   use_resnet=True)
    loss_err, rows, _, dead_live = step_card_vs_cpu(small, 2)
    if loss_err > 1e-4 or dead_live or max(r[0] for r in rows) > 1e-3:
        raise AssertionError("card step disagrees with the CPU step at "
                             "32x64")
    # the CPU step costs about four forwards (forward, backward, two
    # discriminator passes); full width when that stays near a minute
    full = 4 * cpu_fwd_s < 60
    cfg8 = Config(image_height=H if full else 128,
                  image_width=W if full else 256, ngf=NGF if full else 32,
                  ndf=64 if full else 32, segment_class=N_CLASS,
                  batch_size=1, max_size=50, compute_dtype="float32",
                  loss_mode="sggan", use_resnet=True)
    print(f"  {'full width' if full else 'reduced'} (CPU forward "
          f"{cpu_fwd_s:.1f} s):")
    loss_err, rows, card_g, dead_live = step_card_vs_cpu(cfg8, 1)
    # the noise floor: the same kernels with PyTorch's own convolutions in
    # place of cuDNN's, which sum in another order
    torch.backends.cudnn.enabled = False
    try:
        _, native_g = step_grads(cfg8, 1, "cuda")
    finally:
        torch.backends.cudnn.enabled = True
    print_rows("card with cuDNN off vs card (noise floor)",
               grad_rows(card_g, native_g))
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    if (loss_err > 1e-4 or dead_live
            or max(r[0] for r in rows) > STEP_MAX_REL
            or max(r[1] for r in rows) > STEP_NORM_REL):
        raise AssertionError("card step disagrees with the CPU step")
    del card_g, native_g
    torch.cuda.empty_cache()

    phase("9 train step at 256x512, bf16, b=16 (main path)")
    cfg = Config(image_height=H, image_width=W, ngf=NGF, ndf=64,
                 segment_class=N_CLASS, batch_size=B_TRAIN, max_size=50,
                 compute_dtype="bfloat16", loss_mode="sggan",
                 use_resnet=True)
    state = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cuda")
    batch = train_batch(cfg, B_TRAIN, dev, seed=5)
    step_fn = tstep.build_step_fn(cfg)
    draw_gen = torch.Generator().manual_seed(6)
    cuda_in.launches = cuda_in.bwd_launches = 0  # the main path starts here
    step_losses = []
    for _ in range(N_STEPS):
        state, m = step_fn(state, batch, 1e-3, tpool.pool_draws(
            draw_gen, B_TRAIN, cfg.max_size))
        step_losses.append(torch.stack([m["gen_loss"], m["disc_loss"]]))
    torch.cuda.synchronize()
    train_fwd, train_bwd = cuda_in.launches, cuda_in.bwd_launches
    step_losses = torch.stack(step_losses).cpu()
    print(f"  {N_STEPS} steps: K1 launches forward {train_fwd}, backward "
          f"{train_bwd} ({LAUNCHES_PER_STEP} each per step expected); pool "
          f"{state.pool.count} of {cfg.max_size}")
    print(f"  gen_loss {[round(v, 4) for v in step_losses[:, 0].tolist()]}")
    print(f"  disc_loss {[round(v, 4) for v in step_losses[:, 1].tolist()]}")
    if train_fwd != LAUNCHES_PER_STEP * N_STEPS \
            or train_bwd != LAUNCHES_PER_STEP * N_STEPS:
        raise AssertionError("the step did not run 37 forward and 37 "
                             "backward kernel launches per step")
    if not torch.isfinite(step_losses).all() or state.step != N_STEPS:
        raise AssertionError("train step losses not finite")

    phase("10 train step timings")
    step_ms = {}
    for b in (B_TRAIN, 24):
        if b != B_TRAIN:
            del state, batch
            torch.cuda.empty_cache()
            state = tstep.init_state(cfg.replace(batch_size=b),
                                     torch.Generator().manual_seed(0),
                                     "cuda")
            batch = train_batch(cfg, b, dev, seed=5)
        holder = [state]

        def one_step():
            holder[0] = step_fn(holder[0], batch, 1e-3, tpool.pool_draws(
                draw_gen, b, cfg.max_size))[0]
        torch.cuda.reset_peak_memory_stats()
        try:
            step_ms[b] = cuda_ms(one_step, 8, warmup=2)
        except torch.cuda.OutOfMemoryError:
            if b == B_TRAIN:  # the main path's batch must fit
                raise
            print(f"  [{card}] b={b}: out of memory")
            continue
        state = holder[0]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  [{card}] sggan step bf16 256x512 b={b}: "
              f"{step_ms[b]:.2f} ms, {1e3 * b / step_ms[b]:.1f} img/s, "
              f"peak memory {peak:.2f} GiB")
        if b == B_TRAIN:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    one_step()
                torch.cuda.synchronize()
            state = holder[0]
            print_breakdown(prof, 2, step_ms[b], f"[{card}] profiler, b={b} "
                            "bf16 train step", STEP_CATEGORIES)
    del state, batch, holder
    torch.cuda.empty_cache()
    k1 = time_sites(card, dev)

    def entry(name, d, replaces, launches, errs_d):
        return {"name": name, "route": "cuda",
                "source": "sggan_tpu_torch/csrc/instance_norm.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs_d.values()),
                "max_abs_err_f32": errs_d[torch.float32],
                "ms": k1[d, "ms"], "plain_ms": k1[d, "plain_ms"],
                "bound_ms": k1[d, "bound_ms"], "bound_by": "bytes",
                "floor_ms": k1[d, "floor_ms"],
                "library_ms": k1[d, "library_ms"],
                "ms_is": "sum over the 37 instance-norm calls of one b=16 "
                         "bf16 train step, per site with CUDA events"}

    fwd = entry("instance_norm_fwd", "fwd", "sggan_tpu/ops/pallas_in.py:107",
                train_fwd, errs)
    fwd["launches_serving"] = main_launches
    bwd = entry("instance_norm_bwd", "bwd", "sggan_tpu/ops/norm.py:97",
                train_bwd, bwd_errs)
    bwd["replaces_pallas_vjp"] = "sggan_tpu/ops/pallas_in.py:141"
    print(json.dumps({"kernels": [fwd, bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
