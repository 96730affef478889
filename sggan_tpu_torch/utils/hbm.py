"""The memory probe, port of ``sggan_tpu/utils/hbm.py``: will a config's
train or eval program fit on the card?

The TPU's verdict is a compile, since its memory is assigned statically.
The card allocates as it runs, so here **the verdict is a run**: the
exact program the config would run, once, on synthetic inputs of its
shapes, with the train state the trainer builds.
- ``step``: one eager step over a resident split of ``n_items`` uint8
  sources of ``source_hw`` (the fused gather, augmentation, preprocess and
  step of ``train/fused.py::resident_step``; both splits under
  ``--loss_mode cycle``);
- ``scan``: the step's CUDA graph (``fused.StepGraph``: warm-up, capture)
  and one chunk of ``--scan_steps`` replays;
- ``eval``: the eval's generator forward through its graph on
  ``min(8, n_items)`` images;
- ``auto``: ``scan`` when ``--scan_steps`` > 1, else ``step``.

``fits`` is that the run raised no ``torch.cuda.OutOfMemoryError``.  On the
card the result reports the peak memory allocated (``total_bytes``) and
reserved by PyTorch's allocator and the card's total; on an OOM,
``error`` and the bytes of torch's message (``_parse_oom``).  A CPU
probe checks the shapes and the plumbing and gives no verdict (no
``fits``), as the JAX probe on the CPU.

Each probe wants a process of its own (an OOM inside a capture can leave
the allocator or the graph's pool in a bad state), and the CLI is one:

    python -m sggan_tpu_torch.utils.hbm --img_height 1024 \\
        --img_width 2048 --loss_mode sggan --use_resnet --remat \\
        --batch_size 12 --probe_kind step --probe_items 12

prints one JSON line, the last of its standard output (the run's own
prints go to standard error).
"""

from __future__ import annotations

import contextlib
import json
import re
import sys
from typing import Optional, Tuple

import numpy as np
import torch

KINDS = ("auto", "scan", "step", "eval")
_UNITS = {"bytes": 1, "KiB": 2 ** 10, "MiB": 2 ** 20, "GiB": 2 ** 30,
          "TiB": 2 ** 40}
_OOM_FIELDS = (("oom_tried_bytes", r"Tried to allocate {}"),
               ("oom_limit_bytes", r"total capacity of {}"),
               ("oom_free_bytes", r"of which {} is free"),
               ("oom_used_bytes",
                r"(?:this process|Process \d+) has {} memory in use"),
               ("oom_allocated_bytes", r"{} is allocated by PyTorch"))


def _parse_oom(msg: str) -> dict:
    """The bytes of torch's CUDA OOM message ("Tried to allocate 2.00 GiB.
    GPU 0 has a total capacity of 79.19 GiB of which 1.23 GiB is free.
    Including non-PyTorch memory, this process has 77.95 GiB memory in
    use. Of the allocated memory 76.50 GiB is allocated by PyTorch,
    ..."; where the process is not its own, "Process 1 has 77.30 GiB
    memory in use"): ``oom_used_bytes`` (the process's) and
    ``oom_limit_bytes``
    (the card's capacity), as the JAX probe names them, and the tried,
    free and allocated bytes; each where the message has it."""
    out = {}
    for key, pat in _OOM_FIELDS:
        m = re.search(pat.format(r"([\d.]+) (bytes|[KMGT]iB)"), msg)
        if m:
            out[key] = int(float(m.group(1)) * _UNITS[m.group(2)])
    return out


def _oom_of(e: Optional[BaseException]) -> Optional[BaseException]:
    """The OOM in ``e``'s chain (a capture that ran out of memory may end
    in another error, raised while it unwinds), or None."""
    while e is not None:
        if isinstance(e, torch.cuda.OutOfMemoryError) \
                or "out of memory" in str(e).lower():
            return e
        e = e.__cause__ or e.__context__
    return None


class SyntheticSplit:
    """A resident split made on ``device`` from a seed, as
    ``loader.DeviceDataset`` holds one: ``n`` uint8 photos, seg maps and
    class maps of ``src_hw``."""

    def __init__(self, n: int, src_hw, n_class: int, device, seed: int):
        g = torch.Generator(device=device).manual_seed(seed)

        def u8(shape, hi):
            return torch.randint(0, hi, shape, generator=g, device=device,
                                 dtype=torch.uint8)
        self.img = u8((n, *src_hw, 3), 256)
        self.seg = u8((n, *src_hw, 3), 256)
        self.cls = u8((n, *src_hw), n_class)

    def __len__(self):
        return self.img.shape[0]


def _run(cfg, kind: str, src_hw, n_items: int, device) -> None:
    """The program of ``kind`` once, on synthetic inputs."""
    from ..train import fused
    from ..train.step import lr_schedule
    from ..train.trainer import Trainer

    tr = Trainer(cfg, device=device)
    tr.lr.fill_(float(np.float32(lr_schedule(cfg, 0))))
    if kind == "eval":
        x = torch.rand(min(8, n_items), *cfg.image_size, 3, device=device)
        tr.generate(x, as_u8=True)
        return
    b = cfg.batch_size
    if n_items < b:
        raise ValueError(f"--probe_items {n_items} is below the batch {b}")
    splits = [SyntheticSplit(n_items, src_hw, cfg.segment_class, device, i)
              for i in range(2 if tr.cycle else 1)]
    make_batch = fused.make_batch_fn(cfg)
    if kind == "step":
        rows = torch.arange(b, device=device)
        fused.resident_step(tr, splits, make_batch, [rows] * len(splits))
    else:
        graph = fused.StepGraph(tr, tuple(splits) if tr.cycle else splits[0],
                                make_batch)
        rows = np.zeros((cfg.scan_steps, b), np.int64)
        fused.run_chunk(tr, graph, [rows] * len(splits))


def probe_memory(cfg, source_hw: Optional[Tuple[int, int]] = None,
                 n_items: int = 100, kind: str = "auto",
                 device="cuda") -> dict:
    """Run the configured program once on ``device`` (see the module
    docstring) and return the verdict and its bytes.

    ``source_hw``: the decoded source (H, W) as the loader would feed it
    (after ``--host_downscale``), by default the training resolution;
    ``n_items``: the resident split's length."""
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r}: one of {'/'.join(KINDS)}")
    if kind == "auto":
        kind = "scan" if cfg.scan_steps > 1 else "step"
    device = torch.device(device)
    sh, sw = source_hw or cfg.image_size
    out = {"kind": kind, "backend": device.type, "source_hw": [sh, sw],
           "n_items": n_items}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        _run(cfg, kind, (sh, sw), n_items, device)
        if cuda:
            torch.cuda.synchronize(device)
            out["fits"] = True
    except Exception as e:  # noqa: BLE001 - re-raised unless an OOM
        oom = _oom_of(e)
        if oom is None:
            raise
        msg = str(oom)
        out["fits"] = False
        out.update(_parse_oom(msg))
        out["error"] = msg[:400]
    if cuda:
        out["total_bytes"] = torch.cuda.max_memory_allocated(device)
        out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(device)
        out["device_total_bytes"] = torch.cuda.get_device_properties(
            device).total_memory
    return out


def main(argv=None, device="cuda") -> dict:
    from ..config import build_parser, config_from_namespace

    p = build_parser()
    p.add_argument("--probe_kind", default="auto", choices=KINDS)
    p.add_argument("--probe_items", type=int, default=100,
                   help="device-resident split length")
    p.add_argument("--probe_src", default=None,
                   help="decoded source HxW, e.g. 1024x2048 "
                        "(default: the training resolution)")
    ns = p.parse_args(argv)
    cfg = config_from_namespace(ns).validate()
    src = None
    if ns.probe_src:
        h, w = ns.probe_src.lower().split("x")
        src = (int(h), int(w))
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sggan_tpu_torch.utils.hbm: no CUDA device is "
                         "visible; the probe's verdict is a run on the card")
    with contextlib.redirect_stdout(sys.stderr):
        out = probe_memory(cfg, source_hw=src, n_items=ns.probe_items,
                           kind=ns.probe_kind, device=device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
