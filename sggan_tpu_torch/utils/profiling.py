"""Step timing and a bounded profiler window, port of
``sggan_tpu/utils/profiling.py``.

* ``StepTimer`` — amortized throughput meter; ``read(sync_value)`` waits
  for the device by reading a value of a device tensor on the host (the
  last loss), so the interval covers the work that was enqueued, not only
  its enqueue.
* ``TraceWindow`` — ``torch.profiler`` over a bounded window of train
  steps (``--profile_dir``), exported as a Chrome trace.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


class StepTimer:
    """Accumulates (images, seconds) across steps; call mark() after each
    step and read(sync_value) at sync points (e.g. epoch end)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._images = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def mark(self, n_images: int):
        if self._t0 is None:
            self.start()
        self._images += n_images

    def read(self, sync_value: Optional[torch.Tensor] = None) -> dict:
        """sync_value: a device tensor (e.g. a loss) to read on the host
        first, so the measured interval covers its computation."""
        if sync_value is not None:
            float(sync_value.reshape(-1)[0])
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        ips = self._images / dt if dt > 0 else 0.0
        return {"images": self._images, "seconds": dt, "images_per_sec": ips}


class TraceWindow:
    """Profiles a bounded window of train steps (CLI --profile_dir).

    Call ``tick()`` after every step: the trace starts after
    `start_after` steps (so first-call costs such as the kernel build and
    cuDNN's algorithm search stay out) and covers the next `n`;
    ``close()`` stops an open trace at shutdown.  The trace is written to
    ``logdir/trace.json`` (Chrome / Perfetto format); ``prof`` keeps the
    profiler for ``key_averages()``, ``steps`` the steps it covered and
    ``seconds`` their wall time, from a device synchronisation at each
    end."""

    def __init__(self, logdir: str, start_after: int = 1, n: int = 2):
        self.logdir = logdir
        self.start_after = start_after
        self.n = n
        self.prof: Optional[torch.profiler.profile] = None
        self.seconds = 0.0
        self.steps = 0
        self._count = 0
        self._state = 0  # 0 pending, 1 tracing, 2 done
        self._t0 = 0.0

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def tick(self):
        self._count += 1
        if self._state == 0 and self._count >= self.start_after:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self._sync()
            self.prof.__enter__()
            self._t0 = time.perf_counter()
            self._state = 1
        elif self._state == 1 and self._count >= self.start_after + self.n:
            self._stop()

    def _stop(self):
        self._sync()
        self.seconds = time.perf_counter() - self._t0
        self.steps = self._count - self.start_after
        self.prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.logdir,
                                                   "trace.json"))
        self._state = 2

    def close(self):
        if self._state == 1:
            self._stop()
