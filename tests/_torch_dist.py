"""Helpers of the port's data-parallel tests (not collected): a job of
ranks in subprocesses over gloo on the CPU, a process group of one rank
in the test's own process, and a dataset of small PNGs for the trainer.

``run_ranks`` starts ``tests/_torch_dp_worker.py`` once per rank with the
environment ``torchrun`` would give it (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and one torch thread,
and returns each rank's exit code and output.  The workers import torch
and the port only, never JAX."""

import contextlib
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(job: str, args, world: int = 2, timeout: float = 600,
              env_extra=None, worker: str = "_torch_dp_worker.py"):
    """Run ``worker job *args`` (``tests/_torch_dp_worker.py`` by default)
    as ``world`` ranks of one gloo job; returns [(returncode, output)] in
    rank order."""
    return wait_ranks(start_ranks(job, args, world, env_extra, worker),
                      timeout)


def start_ranks(job: str, args, world: int = 2, env_extra=None,
                worker: str = "_torch_dp_worker.py") -> list:
    """``run_ranks``'s processes, started and not waited for."""
    port = str(free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=port, OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT, **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, worker), job,
             *map(str, args)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT))
    return procs


def wait_ranks(procs: list, timeout: float = 600) -> list:
    """[(returncode, output)] of ``start_ranks``'s processes, in rank
    order, within one deadline ``timeout`` seconds from now for the whole
    job; kills what is left when it passes."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def write_dataset(root, n_train: int, n_test: int, seed: int = 4) -> None:
    """``n_train`` train and ``n_test`` test triplets of 64x64 PNGs under
    ``root`` (the datasets-contract layout, 8 classes)."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    for split, n in (("trainA", n_train), ("testA", n_test)):
        for sub in ("", "_seg", "_seg_class"):
            os.makedirs(os.path.join(root, f"{split}{sub}"))
        for i in range(n):
            for sub, shape, hi in (("", (64, 64, 3), 256),
                                   ("_seg", (64, 64, 3), 256),
                                   ("_seg_class", (64, 64), 8)):
                Image.fromarray(rng.integers(0, hi, shape, np.uint8)).save(
                    os.path.join(root, f"{split}{sub}", f"v{i}.png"))


@contextlib.contextmanager
def one_rank_group():
    """The default process group of this process alone (gloo on an
    in-memory store), left again at the end."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
