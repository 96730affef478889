"""CLI entry point of the port, parity with the root ``main.py``: the same
flags (the port's ``config.parse_args``), the same dispatch (``--phase
train`` -> ``Trainer.train()``, else ``Trainer.test()``) and the same
directory bootstrapping (reference main.py:47-60).

    python -m sggan_tpu_torch.main --phase train --dataset_dir city \\
        --use_resnet --loss_mode sggan --img_height 256 --img_width 512

Data parallelism runs one process per card, as ``torchrun`` starts them:

    torchrun --nproc_per_node 4 -m sggan_tpu_torch.main --phase train \\
        --mesh_data 4 --dataset_dir city --use_resnet --loss_mode sggan

Spatial sharding runs ``--mesh_data x --mesh_space x --mesh_space_w``
processes the same way:

    torchrun --nproc_per_node 2 -m sggan_tpu_torch.main --phase train \\
        --mesh_space 2 --dataset_dir city --use_resnet --loss_mode sggan

Under ``torchrun`` (``WORLD_SIZE`` set), ``--mesh_data`` > 1 or a spatial
train run, ``main``
joins the process group (``parallel.distributed.initialize``: NCCL on
the cards, gloo on the CPU, a no-op where the caller joined one already)
before it builds the trainer, and leaves the group it joined at the
end.  Each rank runs
on ``cuda:LOCAL_RANK``.

It runs on the CUDA device; without one it stops with an error and never
carries on on the CPU.  ``main(argv, device="cpu")`` is for tests.
"""

from __future__ import annotations

import os
import sys

import torch

from .config import parse_args
from .parallel import distributed
from .parallel.mesh import is_spatial
from .train.trainer import Trainer


def main(argv=None, device="cuda"):
    cfg = parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sggan_tpu_torch.main: no CUDA device is visible; "
                         "the port trains and tests on an NVIDIA GPU")
    joined = False  # whether main joined the group, and so leaves it
    if "WORLD_SIZE" in os.environ or cfg.mesh_data > 1 or (
            is_spatial(cfg) and cfg.phase == "train"):
        joined = not torch.distributed.is_initialized()
        distributed.initialize(device_kind=device)
        device = distributed.device(device)
    try:
        if distributed.is_coordinator():
            for d in (cfg.checkpoint_dir, cfg.sample_dir, cfg.test_dir):
                os.makedirs(d, exist_ok=True)
        trainer = Trainer(cfg, device=device)
        if cfg.phase == "train":
            trainer.train()
        else:
            trainer.test()
    finally:
        if joined:
            distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
