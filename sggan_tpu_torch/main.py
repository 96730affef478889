"""CLI entry point of the port, parity with the root ``main.py``: the same
flags (the port's ``config.parse_args``), the same dispatch (``--phase
train`` -> ``Trainer.train()``, else ``Trainer.test()``) and the same
directory bootstrapping (reference main.py:47-60).

    python -m sggan_tpu_torch.main --phase train --dataset_dir city \\
        --use_resnet --loss_mode sggan --img_height 256 --img_width 512

It runs on the CUDA device; without one it stops with an error and never
carries on on the CPU.  ``main(argv, device="cpu")`` is for tests.
"""

from __future__ import annotations

import os
import sys

import torch

from .config import parse_args
from .train.trainer import Trainer


def main(argv=None, device="cuda"):
    cfg = parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sggan_tpu_torch.main: no CUDA device is visible; "
                         "the port trains and tests on an NVIDIA GPU")
    for d in (cfg.checkpoint_dir, cfg.sample_dir, cfg.test_dir):
        os.makedirs(d, exist_ok=True)
    trainer = Trainer(cfg, device=device)
    if cfg.phase == "train":
        trainer.train()
    else:
        trainer.test()


if __name__ == "__main__":
    main(sys.argv[1:])
