"""Inference half of ``sggan_tpu/train/evaluate.py``: output sharpening,
the generator forward under the config's compute dtype, and the
test-time input convention.  The eval loop, scores and image dumps are
not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import Config
from ..models.generator_resnet import GeneratorResnet


def sharpen(y: torch.Tensor, t: float) -> torch.Tensor:
    """Eval-time sharpening (--eval_sharpen): tanh(t * atanh(y)) in f32;
    t=inf is the sign limit (exact zeros stay 0, as in the JAX package)."""
    y = y.float()
    if math.isinf(t):
        return torch.sign(y)
    safe = torch.clamp(y, -1.0 + 1e-6, 1.0 - 1e-6)
    return torch.tanh(t * torch.atanh(safe))


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _require_ported(cfg: Config) -> None:
    if cfg.use_pix2pix or not cfg.use_resnet:
        net = "pix2pix" if cfg.use_pix2pix else "U-Net"
        raise NotImplementedError(
            f"the {net} generator is not ported yet (ROADMAP Queue 1: "
            "U-Net generator and p2p serving); pass --use_resnet")


def build_generator(cfg: Config) -> GeneratorResnet:
    """The generator ``cfg`` selects, fresh-initialised from
    ``cfg.data_seed`` on the CPU."""
    _require_ported(cfg)
    g = torch.Generator().manual_seed(cfg.data_seed)
    return GeneratorResnet(ngf=cfg.ngf, input_nc=cfg.input_nc,
                           output_nc=cfg.output_nc, generator=g)


def gen_forward(cfg: Config, gen: GeneratorResnet,
                x: torch.Tensor) -> torch.Tensor:
    _require_ported(cfg)
    return gen(x, compute_dtype=compute_dtype(cfg))


@torch.inference_mode()
def generate(cfg: Config, gen: GeneratorResnet, images01: np.ndarray,
             device: torch.device) -> np.ndarray:
    """Generator forward on [0, 1]-range NHWC images, honouring the
    test-time input-scale flag (``round(x * 255)`` under
    ``--test_uint8_input``, as numpy rounds: half to even) and
    ``--eval_sharpen``.  Returns the f32 [-1, 1] output on the host."""
    x = np.asarray(images01, np.float32)
    if cfg.test_uint8_input:
        x = np.round(x * 255.0)
    y = gen_forward(cfg, gen, torch.from_numpy(x).to(device))
    if cfg.eval_sharpen != 1.0:
        y = sharpen(y, cfg.eval_sharpen)
    return y.cpu().numpy()
