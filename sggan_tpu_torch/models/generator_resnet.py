"""Johnson-style ResNet generator, port of
``sggan_tpu/models/generator_resnet.py``.

reflect-pad 3 -> c7s1-ngf -> d(2ngf) -> d(4ngf) -> 9 residual blocks
(reflect-pad 1 + conv3 VALID + IN + relu, reflect-pad 1 + conv3 VALID +
IN, identity skip) -> u(2ngf) -> u(ngf) -> reflect-pad 3 + c7s1-out ->
tanh.  Every instance norm goes through ``ops.norm.instance_norm``, so on
a CUDA device all 23 run the hand-written kernel.

Parameters are ``nn.ParameterDict``s named as the JAX tree (``c1.w``,
``r1.in1.gamma``, ...), so ``utils.bridge.params_from_jax`` output loads
with ``load_state_dict``.  The head is a plain reflect pad and a VALID
7x7 conv: the JAX package's space-to-depth head (``ops/s2d.py``) is the
same math in another summation order, shaped for the TPU's matrix unit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import (conv2d, conv2d_init, conv2d_reflect, conv2d_transpose,
                   conv2d_transpose_init, instance_norm, instance_norm_init,
                   reflect_pad, tanh)
from .base import BNState, Net, _params

N_BLOCKS = 9


class GeneratorResnet(Net):
    def __init__(self, ngf: int = 64, input_nc: int = 3, output_nc: int = 3,
                 generator: Optional[torch.Generator] = None):
        """Keras-default init (glorot kernels, zero biases, IN gamma 1 /
        beta 0) drawn on the CPU from ``generator``, in the JAX package's
        draw order; move the module with ``.to(device)``."""
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.c1 = _params(conv2d_init(7, 7, input_nc, ngf, g))
        self.c1_in = _params(instance_norm_init(ngf))
        self.c2 = _params(conv2d_init(3, 3, ngf, ngf * 2, g))
        self.c2_in = _params(instance_norm_init(ngf * 2))
        self.c3 = _params(conv2d_init(3, 3, ngf * 2, ngf * 4, g))
        self.c3_in = _params(instance_norm_init(ngf * 4))
        for i in range(N_BLOCKS):
            self.add_module(f"r{i + 1}", nn.ModuleDict({
                "conv1": _params(conv2d_init(3, 3, ngf * 4, ngf * 4, g)),
                "in1": _params(instance_norm_init(ngf * 4)),
                "conv2": _params(conv2d_init(3, 3, ngf * 4, ngf * 4, g)),
                "in2": _params(instance_norm_init(ngf * 4)),
            }))
        self.d1 = _params(conv2d_transpose_init(3, 3, ngf * 4, ngf * 2, g))
        self.d1_in = _params(instance_norm_init(ngf * 2))
        self.d2 = _params(conv2d_transpose_init(3, 3, ngf * 2, ngf, g))
        self.d2_in = _params(instance_norm_init(ngf))
        self.out = _params(conv2d_init(7, 7, ngf, output_nc, g))

    @staticmethod
    def _res_block(b: nn.ModuleDict, x: torch.Tensor, cd) -> torch.Tensor:
        # bias=False where an IN follows: the norm removes it exactly
        y = conv2d_reflect(b["conv1"], x, cd, bias=False)
        y = instance_norm(b["in1"], y, act="relu")
        y = conv2d_reflect(b["conv2"], y, cd, bias=False)
        y = instance_norm(b["in2"], y)
        return y + x

    def forward(self, x: torch.Tensor, state: BNState,
                compute_dtype: Optional[torch.dtype] = None,
                drop_masks: Optional[Sequence[torch.Tensor]] = None,
                train: bool = False) -> Tuple[torch.Tensor, BNState]:
        """x: (N, H, W, C) with H, W divisible by 4.  Returns the float32
        tanh image, NHWC, and ``state`` as it came: the net has no batch
        norm and no dropout, so ``state`` is {} and ``drop_masks`` and
        ``train`` change nothing (the generators' common signature)."""
        cd = compute_dtype or x.dtype
        y = conv2d_reflect(self.c1, x.to(cd), cd, bias=False)
        y = instance_norm(self.c1_in, y, act="relu")
        y = conv2d(self.c2, y, 2, "SAME", cd, bias=False)
        y = instance_norm(self.c2_in, y, act="relu")
        y = conv2d(self.c3, y, 2, "SAME", cd, bias=False)
        y = instance_norm(self.c3_in, y, act="relu")
        for i in range(N_BLOCKS):
            y = self._res_block(getattr(self, f"r{i + 1}"), y, cd)
        y = conv2d_transpose(self.d1, y, 2, "SAME", cd, bias=False)
        y = instance_norm(self.d1_in, y, act="relu")
        y = conv2d_transpose(self.d2, y, 2, "SAME", cd, bias=False)
        y = instance_norm(self.d2_in, y, act="relu")
        y = conv2d(self.out, reflect_pad(y, 3), 1, "VALID", cd)
        return tanh(y.float()), state
