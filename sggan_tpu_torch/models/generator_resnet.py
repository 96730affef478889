"""Johnson-style ResNet generator, port of
``sggan_tpu/models/generator_resnet.py``.

reflect-pad 3 -> c7s1-ngf -> d(2ngf) -> d(4ngf) -> 9 residual blocks
(reflect-pad 1 + conv3 VALID + IN + relu, reflect-pad 1 + conv3 VALID +
IN, identity skip) -> u(2ngf) -> u(ngf) -> reflect-pad 3 + c7s1-out ->
tanh.  Every instance norm goes through ``ops.norm.instance_norm``, so on
a CUDA device all 23 run the hand-written kernel.  ``c1`` and the
resblocks' convs are ``ops.conv2d_reflect``; the output conv (the head)
takes the JAX package's branches (``generator_resnet.apply``): with
``pad_free_head`` the space-to-depth strided conv with the pad folded in
(``ops.s2d.conv2d_reflect_s2d``), else a reflect pad and the pre-padded
strided conv (``conv2d_valid_s2d``), at the block ``s2d.head_block``
picks; where that is (1, 1), ``conv2d_reflect``, or the pad and a VALID
conv.  ``remat`` recomputes each resblock in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint``).

Parameters are ``nn.ParameterDict``s named as the JAX tree (``c1.w``,
``r1.in1.gamma``, ...), so ``utils.bridge.params_from_jax`` output loads
with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import (conv2d, conv2d_init, conv2d_reflect, conv2d_transpose,
                   conv2d_transpose_init, instance_norm, instance_norm_init,
                   reflect_pad, s2d, tanh)
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

    def _head(self, y: torch.Tensor, cd, pad_free: bool) -> torch.Tensor:
        w = self.out["w"]
        r = s2d.head_block(w.shape[2], w.shape[0], y.shape[1], y.shape[2])
        blocked = r[0] * r[1] > 1
        if pad_free:
            if blocked and s2d.applicable_reflect(y, w, r):
                return s2d.conv2d_reflect_s2d(self.out, y, r, cd)
            return conv2d_reflect(self.out, y, cd)
        y = reflect_pad(y, 3)
        if blocked and s2d.applicable(y, w, r):
            return s2d.conv2d_valid_s2d(self.out, y, r, cd)
        return conv2d(self.out, y, 1, "VALID", cd)

    def forward(self, x: torch.Tensor, state: BNState,
                compute_dtype: Optional[torch.dtype] = None,
                drop_masks: Optional[Sequence[torch.Tensor]] = None,
                train: bool = False, remat: bool = False,
                pad_free_head: bool = True) -> Tuple[torch.Tensor, BNState]:
        """x: (N, H, W, C) with H, W divisible by 4.  Returns the float32
        tanh image, NHWC, and ``state`` as it came: the net has no batch
        norm and no dropout, so ``state`` is {} and ``drop_masks`` and
        ``train`` change nothing (the generators' common signature).

        ``remat``: where autograd records the forward, each resblock is
        recomputed in the backward instead of keeping its four
        intermediate activations; the same kernels on the same inputs, so
        the same values.  The blocks draw nothing, so no RNG state is kept
        (and none read inside a CUDA graph capture).  ``pad_free_head``:
        the head's form (the module docstring), the same math up to f32
        summation order."""
        cd = compute_dtype or x.dtype
        y = conv2d_reflect(self.c1, x.to(cd), cd, bias=False)
        y = instance_norm(self.c1_in, y, act="relu")
        y = conv2d(self.c2, y, 2, "SAME", cd, bias=False)
        y = instance_norm(self.c2_in, y, act="relu")
        y = conv2d(self.c3, y, 2, "SAME", cd, bias=False)
        y = instance_norm(self.c3_in, y, act="relu")
        remat = remat and torch.is_grad_enabled()
        for i in range(N_BLOCKS):
            b = getattr(self, f"r{i + 1}")
            if remat:
                y = checkpoint(self._res_block, b, y, cd, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                y = self._res_block(b, y, cd)
        y = conv2d_transpose(self.d1, y, 2, "SAME", cd, bias=False)
        y = instance_norm(self.d1_in, y, act="relu")
        y = conv2d_transpose(self.d2, y, 2, "SAME", cd, bias=False)
        y = instance_norm(self.d2_in, y, act="relu")
        return tanh(self._head(y, cd, pad_free_head).float()), state
