"""The reference's default generator, port of
``sggan_tpu/models/generator_unet.py`` (reference module.py:125-206).

Every conv and conv-transpose is 3x3 stride 1 SAME: there is no down- or
upsampling, and "U-Net" names only the additive skips.  Encoder e1-e8
(conv, instance norm with leaky_relu, relu after e8), decoder d1-d7
(conv-transpose, dropout 0.5 on d1-d3, instance norm without activation,
plus the skip from e(8-i), relu after d3 and d7), then d8 and tanh.  All
15 instance norms go through ``ops.norm.instance_norm``, so on a CUDA
device each runs K1 forward and backward.

Parameters are ``nn.ParameterDict``s named as the JAX tree (``e1.w``,
``e1_in.gamma``, ... ``d8.b``), so ``utils.bridge.params_from_jax``
output loads with ``load_state_dict``.  Dropout's randomness is explicit:
``forward`` takes the d1-d3 keep masks (``drop_shapes`` gives their
shapes, ``ops.dropout_masks`` draws them at ``drop_rate``); without masks
it is deterministic.  ``remat`` recomputes each encoder and decoder
stage in the backward (``torch.utils.checkpoint``, as the JAX package's
``jax.checkpoint`` of ``enc_stage`` and ``dec_stage``): the masks are
inputs, so the recompute draws nothing, and the additive skips stay
live.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import (conv2d, conv2d_init, conv2d_transpose,
                   conv2d_transpose_init, dropout, instance_norm,
                   instance_norm_init, relu, tanh)
from .base import BNState, Net, _params

N_DROP = 3  # d1-d3


def _enc_channels(ngf: int):
    return [ngf, ngf * 2, ngf * 4, ngf * 8, ngf * 8, ngf * 8, ngf * 8, ngf * 8]


def _dec_channels(ngf: int):
    return [ngf * 8, ngf * 8, ngf * 8, ngf * 8, ngf * 4, ngf * 2, ngf]


class GeneratorUnet(Net):
    drop_rate = 0.5

    def __init__(self, ngf: int = 64, input_nc: int = 3, output_nc: int = 3,
                 generator: Optional[torch.Generator] = None):
        """Keras-default init (glorot kernels, zero biases, IN gamma 1 /
        beta 0) drawn on the CPU from ``generator``, in the JAX package's
        draw order; move the module with ``.to(device)``."""
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        cin = input_nc
        for i, c in enumerate(_enc_channels(ngf), 1):
            setattr(self, f"e{i}", _params(conv2d_init(3, 3, cin, c, g)))
            setattr(self, f"e{i}_in", _params(instance_norm_init(c)))
            cin = c
        for i, c in enumerate(_dec_channels(ngf), 1):
            setattr(self, f"d{i}",
                    _params(conv2d_transpose_init(3, 3, cin, c, g)))
            setattr(self, f"d{i}_in", _params(instance_norm_init(c)))
            cin = c
        self.d8 = _params(conv2d_transpose_init(3, 3, cin, output_nc, g))

    def drop_shapes(self, n: int, h: int, w: int):
        """Shapes of the d1-d3 dropout masks for an (n, h, w, C) input."""
        return [(n, h, w, self.d1["w"].shape[1])] * N_DROP

    def _enc_stage(self, i: int, y: torch.Tensor, cd) -> torch.Tensor:
        # bias=False: IN follows directly, and removes it exactly
        y = conv2d(getattr(self, f"e{i}"), y, 1, "SAME", cd, bias=False)
        return instance_norm(getattr(self, f"e{i}_in"), y,
                             act="relu" if i == 8 else "leaky_relu")

    def _dec_stage(self, i: int, y: torch.Tensor, skip: torch.Tensor,
                   mask: Optional[torch.Tensor], cd) -> torch.Tensor:
        # d1-d3 keep the bias: dropout sits between the conv-transpose and
        # IN, and a masked shift is not removed by the norm
        y = conv2d_transpose(getattr(self, f"d{i}"), y, 1, "SAME", cd,
                             bias=i <= N_DROP)
        if mask is not None:
            y = dropout(y, self.drop_rate, mask)
        y = instance_norm(getattr(self, f"d{i}_in"), y)
        y = y + skip
        return relu(y) if i in (3, 7) else y

    def forward(self, x: torch.Tensor, state: BNState,
                compute_dtype: Optional[torch.dtype] = None,
                drop_masks: Optional[Sequence[torch.Tensor]] = None,
                train: bool = False, remat: bool = False,
                pad_free_head: bool = True) -> Tuple[torch.Tensor, BNState]:
        """x: (N, H, W, C).  ``drop_masks``: the three keep masks of
        d1-d3, or None (no dropout).  ``remat``: each stage recomputed in
        the backward where autograd records the forward.  Returns the
        float32 tanh image, NHWC, and ``state`` as it came: the net has no
        batch norm, so ``state`` is {} and ``train`` changes nothing;
        ``pad_free_head`` is the ResNet's (the generators' common
        signature)."""
        cd = compute_dtype or x.dtype
        if remat and torch.is_grad_enabled():
            def run(f, *a):
                return checkpoint(f, *a, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            def run(f, *a):
                return f(*a)
        y = x.to(cd)
        enc = []
        for i in range(1, 9):
            y = run(self._enc_stage, i, y, cd)
            enc.append(y)
        for i in range(1, 8):
            mask = drop_masks[i - 1] if i <= N_DROP and drop_masks is not None \
                else None
            y = run(self._dec_stage, i, y, enc[7 - i], mask, cd)
        y = conv2d_transpose(self.d8, y, 1, "SAME", cd)
        return tanh(y.float()), state
