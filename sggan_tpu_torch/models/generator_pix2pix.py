"""The pix2pix (TF tutorial) U-Net generator, port of
``sggan_tpu/models/generator_pix2pix.py`` (reference module.py:48-95).

log2(H) downsample blocks (conv4 s2 SAME without bias, batch norm but on
the first, leaky_relu) take H to 1; because the reference zips its up
stack against one skip fewer, one block fewer goes up (conv-transpose4 s2
SAME without bias, batch norm, dropout 0.5 on the first three, relu,
concat skip); then a conv-transpose4 s2 to ``output_nc`` and tanh.
Kernels are RandomNormal(0, 0.02).  The depth follows H alone, as in the
JAX package: at 256x512 the bottom is 1x2.

The batch norms' moving stats are explicit state: ``init_bn_state`` makes
them, ``forward`` takes them and returns the new ones.  Parameters are
named as the JAX tree (``down1.w``, ``down1_bn.gamma``, ``up0.w``,
``last.b``), the state as its state tree (``down1_bn.moving_mean``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..ops import (batch_norm, conv2d, conv2d_init, conv2d_transpose,
                   conv2d_transpose_init, dropout, leaky_relu, normal_init,
                   relu, tanh)
from .base import BNState, Net, _params

_INIT = normal_init(0.02)


def _plan(image_size: int, ngf: int) -> Tuple[list, list]:
    """Channel plans of the down and up blocks (generator_pix2pix._plan):
    at 128 the reference's module.py:51-69."""
    n_down = int(math.log2(image_size))
    down = [min(ngf * 2 ** i, ngf * 8) for i in range(n_down)]
    return down, list(reversed(down))[:n_down - 1]


class GeneratorPix2pix(Net):
    drop_rate = 0.5

    def __init__(self, ngf: int = 64, input_nc: int = 3, output_nc: int = 3,
                 image_size: int = 128,
                 generator: Optional[torch.Generator] = None):
        """RandomNormal(0, 0.02) kernels drawn on the CPU from
        ``generator`` in the JAX package's order, for inputs of height
        ``image_size``; move the module with ``.to(device)``."""
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.down_ch, self.up_ch = _plan(image_size, ngf)
        cin = input_nc
        for i, c in enumerate(self.down_ch):
            setattr(self, f"down{i}", _params(conv2d_init(
                4, 4, cin, c, g, use_bias=False, kernel_init=_INIT)))
            if i > 0:
                self._add_bn(f"down{i}_bn", c)
            cin = c
        skip_chs = list(reversed(self.down_ch[:-1]))
        for i, c in enumerate(self.up_ch):
            setattr(self, f"up{i}", _params(conv2d_transpose_init(
                4, 4, cin, c, g, use_bias=False, kernel_init=_INIT)))
            self._add_bn(f"up{i}_bn", c)
            cin = c + skip_chs[i]
        self.last = _params(conv2d_transpose_init(4, 4, cin, output_nc, g,
                                                  kernel_init=_INIT))

    def drop_shapes(self, n: int, h: int, w: int):
        """Shapes of the dropout masks of the first three up blocks for an
        (n, h, w, C) input: each block's output, before the concat."""
        sizes = [(h, w)]
        for _ in self.down_ch:
            sizes.append((-(-sizes[-1][0] // 2), -(-sizes[-1][1] // 2)))
        # up block i doubles the output of the one below it
        return [(n, 2 * sizes[-1 - i][0], 2 * sizes[-1 - i][1], c)
                for i, c in enumerate(self.up_ch[:3])]

    def forward(self, x: torch.Tensor, state: BNState,
                compute_dtype: Optional[torch.dtype] = None,
                drop_masks: Optional[Sequence[torch.Tensor]] = None,
                train: bool = False, remat: bool = False,
                pad_free_head: bool = True) -> Tuple[torch.Tensor, BNState]:
        """x: (N, H, W, C) with log2(H) down blocks' worth of height;
        ``train``: batch norm on the batch's statistics (moving the state)
        else on the moving stats; ``drop_masks``: keep masks of the first
        three up blocks, or None.  Returns the float32 tanh image and the
        new state.  ``remat`` and ``pad_free_head`` change nothing, as the
        JAX step's ``_gen_fwd`` passes neither to this net."""
        cd = compute_dtype or x.dtype
        self._check_state(state)
        if int(math.log2(x.shape[1])) != len(self.down_ch):
            raise ValueError(f"input height {x.shape[1]} needs another "
                             "depth than this net was built for")
        new = {}
        y = x.to(cd)
        skips = []
        for i in range(len(self.down_ch)):
            y = conv2d(getattr(self, f"down{i}"), y, 2, "SAME", cd)
            if i > 0:
                k = f"down{i}_bn"
                y, new[k] = batch_norm(getattr(self, k), state[k], y, train)
            y = leaky_relu(y)
            skips.append(y)
        skips = list(reversed(skips[:-1]))
        for i in range(len(self.up_ch)):
            y = conv2d_transpose(getattr(self, f"up{i}"), y, 2, "SAME", cd)
            k = f"up{i}_bn"
            y, new[k] = batch_norm(getattr(self, k), state[k], y, train)
            if i < 3 and drop_masks is not None:
                y = dropout(y, self.drop_rate, drop_masks[i])
            y = relu(y)
            y = torch.cat([y, skips[i]], dim=-1)
        y = conv2d_transpose(self.last, y, 2, "SAME", cd)
        return tanh(y.float()), new
