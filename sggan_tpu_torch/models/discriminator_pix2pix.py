"""The pix2pix PatchGAN discriminator, port of
``sggan_tpu/models/discriminator_pix2pix.py`` (reference module.py:97-123).

concat(input, target) -> 3 downsample blocks (conv4 s2 SAME without bias,
batch norm but on the first, leaky_relu) -> zero-pad 1 -> conv4 s1 VALID
8ndf without bias -> batch norm -> leaky_relu -> zero-pad 1 -> conv4 s1
VALID -> one-channel patch logits (14x14 at 128x128).  Kernels are
RandomNormal(0, 0.02).  The batch norms' moving stats are explicit state,
as in ``generator_pix2pix``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import batch_norm, conv2d, conv2d_init, leaky_relu, normal_init
from .base import BNState, Net, _params

_INIT = normal_init(0.02)


def _zero_pad(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 1, 1, 1))  # H and W of NHWC


class DiscriminatorPix2pix(Net):
    def __init__(self, ndf: int = 64, input_nc: int = 3,
                 generator: Optional[torch.Generator] = None):
        """RandomNormal(0, 0.02) kernels drawn on the CPU from
        ``generator`` in the JAX package's order; move the module with
        ``.to(device)``."""
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        cin = input_nc * 2
        for i, c in enumerate([ndf, ndf * 2, ndf * 4]):
            setattr(self, f"down{i}", _params(conv2d_init(
                4, 4, cin, c, g, use_bias=False, kernel_init=_INIT)))
            if i > 0:
                self._add_bn(f"down{i}_bn", c)
            cin = c
        self.conv = _params(conv2d_init(4, 4, cin, ndf * 8, g,
                                        use_bias=False, kernel_init=_INIT))
        self._add_bn("conv_bn", ndf * 8)
        self.last = _params(conv2d_init(4, 4, ndf * 8, 1, g,
                                        kernel_init=_INIT))

    def forward(self, inp: torch.Tensor, tar: torch.Tensor, state: BNState,
                compute_dtype: Optional[torch.dtype] = None,
                train: bool = False) -> Tuple[torch.Tensor, BNState]:
        """inp, tar: (N, H, W, C).  Returns the f32 patch logits (N, h, w,
        1) and the new state."""
        cd = compute_dtype or inp.dtype
        self._check_state(state)
        y = torch.cat([inp.to(cd), tar.to(cd)], dim=-1)
        new = {}
        for i in range(3):
            y = conv2d(getattr(self, f"down{i}"), y, 2, "SAME", cd)
            if i > 0:
                k = f"down{i}_bn"
                y, new[k] = batch_norm(getattr(self, k), state[k], y, train)
            y = leaky_relu(y)
        y = conv2d(self.conv, _zero_pad(y), 1, "VALID", cd)
        y, new["conv_bn"] = batch_norm(self.conv_bn, state["conv_bn"], y,
                                       train)
        y = leaky_relu(y)
        y = conv2d(self.last, _zero_pad(y), 1, "VALID", cd)
        return y.float(), new
