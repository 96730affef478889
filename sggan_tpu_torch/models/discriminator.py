"""Semantic-aware, mask-gated PatchGAN discriminator, port of
``sggan_tpu/models/discriminator.py`` (reference module.py:272-318).

conv3 s2 SAME ndf (leaky_relu, no IN) -> conv3 s2 SAME 2ndf (IN+L) ->
conv3 s2 SAME 4ndf (IN+L) -> conv3 s1 SAME 8ndf (IN+L) -> ["global" head:
a chain of conv3 s2 VALID 8ndf (IN+L) while the plane is > 3, then one
conv3 s1 VALID 8ndf (IN+L)] -> conv3 SAME n_class -> times the one-hot
class mask -> sum over the class axis.  Every IN goes through
``ops.norm.instance_norm`` with leaky_relu (alpha 0.3), so on a CUDA device
the hand-written kernel runs it, forward and backward.

Parameters are ``nn.ParameterDict``s named as the JAX tree (``h0.w``,
``h1_in.gamma``, ``v0.w``, ``h4.b``, ...), so ``utils.bridge`` output
loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..ops import (conv2d, conv2d_init, instance_norm, instance_norm_init,
                   leaky_relu)
from .base import Net, _params


def _valid_chain(h: int, w: int) -> List[int]:
    """Strides of the VALID tail for a post-h3 grid, e.g. [2, 2, 1] for
    16x16 (the reference's h31/h32/h33)."""
    chain = []
    while min(h, w) > 3:
        chain.append(2)
        h = (h - 3) // 2 + 1
        w = (w - 3) // 2 + 1
    if min(h, w) >= 3:
        chain.append(1)
    return chain


class Discriminator(Net):
    def __init__(self, ndf: int = 64, input_nc: int = 3, n_class: int = 34,
                 image_size: Tuple[int, int] = (128, 128),
                 head: str = "global",
                 generator: Optional[torch.Generator] = None):
        """Keras-default init drawn on the CPU from ``generator``; move the
        module with ``.to(device)``.  ``head``: "global" (the train step's,
        reference semantics) or "patch" (no VALID chain: the class map
        stays on the H/8 x W/8 grid)."""
        super().__init__()
        if head not in ("global", "patch"):
            raise ValueError(f"head={head!r} — must be 'global' or 'patch'")
        g = generator if generator is not None else torch.Generator()
        self.head = head
        self.h0 = _params(conv2d_init(3, 3, input_nc, ndf, g))
        self.h1 = _params(conv2d_init(3, 3, ndf, ndf * 2, g))
        self.h1_in = _params(instance_norm_init(ndf * 2))
        self.h2 = _params(conv2d_init(3, 3, ndf * 2, ndf * 4, g))
        self.h2_in = _params(instance_norm_init(ndf * 4))
        self.h3 = _params(conv2d_init(3, 3, ndf * 4, ndf * 8, g))
        self.h3_in = _params(instance_norm_init(ndf * 8))
        if head == "global":
            chain = _valid_chain(image_size[0] // 8, image_size[1] // 8)
            for i in range(len(chain)):
                setattr(self, f"v{i}",
                        _params(conv2d_init(3, 3, ndf * 8, ndf * 8, g)))
                setattr(self, f"v{i}_in", _params(instance_norm_init(ndf * 8)))
        self.h4 = _params(conv2d_init(3, 3, ndf * 8, n_class, g))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x: (N, H, W, C) image; mask: (N, hm, wm, n_class) one-hot class
        mask.  Returns the class-gated f32 logits (N, hm, wm, 1)."""
        cd = compute_dtype or x.dtype
        y = leaky_relu(conv2d(self.h0, x.to(cd), 2, "SAME", cd))
        # bias=False where an IN follows: the norm removes it exactly
        y = conv2d(self.h1, y, 2, "SAME", cd, bias=False)
        y = instance_norm(self.h1_in, y, act="leaky_relu")
        y = conv2d(self.h2, y, 2, "SAME", cd, bias=False)
        y = instance_norm(self.h2_in, y, act="leaky_relu")
        y = conv2d(self.h3, y, 1, "SAME", cd, bias=False)
        y = instance_norm(self.h3_in, y, act="leaky_relu")
        if self.head == "global":
            for i, s in enumerate(_valid_chain(y.shape[1], y.shape[2])):
                y = conv2d(getattr(self, f"v{i}"), y, s, "VALID", cd,
                           bias=False)
                y = instance_norm(getattr(self, f"v{i}_in"), y,
                                  act="leaky_relu")
        y = conv2d(self.h4, y, 1, "SAME", cd).float()
        mask = mask.float()
        if y.shape[1:3] != mask.shape[1:3] and y.shape[1:3] != (1, 1):
            # collapse the score map to a global class score before gating
            # (the reference relies on its map being 1x1)
            y = y.mean((1, 2), keepdim=True)
        return (y * mask).sum(-1, keepdim=True)
