"""What every net of the port shares.

Parameters are ``nn.ParameterDict``s named as the JAX tree, so
``utils.bridge.params_from_jax`` output loads with ``load_state_dict``.
The moving stats of a net's batch norms live outside the module, as
explicit state that the caller threads: ``init_bn_state`` makes them
({} for the instance-norm nets).  A generator's dropout takes keep masks
that the caller draws: ``drop_shapes`` gives their shapes ([] for the
ResNet), ``drop_rate`` their rate.  Every generator has one signature,
``forward(x, state, compute_dtype=None, drop_masks=None, train=False,
remat=False, pad_free_head=True) -> (y, new state)``: ``remat`` recomputes
the ResNet's resblocks or the U-Net's stages in the backward,
``pad_free_head`` picks the ResNet's head form; a net ignores what it
does not have.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..ops import batch_norm_init

BNState = Dict[str, Dict[str, torch.Tensor]]


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in d.items()})


class Net(nn.Module):
    drop_rate = 0.0

    def __init__(self):
        super().__init__()
        self._bn_ch: Dict[str, int] = {}

    def _add_bn(self, name: str, c: int) -> None:
        """A batch norm's gamma and beta as parameters ``name``; its moving
        stats go in the state under the same name."""
        setattr(self, name, _params(batch_norm_init(c)[0]))
        self._bn_ch[name] = c

    def init_bn_state(self, device=None) -> BNState:
        """Fresh moving stats (mean 0, var 1) of every batch norm."""
        return {k: {n: t.to(device) for n, t in batch_norm_init(c)[1]
                    .items()} for k, c in self._bn_ch.items()}

    def _check_state(self, state: BNState) -> None:
        missing = sorted(set(self._bn_ch) - set(state))
        if missing:
            raise ValueError(f"{type(self).__name__} needs its BN state "
                             f"(init_bn_state or the train state's); "
                             f"missing {missing}")

    def drop_shapes(self, n: int, h: int, w: int) -> List[Tuple[int, ...]]:
        """Shapes of the dropout keep masks for an (n, h, w, C) input."""
        return []
