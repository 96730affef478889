"""AOT export of the generator for serving, port of
``sggan_tpu/utils/export.py``.

``torch.export`` turns the generator's forward, closed over its weights,
into a program for one fixed input shape, saved as one file that reloads
and runs without the model's Python: the deployment path of the
translation service (``serve.py``).  As ``jax.export``'s, the shapes are
fixed; there is no dynamic batch.

The forward is traced under ``torch.no_grad()`` with the parameters
frozen, so every instance norm is the registered op
``torch.ops.sggan_tpu_torch.instance_norm`` (``ops/norm.py``): one graph
node per call, which runs K1 on a CUDA tensor and the plain version on a
CPU one.  ``load`` imports that module before it reads a program.

A program holds the device it was exported on, and runs there only: an
input on another device is an error, not a move.  On the card an
``Artifact`` runs its program as one CUDA graph of its input shape,
captured at its first call (``utils.cuda_graph``): the GraphModule's
Python dispatches each of its nodes once, at the capture, and a call is
one replay, as a ``jax.export`` program is one dispatch.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import norm  # noqa: F401  registers the op a program calls
from .cuda_graph import ForwardGraphs

_META = "sggan_meta.json"


def export_fn(module: torch.nn.Module, *example_inputs: torch.Tensor
              ) -> torch.export.ExportedProgram:
    """``torch.export`` of ``module(*example_inputs)`` at those inputs'
    shapes, dtypes and device, in eval mode with the parameters frozen,
    under ``torch.no_grad()``.  The module runs once eagerly first: that
    checks it and fills the reflect pads' index cache, whose tensors the
    program then holds as constants."""
    module = module.eval().requires_grad_(False)
    with torch.no_grad():
        module(*example_inputs)
        return torch.export.export(module, tuple(example_inputs))


class _Generator(torch.nn.Module):
    def __init__(self, gen, gen_bn, compute_dtype):
        super().__init__()
        self.gen, self.gen_bn, self.compute_dtype = gen, gen_bn, compute_dtype

    def forward(self, x):
        return self.gen(x, self.gen_bn, self.compute_dtype)[0]


def export_generator(gen: torch.nn.Module, image_hw, batch_size: int = 1,
                     compute_dtype=torch.bfloat16,
                     gen_bn: Optional[dict] = None
                     ) -> torch.export.ExportedProgram:
    """The inference forward of ``gen`` (no dropout; batch norms on
    ``gen_bn``'s moving stats, None for a net without them) on a
    (batch_size, H, W, 3) f32 input on the parameters' device, in
    ``compute_dtype``."""
    dev = next(gen.parameters()).device
    x = torch.zeros((batch_size, *image_hw, 3), dtype=torch.float32,
                    device=dev)
    return export_fn(_Generator(gen, gen_bn or {}, compute_dtype), x)


def graph_ops(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """How many nodes of each op the program's graph calls, by name
    (``sggan_tpu_torch.instance_norm.default``, ``aten.conv2d.default``)."""
    return dict(Counter(str(n.target) for n in program.graph.nodes
                        if n.op == "call_function"))


def save(path: str, program: torch.export.ExportedProgram,
         meta: Optional[dict] = None) -> None:
    """Write ``program`` to ``path``, with ``meta`` (JSON) beside it."""
    torch.export.save(program, path,
                      extra_files={_META: json.dumps(meta or {})})


class Artifact:
    """A loaded program: ``artifact(x)`` runs it on ``x`` (a tensor on the
    program's device, or a numpy array, copied there) under inference
    mode, through its CUDA graph on the card, and returns its output on
    that device, a tensor of its own.  ``meta`` is what ``save`` stored;
    ``input_shapes`` the shapes the program takes.  Calls are not
    thread-safe on the card: they share the graph's buffers."""

    def __init__(self, program: torch.export.ExportedProgram, meta: dict):
        self.program, self.meta = program, meta
        names = set(program.graph_signature.user_inputs)
        inputs = [n.meta["val"] for n in program.graph.nodes
                  if n.op == "placeholder" and n.name in names]
        devices = {x.device for x in inputs}
        if len(devices) != 1:
            raise ValueError(f"a program's inputs lie on one device, got "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()
        self.input_shapes = [tuple(x.shape) for x in inputs]
        self._module = program.module()
        self._graphs = ForwardGraphs()

    def __call__(self, *args):
        xs = []
        for x in args:
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x).to(self.device)
            elif not _same_device(x.device, self.device):
                raise ValueError(f"this program runs on {self.device}; "
                                 f"got an input on {x.device}")
            xs.append(x)
        with torch.inference_mode():
            if self.device.type != "cuda":
                return self._module(*xs)
            weights = [*self._module.parameters(), *self._module.buffers()]
            return self._graphs(self._module, tuple(xs), "program",
                                weights).clone()


def _same_device(a: torch.device, b: torch.device) -> bool:
    # "cuda" names the current card, which a program's "cuda:0" may be
    return a.type == b.type and None in (a.index, b.index) or a == b


def load(path: str, device=None) -> Artifact:
    """The program at ``path``.  ``device``, when given, must be the one
    it was exported on."""
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    art = Artifact(program, json.loads(extra[_META] or "{}"))
    if device is not None and not _same_device(torch.device(device),
                                               art.device):
        raise ValueError(f"{path} was exported on {art.device} and runs "
                         f"there only; asked for {torch.device(device)}")
    return art
