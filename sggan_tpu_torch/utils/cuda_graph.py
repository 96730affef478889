"""CUDA graphs of the port's fixed-shape work: the analog of the JAX
package's one compiled program per dispatch.

A CUDA graph replays the kernels that one capture recorded, on the same
addresses, from one host call, where eager PyTorch dispatches every op
from Python.  A function that is captured keeps these rules: it reads
and writes only tensors that outlive the graph (its static inputs, a
state updated in place); it makes no host sync and copies no new host
tensor to the device; the caches it reads (the reflect pads' index, the
resize weights) are filled by a run before the capture; its random draws
come from generators registered with the graph, which then advance at
each replay as an eager call would advance them.

``capture`` warms a function up on a side stream and captures it there,
after ``cuda_in.prepare_capture``; ``ForwardGraphs`` keeps one captured
forward per input shape and captures again when a weight it reads has
changed its storage.  Graphs exist on CUDA only; their callers run the
same function eagerly on the CPU.  A function with NCCL collectives is
captured too (``train/fused.py``): its warm-up makes the communicators
its collectives need, and the capture records their kernels.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, NamedTuple, Optional, Sequence

import torch

from ..ops import cuda_in


def storage_key(tensors: Iterable[torch.Tensor]) -> tuple:
    """The addresses a graph captured over ``tensors`` reads: equal keys,
    the graph reads these tensors."""
    return tuple(t.data_ptr() for t in tensors)


def capture(fn: Callable[[], object], warmup: int = 1,
            generators: Sequence[torch.Generator] = (),
            after_warmup: Optional[Callable[[], None]] = None):
    """``(graph, fn's output at the capture)``: ``fn()`` run ``warmup``
    times on a side stream (cuDNN's plans, cuBLAS's workspace, the caches
    it fills), then ``after_warmup()``, then ``fn()`` captured on that
    stream with ``generators`` registered, so that each replay draws from
    them what the next eager call would.  The output's tensors are the
    graph's static outputs, overwritten by each replay.  Only this
    thread's CUDA calls are held to the capture's rules: another thread
    (NCCL's watchdog, which queries its collectives' events) may make
    CUDA calls while it runs."""
    stream = torch.cuda.Stream()
    cuda_in.prepare_capture(stream)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    if after_warmup is not None:
        after_warmup()
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        out = fn()
    return graph, out


class _Forward(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple
    output: torch.Tensor
    key: tuple


def _math_mode() -> tuple:
    # what picks the kernels a capture records: cuDNN's and cuBLAS's TF32,
    # and cuDNN's algorithm choice
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


class ForwardGraphs:
    """One captured forward per (name, input shapes and dtypes, TF32 and
    cuDNN settings), for a function of its inputs and of ``weights`` that
    changes nothing: the inference forward of the eval, the service and
    the artifact.  A graph is captured at its first call, and again when
    one of ``weights`` lies at another address than at its capture, as
    after a load that replaces a parameter or a batch norm's stats: a
    graph never reads stale weights.  Not thread-safe; its callers
    serialise their calls."""

    def __init__(self):
        self._graphs: Dict[tuple, _Forward] = {}

    def __call__(self, fn: Callable[..., torch.Tensor], inputs: tuple,
                 name, weights: Iterable[torch.Tensor]) -> torch.Tensor:
        """``fn(*inputs)`` through its graph (CUDA inputs).  Returns the
        graph's output tensor, which the next call of the same graph
        overwrites."""
        slot = (name, _math_mode(),
                *((tuple(x.shape), x.dtype) for x in inputs))
        key = storage_key(weights)
        fwd = self._graphs.get(slot)
        if fwd is None or fwd.key != key:
            self._graphs.pop(slot, None)  # its memory goes first
            static = tuple(x.clone() for x in inputs)
            graph, out = capture(lambda: fn(*static))
            fwd = self._graphs[slot] = _Forward(graph, static, out, key)
        for s, x in zip(fwd.inputs, inputs):
            s.copy_(x)
        fwd.graph.replay()
        return fwd.output

    def __len__(self) -> int:
        return len(self._graphs)
