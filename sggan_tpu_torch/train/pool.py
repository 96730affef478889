"""Image pool of (fake, mask) entries, port of ``sggan_tpu/train/pool.py``.

Per item, in batch order: while the pool fills, store the item and pass it
through; once full, with p = 0.5 return a uniformly random stored entry
and put the item in its slot, else pass the item through (CycleGAN's rule,
reference utils.py:36-53).  An entry is a dict of arrays (here fake and
mask) stored and swapped together, so a historical fake is judged against
the mask it was generated under.

The random draws are explicit (``pool_draws``): jax.random streams cannot
be reproduced in torch, so a test feeds both packages the same draws.
Every decision depends only on the draws and the running count, so it is
made on the host, item by item in the JAX order (``filling``,
``write_idx``, ``use_hist``, ``do_write``), and the device does one gather
per leaf for the output and one for the new buffer: no host sync.  A
CUDA graph of the step cannot copy a new index to the device at each
replay, so ``plan_steps`` plans K updates at once from K steps' draws
(the count follows from them) and the step reads each update's rows from
a buffer on the device (``PoolPlan``).

The fake history of ``--compat_fake_history`` (the reference's
concat-to-10-then-reset, model.py:175-179; ``sggan_tpu/train/step.py``'s
``compat_hist`` branch) is planned the same way: its offset, valid
prefix and count follow from the count alone, so ``hist_plan`` and
``plan_hist_steps`` give the rows of [history; fakes] that form the new
history and its valid entries (``HistPlan``), and the step gathers them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch


class PoolState(NamedTuple):
    buffer: Dict[str, torch.Tensor]  # each (slots, *item_shape)
    count: int                       # entries stored, at most slots


class PoolDraws(NamedTuple):
    u: torch.Tensor    # (B,) uniforms in [0, 1): history if u > 0.5
    idx: torch.Tensor  # (B,) int64 slots in [0, slots)


class PoolPlan(NamedTuple):
    """One update planned ahead (``plan_steps``): its rows of the table
    [buffer; items] as int64 tensors on the buffer's device, and the
    count after it."""
    out: torch.Tensor  # (B,) the output's rows
    buf: torch.Tensor  # (slots,) the new buffer's rows
    count: int


class HistPlan(NamedTuple):
    """One update of the fake history planned ahead: the rows of the
    table [history; fakes] that form the new history and 1 where its
    entry is valid, int64 tensors of one row a slot on the buffer's
    device, and the count after it."""
    rows: torch.Tensor   # (slots,)
    valid: torch.Tensor  # (slots,)
    count: int


HIST_RESET = 10  # the history starts again once it holds this many


def _hist(slots: int, count: int, b: int
          ) -> Tuple[List[int], List[int], int]:
    """The JAX step's history update as rows: the ``b`` fakes written at
    ``offset`` (0 once ``count`` reached ``HIST_RESET``, else ``count``),
    the entries below ``offset + b`` valid, ``offset + b`` the new
    count."""
    offset = 0 if count >= HIST_RESET else count
    if offset + b > slots:
        raise ValueError(f"a history of {slots} slots at count {count} "
                         f"cannot take {b} more fakes")
    rows = [slots + j - offset if offset <= j < offset + b else j
            for j in range(slots)]
    return rows, [int(j < offset + b) for j in range(slots)], offset + b


def hist_plan(slots: int, count: int, b: int, device) -> HistPlan:
    """The next history update of ``b`` fakes at ``count``, on
    ``device``."""
    rows, valid, count = _hist(slots, count, b)
    device = torch.device(device)
    return HistPlan(_index(rows, device), _index(valid, device), count)


def plan_hist_steps(slots: int, count: int, b: int, k: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """``k`` history updates of ``b`` fakes in order from ``count``: the
    valid entries (k, slots), the rows (k, slots) and the count after the
    last."""
    rows, valid = [], []
    for _ in range(k):
        r, v, count = _hist(slots, count, b)
        rows.append(r)
        valid.append(v)
    return (np.array(valid, np.int64).reshape(k, slots),
            np.array(rows, np.int64).reshape(k, slots), count)


def pool_init(max_size: int, item_shapes: Mapping[str, Tuple[int, ...]],
              dtype=torch.float32, device="cuda") -> PoolState:
    """Zeroed buffers of max(max_size, 1) slots per leaf."""
    n = max(max_size, 1)
    buf = {k: torch.zeros((n, *s), dtype=dtype, device=device)
           for k, s in item_shapes.items()}
    return PoolState(buf, 0)


def pool_draws(generator: torch.Generator, b: int,
               max_size: int) -> PoolDraws:
    """The draws of one update of ``b`` items, on the CPU."""
    u = torch.rand(b, generator=generator)
    idx = torch.randint(0, max(max_size, 1), (b,), generator=generator)
    return PoolDraws(u, idx)


def _plan(slots: int, count: int, draws: PoolDraws,
          b: int) -> Tuple[List[int], List[int], int]:
    """Rows of the table [buffer; items] that form the output and the new
    buffer, and the new count."""
    src = list(range(slots))  # row of the table that each slot now holds
    out = []
    u, idx = draws.u.tolist(), draws.idx.tolist()
    for i in range(b):
        filling = count < slots
        write_idx = count if filling else int(idx[i])
        use_hist = not filling and u[i] > 0.5
        out.append(src[write_idx] if use_hist else slots + i)
        if filling or use_hist:  # do_write
            src[write_idx] = slots + i
        count = min(count + int(filling), slots)
    return out, src, count


def plan_steps(slots: int, count: int, draws: Sequence[PoolDraws]
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """K updates planned in order from their draws: the output's rows (K,
    B), the new buffer's rows (K, slots), each update's rows of its own
    table, and the count after the last."""
    outs, bufs = [], []
    for d in draws:
        out, buf, count = _plan(slots, count, d, len(d.u))
        outs.append(out)
        bufs.append(buf)
    return (np.array(outs, np.int64).reshape(len(draws), -1),
            np.array(bufs, np.int64).reshape(len(draws), slots), count)


def _index(rows: List[int], device: torch.device) -> torch.Tensor:
    t = torch.tensor(rows, dtype=torch.int64)
    if device.type == "cuda":  # pinned, so the copy does not sync the host
        return t.pin_memory().to(device, non_blocking=True)
    return t


def pool_update(state: PoolState, items: Mapping[str, torch.Tensor],
                draws: Union[PoolDraws, PoolPlan]
                ) -> Tuple[PoolState, Dict[str, torch.Tensor]]:
    """items: dict of (B, *item_shape) with the buffer's keys; ``draws``
    this update's draws, or its ``PoolPlan``.  Returns (new state, output
    items), both new tensors in the buffer's dtype (items are cast on
    entry); ``state`` is not changed."""
    if isinstance(draws, PoolPlan):
        out_i, buf_i, count = draws
    else:
        first = next(iter(state.buffer.values()))
        b = next(iter(items.values())).shape[0]
        out_rows, buf_rows, count = _plan(first.shape[0], state.count, draws,
                                          b)
        out_i = _index(out_rows, first.device)
        buf_i = _index(buf_rows, first.device)
    new_buf, out = {}, {}
    for k, buf in state.buffer.items():
        table = torch.cat([buf, items[k].to(buf.dtype)])
        out[k] = table.index_select(0, out_i)
        new_buf[k] = table.index_select(0, buf_i)
    return PoolState(new_buf, count), out
