"""The epoch over the card-resident split, port of
``sggan_tpu/train/fused.py``: batch assembly on the device (a gather from
the resident split, the augmentation doubling, the preprocess) and the
epoch loop with its per-epoch shuffle, prints and ``--save_freq`` saves.

``--scan_steps K`` (K > 1, the default 8) is the analog of the JAX
package's ``make_fused_scan``, K whole steps per dispatch.  ``StepGraph``
captures one step, from its static inputs to the state it updates in
place, as one CUDA graph: the batch assembly, the device draws with the
dropout masks, and the step with Adam, the batch norms' stats, the pool
and the EMA (``train/step.py``).  Its static inputs are the trainer's
``lr`` tensor and one int64 row a step, copied into place before each
replay: each split's batch indices in the epoch's order, then the pool's
output and buffer rows, which ``pool.plan_steps`` plans on the host for
the chunk's K steps from K steps of the pool's host draws (under
``--compat_fake_history`` the fake history's valid entries and rows,
which ``pool.plan_hist_steps`` plans from the count).  The trainer's
device generator is registered with the graph, so replay k draws what
the k-th eager step would.  Before the capture two steps warm the step up
on the capture's stream, from a snapshot of every tensor they write and
of the generator, restored after them: the capture trains nothing.

The epoch goes in chunks of ``kc = min(K, nb - done)`` steps, the tail
too, through the one graph replayed ``kc`` times.  Per chunk, as the JAX
chunk loop (fused.py:262-281): the chunk's losses kept on the device, one
``StepTimer`` mark and one profiler tick, a print when ``done == 0`` or
the chunk crosses a multiple of ``--print_freq`` (its last step's index
and losses), a save when it crosses a multiple of ``--save_freq``.  On the
CPU, which has no graphs, a chunk calls the same step function once a
step: the tests hold the chunk loop there.  ``--scan_steps 1`` and the
host iterator run the eager step, one dispatch per op, step by step.  Not
ported: the JAX fallback to the per-step path when the scan program runs
out of memory (``is_hbm_failure``); a capture that fails raises.

Each step uploads nothing: the epoch's order goes to the device once (a
chunk's rows, once a chunk, under ``--scan_steps`` K), the data draws and
the generator's dropout masks come from the trainer's device generator,
and the pool's draws from its host generator, since the pool plans on the
host (``train/pool.py``).

Under ``--loss_mode cycle`` the epoch runs over two resident splits,
trainA and trainB (fused.py:90-104, :197-212): B's order is the shuffle
of ``data_seed + 7919``, as the host iterator of trainB draws it; the
epoch has ``min(len_a, len_b) // batch_size`` steps; each step assembles
an A batch and a B batch and joins them (``two_domain``).  The draws keep
one order in the resident and the host path: A's preprocess, B's, then
the four mask sets from the device generator, the pool's from the host
one.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..data.loader import epoch_order
from ..data.preprocess import (PreprocessDraws, draw_preprocess,
                               preprocess_train)
from ..ops import cuda_in
from ..utils import cuda_graph
from .pool import (HistPlan, PoolPlan, plan_hist_steps, plan_steps,
                   pool_draws)
from .step import compat_hist, dropout_masks, pools, state_tensors

B_SEED_OFFSET = 7919  # trainB's shuffle seed is data_seed + 7919


def make_batch_fn(cfg):
    """Batch assembly on the device (fused.py:26-50): gather from the
    resident split, augmentation doubling, preprocess, with the host
    iterator's flag layout.  ``make_batch(img_all, seg_all, cls_all, idxs,
    draws)``: ``idxs`` an int64 tensor of ``batch_size`` rows on the
    split's device, ``draws`` from ``draw_preprocess`` for the doubled
    batch."""
    b = cfg.batch_size

    def make_batch(img_all, seg_all, cls_all, idxs,
                   draws: PreprocessDraws) -> dict:
        take = lambda a: a.index_select(0, idxs)  # noqa: E731
        img, seg, cls = take(img_all), take(seg_all), take(cls_all)
        if cfg.use_augmentation:
            img, seg, cls = (torch.cat([a, a]) for a in (img, seg, cls))
            flags = torch.arange(2 * b, device=img.device) >= b
        else:
            flags = torch.zeros(b, dtype=torch.bool, device=img.device)
        return preprocess_train(
            img, seg, cls, draws, flags, out_hw=cfg.image_size,
            mask_hw=cfg.mask_hw, n_class=cfg.segment_class,
            photometric=cfg.use_photometric,
            aug_layout="half" if cfg.use_augmentation else "none")

    return make_batch


def effective_batch(cfg) -> int:
    return cfg.batch_size * (2 if cfg.use_augmentation else 1)


def device_draws(tr, src_h: int, src_h_b: Optional[int] = None):
    """One step's draws from the trainer's device generator: the
    preprocess's, then the dropout masks (None for a net without
    dropout).  Under ``--loss_mode cycle`` the preprocess's are a pair,
    A's (sources ``src_h`` rows high) then B's (``src_h_b``), and the
    masks the cycle step's four sets."""
    cfg = tr.cfg
    b_eff = effective_batch(cfg)

    def pre(h):
        return draw_preprocess(tr.data_gen, b_eff, h, cfg.image_size,
                               cfg.use_photometric)
    draws = (pre(src_h), pre(src_h_b)) if tr.cycle else pre(src_h)
    return draws, dropout_masks(cfg, tr.state.gen_params, tr.data_gen,
                                b_eff)


def step_draws(tr, src_h: int, src_h_b: Optional[int] = None):
    """One step's draws: the device ones (``device_draws``) and the
    pool's from the trainer's host generator, as (preprocess, pool,
    masks)."""
    draws, masks = device_draws(tr, src_h, src_h_b)
    return (draws, pool_draws(tr.pool_gen, effective_batch(tr.cfg),
                              tr.cfg.max_size), masks)


def two_domain(batch_a: dict, batch_b: dict) -> dict:
    """The cycle step's batch: A's, with B's image, seg and mask as
    ``real_b``, ``seg_b`` and ``mask_b``."""
    return dict(batch_a, real_b=batch_b["real_a"], seg_b=batch_b["seg_a"],
                mask_b=batch_b["mask_a"])


def end_step(tr, epoch: int, idx: int, m: dict, n_images: int,
             g_losses: list, d_losses: list, global_step: int,
             start_time: float) -> int:
    """The bookkeeping after step ``idx`` of an epoch, as the JAX trainer
    does it (trainer.py:373-386): keep the losses on the device, count the
    images, tick the profiler window, print at the first step and every
    ``--print_freq`` steps (the reference's line, model.py:260-261), save
    when the step count reaches a multiple of ``--save_freq``.  Returns
    the new global step."""
    cfg = tr.cfg
    g_losses.append(m["gen_loss"])
    d_losses.append(m["disc_loss"])
    tr._timer.mark(n_images)
    if tr._prof is not None:
        tr._prof.tick()
    if idx % cfg.print_freq == 0:
        print("Epoch: [%2d] [%4d] time: %4.4f "
              "Gen_Loss: %f Disc_Loss: %f" % (
                  epoch, idx, time.time() - start_time,
                  float(m["gen_loss"]), float(m["disc_loss"])))
    global_step += 1
    if cfg.save_freq and global_step % cfg.save_freq == 0:
        tr._save(epoch)
    return global_step


def run_epoch_fused(tr, epoch: int, dev_ds, make_batch, g_losses: list,
                    d_losses: list, global_step: int,
                    start_time: float) -> int:
    """One epoch over the resident split (a (trainA, trainB) pair under
    ``--loss_mode cycle``), one eager step per dispatch, in the order of
    ``np.random.default_rng(data_seed + epoch)``'s shuffle (trainB's of
    ``data_seed + 7919 + epoch``), at the trainer's ``lr``.  Returns the
    new global step."""
    cfg = tr.cfg
    b = cfg.batch_size
    splits = dev_ds if tr.cycle else (dev_ds,)
    orders = [torch.from_numpy(order).to(ds.img.device)
              for ds, order in zip(splits, epoch_orders(cfg, splits, epoch))]
    for done in range(min(len(ds) for ds in splits) // b):
        m = resident_step(tr, splits, make_batch,
                          [o[done * b:(done + 1) * b] for o in orders])
        global_step = end_step(tr, epoch, done, m, effective_batch(cfg),
                               g_losses, d_losses, global_step, start_time)
    return global_step


def resident_step(tr, splits, make_batch, idxs) -> dict:
    """One eager step over the resident ``splits`` (one, or trainA and
    trainB), the batch rows ``idxs`` (an int64 tensor of ``batch_size``
    rows a split, on the device): draws, batch assembly, the step.
    Updates ``tr.state``; returns the step's metrics."""
    draws, pdraws, masks = step_draws(tr, *(ds.img.shape[1] for ds in splits))
    batches = [make_batch(ds.img, ds.seg, ds.cls, ix, d)
               for ds, ix, d in zip(splits, idxs,
                                    draws if tr.cycle else (draws,))]
    batch = two_domain(*batches) if tr.cycle else batches[0]
    tr.state, m = tr.step_fn(tr.state, batch, tr.lr, pdraws, masks)
    return m


def epoch_orders(cfg, splits, epoch: int) -> list:
    """Each split's shuffle of the epoch: trainA's from ``data_seed``,
    trainB's from ``data_seed + 7919``."""
    return [epoch_order(len(ds), cfg.data_seed + seed, epoch)
            for ds, seed in zip(splits, (0, B_SEED_OFFSET))]


WARMUP_STEPS = 2  # eager steps on the capture's stream before a capture


class StepGraph:
    """One train step over the resident split (a (trainA, trainB) pair
    under ``--loss_mode cycle``) from static inputs, captured as a CUDA
    graph on the card at the first chunk and replayed once a step; on the
    CPU the same function runs eagerly once a step.  ``k1_calls``: K1's
    wrapper calls recorded at the capture, a step's worth ((forward,
    backward) totals and calls by (direction, route)), since the replays
    do not pass through the wrapper."""

    def __init__(self, tr, dev_ds, make_batch):
        cfg = tr.cfg
        self.tr, self.make_batch = tr, make_batch
        self.splits = dev_ds if tr.cycle else (dev_ds,)
        slots = next(iter(tr.state.pool.buffer.values())).shape[0]
        b = cfg.batch_size
        # a step's row: each split's batch indices, the pool's output
        # rows, then its buffer rows (the history's valid entries, then
        # its rows)
        self.hist = compat_hist(cfg)
        out_w = slots if self.hist else effective_batch(cfg)
        self.cuts = [i * b for i in range(len(self.splits) + 1)]
        self.cuts += [self.cuts[-1] + out_w, self.cuts[-1] + out_w + slots]
        self.rows = torch.zeros(self.cuts[-1], dtype=torch.int64,
                                device=self.splits[0].img.device)
        self.graph = self.losses = self.k1_calls = None
        self._key = None

    def _step(self) -> torch.Tensor:
        """One step from ``rows``: the state updated in place, the
        (gen, disc) losses as a (2,) tensor."""
        tr, c = self.tr, self.cuts
        draws, masks = device_draws(
            tr, *(ds.img.shape[1] for ds in self.splits))
        batches = [self.make_batch(ds.img, ds.seg, ds.cls,
                                   self.rows[c[i]:c[i + 1]], d)
                   for i, (ds, d) in enumerate(zip(
                       self.splits, draws if tr.cycle else (draws,)))]
        batch = two_domain(*batches) if tr.cycle else batches[0]
        out, buf, count = (self.rows[c[-3]:c[-2]], self.rows[c[-2]:],
                           tr.state.pool.count)
        plan = (HistPlan(buf, out, count) if self.hist
                else PoolPlan(out, buf, count))
        _, m = tr.step_fn(tr.state, batch, tr.lr, plan, masks)
        return torch.stack([m["gen_loss"], m["disc_loss"]])

    def _capture(self) -> None:
        self.graph = None  # its memory pool goes before the new one's
        tr = self.tr
        tensors = list(state_tensors(tr.state).values())
        with torch.no_grad():
            saved = [t.clone() for t in tensors]
        gen_state = tr.data_gen.get_state()
        counts = []  # K1's counters before and after the capture

        def restore():
            with torch.no_grad():
                for t, v in zip(tensors, saved):
                    t.copy_(v)
            tr.data_gen.set_state(gen_state)
            counts.append(_k1_counts())

        t0 = time.perf_counter()
        self.graph, self.losses = cuda_graph.capture(
            self._step, WARMUP_STEPS, (tr.data_gen,), restore)
        tr.data_gen.set_state(gen_state)  # where the first replay draws
        counts.append(_k1_counts())
        (f0, b0, r0), (f1, b1, r1) = counts
        self.k1_calls = ((f1 - f0, b1 - b0),
                         {k: v - r0[k] for k, v in r1.items() if v != r0[k]})
        self._key = cuda_graph.storage_key(tensors)
        print(f" [*] train step captured as a CUDA graph in "
              f"{time.perf_counter() - t0:.2f} s (K1 calls a step: "
              f"{self.k1_calls[0][0]} forward, {self.k1_calls[0][1]} "
              f"backward); {tr.cfg.scan_steps} steps a chunk")

    def run(self, rows: np.ndarray) -> torch.Tensor:
        """The steps of one chunk, one per row of ``rows`` (kc, width)
        int64; returns their losses, (kc, 2) on the device.  On the card
        the graph is captured first when it has none, or when a tensor of
        the state has moved since its capture."""
        dev = self.rows.device
        table = torch.from_numpy(rows)
        if dev.type == "cuda":  # pinned, so the copy does not sync the host
            table = table.pin_memory().to(dev, non_blocking=True)
            key = cuda_graph.storage_key(state_tensors(self.tr.state)
                                         .values())
            if self.graph is None or key != self._key:
                self.rows.copy_(table[0])
                self._capture()
        out = torch.empty((len(rows), 2), device=dev)
        for r in range(len(rows)):
            self.rows.copy_(table[r])
            if self.graph is not None:
                self.graph.replay()
                out[r].copy_(self.losses)
            else:
                out[r].copy_(self._step())
        return out


def _k1_counts() -> tuple:
    return (cuda_in.launches, cuda_in.bwd_launches,
            dict(cuda_in.route_launches))


def run_chunk(tr, graph: StepGraph, ix) -> torch.Tensor:
    """The ``kc`` steps of one chunk through ``graph``, each split's batch
    rows ``ix`` (kc, batch_size) int64 on the host: the pool's host draws
    (drawn as an eager step draws them, whether the step pools or not) and
    its rows or the history's, planned for the chunk.  Advances
    ``tr.state``'s step and pool count; returns the losses (kc, 2) on the
    device."""
    cfg = tr.cfg
    kc, b_eff = len(ix[0]), effective_batch(cfg)
    slots = next(iter(tr.state.pool.buffer.values())).shape[0]
    draws = [pool_draws(tr.pool_gen, b_eff, cfg.max_size) for _ in range(kc)]
    count = tr.state.pool.count
    if pools(cfg):
        out_rows, buf_rows, count = plan_steps(slots, count, draws)
    elif graph.hist:
        out_rows, buf_rows, count = plan_hist_steps(slots, count, b_eff, kc)
    else:  # rows the step does not read
        out_rows = np.zeros((kc, b_eff), np.int64)
        buf_rows = np.zeros((kc, slots), np.int64)
    m = graph.run(np.concatenate([*ix, out_rows, buf_rows], axis=1))
    tr.state = tr.state._replace(step=tr.state.step + kc,
                                 pool=tr.state.pool._replace(count=count))
    return m


def run_epoch_chunked(tr, epoch: int, graph: StepGraph, g_losses: list,
                      d_losses: list, global_step: int,
                      start_time: float) -> int:
    """One epoch over the resident split in chunks of ``--scan_steps``
    steps through ``graph`` (the module docstring), in the order of
    ``run_epoch_fused``.  Returns the new global step."""
    cfg = tr.cfg
    b, b_eff, pf = cfg.batch_size, effective_batch(cfg), cfg.print_freq
    orders = epoch_orders(cfg, graph.splits, epoch)
    nb = min(len(ds) for ds in graph.splits) // b
    done = 0
    while done < nb:
        kc = min(cfg.scan_steps, nb - done)
        m = run_chunk(tr, graph, [o[done * b:(done + kc) * b].reshape(kc, b)
                                  for o in orders])
        g_losses.extend(m[:, 0].unbind())
        d_losses.extend(m[:, 1].unbind())
        tr._timer.mark(kc * b_eff)
        if tr._prof is not None:
            tr._prof.tick()
        if done == 0 or (done - 1) // pf != (done + kc - 1) // pf:
            print("Epoch: [%2d] [%4d] time: %4.4f "
                  "Gen_Loss: %f Disc_Loss: %f" % (
                      epoch, done + kc - 1, time.time() - start_time,
                      float(m[-1, 0]), float(m[-1, 1])))
        prev = global_step
        done += kc
        global_step += kc
        if cfg.save_freq and \
                prev // cfg.save_freq != global_step // cfg.save_freq:
            tr._save(epoch)
    return global_step
