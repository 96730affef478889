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
step: the tests hold the chunk loop there.  The print is the
coordinator's, the save every rank's, as at a step (``end_step``).
``--scan_steps 1`` and the host iterator run the eager step, one
dispatch per op, step by step.  Not
ported: the JAX fallback to the per-step path when the scan program runs
out of memory (``is_hbm_failure``); a capture that fails raises, under
NCCL too: nothing falls back to eager steps.

Each step uploads nothing: the epoch's order goes to the device once (a
chunk's rows, once a chunk, under ``--scan_steps`` K), the data draws and
the generator's dropout masks come from the trainer's device generator,
and the pool's draws from its host generator, since the pool plans on the
host (``train/pool.py``).

Under ``--mesh_data N`` every rank holds the whole split and assembles
its block ``[r B'/N, (r + 1) B'/N)`` of the global batch of B' rows
(``make_batch_fn``'s ``rows``, ``own_rows``): the rows that
``with_sharding_constraint(batch, P(data))`` hands device r of the JAX
mesh in ``make_fused_step`` and ``make_fused_scan`` (fused.py:99-111),
row j the source ``order[done * b + (j mod b)]``, augmented where ``j >=
b``, with row j of the global batch's draws, which every rank draws.
Under ``--mesh_space`` the block is its data row's, then cut to the
rank's block of the plane (``assemble``, ``_batch_spec``'s layout).  The
host iterator lays a global batch out otherwise (a rank's files and their
augmented copies, the JAX multi-process layout, ``trainer.py``).  Under
several ranks the chunk loop runs as on one, its pool draws and plans
each rank's own (``own_pool_draws``).  Over NCCL each rank captures the
step with its collectives (the gradients' buckets, the halos, the
moments' and batch norms' all-reduces, the gathers) in its graph, as the
JAX scan holds its ``psum``s and ``ppermute``s in one program; the warm-up
steps before the capture make every communicator the step's collectives
need.  Whether a state tensor has moved, so that the graph is captured
again, is agreed by every rank (``dp.agree``) before a chunk: a rank that
captured alone would leave the others' collectives unmatched.  Over gloo,
whose collectives run on the host and cannot be captured, each step of a
chunk runs eagerly (``captures``); a profiler window then counts steps,
as the per-step loop's does, where it counts a replayed chunk as one.

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
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.loader import epoch_order
from ..data.preprocess import (PreprocessDraws, draw_preprocess,
                               preprocess_train)
from ..ops import cuda_in, norm
from ..parallel import dp, spatial
from ..parallel.spatial_step import shard_batch
from ..utils import cuda_graph
from .pool import (HistPlan, PoolPlan, plan_hist_steps, plan_steps,
                   pool_draws)
from .step import compat_hist, dropout_masks, pools, state_tensors

B_SEED_OFFSET = 7919  # trainB's shuffle seed is data_seed + 7919


def make_batch_fn(cfg, rows: Optional[Tuple[int, int]] = None):
    """Batch assembly on the device (fused.py:26-50): gather from the
    resident split, augmentation doubling, preprocess, with the host
    iterator's flag layout.  ``make_batch(img_all, seg_all, cls_all, idxs,
    draws)``: ``idxs`` an int64 tensor of ``batch_size`` rows on the
    split's device, ``draws`` from ``draw_preprocess`` for the doubled
    batch.

    ``rows`` (lo, hi): only the rows [lo, hi) of the doubled batch of B'
    rows (every row by default), a rank's block (``dp.own_rows``,
    ``mesh.Grid.own_rows``), as ``with_sharding_constraint(batch,
    P(data))`` hands them to device r of the JAX mesh (fused.py:99-111):
    row j gathers ``idxs[j mod batch_size]``, warps where ``j >=
    batch_size`` and takes row j of the global batch's draws
    (``preprocess_train``'s ``global_b`` and ``sample_rows``), so every
    row is the one-process batch's row."""
    b, aug = cfg.batch_size, cfg.use_augmentation
    lo, hi = (0, effective_batch(cfg)) if rows is None else rows
    # the block's plain rows come first: [lo, min(hi, b)) of [0, b)
    n_plain = min(max(b - lo, 0), hi - lo) if aug else hi - lo

    def make_batch(img_all, seg_all, cls_all, idxs,
                   draws: PreprocessDraws) -> dict:
        pos = torch.arange(lo, hi, device=idxs.device)
        src = idxs.index_select(0, pos % b)
        img, seg, cls = (a.index_select(0, src)
                         for a in (img_all, seg_all, cls_all))
        return preprocess_train(
            img, seg, cls, draws, pos >= b, out_hw=cfg.image_size,
            mask_hw=cfg.mask_hw, n_class=cfg.segment_class,
            photometric=cfg.use_photometric, global_b=effective_batch(cfg),
            sample_rows=pos, aug_layout="half" if aug else "none",
            n_plain=n_plain)

    return make_batch


def effective_batch(cfg) -> int:
    return cfg.batch_size * (2 if cfg.use_augmentation else 1)


def own_rows(tr) -> Optional[Tuple[int, int]]:
    """This rank's block of the doubled batch: its own under
    ``--mesh_data``, its data row's under ``--mesh_space``, None (every
    row) for one process."""
    grid = getattr(tr, "grid", None)
    if grid is not None:
        return grid.own_rows(effective_batch(tr.cfg))
    return dp.own_rows(effective_batch(tr.cfg), tr.group)


def device_draws(tr, src_h: int, src_h_b: Optional[int] = None):
    """One step's draws from the trainer's device generator: the
    preprocess's, then the dropout masks (None for a net without
    dropout).  Under ``--loss_mode cycle`` the preprocess's are a pair,
    A's (sources ``src_h`` rows high) then B's (``src_h_b``), and the
    masks the cycle step's four sets.

    Under ``--mesh_data N`` every rank draws what one process would for
    the global batch: the preprocess's draws for all of its rows (each
    rank's preprocess takes its own, ``preprocess_train``'s
    ``sample_rows``), then the masks of each shard in rank order, of
    which it keeps its own (``parallel.dp.own_shard``); under
    ``--mesh_space`` each shard's masks at its block's shapes
    (``spatial_step.sp_dropout_masks``)."""
    cfg = tr.cfg
    b_eff = effective_batch(cfg)

    def pre(h):
        return draw_preprocess(tr.data_gen, b_eff, h, cfg.image_size,
                               cfg.use_photometric)
    draws = (pre(src_h), pre(src_h_b)) if tr.cycle else pre(src_h)
    grid = getattr(tr, "grid", None)
    if grid is not None:
        from ..parallel.spatial_step import sp_dropout_masks
        return draws, sp_dropout_masks(cfg, grid, tr.state.gen_params,
                                       tr.data_gen, b_eff // grid.data)
    return draws, dp.own_shard(lambda: dropout_masks(
        cfg, tr.state.gen_params, tr.data_gen, b_eff // tr.world), tr.group)


def step_draws(tr, src_h: int, src_h_b: Optional[int] = None):
    """One step's draws: the device ones (``device_draws``) and the
    pool's from the trainer's host generator, as (preprocess, pool,
    masks); under ``--mesh_data N`` this rank's pool draws, drawn after
    those of the ranks before it and before those of the ranks after;
    under ``--mesh_space`` its data row's (``mesh.Grid.own_row``)."""
    draws, masks = device_draws(tr, src_h, src_h_b)
    return draws, own_pool_draws(tr), masks


def own_pool_draws(tr):
    """One step's pool draws from the trainer's host generator: every
    rank's in rank order under ``--mesh_data``, this rank's kept; every
    data row's under ``--mesh_space``, this rank's row's kept."""
    cfg = tr.cfg
    grid = getattr(tr, "grid", None)
    if grid is not None:
        return grid.own_row(lambda: pool_draws(
            tr.pool_gen, effective_batch(cfg) // grid.data, cfg.max_size))
    return dp.own_shard(lambda: pool_draws(
        tr.pool_gen, effective_batch(cfg) // tr.world, cfg.max_size),
        tr.group)


def two_domain(batch_a: dict, batch_b: dict) -> dict:
    """The cycle step's batch: A's, with B's image, seg and mask as
    ``real_b``, ``seg_b`` and ``mask_b``."""
    return dict(batch_a, real_b=batch_b["real_a"], seg_b=batch_b["seg_a"],
                mask_b=batch_b["mask_a"])


def assemble(tr, splits, make_batch, idxs, draws) -> dict:
    """A step's batch from the resident ``splits`` (one, or trainA and
    trainB): each split's rows ``idxs`` through ``make_batch`` with its
    draws (a pair under ``--loss_mode cycle``), the domains joined, and
    under ``--mesh_space`` this rank's block of the plane."""
    batches = [make_batch(ds.img, ds.seg, ds.cls, ix, d)
               for ds, ix, d in zip(splits, idxs,
                                    draws if tr.cycle else (draws,))]
    batch = two_domain(*batches) if tr.cycle else batches[0]
    grid = getattr(tr, "grid", None)
    return batch if grid is None else shard_batch(batch, grid)


def end_step(tr, epoch: int, idx: int, m: dict, n_images: int,
             g_losses: list, d_losses: list, global_step: int,
             start_time: float) -> int:
    """The bookkeeping after step ``idx`` of an epoch, as the JAX trainer
    does it (trainer.py:373-386): keep the losses on the device, count the
    images, tick the profiler window, print at the first step and every
    ``--print_freq`` steps (the reference's line, model.py:260-261; the
    coordinator alone under ``--mesh_data``), save
    when the step count reaches a multiple of ``--save_freq``.  Returns
    the new global step."""
    cfg = tr.cfg
    g_losses.append(m["gen_loss"])
    d_losses.append(m["disc_loss"])
    tr._timer.mark(n_images)
    if tr._prof is not None:
        tr._prof.tick()
    if idx % cfg.print_freq == 0 and tr.is_coord:
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
    batch = assemble(tr, splits, make_batch, idxs, draws)
    tr.state, m = tr.step_fn(tr.state, batch, tr.lr, pdraws, masks)
    return m


def epoch_orders(cfg, splits, epoch: int) -> list:
    """Each split's shuffle of the epoch: trainA's from ``data_seed``,
    trainB's from ``data_seed + 7919``."""
    return [epoch_order(len(ds), cfg.data_seed + seed, epoch)
            for ds, seed in zip(splits, (0, B_SEED_OFFSET))]


WARMUP_STEPS = 2  # eager steps on the capture's stream before a capture


def captures(device, backend: Optional[str]) -> bool:
    """Whether a step on ``device`` whose collectives go over a group of
    ``backend`` (None: one process, no group) is captured as a CUDA graph:
    on a CUDA device with no group or an NCCL group, whose collectives
    are kernels on the card.  Gloo's run on the host, so a gloo step stays
    eager, as every step does on the CPU."""
    return torch.device(device).type == "cuda" and backend in (None, "nccl")


def comm_counts() -> dict:
    """The collectives' counters, calls and bytes: the gradients' buckets
    (``dp.mean_``), the halos, the gathers and the moments'
    all-reduces."""
    return {"dp.all_reduce_calls": dp.reductions,
            "dp.all_reduce_bytes": dp.bytes_reduced,
            "sp.halo_calls": spatial.halo_calls,
            "sp.halo_bytes": spatial.halo_bytes,
            "sp.gather_calls": spatial.gather_calls,
            "sp.gather_bytes": spatial.gather_bytes,
            "sp.moments_calls": norm.moments_calls,
            "sp.moments_bytes": norm.moments_bytes}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before[k] for k, v in after.items()}


class StepGraph:
    """One train step over the resident split (a (trainA, trainB) pair
    under ``--loss_mode cycle``) from static inputs, captured as a CUDA
    graph on the card at the first chunk and replayed once a step, its
    NCCL collectives inside; on the CPU, and over a gloo group
    (``captures``), the same function runs eagerly once a step.  The
    replays pass through no wrapper and no counter, so a step's counts
    are recorded at the capture: ``k1_calls``, K1's calls ((forward,
    backward) totals, and calls by (direction, route) and by ("sp", split
    pass)), and ``comm_calls``, the collectives' counters (``comm_counts``;
    on the eager path around its first step)."""

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
        out_w = slots if self.hist else effective_batch(cfg) // tr.n_rows
        self.cuts = [i * b for i in range(len(self.splits) + 1)]
        self.cuts += [self.cuts[-1] + out_w, self.cuts[-1] + out_w + slots]
        self.rows = torch.zeros(self.cuts[-1], dtype=torch.int64,
                                device=self.splits[0].img.device)
        self.graph = self.losses = self.k1_calls = self.comm_calls = None
        self._key = None
        self.captures = captures(self.rows.device, dp.backend(tr.group))

    def _step(self) -> torch.Tensor:
        """One step from ``rows``: the state updated in place, the
        (gen, disc) losses as a (2,) tensor."""
        tr, c = self.tr, self.cuts
        draws, masks = device_draws(
            tr, *(ds.img.shape[1] for ds in self.splits))
        batch = assemble(tr, self.splits, self.make_batch,
                         [self.rows[c[i]:c[i + 1]]
                          for i in range(len(self.splits))], draws)
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
        counts = []  # the counters before and after the capture

        def restore():
            with torch.no_grad():
                for t, v in zip(tensors, saved):
                    t.copy_(v)
            tr.data_gen.set_state(gen_state)
            counts.append((_k1_counts(), comm_counts()))

        t0 = time.perf_counter()
        self.graph, self.losses = cuda_graph.capture(
            self._step, WARMUP_STEPS, (tr.data_gen,), restore)
        tr.data_gen.set_state(gen_state)  # where the first replay draws
        counts.append((_k1_counts(), comm_counts()))
        ((f0, b0, r0), c0), ((f1, b1, r1), c1) = counts
        self.k1_calls = ((f1 - f0, b1 - b0),
                         {k: v - r0[k] for k, v in r1.items() if v != r0[k]})
        self.comm_calls = _delta(c1, c0)
        self._key = cuda_graph.storage_key(tensors)
        on = f" on rank {tr.rank}" if tr.group is not None else ""
        split = {p: n for (d, p), n in self.k1_calls[1].items() if d == "sp"}
        extra = (f"; K1's split passes a step: {split}" if split else "") + (
            "; collectives a step: {} ({} bytes)".format(*(
                sum(v for k, v in self.comm_calls.items() if k.endswith(e))
                for e in ("_calls", "_bytes")))
            if tr.group is not None else "")
        print(f" [*] train step captured as a CUDA graph{on} in "
              f"{time.perf_counter() - t0:.2f} s (K1 calls a step: "
              f"{self.k1_calls[0][0]} forward, {self.k1_calls[0][1]} "
              f"backward); {tr.cfg.scan_steps} steps a chunk{extra}")

    def run(self, rows: np.ndarray, tick=None) -> torch.Tensor:
        """The steps of one chunk, one per row of ``rows`` (kc, width)
        int64; returns their losses, (kc, 2) on the device.  Where it
        ``captures`` the graph is captured first when it has none, or when
        a tensor of the state has moved since its capture on any rank of
        the step's group; else ``tick`` (a profiler window's) is called
        after each eager step."""
        dev = self.rows.device
        table = torch.from_numpy(rows)
        if dev.type == "cuda":  # pinned, so the copy does not sync the host
            table = table.pin_memory().to(dev, non_blocking=True)
        if self.captures:
            key = cuda_graph.storage_key(state_tensors(self.tr.state)
                                         .values())
            # the ranks capture together, or their collectives part
            if not dp.agree(self.graph is not None and key == self._key,
                            self.tr.group):
                self.rows.copy_(table[0])
                self._capture()
        out = torch.empty((len(rows), 2), device=dev)
        for r in range(len(rows)):
            self.rows.copy_(table[r])
            if self.graph is not None:
                self.graph.replay()
                out[r].copy_(self.losses)
            else:
                before = comm_counts() if self.comm_calls is None else None
                out[r].copy_(self._step())
                if before is not None:
                    self.comm_calls = _delta(comm_counts(), before)
                if tick is not None:
                    tick()
        return out


def _k1_counts() -> tuple:
    return (cuda_in.launches, cuda_in.bwd_launches,
            {**cuda_in.route_launches,
             **{("sp", p): n for p, n in cuda_in.sp_launches.items()}})


def run_chunk(tr, graph: StepGraph, ix, tick=None) -> torch.Tensor:
    """The ``kc`` steps of one chunk through ``graph``, each split's batch
    rows ``ix`` (kc, batch_size) int64 on the host: the pool's host draws
    (drawn as an eager step draws them, whether the step pools or not:
    this rank's or its data row's, ``own_pool_draws``) and its rows or the
    history's, planned for the chunk over this rank's slots.  Advances
    ``tr.state``'s step and pool count; returns the losses (kc, 2) on the
    device.  ``tick``: ``StepGraph.run``'s."""
    cfg = tr.cfg
    kc, b_eff = len(ix[0]), effective_batch(cfg)
    slots = next(iter(tr.state.pool.buffer.values())).shape[0]
    draws = [own_pool_draws(tr) for _ in range(kc)]
    count = tr.state.pool.count
    if pools(cfg):
        out_rows, buf_rows, count = plan_steps(slots, count, draws)
    elif graph.hist:
        out_rows, buf_rows, count = plan_hist_steps(slots, count, b_eff, kc)
    else:  # rows the step does not read
        out_rows = np.zeros((kc, b_eff // tr.n_rows), np.int64)
        buf_rows = np.zeros((kc, slots), np.int64)
    m = graph.run(np.concatenate([*ix, out_rows, buf_rows], axis=1), tick)
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
    # a profiler window counts replayed chunks, or eager steps
    tick = tr._prof.tick if tr._prof is not None else None
    done = 0
    while done < nb:
        kc = min(cfg.scan_steps, nb - done)
        m = run_chunk(tr, graph, [o[done * b:(done + kc) * b].reshape(kc, b)
                                  for o in orders],
                      None if graph.captures else tick)
        g_losses.extend(m[:, 0].unbind())
        d_losses.extend(m[:, 1].unbind())
        tr._timer.mark(kc * b_eff)
        if tick is not None and graph.captures:
            tick()
        if tr.is_coord and (done == 0 or
                            (done - 1) // pf != (done + kc - 1) // pf):
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
