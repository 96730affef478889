"""The epoch over the card-resident split, port of
``sggan_tpu/train/fused.py``: batch assembly on the device (a gather from
the resident split, the augmentation doubling, the preprocess) and the
epoch loop with its per-epoch shuffle, prints and ``--save_freq`` saves.

The port runs one step per dispatch.  The JAX package's ``--scan_steps``
rolls K steps into one ``lax.scan`` program and documents it as
numerically identical to its per-step path (fused.py:187-193), so the
port accepts the flag and runs that per-step path until the step is
captured as a CUDA graph (ROADMAP Queue 1, item 2).  Not ported, since
nothing on one card needs them: the scan program itself, its fallback on
a memory failure (``is_hbm_failure``) and the relay fences.

Each step uploads nothing: the epoch's order goes to the device once, the
data draws and the generator's dropout masks come from the trainer's
device generator, and the pool's draws from its host generator, since
the pool plans on the host (``train/pool.py``).

Under ``--loss_mode cycle`` the epoch runs over two resident splits,
trainA and trainB (fused.py:90-104, :197-212): B's order is the shuffle
of ``data_seed + 7919``, as the host iterator of trainB draws it; the
epoch has ``min(len_a, len_b) // batch_size`` steps; each step assembles
an A batch and a B batch and joins them (``two_domain``).  The draws keep
one order in the resident and the host path: A's preprocess, B's, the
pool's, then the four mask sets.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..data.loader import epoch_order
from ..data.preprocess import (PreprocessDraws, draw_preprocess,
                               preprocess_train)
from .pool import pool_draws
from .step import dropout_masks

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


def step_draws(tr, src_h: int, src_h_b: Optional[int] = None):
    """One step's draws: the preprocess's and then the dropout masks
    (None for a net without dropout) from the trainer's device generator,
    the pool's from its host generator.  Under ``--loss_mode cycle`` the
    preprocess's are a pair, A's (sources ``src_h`` rows high) then B's
    (``src_h_b``), and the masks the cycle step's four sets."""
    cfg = tr.cfg
    b_eff = effective_batch(cfg)

    def pre(h):
        return draw_preprocess(tr.data_gen, b_eff, h, cfg.image_size,
                               cfg.use_photometric)
    draws = (pre(src_h), pre(src_h_b)) if tr.cycle else pre(src_h)
    return (draws, pool_draws(tr.pool_gen, b_eff, cfg.max_size),
            dropout_masks(cfg, tr.state.gen_params, tr.data_gen, b_eff))


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


def run_epoch_fused(tr, epoch: int, lr: float, dev_ds, make_batch,
                    g_losses: list, d_losses: list, global_step: int,
                    start_time: float) -> int:
    """One epoch over the resident split (a (trainA, trainB) pair under
    ``--loss_mode cycle``), one step per dispatch, in the order of
    ``np.random.default_rng(data_seed + epoch)``'s shuffle (trainB's of
    ``data_seed + 7919 + epoch``).  Returns the new global step."""
    cfg = tr.cfg
    b = cfg.batch_size
    splits = dev_ds if tr.cycle else (dev_ds,)
    orders = [torch.from_numpy(epoch_order(len(ds), cfg.data_seed + seed,
                                           epoch)).to(ds.img.device)
              for ds, seed in zip(splits, (0, B_SEED_OFFSET))]
    for done in range(min(len(ds) for ds in splits) // b):
        draws, pdraws, masks = step_draws(
            tr, *(ds.img.shape[1] for ds in splits))
        batches = [make_batch(ds.img, ds.seg, ds.cls,
                              order[done * b:(done + 1) * b], d)
                   for ds, order, d in zip(
                       splits, orders, draws if tr.cycle else (draws,))]
        batch = two_domain(*batches) if tr.cycle else batches[0]
        tr.state, m = tr.step_fn(tr.state, batch, lr, pdraws, masks)
        global_step = end_step(tr, epoch, done, m, effective_batch(cfg),
                               g_losses, d_losses, global_step, start_time)
    return global_step
