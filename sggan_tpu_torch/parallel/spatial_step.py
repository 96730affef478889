"""The (data x space[ x wspace]) sharded train step, port of
``sggan_tpu/parallel/spatial_step.py``: one rank per card
(``parallel/mesh.py``), each holding its data row's rows of the batch cut
to its block of the plane.

* ``--loss_mode sggan`` with the ResNet or U-Net generator and the
  semantic discriminator with its patch head (the global VALID chain does
  not split), ``--loss_mode cycle`` with two generators, two patch-head
  discriminators and the pair pool, and ``--loss_mode p2p`` with the
  pix2pix pair (spatial_step.py:334-401); every forward is the sharded
  one of ``parallel/spatial.py``.
* The pix2pix step: the generator loss's discriminator call on the
  pre-step BN state in inference mode, its new state dropped; the
  discriminator loss's two calls, real then fake, threading the state;
  the batch norms on the batch's moments unless ``--dropout_mode
  keras_quirk``.  The new BN states are exact over the plane already
  (``batch_norm_sp``), so they are averaged over the data rows alone
  (``Grid.across``), as the JAX step's ``pmean`` over ``data``.
* Every loss term is a mean over equal blocks, so the local means
  averaged over the world are the global means: each net's gradients and
  loss are averaged over every rank through ``dp.mean_``'s one flat
  bucket, as the JAX step's ``pmean`` over all axes.  The gradients that
  cross blocks come back through the halos' and the moments' backwards.
* The pool keeps ``max(max_size, 1)`` slots a data row, each rank this
  block's rows (and columns) of them, the mask pool's rows split the same
  way.  Its draws are the data row's (``Grid.own_row``), so every
  spatial rank of a row takes the same slot decisions
  (spatial_step.py:26-28, 263-264).
* The U-Net's dropout masks are drawn per shard (``sp_dropout_masks``):
  every rank draws every shard's from the generator the ranks share and
  keeps its own, as ``dp.own_shard`` does.  The pix2pix generator's are
  per shard where its up block runs sharded, and one for the data row's
  whole plane where it runs replicated (the JAX step folds the latter's
  key by the data index alone).
* The discriminator makes one call over [real; pooled fake] (instance
  norm is per sample), where the JAX step makes two: the same sums with
  half the collectives.

``shard_batch`` cuts a data row's batch to this rank's block (the JAX
package's ``shard_sp_batch``); ``global_pool``/``pool_block`` map the
pool between the ranks and the JAX package's global layout (slots over
data, H over space, W over wspace), which the checkpoint holds.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from .. import losses
from ..ops import dropout_masks as _draw_masks
from ..train.cycle import N_MASK_SETS, new_cycle_nets
from ..train.pool import PoolDraws, PoolPlan, pool_init, pool_update
from ..train.step import (TrainState, _assign, _conv_precision, _dtype,
                          _ema_update, _grads, _keep_pool, adam_init,
                          adam_update,
                          deterministic, mean_over_ranks, new_discriminator,
                          new_generator, pools)
from . import dp, spatial
from .mesh import Grid


def local_hw(cfg, grid: Grid) -> tuple:
    """(H, W) of a rank's block of the image."""
    return cfg.image_height // grid.space, cfg.image_width // grid.wspace


def _local_mask_hw(cfg, grid: Grid) -> tuple:
    hm, wm = cfg.mask_hw
    return hm // grid.space, wm // grid.wspace


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "visible")
    return device


def init_sp_state(cfg, generator: torch.Generator, device,
                  grid: Grid) -> TrainState:
    """One rank's sggan state (spatial_step.py:49-87): the generator,
    then the patch-head discriminator, drawn on the CPU from
    ``generator``; zero Adam states; a pool of ``max(max_size, 1)`` slots
    of this block's (fake, mask) rows in the compute dtype.  Under
    ``--use_pix2pix`` the pix2pix pair with both nets' BN states and the
    p2p step's unused pool of one slot of this block's fake rows, which
    checkpoints carry (spatial_step.py:55-67)."""
    device = _device(device)
    gen = new_generator(cfg, generator).to(device)
    disc = new_discriminator(cfg, generator).to(device)
    h, w = local_hw(cfg, grid)
    if cfg.use_pix2pix:
        shapes, slots = {"fake": (h, w, cfg.output_nc)}, 1
    else:
        shapes = {"fake": (h, w, cfg.output_nc),
                  "mask": (*_local_mask_hw(cfg, grid), cfg.segment_class)}
        slots = cfg.max_size
    pool = pool_init(slots, shapes, _dtype(cfg), device)
    ema = ({k: p.detach().clone() for k, p in gen.named_parameters()}
           if cfg.gen_ema > 0 else None)
    return TrainState(gen, gen.init_bn_state(device), disc,
                      disc.init_bn_state(device), adam_init(gen),
                      adam_init(disc), pool, 0, ema)


def init_sp_cycle_state(cfg, generator: torch.Generator, device,
                        grid: Grid) -> TrainState:
    """One rank's cycle state (spatial_step.py:90-119): a2b, b2a and two
    patch-head discriminators in ``cycle.new_cycle_nets``'s order, a pool
    of this block's (fake pair, mask pair) rows."""
    device = _device(device)
    gen, disc = (m.to(device) for m in new_cycle_nets(cfg, generator))
    h, w = local_hw(cfg, grid)
    pool = pool_init(cfg.max_size,
                     {"fakes": (2, h, w, cfg.output_nc),
                      "masks": (2, *_local_mask_hw(cfg, grid),
                                cfg.segment_class)}, _dtype(cfg), device)
    ema = ({k: p.detach().clone() for k, p in gen.named_parameters()}
           if cfg.gen_ema > 0 else None)
    return TrainState(gen, {}, disc, {}, adam_init(gen), adam_init(disc),
                      pool, 0, ema)


def sp_dropout_masks(cfg, grid: Grid, gen: nn.Module,
                     generator: torch.Generator, n: int):
    """This shard's dropout keep masks of one step at a local batch of
    ``n``: every shard's drawn from ``generator`` in rank order (at the
    local block's shapes), this rank's kept; the cycle step's four sets
    under ``--loss_mode cycle``; None for the ResNet or under
    ``--dropout_mode keras_quirk``."""
    g = gen["a2b"] if cfg.loss_mode == "cycle" else gen
    if deterministic(cfg) or not g.drop_rate:
        return None
    if cfg.use_pix2pix:
        return _pix2pix_masks(cfg, grid, g, generator, n)
    shapes = g.drop_shapes(n, *local_hw(cfg, grid))

    def draw():
        if cfg.loss_mode == "cycle":
            return tuple(_draw_masks(generator, shapes, g.drop_rate)
                         for _ in range(N_MASK_SETS))
        return _draw_masks(generator, shapes, g.drop_rate)
    return grid.own_shard(draw)


def _pix2pix_masks(cfg, grid: Grid, gen: nn.Module,
                   generator: torch.Generator, n: int) -> tuple:
    """The pix2pix generator's keep masks of up blocks 0-2, block by
    block: where the block runs sharded (``spatial.pix2pix_sharded``)
    every shard's at its block's shape in rank order, this rank's kept;
    where it runs replicated every data row's at the whole plane's shape,
    this rank's row's kept."""
    down = spatial.pix2pix_sharded(len(gen.down_ch), *local_hw(cfg, grid),
                                   grid)
    out = []
    for i, shape in enumerate(gen.drop_shapes(n, *cfg.image_size)):
        if down[len(down) - 2 - i]:
            local = (shape[0], shape[1] // grid.space,
                     shape[2] // grid.wspace, shape[3])
            out.append(grid.own_shard(
                lambda: _draw_masks(generator, [local], gen.drop_rate)[0]))
        else:
            out.append(grid.own_row(
                lambda: _draw_masks(generator, [shape], gen.drop_rate)[0]))
    return tuple(out)


def shard_batch(batch: Dict[str, torch.Tensor], grid: Grid
                ) -> Dict[str, torch.Tensor]:
    """A data row's batch cut to this rank's block: H (dim 1) over
    ``space``, W (dim 2) over ``wspace``, each tensor by its own size
    (the image's rows, the mask's)."""
    out = {}
    for k, v in batch.items():
        h, w = v.shape[1] // grid.space, v.shape[2] // grid.wspace
        out[k] = v[:, grid.s * h:(grid.s + 1) * h,
                   grid.w * w:(grid.w + 1) * w].contiguous()
    return out


def shard_global(batch: Dict[str, torch.Tensor], grid: Grid
                 ) -> Dict[str, torch.Tensor]:
    """A global batch cut to this rank's rows (its data row's) and block
    (the JAX package's ``shard_sp_batch``)."""
    b = next(iter(batch.values())).shape[0] // grid.data
    return shard_batch({k: v[grid.d * b:(grid.d + 1) * b]
                        for k, v in batch.items()}, grid)


def pool_block(shape, sizes, coords) -> tuple:
    """The index of the block of rank (d, s, w) (``coords``) in a global
    pool buffer of ``shape`` over a (D, S, W) layout (``sizes``): slots
    over data, H (dim -3) over space, W (dim -2) over wspace."""
    (D, S, W), (d, s, w) = sizes, coords
    idx = [slice(None)] * len(shape)
    for dim, n, i in ((0, D, d), (len(shape) - 3, S, s),
                      (len(shape) - 2, W, w)):
        k = shape[dim] // n
        idx[dim] = slice(i * k, (i + 1) * k)
    return tuple(idx)


def global_shape(local, sizes) -> tuple:
    D, S, W = sizes
    shape = list(local)
    shape[0] *= D
    shape[-3] *= S
    shape[-2] *= W
    return tuple(shape)


@torch.no_grad()
def global_pool(buffer: Dict[str, torch.Tensor], grid: Grid
                ) -> Dict[str, torch.Tensor]:
    """Every rank's pool block in the JAX package's global layout, on
    every rank (a collective over the world): ``dp.gather_blocks``."""
    sizes = (grid.data, grid.space, grid.wspace)
    coords = (grid.d, grid.s, grid.w)
    return dp.gather_blocks(
        buffer, grid.world,
        lambda t: (global_shape(t.shape, sizes),
                   pool_block(global_shape(t.shape, sizes), sizes,
                              coords)))


def _sggan_losses_and_grads(cfg, grid: Grid, state: TrainState, batch,
                            draws, drop_masks):
    """The sggan objective on this rank's block (spatial_step.py:253-331):
    ``(metrics, gen grads, disc grads, new pool)``, the losses and
    gradients this block's own."""
    cd = _dtype(cfg)
    crit = losses.criterion_gan(cfg.use_lsgan)
    gen, disc = state.gen_params, state.disc_params
    train = not deterministic(cfg)
    if train and drop_masks is None and gen.drop_rate:
        raise ValueError("--dropout_mode intended: the step needs this "
                         "shard's dropout masks (sp_dropout_masks)")
    masks = drop_masks if train else None
    real_a = batch["real_a"].float()
    seg_a = batch["seg_a"].float()
    mask_a = batch["mask_a"]
    anchor = seg_a if cfg.sggan_l1_target == "seg" else real_a
    with _conv_precision(cd):
        fake = spatial.generator_sp(gen, real_a, grid, cd, masks)
        # the pre-step discriminator; its parameters get no gradient
        da_fake = spatial.discriminator_sp(disc, fake, mask_a, grid, cd)
        g_loss = crit(da_fake, torch.ones_like(da_fake))
        g_loss = g_loss + cfg.L1_lambda * losses.abs_criterion(anchor, fake)
        if cfg.Lg_lambda:
            w_a = spatial.seg_boundary_weight_sp(seg_a, grid)
            g_loss = g_loss + cfg.Lg_lambda * spatial.gradloss_criterion_sp(
                fake, real_a, w_a, grid)
        g_grads = _grads(g_loss, gen)

        fake_sg, mask_for_d, new_pool = fake.detach(), mask_a, state.pool
        if pools(cfg):
            new_pool, pooled = pool_update(
                state.pool, {"fake": fake_sg, "mask": mask_a}, draws)
            fake_sg, mask_for_d = pooled["fake"], pooled["mask"]
        both = spatial.discriminator_sp(
            disc, torch.cat([seg_a, fake_sg.float()]),
            torch.cat([mask_a, mask_for_d.to(mask_a.dtype)]), grid, cd)
        n = seg_a.shape[0]
        d_loss = losses.disc_loss_sggan(both[:n], both[n:],
                                        use_lsgan=cfg.use_lsgan)
        d_grads = _grads(d_loss, disc)
    metrics = {"gen_loss": g_loss.detach(), "disc_loss": d_loss.detach()}
    return metrics, g_grads, d_grads, new_pool


def _cycle_losses_and_grads(cfg, grid: Grid, state: TrainState, batch,
                            draws, drop_masks):
    """The cycle objective on this rank's block (spatial_step.py:122-237),
    ``train/cycle.py``'s terms with the sharded forwards."""
    cd = _dtype(cfg)
    crit = losses.criterion_gan(cfg.use_lsgan)
    gen, disc = state.gen_params, state.disc_params
    train = not deterministic(cfg)
    if train and drop_masks is None and gen["a2b"].drop_rate:
        raise ValueError("--dropout_mode intended: the cycle step needs "
                         "this shard's four mask sets (sp_dropout_masks)")
    masks = drop_masks if train and drop_masks is not None \
        else (None,) * N_MASK_SETS

    def g_apply(net, x, k):
        return spatial.generator_sp(gen[net], x, grid, cd, masks[k])

    def d_apply(net, x, mask):
        return spatial.discriminator_sp(disc[net], x, mask, grid, cd)

    real_a, real_b = batch["real_a"].float(), batch["real_b"].float()
    mask_a, mask_b = batch["mask_a"], batch["mask_b"]
    with _conv_precision(cd):
        fake_b = g_apply("a2b", real_a, 0)
        fake_a = g_apply("b2a", real_b, 1)
        cyc_a = g_apply("b2a", fake_b, 2)
        cyc_b = g_apply("a2b", fake_a, 3)
        d_fake_b = d_apply("db", fake_b, mask_a)
        d_fake_a = d_apply("da", fake_a, mask_b)
        g_loss = (crit(d_fake_b, torch.ones_like(d_fake_b))
                  + crit(d_fake_a, torch.ones_like(d_fake_a)))
        g_loss = g_loss + cfg.L1_lambda * (
            losses.abs_criterion(real_a, cyc_a)
            + losses.abs_criterion(real_b, cyc_b))
        if cfg.identity_lambda:
            idt_b = g_apply("a2b", real_b, 2)
            idt_a = g_apply("b2a", real_a, 3)
            g_loss = g_loss + cfg.identity_lambda * (
                losses.abs_criterion(idt_b, real_b)
                + losses.abs_criterion(idt_a, real_a))
        if cfg.Lg_lambda:
            w_a = spatial.seg_boundary_weight_sp(batch["seg_a"], grid)
            w_b = spatial.seg_boundary_weight_sp(batch["seg_b"], grid)
            g_loss = g_loss + cfg.Lg_lambda * (
                spatial.gradloss_criterion_sp(fake_b, real_a, w_a, grid)
                + spatial.gradloss_criterion_sp(fake_a, real_b, w_b, grid))
        g_grads = _grads(g_loss, gen)

        # fake_a came from real_b (judged under mask_b), fake_b from real_a
        entry = {"fakes": torch.stack([fake_a.detach(), fake_b.detach()], 1),
                 "masks": torch.stack([mask_b, mask_a], 1)}
        new_pool, pooled = state.pool, entry
        if pools(cfg):
            new_pool, pooled = pool_update(state.pool, entry, draws)
        n = real_a.shape[0]
        d_loss = 0.0
        for name, real, mask, k in (("da", real_a, mask_a, 0),
                                    ("db", real_b, mask_b, 1)):
            both = d_apply(name, torch.cat([real, pooled["fakes"][:, k]
                                            .float()]),
                           torch.cat([mask, pooled["masks"][:, k]
                                      .to(mask.dtype)]))
            d_real, d_fake = both[:n], both[n:]
            d_loss = d_loss + (crit(d_real, torch.ones_like(d_real))
                               + crit(d_fake, torch.zeros_like(d_fake))) / 2.0
        d_grads = _grads(d_loss, disc)
    metrics = {"gen_loss": g_loss.detach(), "disc_loss": d_loss.detach()}
    return metrics, g_grads, d_grads, new_pool


def _pix2pix_losses_and_grads(cfg, grid: Grid, state: TrainState, batch,
                              draws, drop_masks):
    """The p2p objective with the pix2pix pair on this rank's block
    (spatial_step.py:334-401): the generator loss through the pre-step
    discriminator in inference mode, the discriminator's two calls, real
    then fake, threading its BN state.  The patch logits are replicated,
    so each rank's GAN terms are the whole plane's and its L1 its block's
    mean; the world's average is the global loss."""
    cd = _dtype(cfg)
    gen, disc = state.gen_params, state.disc_params
    bn_train = not deterministic(cfg)
    if bn_train and drop_masks is None:
        raise ValueError("--dropout_mode intended: the step needs this "
                         "shard's dropout masks (sp_dropout_masks)")
    masks = drop_masks if bn_train else None
    real_a = batch["real_a"].float()
    seg_a = batch["seg_a"].float()
    with _conv_precision(cd):
        fake, new_gbn = spatial.generator_pix2pix_sp(
            gen, state.gen_bn, real_a, grid, cd, masks, bn_train)
        da_fake, _ = spatial.discriminator_pix2pix_sp(
            disc, state.disc_bn, seg_a, fake, grid, cd, train=False)
        g_loss = losses.gen_loss_p2p(da_fake, fake, seg_a)
        g_grads = _grads(g_loss, gen)
        fake_sg = fake.detach()
        da_real, dbn1 = spatial.discriminator_pix2pix_sp(
            disc, state.disc_bn, seg_a, seg_a, grid, cd, train=bn_train)
        da_fake_s, new_dbn = spatial.discriminator_pix2pix_sp(
            disc, dbn1, seg_a, fake_sg, grid, cd, train=bn_train)
        d_loss = losses.disc_loss_p2p(da_real, da_fake_s)
        d_grads = _grads(d_loss, disc)
    metrics = {"gen_loss": g_loss.detach(), "disc_loss": d_loss.detach()}
    return metrics, g_grads, d_grads, state.pool, (new_gbn, new_dbn)


def losses_and_grads(cfg, grid: Grid, state: TrainState, batch,
                     draws: Union[PoolDraws, PoolPlan, None],
                     drop_masks: Optional[Sequence] = None):
    """This block's forward and backward, without the averaging or the
    updates: ``(metrics, gen grads, disc grads, new pool, (new gen BN
    state, new disc BN state))``, the BN states ({} for the semantic nets)
    not yet averaged over the data rows; ``state`` is not changed."""
    if cfg.use_pix2pix:
        return _pix2pix_losses_and_grads(cfg, grid, state, batch, draws,
                                         drop_masks)
    fn = _cycle_losses_and_grads if cfg.loss_mode == "cycle" \
        else _sggan_losses_and_grads
    return (*fn(cfg, grid, state, batch, draws, drop_masks), ({}, {}))


def build_sp_step_fn(cfg, grid: Grid):
    """The spatial step: ``(state, batch, lr, pool_draws, drop_masks=None)
    -> (state, metrics)`` on this rank's block: ``batch`` its data row's
    rows cut to its block (``shard_batch``), ``pool_draws`` its data row's
    (``Grid.own_row``, unused by the p2p step), ``drop_masks`` its own
    (``sp_dropout_masks``).  Each net's gradients and loss are averaged
    over the world, the pix2pix nets' new BN states over the data rows;
    then Adam and the EMA update every rank's replica in place, the same
    on each."""
    # the JAX trainer's refusal (trainer.py:90-97)
    if not ((cfg.loss_mode in ("sggan", "cycle") and not cfg.use_pix2pix)
            or (cfg.loss_mode == "p2p" and cfg.use_pix2pix)):
        raise NotImplementedError(
            "mesh_space>1 supports --loss_mode sggan/cycle with the "
            "resnet/unet nets, or --loss_mode p2p with --use_pix2pix")

    def step_fn(state: TrainState, batch, lr, pool_draws,
                drop_masks=None):
        metrics, g_grads, d_grads, pool, (gen_bn, disc_bn) = \
            losses_and_grads(cfg, grid, state, batch, pool_draws,
                             drop_masks)
        mean_over_ranks(grid.world, g_grads, {}, metrics["gen_loss"])
        mean_over_ranks(grid.world, d_grads, {}, metrics["disc_loss"])
        bn = dp.bn_leaves(gen_bn) + dp.bn_leaves(disc_bn)
        if bn and grid.across is not None:
            dp.mean_(bn, grid.across)
        adam_update(state.gen_params, state.g_opt, g_grads, lr, cfg.beta1)
        adam_update(state.disc_params, state.d_opt, d_grads, lr, cfg.beta1)
        _assign(state.gen_bn, gen_bn)
        _assign(state.disc_bn, disc_bn)
        _ema_update(cfg, state.ema, state.gen_params)
        return _keep_pool(state, pool)._replace(step=state.step + 1), metrics

    return step_fn
