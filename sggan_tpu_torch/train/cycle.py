"""The cycle-consistency step (``--loss_mode cycle``), port of
``sggan_tpu/train/cycle.py``: the full SG-GAN objective of two generators
and two semantic discriminators,

    G: A->B, F: B->A (ResNet or U-Net, one architecture), D_A, D_B
    L_G = GAN(D_B(G(a), mask_a)) + GAN(D_A(F(b), mask_b))
        + L1_lambda * (|a - F(G(a))| + |b - G(F(b))|)             cycle
        + identity_lambda * (|G(b) - b| + |F(a) - a|)             identity
        + Lg_lambda * (gradloss(G(a), a, w_a) + gradloss(F(b), b, w_b))
    L_D = sum over both domains of (GAN(D(real), 1) + GAN(D(pooled), 0)) / 2

A translated image keeps its source's layout, so D_B judges G(a) under
mask_a and D_A judges F(b) under mask_b; one pool entry is the detached
pair (F(b), G(a)) with the masks (mask_b, mask_a) it was made under.  The
identity term runs only when ``identity_lambda`` is not 0, the gradient
loss only when ``Lg_lambda`` is not 0.

The state is the step's ``TrainState``: ``gen_params`` an
``nn.ModuleDict`` {"a2b": G, "b2a": F} under one Adam, ``disc_params``
{"da": D_A, "db": D_B} under the other, so parameter names are
``a2b.c1.w``, ``da.h1.w``..., the flattened names of the JAX tree
{"a2b": {...}} (``utils.bridge``).  The generators' loss flows through
the pre-step discriminators, frozen: ``torch.autograd.grad`` over the
generators' parameters only.  Each discriminator makes one call over
``[real; pooled fake]`` (instance norm is per sample).  Adam, the EMA
(one shadow over both generators, keyed ``a2b.*`` and ``b2a.*``), TF32
off in f32 mode, the explicit draws and the updates in place are
``train/step.py``'s.

Dropout: the JAX step splits its key into r1..r4 and gives the U-Net's
calls G(a) r1, F(b) r2, F(G(a)) and G(b) r3, G(F(b)) and F(a) r4; the
same key at the same shapes draws the same masks.  So the port draws four
mask sets (``cycle_dropout_masks``) and feeds set 3 to F(G(a)) and G(b),
set 4 to G(F(b)) and F(a).

``--remat`` and the ResNet head of ``pad_free_head`` reach both
generators as in the sggan step (cycle.py:87-100).  ``--mesh_data N``
runs the step on each of N ranks' shards, with the gradients and losses
averaged over the ranks as the sggan step averages them (cycle.py:
175-178), and each rank's pool keeps ``max(max_size, 1)`` pair slots
(``parallel/dp.py``); spatial sharding has its own cycle step
(``parallel/spatial_step.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .. import losses
from ..ops import dropout_masks as _draw_masks
from ..ops.deriv import seg_boundary_weight
from ..parallel import dp
from .pool import PoolDraws, PoolPlan, pool_init, pool_update
from .step import (TrainState, _conv_precision, _dtype, _ema_update, _grads,
                   _keep_pool, adam_init, adam_update, deterministic,
                   mean_over_ranks, new_discriminator, new_generator,
                   pad_free_head, pools)

N_MASK_SETS = 4  # r1..r4 of the JAX step


def new_cycle_nets(cfg, generator: Optional[torch.Generator] = None,
                   head: Optional[str] = None
                   ) -> Tuple[nn.ModuleDict, nn.ModuleDict]:
    """The two generators and two discriminators, drawn on the CPU from
    ``generator`` in the JAX package's order: a2b, b2a, da, db (their
    ``head`` as ``step.new_discriminator``'s)."""
    a2b = new_generator(cfg, generator)
    b2a = new_generator(cfg, generator)
    da = new_discriminator(cfg, generator, head)
    db = new_discriminator(cfg, generator, head)
    return (nn.ModuleDict({"a2b": a2b, "b2a": b2a}),
            nn.ModuleDict({"da": da, "db": db}))


def init_cycle_state(cfg, generator: torch.Generator, device="cuda",
                     group=None) -> TrainState:
    """Fresh nets (``new_cycle_nets``), zero Adam states over both
    generators and over both discriminators, and an empty pool of
    ``max(max_size, 1)`` (fake pair, mask pair) slots in the compute
    dtype, on ``device``: one rank's state under ``--mesh_data``, which
    must be the size of ``group`` (``step.init_state``)."""
    dp.data_group(cfg, group)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "visible")
    gen, disc = (m.to(device) for m in new_cycle_nets(cfg, generator))
    h, w = cfg.image_size
    # pooled pairs only feed discriminator forwards, which cast to the
    # compute dtype: a buffer in that dtype loses nothing
    pool = pool_init(cfg.max_size,
                     {"fakes": (2, h, w, cfg.output_nc),
                      "masks": (2, *cfg.mask_hw, cfg.segment_class)},
                     _dtype(cfg), device)
    ema = ({k: p.detach().clone() for k, p in gen.named_parameters()}
           if cfg.gen_ema > 0 else None)
    return TrainState(gen, {}, disc, {}, adam_init(gen), adam_init(disc),
                      pool, 0, ema)


def cycle_dropout_masks(cfg, gen: nn.ModuleDict, generator: torch.Generator,
                        n: int):
    """The four dropout mask sets of one step at batch ``n`` (each the
    three d1-d3 keep masks of the U-Net), drawn from ``generator`` on its
    device; None for the ResNet or under ``--dropout_mode keras_quirk``."""
    g = gen["a2b"]
    if deterministic(cfg) or not g.drop_rate:
        return None
    shapes = g.drop_shapes(n, *cfg.image_size)
    return tuple(_draw_masks(generator, shapes, g.drop_rate)
                 for _ in range(N_MASK_SETS))


def losses_and_grads(cfg, state: TrainState, batch: Dict[str, torch.Tensor],
                     draws: Union[PoolDraws, PoolPlan, None],
                     drop_masks: Optional[Sequence] = None):
    """The cycle step's forward and backward, without the updates.

    Returns ``(metrics, gen grads, disc grads, new pool)``; the grads are
    keyed by parameter name (``a2b.*``, ``da.*``...).  ``state`` is not
    changed."""
    cd = _dtype(cfg)
    train = not deterministic(cfg)
    gen, disc = state.gen_params, state.disc_params
    if train and drop_masks is None and gen["a2b"].drop_rate:
        raise ValueError("--dropout_mode intended: the cycle step needs "
                         "four dropout mask sets (cycle_dropout_masks)")
    masks = drop_masks if train and drop_masks is not None \
        else (None,) * N_MASK_SETS

    pfh = pad_free_head(cfg)

    def g_apply(net, x, k):
        return gen[net](x, {}, cd, masks[k], train=train, remat=cfg.remat,
                        pad_free_head=pfh)[0]

    crit = losses.criterion_gan(cfg.use_lsgan)
    real_a, real_b = batch["real_a"].float(), batch["real_b"].float()
    mask_a, mask_b = batch["mask_a"], batch["mask_b"]
    w_a = seg_boundary_weight(batch["seg_a"])
    w_b = seg_boundary_weight(batch["seg_b"])
    with _conv_precision(cd):
        fake_b = g_apply("a2b", real_a, 0)
        fake_a = g_apply("b2a", real_b, 1)
        cyc_a = g_apply("b2a", fake_b, 2)
        cyc_b = g_apply("a2b", fake_a, 3)
        # the pre-step discriminators; their parameters get no gradient
        d_fake_b = disc["db"](fake_b, mask_a, cd)
        d_fake_a = disc["da"](fake_a, mask_b, cd)
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
            g_loss = g_loss + cfg.Lg_lambda * (
                losses.gradloss_criterion(fake_b, real_a, w_a)
                + losses.gradloss_criterion(fake_a, real_b, w_b))
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
            both = disc[name](torch.cat([real, pooled["fakes"][:, k]]),
                              torch.cat([mask, pooled["masks"][:, k]]), cd)
            d_real, d_fake = both[:n], both[n:]
            d_loss = d_loss + (crit(d_real, torch.ones_like(d_real))
                               + crit(d_fake, torch.zeros_like(d_fake))) / 2.0
        d_grads = _grads(d_loss, disc)
    metrics = {"gen_loss": g_loss.detach(), "disc_loss": d_loss.detach()}
    return metrics, g_grads, d_grads, new_pool


def build_cycle_step_fn(cfg, group=None, keep_one: bool = False):
    """The cycle step: ``(state, batch, lr, pool_draws, drop_masks=None)
    -> (state, metrics)``.

    batch: both domains, {"real_a", "seg_a", "mask_a", "real_b", "seg_b",
    "mask_b"} as the sggan step's batch has them for A; ``lr`` a float or
    a 0-d f32 tensor on the state's device; ``pool_draws`` from
    ``pool.pool_draws(generator, B, cfg.max_size)``, or a
    ``pool.PoolPlan`` of this update (unused with ``max_size`` 0);
    ``drop_masks`` from ``cycle_dropout_masks`` (None for the ResNet or
    under ``--dropout_mode keras_quirk``).  Every tensor of the state is
    updated in place, as the sggan step does it; metrics are device
    scalars.  ``group`` and ``keep_one``: the ranks of ``--mesh_data``,
    as the sggan step's (``step.build_step_fn``)."""
    group = dp.data_group(cfg, group, keep_one)

    def step_fn(state: TrainState, batch, lr: Union[float, torch.Tensor],
                pool_draws: Union[PoolDraws, PoolPlan, None],
                drop_masks: Optional[Sequence] = None):
        metrics, g_grads, d_grads, pool = losses_and_grads(
            cfg, state, batch, pool_draws, drop_masks)
        mean_over_ranks(group, g_grads, {}, metrics["gen_loss"])
        mean_over_ranks(group, d_grads, {}, metrics["disc_loss"])
        adam_update(state.gen_params, state.g_opt, g_grads, lr, cfg.beta1)
        adam_update(state.disc_params, state.d_opt, d_grads, lr, cfg.beta1)
        _ema_update(cfg, state.ema, state.gen_params)
        return _keep_pool(state, pool)._replace(step=state.step + 1), metrics

    return step_fn
