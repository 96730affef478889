"""The two-optimizer GAN train step, port of ``sggan_tpu/train/step.py``.

Reference semantics (model.py:169-200): one generator forward; the
semantic discriminator judges (fake, mask); the generator's gradient
flows through a *frozen* discriminator (``torch.autograd.grad`` over the
generator's parameters only, so nothing reaches the discriminator's);
the fake, detached, goes through the image pool with its mask; one
discriminator call over ``[seg_a; pooled fake]`` gives the discriminator
loss and its gradient; then one Adam update per net and the optional EMA.

Ported: the sggan branch (``--loss_mode sggan``, the full SG-GAN objective
with the (fake, mask) pool) and the p2p and simple branches that share its
body, with every net the CLI selects (``models.build``): the ResNet or
U-Net generator with the semantic discriminator, or the pix2pix pair.
``--loss_mode cycle`` has its own step in ``train/cycle.py``;
``init_state``, ``dropout_masks`` and ``build_step_fn`` hand that mode to
it, so a caller takes every mode through this module's entry points.
Under pix2pix the discriminator's batch norm makes the JAX step's two
calls, real then fake, threading the BN state, and the generator loss's
call runs in inference mode on the pre-step state (``_gen_fwd`` and
``_disc_fwd`` of the JAX step); the pix2pix pool holds fakes only.  The
generator runs with ``--remat`` (the ResNet's resblocks or the U-Net's
stages recomputed in the backward) and the ResNet head that
``pad_free_head`` picks, as the JAX step's ``_gen_fwd``.

``--compat_fake_history`` (p2p, the semantic nets: ``compat_hist``) is
the reference's own dynamics (model.py:175-179): an f32 history of
9 + b_eff fakes whose count grows by the batch until it reaches 10, then
starts again; the generator loss judges the whole history, with this
step's fakes written into it (the gradient reaches only those rows), and
the discriminator loss the detached history, each entry against the
current batch's mask and seg tiled to the history's length (the
reference's quirk).  The update's rows are planned on the host
(``pool.hist_plan``), so a CUDA graph of the step reads them from a
buffer.  Under the pix2pix nets the flag is ignored, as in JAX.  Not
ported yet, raising ``NotImplementedError`` that names its ROADMAP item:
data parallelism (``axis_name``, the meshes), in every loss mode.

Adam is optax's ``scale_by_adam`` (betas (beta1, 0.999), eps 1e-7, the
Keras default, not optax's 1e-8) with the learning rate applied outside the
update, ``p -= lr * m_hat / (sqrt(v_hat) + eps)``, and one step count per
optimizer.  Every parameter gets a gradient: the conv biases that feed an
instance norm are unused (the norm removes them exactly) and get zeros,
so the Adam state has optax's layout.

The step updates the state in place: the parameters, Adam's moments and
its count (an int32 tensor on the device, from which the bias corrections
are computed there), the batch norms' moving stats, the pool's buffer and
the EMA keep their storage from step to step, and ``lr`` may be a device
scalar.  So a CUDA graph of the step replays on the same addresses
(``train/fused.py``).  ``losses_and_grads`` changes nothing: it returns
the new BN states and pool as new tensors, which the step copies in.

TF32: under ``--compute_dtype float32`` the step runs its convolutions in
IEEE f32, turning cuDNN's TF32 (on by default in PyTorch) off for the
step's duration and restoring it after: f32 mode is the reference's
precision, and tests hold it to the JAX step.  bf16 mode computes its
convs in bf16 and is not affected.

The random draws are explicit: the pool's come in as ``PoolDraws``
(``pool.pool_draws``), the generator's dropout keep masks as a tuple
(``dropout_masks``).  ``--dropout_mode intended`` (the default) trains
with dropout, and the pix2pix batch norms on batch statistics;
``keras_quirk`` makes the generator's forward deterministic and every
batch norm use its moving stats, as the JAX step's ``deterministic`` does.
The step keeps its losses on the device: it makes no host sync.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import losses
from ..models import build
from ..ops import dropout_masks as _draw_masks
from .pool import (HistPlan, PoolDraws, PoolPlan, PoolState, hist_plan,
                   pool_init, pool_update)

ADAM_EPS = 1e-7
ADAM_B2 = 0.999


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: moments keyed by parameter name, the
    step count a 0-d int32 tensor on their device."""
    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    gen_params: torch.nn.Module  # the nets hold their parameters
    gen_bn: dict                 # BN moving stats; {} for IN models
    disc_params: torch.nn.Module
    disc_bn: dict
    g_opt: AdamState
    d_opt: AdamState
    pool: PoolState
    step: int
    ema: Optional[Dict[str, torch.Tensor]] = None  # f32 shadow of gen


def lr_schedule(cfg, epoch: int) -> float:
    """Reference model.py:205 (override) / model.py:223 (commented decay)."""
    if cfg.compat_lr_override:
        return 1e-3
    if epoch < cfg.epoch_step:
        return cfg.lr
    denom = max(cfg.epoch - cfg.epoch_step, 1)
    return cfg.lr * (cfg.epoch - epoch) / denom


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _require_ported(cfg, axis_name=None) -> None:
    if axis_name is not None or cfg.mesh_data > 1 or cfg.mesh_space > 1:
        raise NotImplementedError(
            "data and spatial parallelism (ROADMAP Queue 1: parallel) is "
            "not ported yet; train on one device (--mesh_data 1 "
            "--mesh_space 1)")


def compat_hist(cfg) -> bool:
    """Whether the step keeps the reference's fake history: p2p mode,
    ``--compat_fake_history``, the semantic nets (the JAX step's
    ``_compat_hist``)."""
    return (cfg.loss_mode == "p2p" and cfg.compat_fake_history
            and not cfg.use_pix2pix)


def hist_slots(cfg) -> int:
    """The history's slots: 9 + the effective batch, the longest prefix
    it reaches before it starts again."""
    return 9 + cfg.batch_size * (2 if cfg.use_augmentation else 1)


def adam_init(net: torch.nn.Module) -> AdamState:
    zeros = {k: torch.zeros_like(p) for k, p in net.named_parameters()}
    count = torch.zeros((), dtype=torch.int32,
                        device=next(iter(zeros.values())).device)
    return AdamState(count, zeros, {k: z.clone() for k, z in zeros.items()})


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor of ``state`` that a step writes, by name: the nets'
    parameters (``gen.*``, ``disc.*``), their BN moving stats, both Adam
    states with their counts, the pool's buffers and the EMA."""
    out = {}
    for name, net in (("gen", state.gen_params), ("disc", state.disc_params)):
        out.update((f"{name}.{k}", p) for k, p in net.named_parameters())
    for name, bn in (("gen_bn", state.gen_bn), ("disc_bn", state.disc_bn)):
        out.update((f"{name}.{k}.{n}", t) for k, v in bn.items()
                   for n, t in v.items())
    for name, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        out[f"{name}.count"] = opt.count
        for part in ("mu", "nu"):
            out.update((f"{name}.{part}.{k}", t)
                       for k, t in getattr(opt, part).items())
    out.update((f"pool.{k}", t) for k, t in state.pool.buffer.items())
    out.update((f"ema.{k}", t) for k, t in (state.ema or {}).items())
    return out


def new_generator(cfg, generator: Optional[torch.Generator] = None):
    """The generator that ``cfg`` selects, drawn on the CPU from
    ``generator``; ``init_state`` draws it first, then the
    discriminator from the same generator (``new_discriminator``)."""
    kw = dict(ngf=cfg.ngf, input_nc=cfg.input_nc, output_nc=cfg.output_nc,
              generator=generator)
    if cfg.use_pix2pix:
        kw["image_size"] = cfg.image_height
    return build(cfg)[0](**kw)


def new_discriminator(cfg, generator: Optional[torch.Generator] = None):
    """The discriminator that ``cfg`` selects, drawn on the CPU from
    ``generator``."""
    kw = dict(ndf=cfg.ndf, input_nc=cfg.input_nc, generator=generator)
    if not cfg.use_pix2pix:
        kw.update(n_class=cfg.segment_class, image_size=cfg.image_size)
    return build(cfg)[1](**kw)


def init_state(cfg, generator: torch.Generator,
               device="cuda") -> TrainState:
    """Fresh nets drawn on the CPU from ``generator`` (generator first,
    then discriminator), fresh BN moving stats, zero Adam state and an
    empty pool, on ``device``; the cycle mode's state under
    ``--loss_mode cycle`` (``cycle.init_cycle_state``)."""
    if cfg.loss_mode == "cycle":
        from .cycle import init_cycle_state
        return init_cycle_state(cfg, generator, device)
    _require_ported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "visible")
    h, w = cfg.image_size
    gen = new_generator(cfg, generator).to(device)
    disc = new_discriminator(cfg, generator).to(device)
    # pooled entries only feed discriminator forwards, which cast to the
    # compute dtype: a buffer in that dtype loses nothing
    if compat_hist(cfg):
        # f32 whatever the compute dtype: the L1 loss reads it directly
        pool = pool_init(hist_slots(cfg), {"fake": (h, w, cfg.output_nc)},
                         torch.float32, device)
    elif cfg.loss_mode == "sggan":
        shapes = {"fake": (h, w, cfg.output_nc)}
        if not cfg.use_pix2pix:  # the semantic D judges a fake by its mask
            shapes["mask"] = (*cfg.mask_hw, cfg.segment_class)
        pool = pool_init(cfg.max_size, shapes, _dtype(cfg), device)
    else:
        pool = pool_init(1, {"fake": (h, w, cfg.output_nc)}, _dtype(cfg),
                         device)
    ema = ({k: p.detach().clone() for k, p in gen.named_parameters()}
           if cfg.gen_ema > 0 else None)
    return TrainState(gen, gen.init_bn_state(device), disc,
                      disc.init_bn_state(device), adam_init(gen),
                      adam_init(disc), pool, 0, ema)


def pools(cfg) -> bool:
    """Whether the step passes its fakes through the pool: the sggan and
    cycle modes with ``max_size`` > 0 (the p2p and simple steps judge this
    step's fakes)."""
    return cfg.max_size > 0 and cfg.loss_mode in ("sggan", "cycle")


def _keep_pool(state: TrainState, pool: PoolState) -> TrainState:
    """``state`` with the updated ``pool`` copied into its buffers and its
    count taken (``state`` itself where the step left the pool alone)."""
    if pool is state.pool:
        return state
    _assign(state.pool.buffer, pool.buffer)
    return state._replace(pool=state.pool._replace(count=pool.count))


def deterministic(cfg) -> bool:
    """``--dropout_mode keras_quirk``: no dropout, batch norm on its moving
    stats (the JAX step's ``deterministic``)."""
    return cfg.dropout_mode == "keras_quirk"


def dropout_masks(cfg, gen: torch.nn.Module, generator: torch.Generator,
                  n: int) -> Optional[Tuple[torch.Tensor, ...]]:
    """The generator's dropout keep masks for one step at batch ``n``,
    drawn from ``generator`` on its device; None where the net has no
    dropout (the ResNet) or under ``--dropout_mode keras_quirk``.  Under
    ``--loss_mode cycle``, the cycle step's four mask sets
    (``cycle.cycle_dropout_masks``)."""
    if cfg.loss_mode == "cycle":
        from .cycle import cycle_dropout_masks
        return cycle_dropout_masks(cfg, gen, generator, n)
    if deterministic(cfg) or not gen.drop_rate:
        return None
    return _draw_masks(generator, gen.drop_shapes(n, *cfg.image_size),
                       gen.drop_rate)


@contextlib.contextmanager
def _conv_precision(cd: torch.dtype):
    prev = torch.backends.cudnn.allow_tf32
    if cd == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _grads(loss: torch.Tensor,
           net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    names, params = zip(*net.named_parameters())
    # unused parameters (the IN-fed conv biases) get zeros, not None
    return dict(zip(names, torch.autograd.grad(loss, params,
                                               materialize_grads=True)))


def pad_free_head(cfg) -> bool:
    """The ResNet head's form: ``--pad_free_head`` where given, else the
    pad-free head unless ``--remat`` (the JAX package's default, which
    keeps the pre-padded head's lower peak memory under ``--remat``)."""
    if cfg.pad_free_head is not None:
        return cfg.pad_free_head
    return not cfg.remat


def _gen_fwd(cfg, gen, gen_bn, x, drop_masks, cd):
    """(fake, new generator BN state), as the JAX step's ``_gen_fwd``."""
    train = not deterministic(cfg)
    if train and drop_masks is None and gen.drop_rate:
        raise ValueError("--dropout_mode intended: the step needs the "
                         "generator's dropout masks (step.dropout_masks)")
    return gen(x, gen_bn, cd, drop_masks if train else None, train=train,
               remat=cfg.remat, pad_free_head=pad_free_head(cfg))


def _disc_fwd(cfg, disc, disc_bn, img, mask_or_tar, cd, train):
    """(logits, new discriminator BN state), as ``_disc_fwd``."""
    if cfg.use_pix2pix:
        return disc(img, mask_or_tar, disc_bn, cd, train=train)
    return disc(img, mask_or_tar, cd), disc_bn


def losses_and_grads(cfg, state: TrainState, batch: Dict[str, torch.Tensor],
                     draws: Union[PoolDraws, PoolPlan, None],
                     drop_masks: Optional[Sequence[torch.Tensor]] = None):
    """The step's forward and backward, without the updates.

    Returns ``(metrics, gen grads, disc grads, new pool, (new gen BN
    state, new disc BN state))``; the grads are keyed by parameter name.
    ``draws``: the pool's draws, or its update planned ahead
    (``pool.plan_steps``); under ``compat_hist`` the history's update
    planned ahead (``pool.HistPlan``), else planned here from the count.
    ``state`` is not changed."""
    if compat_hist(cfg):
        return _hist_losses_and_grads(cfg, state, batch, draws, drop_masks)
    cd = _dtype(cfg)
    bn_train = not deterministic(cfg)
    gen, disc = state.gen_params, state.disc_params
    real_a = batch["real_a"].float()
    seg_a = batch["seg_a"].float()
    mask_a = batch.get("mask_a")
    p2p_nets = cfg.use_pix2pix
    with _conv_precision(cd):
        fake, new_gbn = _gen_fwd(cfg, gen, state.gen_bn, real_a, drop_masks,
                                 cd)
        # the generator loss's D call: inference mode, pre-step state
        da_fake, _ = _disc_fwd(cfg, disc, state.disc_bn,
                               *((seg_a, fake) if p2p_nets
                                 else (fake, mask_a)), cd, False)
        if cfg.loss_mode == "sggan":
            g_loss = losses.gen_loss_sggan(
                da_fake, real_a, fake, seg_a, use_lsgan=cfg.use_lsgan,
                l1_lambda=cfg.L1_lambda, lg_lambda=cfg.Lg_lambda,
                l1_target=cfg.sggan_l1_target)
        elif cfg.loss_mode == "simple":
            g_loss = losses.gen_loss_simple(
                da_fake, fake, seg_a, alpha_recip=1.0 / cfg.ratio_gan2seg)
        else:
            g_loss = losses.gen_loss_p2p(da_fake, fake, seg_a)
        g_grads = _grads(g_loss, gen)

        fake_sg, mask_for_d, new_pool = fake.detach(), mask_a, state.pool
        if pools(cfg):
            items = {"fake": fake_sg}
            if not p2p_nets:
                items["mask"] = mask_a
            new_pool, pooled = pool_update(state.pool, items, draws)
            fake_sg, mask_for_d = pooled["fake"], pooled.get("mask")
        if p2p_nets:
            # batch norm couples the samples: two calls, real then fake,
            # threading the state
            da_real, dbn1 = _disc_fwd(cfg, disc, state.disc_bn, seg_a, seg_a,
                                      cd, bn_train)
            da_fake_s, new_dbn = _disc_fwd(cfg, disc, dbn1, seg_a, fake_sg,
                                           cd, bn_train)
        else:
            # one call over [real; fake]: instance norm is per sample, so
            # this equals two calls, with the convs at twice the batch
            both, new_dbn = _disc_fwd(cfg, disc, state.disc_bn,
                                      torch.cat([seg_a, fake_sg]),
                                      torch.cat([mask_a, mask_for_d]), cd,
                                      False)
            n = seg_a.shape[0]
            da_real, da_fake_s = both[:n], both[n:]
        if cfg.loss_mode == "sggan":
            d_loss = losses.disc_loss_sggan(da_real, da_fake_s,
                                            use_lsgan=cfg.use_lsgan)
        elif cfg.loss_mode == "simple":
            d_loss = losses.disc_loss_simple(da_real, da_fake_s)
        else:
            d_loss = losses.disc_loss_p2p(da_real, da_fake_s)
        d_grads = _grads(d_loss, disc)
    metrics = {"gen_loss": g_loss.detach(), "disc_loss": d_loss.detach()}
    return metrics, g_grads, d_grads, new_pool, (new_gbn, new_dbn)


def _hist_losses_and_grads(cfg, state: TrainState, batch,
                           plan: Optional[HistPlan], drop_masks):
    """``losses_and_grads`` with the fake history (the JAX step's
    ``compat_hist`` branch, step.py:189-229): this step's fakes written
    into the history at the planned rows, the generator loss over the
    whole history, the discriminator's over [seg; detached history] in
    one call."""
    cd = _dtype(cfg)
    gen, disc = state.gen_params, state.disc_params
    real_a = batch["real_a"].float()
    seg_a = batch["seg_a"].float()
    mask_a = batch["mask_a"]
    buf = state.pool.buffer["fake"]
    k, b = buf.shape[0], real_a.shape[0]
    if not isinstance(plan, HistPlan):
        plan = hist_plan(k, state.pool.count, b, buf.device)
    valid = plan.valid.bool()
    reps = -(-k // b)
    # the current batch's mask and seg gate every entry (the reference's
    # quirk, step.py:218-220)
    mask_h = mask_a.repeat(reps, 1, 1, 1)[:k]
    seg_h = seg_a.repeat(reps, 1, 1, 1)[:k]
    with _conv_precision(cd):
        fake, new_gbn = _gen_fwd(cfg, gen, state.gen_bn, real_a, drop_masks,
                                 cd)
        hist = torch.cat([buf, fake.to(buf.dtype)]).index_select(
            0, plan.rows)
        da_hist, _ = _disc_fwd(cfg, disc, state.disc_bn, hist, mask_h, cd,
                               False)
        g_loss = losses.gen_loss_p2p_hist(da_hist, hist, seg_h, valid)
        g_grads = _grads(g_loss, gen)
        hist = hist.detach()
        both, new_dbn = _disc_fwd(cfg, disc, state.disc_bn,
                                  torch.cat([seg_a, hist]),
                                  torch.cat([mask_a, mask_h]), cd, False)
        d_loss = losses.disc_loss_p2p_hist(both[:b], both[b:], valid)
        d_grads = _grads(d_loss, disc)
    metrics = {"gen_loss": g_loss.detach(), "disc_loss": d_loss.detach()}
    return (metrics, g_grads, d_grads,
            PoolState({"fake": hist}, plan.count), (new_gbn, new_dbn))


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    # 1 - decay ** count in f32, as optax computes it, on the count's device
    return 1 - torch.pow(decay, count.float())


@torch.no_grad()
def adam_update(net: torch.nn.Module, opt: AdamState,
                grads: Dict[str, torch.Tensor],
                lr: Union[float, torch.Tensor], beta1: float) -> AdamState:
    """One optax ``scale_by_adam`` update, then ``p += -lr * update``, all
    in place: ``net``'s parameters, ``opt``'s moments and count; returns
    ``opt``.  ``lr`` is a float or a 0-d f32 tensor on the parameters'
    device.  The order of operations is optax's."""
    names = list(opt.mu)
    params = dict(net.named_parameters())
    p = [params[k] for k in names]
    g = [grads[k] for k in names]
    mu = [opt.mu[k] for k in names]
    nu = [opt.nu[k] for k in names]
    torch._foreach_mul_(mu, beta1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - beta1))
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                               1 - ADAM_B2))
    opt.count.add_(1)
    mu_hat = torch._foreach_div(mu, _bias_correction(beta1, opt.count))
    den = torch._foreach_sqrt(torch._foreach_div(
        nu, _bias_correction(ADAM_B2, opt.count)))
    torch._foreach_add_(den, ADAM_EPS)
    upd = torch._foreach_div(mu_hat, den)
    torch._foreach_mul_(upd, -lr if isinstance(lr, torch.Tensor)
                        else -float(np.float32(lr)))
    torch._foreach_add_(p, upd)
    return opt


@torch.no_grad()
def _assign(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst``, a tree of the same
    dicts (BN states, pool buffers), keeping ``dst``'s storage."""
    for k, t in dst.items():
        if isinstance(t, dict):
            _assign(t, src[k])
        else:
            t.copy_(src[k])


@torch.no_grad()
def _ema_update(cfg, ema, gen: torch.nn.Module):
    """ema <- d * ema + (1 - d) * params, in f32, after the Adam step."""
    if ema is None or not cfg.gen_ema:
        return ema
    d = np.float32(cfg.gen_ema)
    params = dict(gen.named_parameters())
    e = list(ema.values())
    torch._foreach_mul_(e, float(d))
    torch._foreach_add_(e, torch._foreach_mul(
        [params[k].float() for k in ema], float(np.float32(1) - d)))
    return ema


def build_step_fn(cfg, axis_name: Optional[str] = None):
    """The step: ``(state, batch, lr, pool_draws, drop_masks=None) ->
    (state, metrics)``.

    batch: {"real_a": (B,H,W,3) [0,1] float, "seg_a": (B,H,W,3),
    "mask_a": (B,hm,wm,n_class) one-hot (unused by the pix2pix nets)};
    ``lr`` a float or a 0-d f32 tensor on the state's device;
    ``pool_draws`` from ``pool.pool_draws(generator, B, cfg.max_size)``,
    or a ``pool.PoolPlan`` of this update (unused, may be None, outside
    the sggan mode or with ``max_size`` 0; under ``compat_hist`` a
    ``pool.HistPlan`` or anything else, the update then planned from the
    count); ``drop_masks`` from
    ``dropout_masks(cfg, state.gen_params, generator, B)`` (None for the
    ResNet or under ``--dropout_mode keras_quirk``).  Every tensor of the
    state is updated in place (``state_tensors``); the returned state
    holds them, with the new step and pool count.  Metrics are device
    scalars.  Under ``--loss_mode cycle``, the cycle step
    (``cycle.build_cycle_step_fn``)."""
    if cfg.loss_mode == "cycle":
        from .cycle import build_cycle_step_fn
        return build_cycle_step_fn(cfg, axis_name)
    _require_ported(cfg, axis_name)

    def step_fn(state: TrainState, batch, lr: Union[float, torch.Tensor],
                pool_draws: Union[PoolDraws, PoolPlan, None],
                drop_masks: Optional[Sequence[torch.Tensor]] = None):
        metrics, g_grads, d_grads, pool, (gen_bn, disc_bn) = \
            losses_and_grads(cfg, state, batch, pool_draws, drop_masks)
        adam_update(state.gen_params, state.g_opt, g_grads, lr, cfg.beta1)
        adam_update(state.disc_params, state.d_opt, d_grads, lr, cfg.beta1)
        _assign(state.gen_bn, gen_bn)
        _assign(state.disc_bn, disc_bn)
        _ema_update(cfg, state.ema, state.gen_params)
        return _keep_pool(state, pool)._replace(step=state.step + 1), metrics

    return step_fn


def make_train_step(cfg):
    """The single-device step.  PyTorch runs it eagerly, with nothing to
    jit or donate (the step updates in place), so this is
    ``build_step_fn(cfg)``."""
    return build_step_fn(cfg)
