"""Every loss criterion of the reference, active and dormant, as pure
functions: port of ``sggan_tpu/losses.py`` (reference module.py:336-351,
model.py:114-166).

Active path (the reference's train step):
    gen_loss_p2p  = BCE(D(fake), 1) + 100 * L1(seg - fake)
    disc_loss_p2p = BCE(D(real), 1) + BCE(D(fake), 0)
SG-GAN objective (``Config.loss_mode="sggan"``):
    generator_loss     = criterionGAN(D(fake), 1) + L1_lambda * L1(anchor,
                         fake) + Lg_lambda * gradloss(fake, real, boundary)
    discriminator_loss = (criterionGAN(D(real), 1)
                          + criterionGAN(D(pool), 0)) / 2
    criterionGAN       = mse (LSGAN) if use_lsgan else sigmoid CE

Every loss reduces with a mean over all elements, in f32.
"""

from __future__ import annotations

import torch

from .ops.deriv import seg_boundary_weight, sobel_xy


# ---------------------------------------------------------------- criterions

def abs_criterion(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L1 — module.py:336-337."""
    return (a.float() - b.float()).abs().mean()


def mae_criterion(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """LSGAN MSE (misnamed 'mae' in the reference) — module.py:340-341."""
    return (logits.float() - target.float()).square().mean()


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """tf.nn.sigmoid_cross_entropy_with_logits, elementwise.  At a logit of
    exactly 0 the gradient follows JAX's subgradients (``maximum`` splits
    a tie, ``abs`` takes +1), so it is ``-z`` there as in the JAX package,
    not torch's ``1 - z``: the semantic discriminator's logits are exactly
    0 at init wherever its last instance norm sees a 1x1 plane (128x128
    and 32x32 inputs)."""
    x, z = logits.float(), labels.float()
    ax = torch.where(x >= 0, x, -x)
    return (torch.maximum(x, torch.zeros_like(x)) - x * z
            + torch.log1p(torch.exp(-ax)))


def sce_criterion(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid CE — module.py:344-345."""
    return sigmoid_ce(logits, labels).mean()


def bce_from_logits(labels: torch.Tensor,
                    logits: torch.Tensor) -> torch.Tensor:
    """Keras BinaryCrossentropy(from_logits=True): mean sigmoid CE
    (model.py:150,161)."""
    return sigmoid_ce(logits, labels).mean()


def gradloss_criterion(in_: torch.Tensor, target: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """Gradient-sensitive semantic loss — module.py:347-351: the mean of
    the boundary-weighted per-pixel mean |(|grad in| - |grad target|)|
    (Sobel)."""
    dxi, dyi = sobel_xy(in_)
    dxt, dyt = sobel_xy(target)
    d = (dxi.abs() - dxt.abs()).abs() + (dyi.abs() - dyt.abs()).abs()
    d = d.sum(-1, keepdim=True) / (2.0 * in_.shape[-1])
    return (weight * d).mean()


def criterion_gan(use_lsgan: bool):
    """model.py:64-67."""
    return mae_criterion if use_lsgan else sce_criterion


# ------------------------------------------------------------- active losses

P2P_LAMBDA = 100.0  # hard-coded in the reference (model.py:151)


def gen_loss_p2p(da_fake, fake_a, seg_a):
    """model.py:149-158."""
    gan = bce_from_logits(torch.ones_like(da_fake), da_fake)
    return gan + P2P_LAMBDA * abs_criterion(seg_a, fake_a)


def disc_loss_p2p(da_real, da_fake):
    """model.py:160-166."""
    return (bce_from_logits(torch.ones_like(da_real), da_real)
            + bce_from_logits(torch.zeros_like(da_fake), da_fake))


def _masked_entry_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over the valid entries of a (K, ...) history, each entry first
    reduced to its own mean."""
    per = x.reshape(x.shape[0], -1).float().mean(1)
    v = valid.float()
    return (per * v).sum() / torch.clamp_min(v.sum(), 1.0)


def gen_loss_p2p_hist(da_hist, hist, seg_hist, valid):
    """gen_loss_p2p over a fixed-shape fake-history buffer with a
    valid-prefix mask (Config.compat_fake_history, model.py:175-179)."""
    gan = _masked_entry_mean(sigmoid_ce(da_hist, torch.ones_like(da_hist)),
                             valid)
    l1 = _masked_entry_mean((seg_hist.float() - hist.float()).abs(), valid)
    return gan + P2P_LAMBDA * l1


def disc_loss_p2p_hist(da_real, da_hist, valid):
    """disc_loss_p2p with the fake branch over the history buffer."""
    return (bce_from_logits(torch.ones_like(da_real), da_real)
            + _masked_entry_mean(
                sigmoid_ce(da_hist, torch.zeros_like(da_hist)), valid))


# ------------------------------------------------ full SG-GAN objective

def gen_loss_sggan(da_fake, real_a, fake_a, seg_a, *, use_lsgan: bool,
                   l1_lambda: float, lg_lambda: float,
                   l1_target: str = "real"):
    """The dormant generator_loss (model.py:114-124) plus the paper's
    gradient-sensitive term.  ``l1_target`` "real" anchors the L1 to the
    photo as the dormant code does (model.py:122); "seg" to the seg map,
    like the active p2p loss (model.py:155).  The gradient term compares
    the fake's edges with the photo's, gated by the class-boundary map."""
    crit = criterion_gan(use_lsgan)
    g = crit(da_fake, torch.ones_like(da_fake))
    anchor = seg_a if l1_target == "seg" else real_a
    g = g + l1_lambda * abs_criterion(anchor, fake_a)
    if lg_lambda:
        w = seg_boundary_weight(seg_a)
        g = g + lg_lambda * gradloss_criterion(fake_a, real_a, w)
    return g


def disc_loss_sggan(da_real, da_fake_sample, *, use_lsgan: bool):
    """model.py:126-133."""
    crit = criterion_gan(use_lsgan)
    return (crit(da_real, torch.ones_like(da_real))
            + crit(da_fake_sample, torch.zeros_like(da_fake_sample))) / 2.0


# ------------------------------------------------------- simple (dormant)

def gen_loss_simple(da_fake, fake_a, seg_a, alpha_recip: float):
    """model.py:135-140."""
    gan = sce_criterion(da_fake, torch.ones_like(da_fake))
    seg = sce_criterion(fake_a, seg_a)
    return alpha_recip * gan + seg


def disc_loss_simple(da_real, da_fake_sample):
    """model.py:142-147."""
    return (sce_criterion(da_real, torch.ones_like(da_real))
            + sce_criterion(da_fake_sample, torch.zeros_like(da_fake_sample)))
