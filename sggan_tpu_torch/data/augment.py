"""Augmentation with explicit draws, port of ``sggan_tpu/data/augment.py``.

The reference's imgaug seq2 (utils.py:80-103: Fliplr(0.5), Crop 20-40 %
per side with keep_size, Affine translate ±10 % / rotate ±1°) composes into
one 2x3 affine matrix applied with one bilinear gather over the channel
concat of image and seg, as in the JAX package; the dormant seq1
(utils.py:57-78) is ``photometric_augment``.

jax.random streams cannot be reproduced in torch, so the randomness is
explicit, as the pool's ``PoolDraws`` are: ``draw_affine`` and
``draw_photometric`` take a ``torch.Generator`` and return NamedTuples of
per-row tensors with the JAX package's distributions and ranges, and
``affine_warp`` and ``photometric_augment`` are pure functions of those
draws.  A test feeds both packages the draws that the JAX functions take
from their keys.

Every function works on a batch: images are (B, H, W, C) float tensors and
each draw has one row per image.  The arithmetic is written as separate
eager ops in the JAX graph's order (coordinates as f32 multiply-adds, never
a matrix product), so no op contracts a multiply and an add that the JAX
package keeps apart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AffineParams(NamedTuple):
    matrix: torch.Tensor  # (B, 2, 3) f32 output -> input coordinate map
    flip: torch.Tensor    # (B,) bool


class PhotometricDraws(NamedTuple):
    """One row per image of ``photometric_augment``'s draws."""
    blur_on: torch.Tensor            # (B,) bool, p 0.5
    sigma: torch.Tensor              # (B,) U(0, 0.5)
    alpha: torch.Tensor              # (B,) U(0.75, 1.5)
    noise_scale: torch.Tensor        # (B,) U(0, 0.05)
    noise_per_channel: torch.Tensor  # (B,) bool, p 0.5
    noise: torch.Tensor              # (B, H, W, C) N(0, 1)
    mult_per_channel: torch.Tensor   # (B,) bool, p 0.2
    mult: torch.Tensor               # (B, C) U(0.8, 1.2)


def take_rows(draws, rows):
    """The rows ``rows`` (a slice or an index tensor) of every tensor of a
    NamedTuple of draws."""
    return type(draws)(*(t[rows] for t in draws))


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return lo + u * (hi - lo)


def affine_matrix(crop: torch.Tensor, trans: torch.Tensor,
                  theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The (B, 2, 3) matrix of ``random_affine_params`` (augment.py:33-76)
    from its draws: per-side crop fractions (top, bottom, left, right)
    (B, 4), translations (dy, dx) (B, 2) as fractions of the size, and the
    rotation ``theta`` (B,) in radians.  Explicit scalar arithmetic in the
    JAX function's order."""
    top, bot, left, right = crop.unbind(1)
    sy = 1.0 - top - bot
    sx = 1.0 - left - right
    ty0 = top * h
    tx0 = left * w
    dty, dtx = trans.unbind(1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    rc_y = cos * cy + sin * cx
    rc_x = -sin * cy + cos * cx
    row0 = torch.stack([sy * cos, sy * sin,
                        sy * (cy - rc_y - dty * h) + ty0], 1)
    row1 = torch.stack([-sx * sin, sx * cos,
                        sx * (cx - rc_x - dtx * w) + tx0], 1)
    return torch.stack([row0, row1], 1)


def draw_affine(generator: torch.Generator, b: int, h: int, w: int,
                crop_lo: float = 0.2, crop_hi: float = 0.4,
                translate: float = 0.1,
                rotate_deg: float = 1.0) -> AffineParams:
    """``b`` rows of imgaug-seq2 parameters for (h, w) images, drawn on
    the generator's device: flip p 0.5, per-side crop U(crop_lo, crop_hi),
    translation U(±translate), rotation U(±rotate_deg) degrees."""
    u = torch.rand(b, 8, generator=generator, device=generator.device)
    crop = _uniform(u[:, 1:5], crop_lo, crop_hi)
    trans = _uniform(u[:, 5:7], -translate, translate)
    theta = _uniform(u[:, 7], -rotate_deg, rotate_deg) * math.pi / 180.0
    return AffineParams(affine_matrix(crop, trans, theta, h, w),
                        u[:, 0] < 0.5)


def conjugate_affine(params: AffineParams, src_hw, out_hw) -> AffineParams:
    """The same geometry on the out_hw grid: M' = D^-1 M D, c' = D^-1 c
    with D = diag(src / out) (augment.py:78)."""
    # d in f32, made on the device (no host copy per call)
    d = torch.where(torch.arange(2, device=params.matrix.device) == 0,
                    src_hw[0] / out_hw[0], src_hw[1] / out_hw[1])
    m, c = params.matrix[:, :, :2], params.matrix[:, :, 2]
    m2 = (m * d[None, None, :]) / d[None, :, None]
    c2 = c / d
    return AffineParams(torch.cat([m2, c2[:, :, None]], 2), params.flip)


def _grid(h: int, w: int, device) -> tuple:
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy.expand(h, w), xx.expand(h, w)


def affine_warp(img: torch.Tensor, params: AffineParams) -> torch.Tensor:
    """Apply each row's affine map to its image with one bilinear gather
    (augment.py:92): f32 coordinates by multiply-add, the four taps as row
    gathers from the (B·H·W, C) table, indices clipped to the border.
    img: (B, H, W, C) float.  Returns the same shape and dtype."""
    bsz, h, w, ch = img.shape
    dev = img.device
    yy, xx = _grid(h, w, dev)
    flip = params.flip[:, None, None]
    xx = torch.where(flip, (w - 1) - xx, xx)
    m = params.matrix[:, :, :, None, None]  # (B, 2, 3, 1, 1)
    y = m[:, 0, 0] * yy + m[:, 0, 1] * xx + m[:, 0, 2]
    x = m[:, 1, 0] * yy + m[:, 1, 1] * xx + m[:, 1, 2]
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0i, 0, h - 1)
    x0i = torch.clamp(x0i, 0, w - 1)
    flat = img.reshape(bsz * h * w, ch)
    base = (torch.arange(bsz, device=dev) * (h * w))[:, None, None]

    def g(yi, xi):
        return flat.index_select(0, (base + yi * w + xi).reshape(-1)) \
            .reshape(bsz, h, w, ch)

    return ((1 - wy) * (1 - wx) * g(y0i, x0i)
            + (1 - wy) * wx * g(y0i, x1i)
            + wy * (1 - wx) * g(y1i, x0i)
            + wy * wx * g(y1i, x1i))


def draw_photometric(generator: torch.Generator, b: int, h: int, w: int,
                     c: int = 3) -> PhotometricDraws:
    """``b`` rows of seq1 draws for (h, w, c) images, on the generator's
    device, with the JAX package's distributions (augment.py:159-195)."""
    dev = generator.device
    u = torch.rand(b, 6 + c, generator=generator, device=dev)
    noise = torch.randn(b, h, w, c, generator=generator, device=dev)
    return PhotometricDraws(
        blur_on=u[:, 0] < 0.5, sigma=_uniform(u[:, 1], 0.0, 0.5),
        alpha=_uniform(u[:, 2], 0.75, 1.5),
        noise_scale=_uniform(u[:, 3], 0.0, 0.05),
        noise_per_channel=u[:, 4] < 0.5, noise=noise,
        mult_per_channel=u[:, 5] < 0.2, mult=_uniform(u[:, 6:], 0.8, 1.2))


def _blur1d_5tap(x: torch.Tensor, kern: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """5-tap correlation along ``axis`` (1: H, 2: W of (B, H, W, C)) with
    edge padding, one kernel per row: kern (B, 5)."""
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(-2, n + 2, device=x.device), 0, n - 1)
    xp = x.index_select(axis, idx)
    k = kern[:, :, None, None, None]
    out = torch.zeros_like(x)
    for i in range(5):
        out = out + k[:, i] * xp.narrow(axis, i, n)
    return out


def photometric_augment(draws: PhotometricDraws,
                        img: torch.Tensor) -> torch.Tensor:
    """The seq1 analog (augment.py:136-200) on (B, H, W, C) images in
    [0, 1]: gaussian blur (5 taps, sigma U(0, 0.5), half the rows), linear
    contrast about imgaug's uint8 pivot 127, additive gaussian noise
    (per channel for half the rows), multiply (per channel for a fifth);
    each stage saturates to [0, 1]."""
    sigma = torch.where(draws.blur_on, draws.sigma,
                        torch.zeros_like(draws.sigma))
    r = torch.arange(-2, 3, dtype=torch.float32, device=img.device)
    raw = torch.exp(-0.5 * torch.square(
        r[None, :] / torch.clamp_min(sigma, 1e-6)[:, None]))
    ident = (r == 0).to(torch.float32)
    kern = torch.where((sigma > 1e-3)[:, None],
                       raw / torch.sum(raw, 1, keepdim=True), ident)
    img = _blur1d_5tap(_blur1d_5tap(img, kern, 1), kern, 2)

    pivot = 127.0 / 255.0
    alpha = draws.alpha[:, None, None, None]
    img = torch.clamp(pivot + alpha * (img - pivot), 0.0, 1.0)

    noise = torch.where(draws.noise_per_channel[:, None, None, None],
                        draws.noise, draws.noise[..., :1].expand_as(img))
    img = torch.clamp(img + draws.noise_scale[:, None, None, None] * noise,
                      0.0, 1.0)

    mult = torch.where(draws.mult_per_channel[:, None], draws.mult,
                       draws.mult[:, :1].expand_as(draws.mult))
    return torch.clamp(img * mult[:, None, None, :], 0.0, 1.0)

