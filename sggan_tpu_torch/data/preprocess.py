"""Preprocessing on the device, port of ``sggan_tpu/data/preprocess.py``.

The host decodes PNGs to uint8 only; everything else runs on the tensors'
device as the JAX program does:

    uint8 -> [0, 1] float -> antialiased resize to (H, W) -> per-sample
    affine augment (one bilinear gather, augment.py), conjugated into the
    output frame -> class map nearest-resized to the mask grid + one-hot
    -> joint random fliplr.

The randomness is explicit (``PreprocessDraws``, ``draw_preprocess``); see
augment.py.  Two resamplers follow ``jax.image`` exactly rather than
``F.interpolate``: the antialiased linear resize is ``scale_and_translate``
with a triangle kernel widened by the scale, its weights normalised per
output sample and built as ``jax.image.compute_weight_mat`` builds them,
applied as one matrix product per axis; the nearest resize samples input
``floor((i + 0.5) * in / out)`` in f32.  The products run in full f32
(TF32 off for their duration).

``fake_u8`` and ``seg_labels_u8`` convert on the device, bit-exact against
the host conversions.  ``fake_u8``'s error-free transformations are
separate eager ops: never put them under ``torch.compile`` or into a
fused kernel, which may contract or reassociate them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .augment import (AffineParams, PhotometricDraws, affine_warp,
                      conjugate_affine, draw_affine, draw_photometric,
                      photometric_augment, take_rows)

class PreprocessDraws(NamedTuple):
    """The draws of one ``preprocess_train`` call, one row per sample:
    the affine parameters in the square source frame of
    ``random_affine_params(k_geo, sh, sh)``, the photometric draws (None
    without ``photometric``) and the final joint fliplr."""
    affine: AffineParams
    photometric: Optional[PhotometricDraws]
    flip: torch.Tensor  # (B,) bool


def draw_rows(draws: PreprocessDraws, rows) -> PreprocessDraws:
    """The rows ``rows`` (a slice or an index tensor) of every draw."""
    return PreprocessDraws(
        take_rows(draws.affine, rows),
        None if draws.photometric is None
        else take_rows(draws.photometric, rows), draws.flip[rows])


def draw_preprocess(generator: torch.Generator, b: int, src_h: int,
                    out_hw, photometric: bool = False) -> PreprocessDraws:
    """The draws of ``preprocess_train`` for ``b`` rows of ``src_h``-high
    sources, on the generator's device."""
    affine = draw_affine(generator, b, src_h, src_h)
    pho = (draw_photometric(generator, b, *out_hw) if photometric
           else None)
    flip = torch.rand(b, generator=generator,
                      device=generator.device) < 0.5
    return PreprocessDraws(affine, pho, flip)


@contextlib.contextmanager
def _full_f32():
    """Matrix products in IEEE f32, as the JAX resize's HIGHEST
    precision; restores the caller's setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@functools.lru_cache(maxsize=16)
def _weights(m: int, n: int, device: str) -> torch.Tensor:
    """The (m, n) f32 weights of ``jax.image.compute_weight_mat`` for a
    linear, antialiased resize of an axis from m to n samples, built on
    the host once and kept on ``device`` (never written to)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n / m))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) \
        - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.from_numpy(
        np.where(inside[None, :], w, f32(0)).astype(f32)).to(device)


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Antialiased linear resize of (..., h, w, c) to (..., *hw, c), as
    ``jax.image.resize(method="linear", antialias=True)``; an axis whose
    size does not change is not touched, and a same-shape call returns
    ``x`` itself (preprocess.py:43)."""
    h, w = x.shape[-3:-1]
    if (h, w) == tuple(hw):
        return x
    with _full_f32():
        if h != hw[0]:
            x = torch.einsum("...hwc,hH->...Hwc", x,
                             _weights(h, hw[0], str(x.device)))
        if w != hw[1]:
            x = torch.einsum("...hwc,wW->...hWc", x,
                             _weights(w, hw[1], str(x.device)))
    return x


@functools.lru_cache(maxsize=16)
def _nearest_index(m: int, n: int, device: str) -> torch.Tensor:
    """``jax.image``'s nearest sampling of n out of m: floor((i + 0.5) *
    m / n) in f32, kept on ``device`` (never written to)."""
    f32 = np.float32
    idx = np.floor((np.arange(n, dtype=f32) + f32(0.5)) * f32(m) / f32(n))
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def _one_hot_mask(cls_u8: torch.Tensor, mask_hw, n_class: int
                  ) -> torch.Tensor:
    """(B, sh, sw) uint8 class map -> (B, mh, mw, n_class) f32 one-hot by
    nearest resize; ids outside [0, n_class) give all-zero rows, as
    ``jax.nn.one_hot`` does (preprocess.py:54)."""
    cls = cls_u8
    for axis, n in ((1, mask_hw[0]), (2, mask_hw[1])):
        m = cls.shape[axis]
        if m != n:
            cls = cls.index_select(axis,
                                   _nearest_index(m, n, str(cls.device)))
    ids = torch.arange(n_class, device=cls.device, dtype=torch.int32)
    return (cls.to(torch.int32)[..., None] == ids).to(torch.float32)


def _to_unit(u8: torch.Tensor) -> torch.Tensor:
    return u8.to(torch.float32) / 255.0


def _identity(b: int, device) -> torch.Tensor:
    return torch.eye(2, 3, device=device).expand(b, 2, 3)


def _augment_rows(img, seg, draws: PreprocessDraws, flags, src_h: int,
                  out_hw, photometric: bool):
    """The JAX ``one`` (preprocess.py:134-145) over a batch of rows: the
    square-frame affine conjugated into the output frame, the identity for
    unflagged rows, one warp of the [img, seg] concat, and the photometric
    chain on the flagged photos."""
    b = img.shape[0]
    p = conjugate_affine(draws.affine, (src_h, src_h), out_hw)
    f = flags[:, None, None]
    p = AffineParams(torch.where(f, p.matrix, _identity(b, img.device)),
                     torch.logical_and(flags, p.flip))
    both = affine_warp(torch.cat([img, seg], -1), p)
    im_out, sg_out = both[..., :3], both[..., 3:]
    if photometric:
        im_out = torch.where(flags[:, None, None, None],
                             photometric_augment(draws.photometric, im_out),
                             im_out)
    return im_out, sg_out


def preprocess_train(img_u8, seg_u8, cls_u8, draws: PreprocessDraws,
                     aug_flags, *, out_hw, mask_hw, n_class: int,
                     photometric: bool = False, global_b: int = 0,
                     sample_rows=None, aug_layout: str = "dynamic",
                     n_plain: Optional[int] = None) -> dict:
    """img_u8/seg_u8: (B, sh, sw, 3) uint8 tensors; cls_u8: (B, sh, sw)
    uint8; draws: ``draw_preprocess(generator, B, sh, out_hw,
    photometric)``; aug_flags: (B,) bool, which samples warp (and, with
    ``photometric``, get the seq1 chain on their photo).

    ``aug_layout`` is the JAX package's promise about ``aug_flags``
    (preprocess.py:84-103): "none" (no sample warps; plain rows pass
    through bit-exactly), "half" ([False]*(B/2) + [True]*(B/2), the layout
    every iterator emits: only the second half warps, with draw rows
    B/2..B-1) or "dynamic" (per-row select).  ``n_plain`` moves the cut
    of "half" to row ``n_plain``: a rank's block of a "half" global batch
    (``train/fused.py::make_batch_fn``) may hold more plain rows than
    augmented ones, or none of either.

    ``global_b`` and ``sample_rows`` (data parallelism, a process a shard;
    preprocess.py:105-113): ``draws`` are the draws of the global batch of
    ``global_b`` rows, and this call takes the rows ``sample_rows`` of
    them (the batch's positions in the global batch, the loader's
    ``rows``; ``range(B)`` by default), so each sample is augmented as one
    process preprocessing the whole global batch augments it.  Returns
    {"real_a", "seg_a", "mask_a"} f32 on the input's device, images in
    [0, 1]."""
    b, sh = img_u8.shape[:2]
    if global_b or sample_rows is not None:
        gb = global_b or b
        if draws.flip.shape[0] != gb:
            raise ValueError(f"draws of {draws.flip.shape[0]} rows for a "
                             f"global batch of {gb}")
        rows = torch.arange(b) if sample_rows is None else sample_rows
        draws = draw_rows(draws, torch.as_tensor(
            rows, dtype=torch.int64, device=draws.flip.device))
    flags = torch.as_tensor(aug_flags, dtype=torch.bool, device=img_u8.device)
    img = _resize(_to_unit(img_u8), out_hw)
    seg = _resize(_to_unit(seg_u8), out_hw)
    aug = functools.partial(_augment_rows, src_h=sh, out_hw=out_hw,
                            photometric=photometric)
    if aug_layout == "none":
        pass
    elif aug_layout == "half":
        if n_plain is None and b % 2:
            raise ValueError("aug_layout='half' needs an even batch")
        hb = b // 2 if n_plain is None else n_plain
        if hb < b:
            im2, sg2 = aug(img[hb:], seg[hb:],
                           draw_rows(draws, slice(hb, None)), flags[hb:])
            img = torch.cat([img[:hb], im2])
            seg = torch.cat([seg[:hb], sg2])
    elif aug_layout == "dynamic":
        img, seg = aug(img, seg, draws, flags)
    else:
        raise ValueError(f"unknown aug_layout {aug_layout!r}")

    mask = _one_hot_mask(cls_u8, mask_hw, n_class)

    # joint random fliplr, utils.py:201-204
    flip = draws.flip[:, None, None, None]
    img = torch.where(flip, img.flip(2), img)
    seg = torch.where(flip, seg.flip(2), seg)
    mask = torch.where(flip, mask.flip(2), mask)
    return {"real_a": img, "seg_a": seg, "mask_a": mask}


def preprocess_test(img_u8, seg_u8, cls_u8, *, out_hw, mask_hw,
                    n_class: int, with_masks: bool = True):
    """Direct resize to (H, W), full-resolution and mask-grid one-hots
    (preprocess.py:168).  Returns (img, seg, mask_full, mask_grid) f32,
    images in [0, 1]; with_masks=False returns None for both masks."""
    img = _resize(_to_unit(img_u8), out_hw)
    seg = _resize(_to_unit(seg_u8), out_hw)
    if not with_masks:
        return img, seg, None, None
    return (img, seg, _one_hot_mask(cls_u8, out_hw, n_class),
            _one_hot_mask(cls_u8, mask_hw, n_class))


def seg_labels_u8(seg: torch.Tensor) -> torch.Tensor:
    """``(255 * seg).astype(np.uint8)`` on the device, bit-exact: f32
    multiply, truncation to int32, then the wrap mod 256 that numpy's
    out-of-range cast makes (a float -> uint8 cast of such values is not
    defined on CUDA), preprocess.py:188."""
    v = torch.trunc(255.0 * seg.to(torch.float32)).to(torch.int32)
    return torch.remainder(v, 256).to(torch.uint8)


def fake_u8(x: torch.Tensor) -> torch.Tensor:
    """``(((float64(x) + 1) / 2) * 255).astype(uint8)`` (the host
    ``utils/images.py::inverse_transform``) in pure f32, bit-exact over
    [-1, 1]: TwoSum for x + 1, an exact halving, two Dekker products by
    255, and the truncation decided on the exact total (preprocess.py:201,
    where the proof is).  Each step is one eager op."""
    # the constants are exact in f32, and each op below computes in f32
    one, half, cc, split = 1.0, 0.5, 255.0, 4097.0  # split: 2**12 + 1
    x = x.to(torch.float32)
    # TwoSum(x, 1): s + e == x + 1 exactly
    s = torch.add(x, one)
    bp = torch.sub(s, x)
    e = torch.add(torch.sub(x, torch.sub(s, bp)), torch.rsub(bp, one))
    h_h = torch.mul(s, half)
    h_l = torch.mul(e, half)
    # Dekker product h_h * 255: p1 + p2 exact
    c = torch.mul(h_h, split)
    a_hi = torch.sub(c, torch.sub(c, h_h))
    a_lo = torch.sub(h_h, a_hi)
    p1 = torch.mul(h_h, cc)
    p2 = torch.add(torch.sub(torch.mul(a_hi, cc), p1), torch.mul(a_lo, cc))
    # Dekker product h_l * 255: q_h + q_l exact
    c2 = torch.mul(h_l, split)
    b_hi = torch.sub(c2, torch.sub(c2, h_l))
    b_lo = torch.sub(h_l, b_hi)
    q_h = torch.mul(h_l, cc)
    q_l = torch.add(torch.sub(torch.mul(b_hi, cc), q_h), torch.mul(b_lo, cc))
    # truncation decision on the exact total kk + r
    k = torch.trunc(p1)
    f = torch.sub(p1, k)
    up = torch.gt(f, half)
    g = torch.where(up, torch.sub(f, one), f)
    kk = torch.where(up, torch.add(k, one), k)
    r = torch.add(torch.add(torch.add(g, p2), q_h), q_l)
    low = torch.lt(r, -2.0 ** -33).to(torch.float32)
    out = torch.sub(kk, low)
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)


def make_preprocess_train(cfg):
    """``preprocess_train`` with the config bound (preprocess.py:261): the
    layout is "half" under ``use_augmentation`` (every iterator emits
    [plain, augmented] halves) and "none" otherwise."""
    return functools.partial(
        preprocess_train, out_hw=(cfg.image_height, cfg.image_width),
        mask_hw=cfg.mask_hw, n_class=cfg.segment_class,
        photometric=cfg.use_photometric,
        aug_layout="half" if cfg.use_augmentation else "none")
