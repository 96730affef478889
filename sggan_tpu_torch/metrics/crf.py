"""Dense-CRF label refinement, the port's copy of
``sggan_tpu/metrics/crf.py``: the reference's pydensecrf wrapper and its
five scoring adapters (metric.py:49-129), backed by the first-party C++
permutohedral lattice in ``native/crf/`` through ctypes.  It runs on the
host, as the JAX package runs it.

The library is built from ``native/crf/*.cpp`` with ``g++`` into
``sggan_tpu_torch/_build/`` at first use (``ops/_build.py::build_host``,
the Makefile's flags), never into ``native/crf/``, and the binary tracked
there is not loaded.  A build that fails raises with the compiler's
output: unlike the JAX package, nothing falls back to the O(N^2) numpy
mean field, which stays here as the plain twin the tests hold the library
to (``_mean_field_numpy``).

Constants match metric.py:11-16: 10 iterations, Gaussian (sxy=1, w=3),
bilateral (sxy=67, srgb=3, w=4).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

MAX_ITER = 10
POS_W = 3.0
POS_XY_STD = 1.0
Bi_W = 4.0
Bi_XY_STD = 67.0
Bi_RGB_STD = 3.0

NATIVE_FILES = ("densecrf.cpp", "permutohedral.cpp", "permutohedral.h")


def native_dir():
    from ..ops._build import _PKG
    return _PKG.parent / "native" / "crf"


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..ops._build import build_host
    path, _, _ = build_host("sgcrf", [native_dir() / f for f in NATIVE_FILES])
    lib = ctypes.CDLL(str(path))
    lib.dense_crf_2d.restype = ctypes.c_int
    lib.dense_crf_2d.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float)]
    lib.permutohedral_filter.restype = ctypes.c_int
    lib.permutohedral_filter.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def permutohedral_filter(features: np.ndarray, values: np.ndarray
                         ) -> np.ndarray:
    """High-dim Gaussian filter of ``values`` [n, vs] by ``features`` [n, d]
    through the native lattice (test and diagnostic entry)."""
    f = np.ascontiguousarray(features, np.float32)
    v = np.ascontiguousarray(values, np.float32)
    out = np.zeros_like(v)
    _lib().permutohedral_filter(_fptr(f), f.shape[0], f.shape[1], _fptr(v),
                                v.shape[1], _fptr(out))
    return out


def unary_from_softmax(probs: np.ndarray, clip: float = 1e-5) -> np.ndarray:
    """(C, H, W) class probabilities -> negative-log unary (pydensecrf
    utils.unary_from_softmax parity)."""
    return -np.log(np.clip(probs, clip, 1.0))


def _mean_field_numpy(unary_hwc: np.ndarray, img: Optional[np.ndarray],
                      n_iter: int) -> np.ndarray:
    """Brute-force O(N^2) mean field: the plain twin of the lattice, for
    small images."""
    h, w, c = unary_hwc.shape
    n = h * w
    yy, xx = np.mgrid[0:h, 0:w]
    pos = np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float64)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    # the self-interaction term stays: the lattice includes it, as the
    # reference's pydensecrf does
    kernels = [(POS_W, np.exp(-d2 / (2 * POS_XY_STD ** 2)))]
    if img is not None:
        rgb = img.reshape(n, 3).astype(np.float64)
        dr2 = ((rgb[:, None, :] - rgb[None, :, :]) ** 2).sum(-1)
        kernels.append((Bi_W, np.exp(-d2 / (2 * Bi_XY_STD ** 2)
                                     - dr2 / (2 * Bi_RGB_STD ** 2))))
    # symmetric normalization, as the lattice path
    u = unary_hwc.reshape(n, c)
    q = _softmax(-u)
    norms = [1.0 / np.sqrt(np.maximum(k.sum(1), 1e-20)) for _, k in kernels]
    for _ in range(n_iter):
        e = -u.copy()
        for (w_, k), nrm in zip(kernels, norms):
            e += w_ * (nrm[:, None] * (k @ (q * nrm[:, None])))
        q = _softmax(e)
    return q.reshape(h, w, c)


def _softmax(e):
    e = e - e.max(-1, keepdims=True)
    q = np.exp(e)
    return q / q.sum(-1, keepdims=True)


def dense_crf(img: Optional[np.ndarray],
              output_probs: np.ndarray) -> np.ndarray:
    """Reference signature (metric.py:49-69): img (H, W, 3) uint8 (None:
    the Gaussian kernel alone), output_probs (C, H, W) softmax scores ->
    refined (C, H, W), through the native lattice."""
    c, h, w = output_probs.shape
    unary = unary_from_softmax(output_probs)
    unary_hwc = np.ascontiguousarray(
        unary.transpose(1, 2, 0).reshape(h * w, c), np.float32)
    img_c = None
    if img is not None:
        img_c = np.ascontiguousarray(img[..., :3], np.uint8)
    out = np.zeros_like(unary_hwc)
    _lib().dense_crf_2d(
        _fptr(unary_hwc),
        img_c.ctypes.data_as(ctypes.c_void_p) if img_c is not None else None,
        w, h, c, MAX_ITER, POS_W, POS_XY_STD, Bi_W, Bi_XY_STD, Bi_RGB_STD,
        _fptr(out))
    return np.ascontiguousarray(out.reshape(h, w, c).transpose(2, 0, 1))


# ------------------------- scoring adapters (metric.py:79-129 parity) ----

def scores_mask_sample_crf(seg_mask_full, rescaled_sample):
    """true: argmax of the one-hot mask; pred: CRF(sample, mask)
    (metric.py:79-89)."""
    sample_u8 = np.asarray(rescaled_sample).astype(np.uint8)
    mask_u8 = np.asarray(seg_mask_full).astype(np.uint8).transpose(0, 3, 2, 1)
    labels = np.argmax(mask_u8, axis=1)
    q = dense_crf(sample_u8[0], mask_u8[0].astype(np.float32))
    preds = np.expand_dims(np.argmax(q, axis=0), 0)
    return labels, preds


def scores_fake_mask_crf(seg_mask_full, rescaled_sample, fake_img):
    """true: argmax of fake image channels; pred: CRF(sample, mask)
    (metric.py:92-102)."""
    sample_u8 = np.asarray(rescaled_sample).astype(np.uint8)
    mask_u8 = np.asarray(seg_mask_full).astype(np.uint8).transpose(0, 3, 2, 1)
    q = dense_crf(sample_u8[0], mask_u8[0].astype(np.float32))
    preds = np.expand_dims(np.argmax(q, axis=0), 0)
    fake_u8 = (255 * np.asarray(fake_img)).astype(np.uint8)
    labels = np.argmax(fake_u8.transpose(0, 3, 2, 1), axis=1)
    return labels, preds


def scores_mask_fake_crf(rescaled_sample, seg_mask_full, fake_img):
    """true: argmax of the mask; pred: CRF(sample, fake image channels)
    (metric.py:116-129)."""
    sample_u8 = np.asarray(rescaled_sample).astype(np.uint8)
    mask_u8 = np.asarray(seg_mask_full).astype(np.uint8).transpose(0, 3, 2, 1)
    fake_u8 = (255 * np.asarray(fake_img)).astype(np.uint8).transpose(
        0, 3, 2, 1)
    q = dense_crf(sample_u8[0], fake_u8[0].astype(np.float32))
    labels = np.argmax(mask_u8, axis=1)
    preds = np.expand_dims(np.argmax(q, axis=0), 0)
    return labels, preds


def scores_seg_da_fake(seg_image, da_fake, stride: int = 8):
    """true: argmax of seg channels; pred: nearest-upsampled discriminator
    output map (metric.py:105-114)."""
    da = np.asarray(da_fake)
    da_up = da.repeat(stride, axis=1).repeat(stride, axis=2)
    da_u8 = (255 * np.clip(da_up, 0, 1)).astype(np.uint8).transpose(0, 3, 2, 1)
    preds = da_u8[0]
    seg_u8 = (255 * np.asarray(seg_image)).astype(np.uint8)
    gts = np.argmax(seg_u8.transpose(0, 3, 2, 1), axis=1)
    return gts, preds
