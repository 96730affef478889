"""Segmentation scores: the port's own copy of the host half of
``sggan_tpu/metrics/scores.py`` (numpy only: ``fast_hist``,
``scores_from_hist``, ``scores``, ``scores_seg_fake``), held to it by
``tests/test_torch_data.py``, and ``hist_device``, the confusion matrix on
the device in torch.  The JAX module's text follows.

Segmentation quality metrics — capability parity with the reference's
metric.py:18-47 (confusion-matrix scores, lineage wkentaro/pytorch-fcn) and
metric.py:71-77 (scores_seg_fake label extraction).
"""

from __future__ import annotations

import numpy as np
import torch


def fast_hist(label_true: np.ndarray, label_pred: np.ndarray,
              n_class: int) -> np.ndarray:
    """n_class x n_class confusion matrix (rows: truth, cols: prediction);
    ignores truth labels outside [0, n_class) — metric.py:18-24."""
    lt = label_true.reshape(-1).astype(np.int64)
    lp = label_pred.reshape(-1).astype(np.int64)
    valid = (lt >= 0) & (lt < n_class)
    return np.bincount(n_class * lt[valid] + lp[valid],
                       minlength=n_class ** 2).reshape(n_class, n_class)


def scores_from_hist(hist: np.ndarray) -> dict:
    """metric.py:31-47 math on an accumulated confusion matrix."""
    n_class = hist.shape[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0)
                              - np.diag(hist))
        valid = hist.sum(axis=1) > 0
        mean_iu = np.nanmean(iu[valid]) if valid.any() else float("nan")
        freq = hist.sum(axis=1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    return {
        "Overall Acc": acc,
        "Mean Acc": acc_cls,
        "FreqW Acc": fwavacc,
        "Mean IoU": mean_iu,
        "Class IoU": dict(zip(range(n_class), iu)),
    }


def scores(label_trues, label_preds, n_class: int) -> dict:
    """Reference `scores` signature (metric.py:27-47): iterables of label
    maps -> metric dict."""
    hist = np.zeros((n_class, n_class), np.int64)
    for lt, lp in zip(label_trues, label_preds):
        hist += fast_hist(np.asarray(lt), np.asarray(lp), n_class)
    return scores_from_hist(hist)


def hist_device(label_true: torch.Tensor, label_pred: torch.Tensor,
                n_class: int) -> torch.Tensor:
    """The confusion matrix of one batch of label maps on their device
    (scores.py:65), int64: truth labels outside [0, n_class) are not
    counted, predictions are clipped into range.  Accumulate across
    batches with a running sum; finish with
    ``scores_from_hist(total.cpu().numpy())``."""
    lt = label_true.reshape(-1).to(torch.int64)
    lp = label_pred.reshape(-1).to(torch.int64)
    valid = (lt >= 0) & (lt < n_class)
    # invalid pixels go to one extra bin, dropped after the count
    idx = torch.where(valid, n_class * lt + torch.clamp(lp, 0, n_class - 1),
                      n_class * n_class)
    counts = torch.bincount(idx, minlength=n_class * n_class + 1)
    return counts[:n_class * n_class].reshape(n_class, n_class)


def scores_seg_fake(seg_image: np.ndarray, fake_img: np.ndarray,
                    compat_eval_overflow: bool = False):
    """Label extraction for the live eval pairing (metric.py:71-77): the
    'labels' are argmaxes over the RGB channel axis of the uint8-scaled
    images, taken on (N, C, W, H)-transposed tensors.

    seg_image: (N, H, W, 3) float in [0, 1]; fake_img: (N, H, W, 3) uint8
    (already inverse-transformed) or float.  Returns (gts, preds) as
    (N, W, H) int arrays.

    compat_eval_overflow reproduces metric.py:75 exactly: the fake at the
    live call site (model.py:363) is ALREADY uint8, and `255 * fake`
    under value-based casting wraps mod 256 before the argmax — so the
    reference effectively argmaxes (256 - x) % 256.  Scores produced with
    the flag on are comparable to reference-produced numbers; off (the
    default) argmaxes the raw channels (the obvious intent)."""
    seg = np.asarray(seg_image)
    # already-converted uint8 (e.g. the trainer's device-side
    # preprocess.seg_labels_u8, bit-exact twin of this conversion)
    seg_u8 = seg if seg.dtype == np.uint8 \
        else (255 * seg).astype(np.uint8)
    fake = np.asarray(fake_img)
    if fake.dtype != np.uint8:
        fake = (255 * fake).astype(np.uint8)
    if compat_eval_overflow:
        fake = (fake * np.uint8(255)).astype(np.uint8)  # wraps mod 256
    gts = np.argmax(seg_u8.transpose(0, 3, 2, 1), axis=1)
    preds = np.argmax(fake.transpose(0, 3, 2, 1), axis=1)
    return gts, preds
