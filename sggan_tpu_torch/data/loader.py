"""Host input pipeline and the card-resident training split.

Everything above ``DeviceDataset`` is the port's own copy of the host half
of ``sggan_tpu/data/loader.py`` (numpy and PIL only), held to it by
``tests/test_torch_data.py``: the dataset contract, PNG decode with its
byte-budgeted cache, ``train_iterator`` with its prefetch thread and
``[plain, to-augment]`` flag layout, the test split.  ``DeviceDataset``
keeps a whole (host-downscaled) split on the device as uint8 tensors, and
a batch is an ``index_select`` there.  The text below is the JAX module's.

Host-side dataset scanning + decode + prefetching input pipeline.

Honours the reference's on-disk dataset contract (SURVEY §1):
    datasets/<name>/{trainA, trainA_seg, trainA_seg_class,
                     testA, testA_seg, testA_seg_class}
with identical basenames; path substitution by directory-name replace
(utils.py:121,146,169-170).

The reference loads, resizes, one-hots and augments every item serially on
the host inside the train loop (model.py:227-258).  Here the host does
PNG decode only, on a background thread that stays ahead of the device;
resize/one-hot/augment run device-side (preprocess.py).  With
use_augmentation, each source item yields a plain and an augmented sample,
doubling the effective batch exactly like model.py:240-244.

Decode is the real-data bottleneck on a 1-core host (~0.1 s per 2048x1024
PNG vs a ~10 ms device step share), so decoded triplets are kept in a
byte-budgeted LRU cache — epochs >= 2 skip PNG decode entirely — and batch
decode fans out over a small thread pool (PIL releases the GIL in its
codecs, so this also helps on multi-core hosts).
"""

from __future__ import annotations

import os
import queue
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from glob import glob
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils.images import imread

_cache_lock = threading.Lock()
_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
_cache_bytes = 0

_pool_lock = threading.Lock()
_decode_pool: Optional[ThreadPoolExecutor] = None


def _executor() -> ThreadPoolExecutor:
    global _decode_pool
    with _pool_lock:
        if _decode_pool is None:
            _decode_pool = ThreadPoolExecutor(
                max_workers=min(8, (os.cpu_count() or 1) * 4),
                thread_name_prefix="decode")
        return _decode_pool


@dataclass
class Dataset:
    root: str            # e.g. ./datasets/city
    split: str           # "trainA" | "testA"

    def files(self) -> List[str]:
        return sorted(glob(os.path.join(self.root, self.split, "*.*")))

    @staticmethod
    def seg_path(p: str, split: str) -> str:
        return p.replace(split, split + "_seg")

    @staticmethod
    def cls_path(p: str, split: str) -> str:
        return p.replace(split, split + "_seg_class")


def _downscale(img: np.ndarray, max_hw, nearest: bool = False) -> np.ndarray:
    """Host-side box/nearest downscale to at most max_hw.  The device
    preprocess resizes to the target anyway; pre-shrinking on the host
    cuts host->device transfer bytes, which dominate real-data training
    through this environment's remote device relay (PERF.md round 2)."""
    mh, mw = max_hw
    if img.shape[0] <= mh and img.shape[1] <= mw:
        return img
    from PIL import Image
    mode = Image.NEAREST if nearest else Image.BOX
    return np.asarray(Image.fromarray(img).resize((mw, mh), mode))


def _load_triplet(path: str, split: str, cache_bytes: int = 0,
                  max_hw: Optional[Tuple[int, int]] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    global _cache_bytes
    key = (path, split, max_hw)
    if cache_bytes:
        with _cache_lock:
            hit = _cache.get(key)
            if hit is not None:
                _cache.move_to_end(key)
                return hit
    img = imread(path)
    seg = imread(Dataset.seg_path(path, split))
    cls = imread(Dataset.cls_path(path, split))
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img[..., :3]
    seg = seg[..., :3] if seg.ndim == 3 else np.stack([seg] * 3, -1)
    if cls.ndim == 3:
        cls = cls[..., 0]
    if max_hw is not None:
        img = _downscale(img, max_hw)
        seg = _downscale(seg, max_hw)
        cls = _downscale(cls, max_hw, nearest=True)  # class ids: no mixing
    trip = (img.astype(np.uint8), seg.astype(np.uint8), cls.astype(np.uint8))
    for a in trip:
        a.setflags(write=False)  # cached arrays are shared — freeze them
    if cache_bytes:
        nb = sum(a.nbytes for a in trip)
        with _cache_lock:
            _cache[key] = trip
            _cache_bytes += nb
            while _cache_bytes > cache_bytes and _cache:
                _, old = _cache.popitem(last=False)
                _cache_bytes -= sum(a.nbytes for a in old)
    return trip


def load_batch(paths: List[str], split: str, cache_bytes: int = 0,
               max_hw: Optional[Tuple[int, int]] = None):
    """Decode a batch of triplets; all images in a dataset must share one
    source shape (true of the reference fixtures)."""
    if len(paths) > 1:
        trips = list(_executor().map(
            lambda p: _load_triplet(p, split, cache_bytes, max_hw), paths))
    else:
        trips = [_load_triplet(p, split, cache_bytes, max_hw)
                 for p in paths]
    return (np.stack([t[0] for t in trips]),
            np.stack([t[1] for t in trips]),
            np.stack([t[2] for t in trips]))


def train_iterator(root: str, batch_size: int, seed: int,
                   use_augmentation: bool = True, epoch: int = 0,
                   train_size: Optional[int] = None,
                   prefetch: int = 2, split: str = "trainA",
                   cache_mb: int = 0,
                   max_src_hw: Optional[Tuple[int, int]] = None,
                   process_index: int = 0, process_count: int = 1
                   ) -> Iterator[dict]:
    """One epoch of decoded uint8 batches, shuffled per epoch
    (model.py:220-221), prefetched on a background thread.

    Yields {"img": (B', sh, sw, 3) u8, "seg": ..., "cls": (B', sh, sw) u8,
            "aug": (B',) bool, "rows": (B',) i32} where B' = 2*batch_size
    when augmenting (plain + to-be-augmented duplicate, model.py:240-244).

    Multi-host: `batch_size` is the PER-PROCESS batch; every process
    shuffles the same global file list (seeded identically) and decodes
    only its contiguous slice of each global batch, so process slices
    concatenated in process order reconstruct exactly the single-process
    global batch.  "rows" carries each sample's position in the global
    effective batch ([plain_0..plain_{gB-1}, aug_0..aug_{gB-1}]) for
    preprocess_train's global-consistent per-sample randomness."""
    ds = Dataset(root, split)
    files = ds.files()
    rng = np.random.default_rng(seed + epoch)
    rng.shuffle(files)
    if train_size is not None:
        files = files[: int(train_size)]
    gbs = batch_size * process_count  # global batch of files
    n_batches = len(files) // gbs
    lo = process_index * batch_size

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        try:
            for b in range(n_batches):
                if stop.is_set():
                    return
                paths = files[b * gbs + lo: b * gbs + lo + batch_size]
                img, seg, cls = load_batch(paths, split,
                                           cache_bytes=cache_mb << 20,
                                           max_hw=max_src_hw)
                plain_rows = lo + np.arange(batch_size, dtype=np.int32)
                if use_augmentation:
                    img = np.concatenate([img, img])
                    seg = np.concatenate([seg, seg])
                    cls = np.concatenate([cls, cls])
                    aug = np.concatenate([np.zeros(batch_size, bool),
                                          np.ones(batch_size, bool)])
                    rows = np.concatenate([plain_rows, gbs + plain_rows])
                else:
                    aug = np.zeros(batch_size, bool)
                    rows = plain_rows
                q.put({"img": img, "seg": seg, "cls": cls, "aug": aug,
                       "rows": rows})
        finally:
            q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            yield item
    finally:
        stop.set()


def test_files(root: str) -> List[str]:
    return Dataset(root, "testA").files()


def load_test_triplet(path: str, cache_mb: int = 0,
                      max_hw: Optional[Tuple[int, int]] = None):
    return _load_triplet(path, "testA", cache_bytes=cache_mb << 20,
                         max_hw=max_hw)


def list_split(img_dir: str, seg_dir: str, replace_names=None):
    """Pair image/seg files by basename — parity with prepare_data.prepare's
    pairing stage (prepare_data.py:9-18)."""
    imgs = sorted(glob(os.path.join(img_dir, "*.png")))
    segs = set(glob(os.path.join(seg_dir, "*.png")))
    pairs = []
    for ip in imgs:
        base = os.path.basename(ip)
        if replace_names:
            base = base.replace(replace_names[0], replace_names[1])
        sp = os.path.join(seg_dir, base)
        if sp in segs:
            pairs.append((ip, sp))
    return pairs


class DeviceDataset:
    """A whole (host-downscaled) split resident on ``device`` as uint8
    tensors ``img`` (N, sh, sw, 3), ``seg`` (N, sh, sw, 3) and ``cls``
    (N, sh, sw); a batch is an ``index_select`` on the device, so a step
    moves no image bytes from the host.  The port of the JAX package's
    ``DeviceDataset`` (``sggan_tpu/data/loader.py``)."""

    def __init__(self, root: str, split: str,
                 max_hw: Optional[Tuple[int, int]] = None,
                 cache_mb: int = 0, train_size: Optional[int] = None,
                 device="cuda"):
        import torch
        files = Dataset(root, split).files()
        if train_size is not None:
            files = files[: int(train_size)]
        self.files = files
        img, seg, cls = load_batch(files, split,
                                   cache_bytes=cache_mb << 20,
                                   max_hw=max_hw)
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        self.img, self.seg, self.cls = put(img), put(seg), put(cls)
        self.nbytes = img.nbytes + seg.nbytes + cls.nbytes

    def __len__(self):
        return len(self.files)

    def batch(self, idxs, use_augmentation: bool) -> dict:
        """Gather of a batch on the device; ``idxs`` is an int64 tensor on
        the split's device (or anything ``torch.as_tensor`` takes).  With
        augmentation the batch is doubled into (plain, to-be-augmented)
        halves exactly like ``train_iterator`` / model.py:240-244."""
        import torch
        dev = self.img.device
        i = torch.as_tensor(idxs, dtype=torch.int64, device=dev)
        n = i.shape[0]
        if use_augmentation:
            i = torch.cat([i, i])
        aug = torch.arange(i.shape[0], device=dev) >= n if use_augmentation \
            else torch.zeros(n, dtype=torch.bool, device=dev)
        return {"img": self.img.index_select(0, i),
                "seg": self.seg.index_select(0, i),
                "cls": self.cls.index_select(0, i), "aug": aug}


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The per-epoch shuffle of ``n`` items (model.py:220-221), as
    ``train_iterator`` and the JAX package's device iterators draw it."""
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


def device_dataset_iterator(ds: DeviceDataset, batch_size: int, seed: int,
                            use_augmentation: bool = True, epoch: int = 0
                            ) -> Iterator[dict]:
    """Epoch iterator over a DeviceDataset with the same shuffle contract
    as train_iterator (per-epoch reshuffle, model.py:220-221).  The
    epoch's order goes to the device once; each batch slices it."""
    import torch
    order = torch.from_numpy(epoch_order(len(ds), seed, epoch)).to(
        ds.img.device)
    for b in range(len(ds) // batch_size):
        yield ds.batch(order[b * batch_size:(b + 1) * batch_size],
                       use_augmentation)
