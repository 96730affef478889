"""Offline RGB->class-id conversion, the port's copy of
``sggan_tpu/data/segment_class.py``: in place of the reference's
per-pixel Python double loop over multiprocessing.Pool(8)
(segment_class.py:87-99), one vectorized lookup: pack RGB into a 24-bit
key and gather from a dense LUT.  numpy and PIL, no framework.

    python -m sggan_tpu_torch.data.segment_class datasets/gta/trainA_seg

Class map (segment_class.py:60-70): vehicles 1, pedestrians 2, cyclist 3,
roads 4, buildings 5, sky 6, tree 7, others 0.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np
from PIL import Image

NUM_SEG_MASKS = 8

# Cityscapes color -> coarse class id (segment_class.py:63-66)
CITYSCAPE_MAP = [
    ((128, 64, 128), 4), ((244, 35, 232), 4), ((250, 170, 160), 4),
    ((230, 150, 140), 4), ((70, 70, 70), 5), ((102, 102, 156), 5),
    ((190, 153, 153), 5), ((180, 165, 180), 5), ((150, 100, 100), 5),
    ((150, 120, 90), 5), ((107, 142, 35), 7), ((70, 130, 180), 6),
    ((220, 20, 60), 2), ((255, 0, 0), 2), ((0, 0, 142), 1),
    ((0, 0, 70), 1), ((0, 60, 100), 1), ((0, 0, 90), 1),
    ((0, 0, 110), 1), ((0, 0, 230), 3), ((119, 11, 32), 3),
]


def build_lut(color_map=CITYSCAPE_MAP) -> np.ndarray:
    """Dense 2^24-entry uint8 LUT keyed by (r<<16)|(g<<8)|b; unmapped
    colors -> 0 (the defaultdict(int) behaviour, segment_class.py:61)."""
    lut = np.zeros(1 << 24, np.uint8)
    for (r, g, b), cid in color_map:
        lut[(r << 16) | (g << 8) | b] = cid
    return lut


def rgb_to_class(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """(H, W, >=3) uint8 -> (H, W) uint8 class ids, vectorized."""
    rgb = img[..., :3].astype(np.uint32)
    keys = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    return lut[keys]


def preprocess_dir(src: str, lut: np.ndarray = None) -> int:
    """Convert every *_seg/*.png into *_seg_class/*.png, parity with
    preprocess_master (segment_class.py:76-99), without a process
    pool."""
    lut = build_lut() if lut is None else lut
    dst = src.replace("_seg", "_seg_class")
    os.makedirs(dst, exist_ok=True)
    n = 0
    for path in sorted(glob(os.path.join(src, "*.png"))):
        img = np.asarray(Image.open(path))
        cls = rgb_to_class(img, lut)
        Image.fromarray(cls, mode="L").save(
            path.replace("_seg", "_seg_class"))
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="RGB seg -> class-id converter")
    p.add_argument("src", nargs="?", default="datasets/gta/trainA_seg")
    args = p.parse_args(argv)
    n = preprocess_dir(args.src)
    print(f"converted {n} images from {args.src}")


if __name__ == "__main__":
    main()
