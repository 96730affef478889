"""Offline dataset splitter, the port's copy of
``sggan_tpu/data/prepare_data.py`` (parity with the reference's
prepare_data.py): pair image and seg dirs by filename (the port's
``loader.list_split``), shuffle, copy the train and test splits into
datasets/<name>/{trainA,testA}{,_seg}.

    python -m sggan_tpu_torch.data.prepare_data -Ai images/ -As labels/ \
        -tr 2000 -te 500
"""

from __future__ import annotations

import argparse
import os
import random
import shutil

from .loader import list_split


def prepare(img_dir: str, seg_dir: str, img_target_dir: str,
            seg_target_dir: str, train_size: int, test_size: int,
            replace_names=None, seed: int = 0) -> int:
    pairs = list_split(img_dir, seg_dir, replace_names)
    print("candidates:", len(pairs))
    if len(pairs) < train_size + test_size:
        print("candidates not enough!")
        return 0

    for d in (img_target_dir, seg_target_dir):
        os.makedirs(d, exist_ok=True)
        os.makedirs(d.replace("train", "test"), exist_ok=True)

    random.Random(seed).shuffle(pairs)

    def copy(pair, img_dst, seg_dst):
        ip, sp = pair
        ib, sb = os.path.basename(ip), os.path.basename(sp)
        if replace_names:
            ib = ib.replace(replace_names[0], "")
            sb = sb.replace(replace_names[1], "")
        shutil.copy2(ip, os.path.join(img_dst, ib))
        shutil.copy2(sp, os.path.join(seg_dst, sb))

    for pair in pairs[:train_size]:
        copy(pair, img_target_dir, seg_target_dir)
    for pair in pairs[train_size:train_size + test_size]:
        copy(pair, img_target_dir.replace("train", "test"),
             seg_target_dir.replace("train", "test"))
    return train_size + test_size


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--A_imagepath", "-Ai", default="/data/playing/images/")
    p.add_argument("--A_segpath", "-As", default="/data/playing/labels/")
    p.add_argument("--train_size", "-tr", type=int, default=2000)
    p.add_argument("--test_size", "-te", type=int, default=500)
    p.add_argument("--out_img", default="./datasets/gta/trainA/")
    p.add_argument("--out_seg", default="./datasets/gta/trainA_seg/")
    a = p.parse_args(argv)
    prepare(a.A_imagepath, a.A_segpath, a.out_img, a.out_seg,
            a.train_size, a.test_size)


if __name__ == "__main__":
    main()
