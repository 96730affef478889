"""Regenerate the committed Orbax fixtures under ``tests/golden/orbax/``
(not collected by pytest):

    JAX_PLATFORMS=cpu python tests/make_orbax_fixtures.py

A set of small PNG triplets (``dataset/city``: trainA, testA and, for the
cycle mode, trainB, each with its _seg and _seg_class) is made from a
seed.  For each case of ``CASES`` the JAX package's own CLI (``python
main.py --phase train``) trains one epoch of 2 steps on it and saves its
Orbax checkpoint ``cp-0000`` (gen, disc, train), which is kept under
``<case>/checkpoint/city/``.  Then, in this process, the JAX package's
test phase loads it and translates every testA image (its ``--phase
test`` forward, ``evaluate.generate``, in [-1, 1] before the uint8
conversion): ``<case>/test_fake.npy``.  ``<case>/fixture.json`` holds
the case's CLI flags and the SHA-256 of every leaf of the loaded state
in the port's JAX layout (``sggan_tpu_torch.utils.orbax.leaf_digests``),
which the port's load of the checkpoint must give bit for bit (``chip_smoke.py`` phase 38 on the
card, ``tests/test_torch_orbax_golden.py`` on the CPU).

The nets are the smallest the flags allow (ngf and ndf 1, a pool of one
slot) at 32x64, the PNGs' own size (no resize: the pix2pix pair's test
input is rounded to uint8 levels, where a resize's last bits would move
whole levels), f32, so the whole set stays
under 2 MB: most of it is Orbax's own metadata, a few hundred bytes a
leaf.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(HERE, "golden", "orbax")
DATASET = os.path.join(OUT, "dataset", "city")
N_CLASS = 4
EPOCH = 0  # the checkpoint number the JAX CLI's one epoch saves

COMMON = ["--img_width", "64", "--ngf", "1", "--ndf", "1",
          "--segment_class", str(N_CLASS), "--batch_size", "1",
          "--compute_dtype", "float32", "--print_freq", "1",
          "--max_size", "1", "--data_seed", "3"]
CASES = {
    "sggan_resnet_ema": ["--img_height", "32", "--loss_mode", "sggan",
                         "--use_resnet", "--gen_ema", "0.99"],
    "pix2pix_p2p": ["--img_height", "32", "--use_pix2pix", "--loss_mode",
                    "p2p"],
    "cycle_resnet": ["--img_height", "32", "--loss_mode", "cycle",
                     "--use_resnet"],
}
SPLITS = {"trainA": 2, "testA": 1, "trainB": 2}


def flags(case: str) -> list:
    """The case's CLI flags, the later of a repeated flag winning."""
    return COMMON + CASES[case]


def make_dataset(root: str = DATASET, seed: int = 0) -> None:
    from PIL import Image
    rng = np.random.default_rng(seed)
    for split, n in SPLITS.items():
        for sub in ("", "_seg", "_seg_class"):
            os.makedirs(os.path.join(root, split + sub), exist_ok=True)
        for i in range(n):
            for sub, shape, hi in (("", (32, 64, 3), 256),
                                   ("_seg", (32, 64, 3), 256),
                                   ("_seg_class", (32, 64), N_CLASS)):
                Image.fromarray(rng.integers(0, hi, shape, np.uint8)).save(
                    os.path.join(root, split + sub, f"v{i}.png"))


def jax_layout(state) -> dict:
    """A JAX ``TrainState`` with numpy leaves as the tree that the port's
    ``bridge.train_state_to_jax`` gives: the pool's buffers by name (a
    pool of one array as "fake") in f32, the counts and the step int32."""
    buf = state.pool.buffer
    if not isinstance(buf, dict):
        buf = {"fake": buf}

    def adam(opt):
        return {"count": np.int32(opt.count), "mu": opt.mu, "nu": opt.nu}
    return {"gen_params": state.gen_params, "gen_bn": state.gen_bn,
            "disc_params": state.disc_params, "disc_bn": state.disc_bn,
            "g_opt": adam(state.g_opt), "d_opt": adam(state.d_opt),
            "pool": {"buffer": {k: np.asarray(v, np.float32)
                                for k, v in buf.items()},
                     "count": np.int32(state.pool.count)},
            "step": np.int32(state.step), "ema": state.ema}


def run_case(case: str, work: str) -> None:
    import jax

    from sggan_tpu.config import parse_args
    from sggan_tpu.data.loader import load_test_triplet, test_files
    from sggan_tpu.data.preprocess import preprocess_test
    from sggan_tpu.train.trainer import Trainer
    from sggan_tpu.utils import checkpoint as ckpt
    from sggan_tpu_torch.utils.orbax import leaf_digests

    dirs = [x for d in ("checkpoint", "sample", "test", "log")
            for x in (f"--{d}_dir", os.path.join(work, d))]
    argv = ["--dataset_dir", DATASET, *flags(case), *dirs]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    subprocess.run([sys.executable, os.path.join(ROOT, "main.py"),
                    "--phase", "train", "--epoch", "1", *argv],
                   cwd=work, env=env, check=True)
    dst = os.path.join(OUT, case, "checkpoint", "city")
    shutil.rmtree(os.path.join(OUT, case), ignore_errors=True)
    for part in ("gen", "disc", "train"):
        shutil.copytree(os.path.join(work, "checkpoint", "city", part,
                                     f"cp-{EPOCH:04d}"),
                        os.path.join(dst, part, f"cp-{EPOCH:04d}"))

    # the test phase's load and forward (sggan_tpu/train/evaluate.py:202)
    cfg = parse_args(["--phase", "test", *argv])
    tr = Trainer(cfg)
    state = ckpt.load(tr.state, cfg.checkpoint_dir, cfg.dataset_dir)
    assert state is not None, "the JAX package loaded no checkpoint"
    tr.state = state
    fakes = []
    for path in test_files(tr.root):
        img_u8, seg_u8, cls_u8 = (a[None] for a in load_test_triplet(path))
        img, _, _, _ = preprocess_test(
            img_u8, seg_u8, cls_u8, out_hw=cfg.image_size,
            mask_hw=cfg.mask_hw, n_class=cfg.segment_class,
            with_masks=False)
        fakes.append(np.asarray(tr.generate(img), np.float32)[0])
    np.save(os.path.join(OUT, case, "test_fake.npy"), np.stack(fakes))
    tree = jax_layout(jax.tree.map(np.asarray, state))
    with open(os.path.join(OUT, case, "fixture.json"), "w") as f:
        json.dump({"flags": flags(case), "epoch": EPOCH,
                   "step": int(tree["step"]),
                   "test_files": [os.path.basename(p)
                                  for p in test_files(tr.root)],
                   "leaves": leaf_digests(tree)}, f, indent=1,
                  sort_keys=True)
        f.write("\n")


def main() -> None:
    sys.path.insert(0, ROOT)
    shutil.rmtree(DATASET, ignore_errors=True)
    make_dataset()
    for case in (sys.argv[1:] or CASES):
        with tempfile.TemporaryDirectory() as work:
            run_case(case, work)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(OUT) for f in fs)
    print(f"fixtures under {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
