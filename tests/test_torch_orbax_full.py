"""The port's import of a full-width JAX checkpoint: the ResNet sggan
state at 256x512 (ngf and ndf 64, 34 classes, a pool of 50 at the default
bf16, the EMA on), made from numpy seeds on ``jax.eval_shape(init_state)``'s
tree (no JAX RNG, no compile) and saved by the JAX package's
``checkpoint.save``.  The port's ``checkpoint.load`` must give
``bridge.train_state_from_jax`` of the JAX package's own load bit for
bit.  The save's and the load's seconds and the bytes on disk are
printed, with this machine's CPU model: a host number, not a card's.
"""

import os
import time

import pytest

torch = pytest.importorskip("torch")

from sggan_tpu import config as jconfig  # noqa: E402
from sggan_tpu_torch import config as tconfig  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from test_torch_orbax import (assert_same, flat, jax_reference,  # noqa: E402
                              jax_state, save_jax)

FULL = ["--img_height", "256", "--img_width", "512", "--ngf", "64",
        "--ndf", "64", "--segment_class", "34", "--max_size", "50",
        "--use_resnet", "--loss_mode", "sggan", "--gen_ema", "0.999"]


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "an unknown CPU"


def test_full_width_state_loads_bit_for_bit(tmp_path):
    jcfg, cfg = jconfig.parse_args(FULL), tconfig.parse_args(FULL)
    state = jax_state(jcfg, seed=11)
    t0 = time.perf_counter()
    save_jax(state, tmp_path)
    t_save = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(tmp_path) for f in fs)
    template = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    t0 = time.perf_counter()
    got = ckpt.load(template, str(tmp_path), "city")
    t_load = time.perf_counter() - t0
    got_flat = flat(got)
    raw = sum(len(v[2]) for v in got_flat.values())
    print(f"full-width ResNet sggan state: {raw / 1e6:.1f} MB of tensors, "
          f"{nbytes / 1e6:.1f} MB on disk; the JAX package's save "
          f"{t_save:.2f} s, the port's load {t_load:.2f} s "
          f"({raw / 1e6 / t_load:.0f} MB/s) on {cpu_model()}")
    assert got.pool.buffer["fake"].dtype == torch.bfloat16
    assert tuple(got.pool.buffer["fake"].shape) == (50, 256, 512, 3)
    del template
    assert_same(got_flat, flat(jax_reference(state, tmp_path, cfg)))
