"""The committed Orbax fixtures (``tests/golden/orbax/``, written by the
JAX package's own CLI through ``tests/make_orbax_fixtures.py``) held on
the CPU against the JAX package and the port, so that they cannot drift
from either:

- the JAX package's ``load`` of each checkpoint gives the per-leaf
  SHA-256 of its ``fixture.json``, and so does the port's
  ``checkpoint.load`` (through ``bridge.train_state_to_jax``);
- the JAX package's test-phase forward (``evaluate.gen_forward``, the EMA
  shadow where there is one, the a2b generator of the cycle mode) of the
  committed testA image gives ``test_fake.npy``, and so does the port's
  test phase (``Trainer`` on the CPU, f32, its ``generate``), each within
  1e-4: the JAX forward is compiled here without XLA's costly passes,
  which round apart from the fixture's by up to 3e-5.

And ``cycle_recon_eval`` scores the cycle fixture.  ``chip_smoke.py``
phase 38 takes the same fixtures through the port's CLI on the card:
resume, test and serve.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu import config as jconfig  # noqa: E402
from sggan_tpu.data.loader import load_test_triplet as jtriplet  # noqa: E402
from sggan_tpu.data.preprocess import preprocess_test  # noqa: E402
from sggan_tpu.train import evaluate as jeval  # noqa: E402
from sggan_tpu.train import step as jstep  # noqa: E402
from sggan_tpu.train.cycle import init_cycle_state  # noqa: E402
from sggan_tpu.utils import checkpoint as jckpt  # noqa: E402
from sggan_tpu_torch import config as tconfig  # noqa: E402
from sggan_tpu_torch.data.loader import load_test_triplet  # noqa: E402
from sggan_tpu_torch.train import evaluate  # noqa: E402
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from sggan_tpu_torch.utils.orbax import leaf_digests  # noqa: E402
from make_orbax_fixtures import CASES, DATASET, OUT, jax_layout  # noqa: E402
from test_torch_step import FAST  # noqa: E402

PORT_ATOL = 1e-4


def _fixture(case: str, work):
    """The fixture's record and the CLI flags of its run, writing under
    ``work``."""
    with open(os.path.join(OUT, case, "fixture.json")) as f:
        fx = json.load(f)
    argv = ["--dataset_dir", DATASET, *fx["flags"], "--checkpoint_dir",
            os.path.join(OUT, case, "checkpoint"),
            *(x for d in ("sample", "test", "log")
              for x in (f"--{d}_dir", os.path.join(str(work), d)))]
    return fx, argv


def _jax_side(case: str, pool) -> dict:
    """The JAX package's load of ``case``'s checkpoint (its leaves'
    digests) and its test-phase forward of the committed image, the
    forward's compile submitted to ``pool``."""
    fx, argv = _fixture(case, os.devnull)
    jcfg = jconfig.parse_args(["--phase", "test", *argv])
    init = init_cycle_state if jcfg.loss_mode == "cycle" \
        else jstep.init_state
    shapes = jax.eval_shape(lambda: init(jcfg, jax.random.PRNGKey(0)))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = jax.tree.map(np.asarray, jckpt.load(
        template, jcfg.checkpoint_dir, jcfg.dataset_dir))
    path = os.path.join(DATASET, "testA", fx["test_files"][0])
    img_u8, seg_u8, cls_u8 = (a[None] for a in jtriplet(path))
    img = np.asarray(preprocess_test(
        img_u8, seg_u8, cls_u8, out_hw=jcfg.image_size,
        mask_hw=jcfg.mask_hw, n_class=jcfg.segment_class,
        with_masks=False)[0])
    if jcfg.test_uint8_input:  # as evaluate.generate scales it
        img = np.round(img * 255.0)
    tr = SimpleNamespace(cfg=jcfg, cycle=jcfg.loss_mode == "cycle")
    args = (state.ema if state.ema is not None else state.gen_params,
            state.gen_bn, img)
    lowered = jax.jit(lambda p, bn, x: jeval.gen_forward(tr, p, bn, x)) \
        .lower(*args)
    return {"leaves": leaf_digests(jax_layout(state)), "args": args,
            "fwd": pool.submit(lowered.compile, FAST)}


@pytest.fixture(scope="module")
def jax_side():
    """Every fixture's JAX side, the forwards compiled side by side (XLA
    compiles outside the GIL)."""
    with ThreadPoolExecutor(len(CASES)) as pool:
        sides = {case: _jax_side(case, pool) for case in CASES}
        for side in sides.values():
            side["y"] = np.asarray(side.pop("fwd").result()(*side["args"]))
    return sides


@pytest.mark.parametrize("case", CASES)
def test_fixture_against_the_jax_package_and_the_port(case, jax_side,
                                                      tmp_path):
    fx, argv = _fixture(case, tmp_path)
    want = np.load(os.path.join(OUT, case, "test_fake.npy"))
    path = os.path.join(DATASET, "testA", fx["test_files"][0])

    # the JAX package: its load and its test-phase forward
    assert jax_side[case]["leaves"] == fx["leaves"]
    np.testing.assert_allclose(jax_side[case]["y"], want, rtol=0,
                               atol=PORT_ATOL)

    # the port: its load, then its test phase's forward
    cfg = tconfig.parse_args(["--phase", "test", *argv])
    t = Trainer(cfg, device="cpu")
    loaded = ckpt.load(t.state, cfg.checkpoint_dir, cfg.dataset_dir)
    assert leaf_digests(bridge.train_state_to_jax(loaded)) == fx["leaves"]
    t.state = loaded
    x, _ = evaluate._test_inputs(t, [load_test_triplet(path)])
    got = evaluate.generate(cfg, evaluate.eval_generator(t), x, t.device,
                            gen_bn=t.state.gen_bn)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=PORT_ATOL)


def test_cycle_recon_eval_scores_the_jax_cycle_fixture(tmp_path,
                                                       monkeypatch):
    """``python -m sggan_tpu_torch.cycle_recon_eval`` on the JAX package's
    cycle checkpoint: it loads it and scores both sides (testA, and
    trainB as the B side)."""
    from sggan_tpu_torch import cycle_recon_eval
    from sggan_tpu_torch.config import parse_args

    fx, _ = _fixture("cycle_resnet", tmp_path)
    ck = os.path.join(OUT, "cycle_resnet", "checkpoint")
    assert ckpt.source(ck, DATASET) == "JAX Orbax cp-0000"
    cfg = parse_args(fx["flags"])
    keys = ("use_resnet", "image_height", "image_width", "ngf", "ndf",
            "segment_class", "compute_dtype")
    monkeypatch.chdir(tmp_path)  # it works in the run's directory
    rec = cycle_recon_eval.main(
        [str(tmp_path), os.path.join(DATASET, "trainB"),
         f"checkpoint_dir={ck}", f"dataset_dir={DATASET}",
         *(f"{k}={getattr(cfg, k)}" for k in keys)], device="cpu")
    assert rec and all(np.isfinite(v) for v in rec.values()
                       if isinstance(v, float))
    assert os.path.isfile(tmp_path / "recon" / "a_fake_recon.png")
