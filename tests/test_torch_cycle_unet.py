"""Port parity of the cycle-consistency mode (``--loss_mode cycle``),
the U-Net half: (b) of ``tests/_torch_cycle_common.py``'s docstring, the
U-Net cycle step with its four mask sets against ``sggan_tpu.train.cycle``
and six sets drawn apart breaking parity; then the two-domain trainer,
the EMA eval by ``--which_direction``, a checkpoint round trip and
``main`` (train, test both directions, resume), with the ResNet."""

import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from _torch_cycle_common import (B, N_CLASS, UNET, Config,  # noqa: E402,F401
                                 _hold_first_step, _jax_state, _run, bridge,
                                 one_thread, tcycle)
from sggan_tpu_torch import main as tmain  # noqa: E402
from sggan_tpu_torch.models.generator_resnet import GeneratorResnet  # noqa: E402
from sggan_tpu_torch.train import evaluate  # noqa: E402
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from test_torch_trainer import _assert_states_equal  # noqa: E402


@pytest.fixture(scope="module")
def unet_run():
    return _run(UNET, 1)


def test_unet_cycle_step_with_four_mask_sets_matches_jax(unet_run):
    _hold_first_step(unet_run, UNET)


def test_six_mask_sets_break_parity(unet_run, monkeypatch):
    """Drawing the identity calls' masks apart (six sets, not four) moves
    the generator loss far beyond the parity limit: the reuse of r3 and r4
    is what the port must reproduce."""
    _, jax_out, _, _, (tbatch, draws, masks) = unet_run
    cfg = Config(**UNET)
    ts = bridge.train_state_from_jax(
        cfg, jax.tree.map(np.asarray, _jax_state(UNET)))
    fresh = tcycle.cycle_dropout_masks(cfg, ts.gen_params,
                                       torch.Generator().manual_seed(9), B)
    calls = []

    def apart(module, args):
        calls.append(module)
        if len(calls) in (5, 6):  # G(b) and F(a): their own sets
            return (*args[:3], fresh[len(calls) - 3])
    hooks = [ts.gen_params[k].register_forward_pre_hook(apart)
             for k in ("a2b", "b2a")]
    m = tcycle.losses_and_grads(cfg, ts, tbatch, draws, masks)[0]
    for h in hooks:
        h.remove()
    assert len(calls) == 6
    jm = jax_out[0][1]["gen_loss"]
    # ten times the parity limit of test_unet_cycle_step_with_four_mask_sets
    assert abs(m["gen_loss"].item() - jm) > 1e-4 * abs(jm)


# ---------------------------------------------------------------------------
# the trainer, eval, checkpoints and the CLI on a two-domain PNG set

CLI = ["--img_height", "32", "--img_width", "32", "--ngf", "4", "--ndf", "4",
       "--segment_class", str(N_CLASS), "--batch_size", "2",
       "--compute_dtype", "float32", "--loss_mode", "cycle", "--use_resnet",
       "--max_size", "3", "--print_freq", "1"]


@pytest.fixture(scope="module")
def cycle_ds(tmp_path_factory):
    """4 trainA, 6 trainB (another seed) and 3 testA triplets of 64x64
    PNGs: an epoch is the shorter split's 2 steps."""
    root = tmp_path_factory.mktemp("datasets") / "city"
    for split, n, seed in (("trainA", 4, 0), ("trainB", 6, 1),
                           ("testA", 3, 2)):
        rng = np.random.default_rng(seed)
        for sub in ("", "_seg", "_seg_class"):
            os.makedirs(root / f"{split}{sub}")
        for i in range(n):
            for sub, shape, hi in (("", (64, 64, 3), 256),
                                   ("_seg", (64, 64, 3), 256),
                                   ("_seg_class", (64, 64), N_CLASS)):
                Image.fromarray(rng.integers(0, hi, shape, np.uint8)).save(
                    root / f"{split}{sub}" / f"v{i}.png")
    return str(root)


def _cfg(root, tmp_path, **kw):
    dirs = {f"{d}_dir": str(tmp_path / d)
            for d in ("checkpoint", "sample", "test", "log")}
    return Config(dataset_dir=root, image_height=32, image_width=32, ngf=4,
                  ndf=4, segment_class=N_CLASS, batch_size=2,
                  compute_dtype="float32", loss_mode="cycle",
                  use_resnet=True, max_size=3, epoch=1, print_freq=1,
                  gen_ema=0.5, **dirs).replace(**kw)


@pytest.fixture(scope="module")
def trained(cycle_ds, tmp_path_factory):
    """One epoch of Trainer.train on the resident pair, with --gen_ema."""
    tr = Trainer(_cfg(cycle_ds, tmp_path_factory.mktemp("run")),
                 device="cpu")
    tr.train()
    return tr


def test_resident_epoch_equals_host_epoch(trained, tmp_path, capsys):
    """Both splits resident, or two host iterators zipped (trainB's cut
    to trainA's length after its shuffle): the same batches, draws and
    steps, so the same state, bitwise."""
    ds_a, ds_b = trained._maybe_device_dataset()
    assert (len(ds_a), len(ds_b)) == (4, 6)
    assert " [*] training splits resident on device" in \
        capsys.readouterr().out
    assert trained.state.step == 2 and trained.state.pool.count == 3
    tr = Trainer(trained.cfg.replace(device_dataset_mb=0,
                                     log_dir=str(tmp_path / "log"),
                                     checkpoint_dir=str(tmp_path / "ck")),
                 device="cpu")
    tr.train()
    assert "resident" not in capsys.readouterr().out
    _assert_states_equal(trained.state, tr.state)


def test_gen_ema_shadows_both_and_eval_follows_the_direction(trained):
    state = trained.state
    assert state.ema.keys() == dict(state.gen_params.named_parameters()).keys()
    x = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(
        trained.generate(x), evaluate.generate(
            trained.cfg, evaluate.eval_generator(trained), x, "cpu"))
    outs = {}
    for direction, key in (("AtoB", "a2b"), ("BtoA", "b2a")):
        cfg = trained.cfg.replace(which_direction=direction)
        shadow = GeneratorResnet(ngf=4)
        shadow.load_state_dict({k[4:]: v for k, v in state.ema.items()
                                if k.startswith(key + ".")})
        want = evaluate.generate(cfg, shadow, x, "cpu")
        raw = evaluate.generate(cfg, state.gen_params[key], x, "cpu")
        assert np.abs(want - raw).max() > 1e-3
        tr = SimpleNamespace(cfg=cfg, state=state, _ema_gen=None)
        outs[direction] = evaluate.generate(
            cfg, evaluate.eval_generator(tr), x, "cpu")
        np.testing.assert_array_equal(outs[direction], want)
    assert np.abs(outs["AtoB"] - outs["BtoA"]).max() > 1e-3


def test_cycle_checkpoint_round_trip(trained, tmp_path):
    cfg = trained.cfg.replace(checkpoint_dir=str(tmp_path / "ck"))
    ckpt.save(trained.state, cfg.checkpoint_dir, cfg.dataset_dir, 2)
    fresh = Trainer(cfg, device="cpu")
    loaded = ckpt.load(fresh.state, cfg.checkpoint_dir, cfg.dataset_dir)
    _assert_states_equal(loaded, trained.state)
    assert set(loaded.pool.buffer) == {"fakes", "masks"}


def test_main_trains_tests_both_directions_and_resumes(cycle_ds, tmp_path,
                                                       monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    tmain.main(["--phase", "train", "--dataset_dir", cycle_ds, "--epoch",
                "1", *CLI], device="cpu")
    out = capsys.readouterr().out
    assert " [*] New training STARTED" in out and "Epoch: [ 0]" in out
    ck = tmp_path / "checkpoint" / "city"
    for part in ("gen", "disc", "train"):
        assert (ck / part / "cp-0000.pt").is_file()
    assert "a2b.c1.w" in torch.load(ck / "gen" / "cp-0000.pt",
                                    weights_only=True)["params"]
    fakes = {}
    for direction in ("AtoB", "BtoA"):
        tmain.main(["--phase", "test", "--dataset_dir", cycle_ds,
                    "--which_direction", direction, "--test_dir",
                    f"test_{direction}", *CLI], device="cpu")
        assert " [*] Load SUCCESS" in capsys.readouterr().out
        fakes[direction] = [np.asarray(Image.open(
            tmp_path / f"test_{direction}" / f"v{i}.png")) for i in range(3)]
        assert (tmp_path / f"test_{direction}" / "real_v0.png").is_file()
    assert any((a != b).any() for a, b in zip(fakes["AtoB"], fakes["BtoA"]))
    tmain.main(["--phase", "train", "--continue_train", "--dataset_dir",
                cycle_ds, "--epoch", "1", *CLI], device="cpu")
    assert " [*] Load SUCCESS" in capsys.readouterr().out
    assert torch.load(ck / "train" / "cp-0001.pt",
                      weights_only=True)["step"] == 4
