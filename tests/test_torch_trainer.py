"""The port's trainer, checkpoints, eval and CLI on the CPU: 32x32, ngf and
ndf 4, 8 classes, 4 triplets of 64x64 PNGs, batch 2 doubled by
augmentation, f32.

* one epoch of ``Trainer.train`` equals ``fused.make_batch_fn`` and the
  step composed by hand from the same seeds, bitwise; the host iterator's
  epoch equals the resident split's;
* a checkpoint save and its ``--continue_train`` load round trip exactly,
  and a resume saves after the checkpoint it loaded;
* under ``--gen_ema`` the eval runs the EMA shadow: it equals a forward
  with the EMA weights and differs from one with the trained weights;
* ``hist_device`` equals the JAX package's ``fast_hist``;
* ``main`` dispatches train and test (the test passes ``device="cpu"``);
* no module of the port, and not chip_smoke.py, imports JAX or the JAX
  package."""

import ast
import importlib
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from sggan_tpu_torch import main as tmain  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.data.loader import DeviceDataset, epoch_order  # noqa: E402
from sggan_tpu_torch.data.preprocess import draw_preprocess  # noqa: E402
from sggan_tpu_torch.metrics.scores import hist_device  # noqa: E402
from sggan_tpu_torch.models.generator_resnet import GeneratorResnet  # noqa: E402
from sggan_tpu_torch.train import evaluate, fused  # noqa: E402
from sggan_tpu_torch.train.pool import pool_draws  # noqa: E402
from sggan_tpu_torch.train.step import (build_step_fn, init_state,  # noqa: E402
                                         pad_free_head)
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASS = 8
CLI = ["--img_height", "32", "--img_width", "32", "--ngf", "4", "--ndf", "4",
       "--segment_class", str(N_CLASS), "--batch_size", "2",
       "--compute_dtype", "float32", "--loss_mode", "sggan", "--use_resnet",
       "--max_size", "3", "--print_freq", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The nets here have 4 channels at 32x32: one thread runs them as fast
    as several, and it does not contend with the other test workers'
    threads for the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """4 train and 3 test triplets of 64x64 PNGs."""
    root = tmp_path_factory.mktemp("datasets") / "city"
    rng = np.random.default_rng(0)
    for split, n in (("trainA", 4), ("testA", 3)):
        for sub in ("", "_seg", "_seg_class"):
            os.makedirs(root / f"{split}{sub}")
        for i in range(n):
            for sub, shape, hi in (("", (64, 64, 3), 256),
                                   ("_seg", (64, 64, 3), 256),
                                   ("_seg_class", (64, 64), N_CLASS)):
                Image.fromarray(rng.integers(0, hi, shape, np.uint8)).save(
                    root / f"{split}{sub}" / f"v{i}.png")
    return str(root)


def _cfg(dataset, tmp_path, **kw):
    dirs = {f"{d}_dir": str(tmp_path / d)
            for d in ("checkpoint", "sample", "test", "log")}
    return Config(dataset_dir=dataset, image_height=32, image_width=32,
                  ngf=4, ndf=4, segment_class=N_CLASS, batch_size=2,
                  compute_dtype="float32", loss_mode="sggan",
                  use_resnet=True, max_size=3, epoch=1, print_freq=1,
                  **dirs).replace(**kw)


def _params(state):
    return {**{f"gen.{k}": v for k, v in state.gen_params.state_dict().items()},
            **{f"disc.{k}": v for k, v in
               state.disc_params.state_dict().items()}}


def _assert_states_equal(a, b):
    for x, y in ((_params(a), _params(b)), (a.g_opt.mu, b.g_opt.mu),
                 (a.g_opt.nu, b.g_opt.nu), (a.d_opt.mu, b.d_opt.mu),
                 (a.d_opt.nu, b.d_opt.nu), (a.pool.buffer, b.pool.buffer),
                 (a.ema or {}, b.ema or {})):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert (a.step, a.pool.count, a.g_opt.count, a.d_opt.count) \
        == (b.step, b.pool.count, b.g_opt.count, b.d_opt.count)


@pytest.fixture(scope="module")
def trained(dataset, tmp_path_factory):
    """One epoch of Trainer.train on the resident split, with --gen_ema."""
    cfg = _cfg(dataset, tmp_path_factory.mktemp("run"), gen_ema=0.5)
    tr = Trainer(cfg, device="cpu")
    tr.train()
    return tr


def test_epoch_equals_make_batch_and_step(trained, dataset):
    """The trainer's epoch is the port's batch assembly and step composed
    by hand: same seeds, same shuffle, same draws, bitwise."""
    cfg = trained.cfg
    state = init_state(cfg, torch.Generator().manual_seed(cfg.data_seed),
                       "cpu")
    data_gen = torch.Generator().manual_seed(cfg.data_seed)
    pool_gen = torch.Generator().manual_seed(cfg.data_seed)
    ds = DeviceDataset(dataset, "trainA", max_hw=(64, 64), device="cpu")
    make_batch, step_fn = fused.make_batch_fn(cfg), build_step_fn(cfg)
    order = torch.from_numpy(epoch_order(len(ds), cfg.data_seed, 0))
    b = cfg.batch_size
    for i in range(len(ds) // b):
        draws = draw_preprocess(data_gen, 2 * b, 64, (32, 32))
        batch = make_batch(ds.img, ds.seg, ds.cls, order[i * b:(i + 1) * b],
                           draws)
        state, _ = step_fn(state, batch, 1e-3,
                           pool_draws(pool_gen, 2 * b, cfg.max_size))
    assert state.step == 2
    _assert_states_equal(trained.state, state)


def test_host_iterator_epoch_equals_resident_epoch(trained, tmp_path,
                                                   capsys):
    """--device_dataset_mb 0 feeds the same batches through the host
    iterator, so the epoch ends in the same state."""
    tr = Trainer(trained.cfg.replace(device_dataset_mb=0,
                                     log_dir=str(tmp_path / "log"),
                                     checkpoint_dir=str(tmp_path / "ck")),
                 device="cpu")
    tr.train()
    assert "resident" not in capsys.readouterr().out
    _assert_states_equal(trained.state, tr.state)


def test_checkpoint_round_trip_and_resume(trained, tmp_path, capsys):
    cfg = trained.cfg.replace(checkpoint_dir=str(tmp_path / "ck"),
                              log_dir=str(tmp_path / "log"))
    ckpt.save(trained.state, cfg.checkpoint_dir, cfg.dataset_dir, 4)
    assert ckpt.latest_epoch(cfg.checkpoint_dir, cfg.dataset_dir) == 4
    name = os.path.basename(cfg.dataset_dir)
    for part in ("gen", "disc", "train"):
        assert os.path.isfile(tmp_path / "ck" / name / part / "cp-0004.pt")
    fresh = Trainer(cfg, device="cpu")
    _assert_states_equal(
        ckpt.load(fresh.state, cfg.checkpoint_dir, cfg.dataset_dir),
        trained.state)
    # --continue_train: loads cp-0004, resumes at its step, saves cp-0005
    tr = Trainer(cfg.replace(continue_train=True), device="cpu")
    tr.train()
    out = capsys.readouterr().out
    assert " [*] Load SUCCESS" in out and "New training" not in out
    assert tr.state.step == trained.state.step + 2
    assert ckpt.latest_epoch(cfg.checkpoint_dir, cfg.dataset_dir) == 5
    _assert_states_equal(
        ckpt.load(Trainer(cfg, device="cpu").state, cfg.checkpoint_dir,
                  cfg.dataset_dir), tr.state)
    with pytest.raises(ValueError, match="EMA"):
        ckpt.load(Trainer(cfg.replace(gen_ema=0.0), device="cpu").state,
                  cfg.checkpoint_dir, cfg.dataset_dir)


def test_gen_ema_eval_runs_the_shadow(trained):
    """Under --gen_ema the eval's fakes are the EMA weights' forward, and
    the trained weights' forward differs from them."""
    cfg, state = trained.cfg, trained.state
    x = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    ema_gen = GeneratorResnet(ngf=4)
    ema_gen.load_state_dict(state.ema)
    want = evaluate.generate(cfg, ema_gen, x, "cpu")
    raw = evaluate.generate(cfg, state.gen_params, x, "cpu")
    assert np.abs(want - raw).max() > 1e-3
    np.testing.assert_array_equal(trained.generate(x), want)
    # the epoch-end eval's fakes, through the device uint8 conversion
    fakes, score = trained.test_during_train(0)
    test = [np.asarray(Image.open(os.path.join(trained.root, "testA", f)))
            for f in ("v0.png", "v1.png", "v2.png")]
    x_test = torch.from_numpy(np.stack(test))
    from sggan_tpu_torch.data.preprocess import preprocess_test
    img, _, _, _ = preprocess_test(x_test, x_test, None, out_hw=(32, 32),
                                   mask_hw=cfg.mask_hw, n_class=N_CLASS,
                                   with_masks=False)
    np.testing.assert_array_equal(
        fakes, evaluate.generate(cfg, ema_gen, img, "cpu", as_u8=True))
    assert set(score) >= {"Overall Acc", "Mean IoU"}


def test_hist_device_matches_fast_hist():
    jscores = importlib.import_module("sggan_tpu.metrics.scores")
    r = np.random.default_rng(5)
    lt = r.integers(-2, N_CLASS + 2, (3, 17, 13))
    lp = r.integers(0, N_CLASS, (3, 17, 13))
    got = hist_device(torch.from_numpy(lt), torch.from_numpy(lp), N_CLASS)
    np.testing.assert_array_equal(got.numpy(),
                                  jscores.fast_hist(lt, lp, N_CLASS))


def test_main_dispatches_train_and_test(dataset, tmp_path, monkeypatch,
                                        capsys):
    """The CLI's train writes the reference's layout under the working
    directory, and its test loads the checkpoint and translates testA."""
    monkeypatch.chdir(tmp_path)
    tmain.main(["--phase", "train", "--dataset_dir", dataset, "--epoch", "1",
                *CLI], device="cpu")
    out = capsys.readouterr().out
    assert " [*] New training STARTED" in out and "Epoch: [ 0]" in out
    for part in ("gen", "disc", "train"):
        assert (tmp_path / "checkpoint" / "city" / part / "cp-0000.pt") \
            .is_file()
    assert list((tmp_path / "logs").glob("*/train/events.out.tfevents.*"))
    tmain.main(["--phase", "test", "--dataset_dir", dataset, *CLI],
               device="cpu")
    assert " [*] Load SUCCESS" in capsys.readouterr().out
    for i in range(3):
        assert (tmp_path / "test" / f"real_v{i}.png").is_file()
        assert (tmp_path / "test" / f"v{i}.png").is_file()
    assert (tmp_path / "sample").is_dir()


def test_main_without_a_gpu_is_an_error(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tmain.main(["--phase", "train", *CLI])
    assert not (tmp_path / "checkpoint").exists()


@pytest.mark.parametrize("cfg_kw,what", [
    (dict(mesh_data=2), "parallel"),
    (dict(mesh_space=2), "parallel")])
def test_trainer_refuses_what_is_not_ported(dataset, tmp_path, cfg_kw,
                                            what):
    with pytest.raises(NotImplementedError, match=what):
        Trainer(_cfg(dataset, tmp_path, **cfg_kw), device="cpu")


def test_trainer_trains_under_remat(dataset, tmp_path):
    """--remat through the trainer: the resident epoch's chunk loop (the
    step eagerly on the CPU) recomputes the resblocks in the backward, the
    eval runs the pre-padded head --remat defaults to; finite losses, the
    checkpoint, the eval's PNGs."""
    cfg = _cfg(dataset, tmp_path, remat=True)
    tr = Trainer(cfg, device="cpu")
    tr.train()
    assert tr.state.step == 2
    assert all(bool(torch.isfinite(p).all())
               for p in tr.state.gen_params.parameters())
    assert os.listdir(tmp_path / "checkpoint" / "city" / "gen")
    assert len(os.listdir(tmp_path / "test")) > 0
    assert pad_free_head(cfg) is False


def test_port_sources_import_no_jax():
    """The card's machine has no JAX: no module of sggan_tpu_torch, nor
    chip_smoke.py, imports jax or anything of sggan_tpu."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "sggan_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    bad = []
    for p in paths:
        for node in ast.walk(ast.parse(open(p).read(), p)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{p}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "sggan_tpu")]
    assert len(paths) > 20 and not bad, bad
