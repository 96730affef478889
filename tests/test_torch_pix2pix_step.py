"""Port parity of the pix2pix pair (``--use_pix2pix``) in training, split
from ``tests/test_torch_pix2pix.py`` (the nets): one p2p train step
against the JAX step (dropout on, masks fed; the discriminator's two
calls threading its BN state; the generator loss's call on the pre-step
state): losses, gradients, Adam moments and both new BN states held as
tests/test_torch_step.py's ``_close`` holds the ResNet's; ``--dropout_mode
keras_quirk``; the train state's bridge round trip with its BN states, a
checkpoint that carries them, ``main`` and the service with
``--use_pix2pix``.  The JAX step is compiled as one program without
XLA's LLVM passes, as tests/test_torch_step.py compiles its step."""

import io

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.train import pool as jpool  # noqa: E402
from sggan_tpu.train import step as jstep  # noqa: E402
from sggan_tpu_torch import main as tmain  # noqa: E402
from sggan_tpu_torch import serve  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.models.generator_pix2pix import (  # noqa: E402
    GeneratorPix2pix)
from sggan_tpu_torch.train import evaluate  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from test_torch_pix2pix import (B, CLI, H, KW, LR, RNG, W,  # noqa: E402
                                _bn_close, _compile, _np, _pix2pix_masks)
from test_torch_step import _close  # noqa: E402
from test_torch_trainer import _assert_states_equal, dataset  # noqa: E402,F401
from test_torch_unet import _Opt  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """4-channel nets at 32x32: one torch thread runs them as fast as
    several and does not contend with the other test workers (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(cfg):
    """A JAX TrainState whose nets and BN states are the port's seeded
    init, with optax's state and the p2p pool (one slot)."""
    tree = bridge.train_state_to_jax(
        tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu"))
    tx = jstep._tx(cfg.beta1)
    gp, dp = tree["gen_params"], tree["disc_params"]
    return jstep.TrainState(gp, tree["gen_bn"], dp, tree["disc_bn"],
                            tx.init(gp), tx.init(dp),
                            jpool.pool_init(1, (H, W, 3)),
                            jnp.zeros((), jnp.int32), None)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    return {"real_a": r.uniform(size=(B, H, W, 3)).astype(np.float32),
            "seg_a": r.uniform(size=(B, H, W, 3)).astype(np.float32),
            "mask_a": np.eye(8, dtype=np.float32)[
                r.integers(0, 8, (B, H // 8, W // 8))]}


@pytest.fixture(scope="module")
def pix2pix_step():
    """One step of each package from the same state and batch, the port
    fed the dropout masks that the JAX step draws from its key."""
    cfg = Config(**KW)
    js = _jax_state(JConfig(**KW))
    ts = bridge.train_state_from_jax(cfg, _np(js))
    batch = _batch()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    masks = _pix2pix_masks(jax.random.split(RNG)[0], ts.gen_params)
    grads = tstep.losses_and_grads(cfg, ts, tbatch, None, masks)
    js, jm = _compile(jstep.build_step_fn(JConfig(**KW)), js, batch,
                      jnp.float32(LR), RNG)
    ts, tm = tstep.build_step_fn(cfg)(ts, tbatch, LR, None, masks)
    return (grads, (_np(js), {k: float(v) for k, v in jm.items()}),
            (bridge.train_state_to_jax(ts), {k: v.item() for k, v in
                                             tm.items()}, ts))


def test_pix2pix_p2p_step_matches_jax(pix2pix_step):
    (metrics, g_grads, d_grads, _, (gbn, dbn)), (jstate, jm), \
        (tstate, tm, ts) = pix2pix_step
    for k in ("gen_loss", "disc_loss"):
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm, jm)
        assert abs(metrics[k].item() - tm[k]) <= 1e-5 * abs(tm[k])
    b1 = Config(**KW).beta1
    for grads, mu in ((g_grads, jstate.g_opt.mu), (d_grads, jstate.d_opt.mu)):
        ref = jax.tree.map(lambda m: np.asarray(m) / (1 - b1), mu)
        _close(bridge.params_to_jax(grads), ref, atol_of_max=2e-4)
    for name, opt in (("g_opt", jstate.g_opt), ("d_opt", jstate.d_opt)):
        assert tstate[name]["count"] == int(opt.count) == 1
        _close(tstate[name]["mu"], opt.mu, atol_of_max=2e-4)
        _close(tstate[name]["nu"], opt.nu)
    # both BN states: the generator's from its training forward, the
    # discriminator's from the real call then the fake call
    _close(tstate["gen_bn"], jstate.gen_bn)
    _close(tstate["disc_bn"], jstate.disc_bn)
    # losses_and_grads returns the states that the step keeps
    _bn_close(gbn, tstate["gen_bn"], rtol=0, atol=0)
    _bn_close(dbn, tstate["disc_bn"], rtol=0, atol=0)
    fresh = ts.disc_params.init_bn_state()
    assert ts.step == 1 and not torch.equal(
        dbn["conv_bn"]["moving_mean"], fresh["conv_bn"]["moving_mean"])


def test_pix2pix_keras_quirk_keeps_the_moving_stats():
    """--dropout_mode keras_quirk: no dropout, and every batch norm runs on
    its moving stats, which the step leaves as they were."""
    cfg = Config(**{**KW, "dropout_mode": "keras_quirk"})
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    before = bridge._bn_to_jax(ts.gen_bn), bridge._bn_to_jax(ts.disc_bn)
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    ts, m = tstep.build_step_fn(cfg)(ts, tbatch, LR, None)
    assert all(np.isfinite(v.item()) for v in m.values())
    _close(bridge._bn_to_jax(ts.gen_bn), before[0])
    _close(bridge._bn_to_jax(ts.disc_bn), before[1])


def test_pix2pix_train_state_bridge_round_trip(pix2pix_step):
    """The stepped port state to the JAX layouts and back: parameters,
    BN states and Adam moments equal."""
    *_, (tree, _, ts) = pix2pix_step
    cfg = Config(**KW)
    js = jstep.TrainState(tree["gen_params"], tree["gen_bn"],
                          tree["disc_params"], tree["disc_bn"],
                          _Opt(tree["g_opt"]), _Opt(tree["d_opt"]),
                          jpool.PoolState(ts.pool.buffer["fake"].numpy(),
                                          np.int32(ts.pool.count)),
                          np.int32(ts.step), None)
    back = bridge.train_state_from_jax(cfg, js)
    assert isinstance(back.gen_params, GeneratorPix2pix)
    _assert_states_equal(back, ts)
    for a, b in ((back.gen_bn, ts.gen_bn), (back.disc_bn, ts.disc_bn)):
        _bn_close(a, bridge._bn_to_jax(b), rtol=0, atol=0)


def test_checkpoint_carries_the_bn_states(pix2pix_step, tmp_path):
    *_, (_, _, ts) = pix2pix_step
    ckpt.save(ts, str(tmp_path), "city", 0)
    fresh = tstep.init_state(Config(**KW), torch.Generator(), "cpu")
    back = ckpt.load(fresh, str(tmp_path), "city")
    _assert_states_equal(back, ts)
    for a, b in ((back.gen_bn, ts.gen_bn), (back.disc_bn, ts.disc_bn)):
        _bn_close(a, bridge._bn_to_jax(b), rtol=0, atol=0)


def test_main_trains_and_tests_the_pix2pix_pair(dataset, tmp_path,
                                                monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    tmain.main(["--phase", "train", "--dataset_dir", dataset, "--epoch", "1",
                *CLI], device="cpu")
    out = capsys.readouterr().out
    assert " [*] New training STARTED" in out and "Epoch: [ 0]" in out
    gen = torch.load(tmp_path / "checkpoint" / "city" / "gen" / "cp-0000.pt",
                     weights_only=True)
    disc = torch.load(tmp_path / "checkpoint" / "city" / "disc" /
                      "cp-0000.pt", weights_only=True)
    assert "up0_bn" in gen["bn"] and "conv_bn" in disc["bn"]
    # the steps moved the stats from their init (mean 0)
    assert gen["bn"]["up0_bn"]["moving_mean"].abs().max() > 0
    tmain.main(["--phase", "test", "--dataset_dir", dataset, *CLI],
               device="cpu")
    assert " [*] Load SUCCESS" in capsys.readouterr().out
    assert (tmp_path / "test" / "v0.png").is_file()


def test_translate_with_pix2pix(tmp_path):
    cfg = Config(dataset_dir=str(tmp_path), image_height=H, image_width=W,
                 ngf=4, compute_dtype="float32", use_pix2pix=True)
    svc = serve._Service(cfg, device="cpu")
    assert isinstance(svc.gen, GeneratorPix2pix)
    assert set(svc.gen_bn) == set(svc.gen.init_bn_state())
    img = np.random.default_rng(3).integers(0, 256, (H, W, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    out = np.asarray(Image.open(io.BytesIO(svc.translate_png(
        buf.getvalue()))))
    gen = evaluate.build_generator(cfg)
    want = evaluate.generate(cfg, gen, img[None].astype(np.float32) / 255.0,
                             "cpu", gen_bn=gen.init_bn_state())
    assert out.shape == (H, W, 3)
    np.testing.assert_array_equal(
        out, ((want[0] + 1.0) / 2.0 * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="BN state"):
        evaluate.gen_forward(cfg, gen, torch.zeros(1, H, W, 3))
