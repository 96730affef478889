"""Port parity of the cycle-consistency mode (``--loss_mode cycle``):
``sggan_tpu_torch.train.cycle`` against ``sggan_tpu.train.cycle`` on the
CPU, f32, 32x32, b=2, ngf and ndf 4, 8 classes, pool 2, from one JAX
cycle ``TrainState`` bridged into the port, with the same batch (numpy
from a seed) and the pool draws the JAX step takes from its ``rng_pool``
key.

* (a) the ResNet cycle step with identity and gradient loss on, LSGAN:
  two steps (the second swaps pooled history);
* (b) the U-Net cycle step with the sigmoid cross entropy and dropout,
  the port fed the four mask sets that the JAX step draws from r1..r4
  (r3 for F(G(a)) and G(b), r4 for G(F(b)) and F(a)).

For each: the losses (rel 1e-5 after one step, 1e-4 after two), every
gradient of the four nets and the generators' first Adam moment under
``tests/test_torch_step.py``'s ``_close`` with ``atol_of_max`` 2e-4 (the
two packages' convolutions sum in other orders, see that file), the
discriminators' moments and the second moments at its plain limits, and
the pooled entries.  The JAX steps are compiled once each, without XLA's
LLVM passes, as ``test_torch_step.py`` compiles its step, each one
program that also returns the draws and masks it takes from its key.

The two packages' forwards differ by up to ~2e-4 (conv summation order,
rescaled by the instance norms), so a value that close to 0 where the
gradient takes its sign — a generator's or discriminator's gate, an L1's
or the gradient loss's abs — can fall on the other side in the other
package.  One such flip among the ~10^5 signs of a step moves whole
tensors' gradients by up to 3% of their largest: the gradient loss's
per-pixel terms have random signs and cancel to ~1/sqrt(N) of their sum.
At 32x64 every batch seed from 0 to 15 had one to five flips; at 32x32
the batches of seeds 9 (ResNet) and 10 (U-Net with the step's masks)
have none, so the comparison is between the same branches.  Without a
flip the ResNet step's gradients still differ by up to 1.6e-4 of a
tensor's largest (b2a.r8.in1.gamma; the U-Net's by under 5e-5): the
gradient that reaches a generator through the other one's backward
carries both nets' summation noise, so the limit holds it with little
room.

Port-only: the init's names, draw order and pool; ``max_size`` 0 passes
the entry through; four generator calls without the identity term;
six mask sets drawn apart break parity with (b); the EMA shadows both
generators and the eval runs the one of ``--which_direction``; the
resident two-domain epoch equals the host iterators'; ``main`` trains,
tests both directions and resumes; a checkpoint round trip."""

import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.train import cycle as jcycle  # noqa: E402
from sggan_tpu.train import pool as jpool  # noqa: E402
from sggan_tpu.train import step as jstep  # noqa: E402
from sggan_tpu_torch import main as tmain  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.models.generator_resnet import GeneratorResnet  # noqa: E402
from sggan_tpu_torch.train import cycle as tcycle  # noqa: E402
from sggan_tpu_torch.train import evaluate  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from test_torch_step import FAST, _close  # noqa: E402
from test_torch_trainer import _assert_states_equal  # noqa: E402

B, H, W, N_CLASS, POOL = 2, 32, 32, 8, 2
KW = dict(image_height=H, image_width=W, ngf=4, ndf=4, segment_class=N_CLASS,
          batch_size=B, max_size=POOL, compute_dtype="float32",
          loss_mode="cycle", L1_lambda=10.0, identity_lambda=5.0,
          Lg_lambda=5.0)
RESNET = dict(KW, use_resnet=True, use_lsgan=True)
UNET = dict(KW, use_resnet=False, use_lsgan=False, dropout_mode="intended")
# the batch seeds of (a) and (b): batches on which every sign the step's
# gradient follows agrees between the packages (the module docstring)
SEED = {True: 9, False: 10}
LR = 1e-3
RNGS = [jax.random.PRNGKey(30 + i) for i in range(2)]
MASK_C = 32  # the U-Net's d1-d3 width at ngf 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """4-channel nets at 32x32: one torch thread runs them as fast as
    several and does not contend with the other test workers (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    hm, wm = H // 8, W // 8
    out = {}
    for d in "ab":
        out[f"real_{d}"] = r.uniform(size=(B, H, W, 3)).astype(np.float32)
        out[f"seg_{d}"] = r.uniform(size=(B, H, W, 3)).astype(np.float32)
        out[f"mask_{d}"] = np.eye(N_CLASS, dtype=np.float32)[
            r.integers(0, N_CLASS, (B, hm, wm))]
    return out


def _jax_step(kw, masks: bool):
    """The JAX cycle step with, as further outputs of the same program, the
    pool draws it takes from its ``rng_pool`` key and, with ``masks``, the
    U-Net's dropout masks it draws from r1..r4 (three each, as
    generator_unet.py:96 splits its key)."""
    step = jcycle.build_cycle_step_fn(JConfig(**kw))

    def one(key, i):
        k_use, k_idx = jax.random.split(jax.random.fold_in(key, i))
        return (jax.random.uniform(k_use),
                jax.random.randint(k_idx, (), 0, POOL))

    def fn(state, batch, lr, rng):
        keys = jax.random.split(rng, 5)
        draws = jax.vmap(lambda i: one(keys[4], i))(jnp.arange(B))
        sets = None
        if masks:
            sets = [[jax.random.bernoulli(k, 0.5, (B, H, W, MASK_C))
                     for k in jax.random.split(keys[j], 3)]
                    for j in range(4)]
        return (*step(state, batch, lr, rng), draws, sets)
    return fn


def _jax_state(kw):
    """A JAX cycle TrainState whose nets are the port's seeded init (JAX's
    own RNG init costs seconds of XLA compile here), with optax's state and
    the JAX pair pool."""
    cfg = Config(**kw)
    tree = bridge.train_state_to_jax(
        tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu"))
    tx = jstep._tx(cfg.beta1)
    gp, dp = tree["gen_params"], tree["disc_params"]
    pool = jpool.pool_init(POOL, {"fakes": (2, H, W, 3),
                                  "masks": (2, H // 8, W // 8, N_CLASS)})
    return jstep.TrainState(gp, {}, dp, {}, tx.init(gp), tx.init(dp), pool,
                            jnp.zeros((), jnp.int32), None)


def _run(kw, n_steps: int):
    """``n_steps`` steps of each package from the same state and batch,
    the port fed the draws and masks of the JAX step's program; the
    port's first-step losses and grads apart."""
    cfg = Config(**kw)
    js = _jax_state(kw)
    np_state = lambda s: jax.tree.map(np.asarray, s)  # noqa: E731
    ts = bridge.train_state_from_jax(cfg, np_state(js))
    batch = _batch(SEED[cfg.use_resnet])
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jfn = jax.jit(_jax_step(kw, not cfg.use_resnet)).lower(
        js, batch, jnp.float32(LR), RNGS[0]).compile(FAST)
    tfn = tstep.build_step_fn(cfg)
    jax_out, port_out, first = [], [], None
    for rng in RNGS[:n_steps]:
        js, jm, (u, idx), sets = jfn(js, batch, jnp.float32(LR), rng)
        draws = tpool.PoolDraws(torch.from_numpy(np.array(u)),
                                torch.from_numpy(np.array(idx)).long())
        masks = None if sets is None else tuple(
            tuple(torch.from_numpy(np.array(m)) for m in s) for s in sets)
        if first is None:
            first = tcycle.losses_and_grads(cfg, ts, tbatch, draws, masks)
            fed = (tbatch, draws, masks)
        jax_out.append((np_state(js), {k: float(v) for k, v in jm.items()}))
        ts, tm = tfn(ts, tbatch, LR, draws, masks)
        port_out.append((bridge.train_state_to_jax(ts),
                         {k: v.item() for k, v in tm.items()}))
    return first, jax_out, port_out, ts, fed


@pytest.fixture(scope="module")
def resnet_run():
    return _run(RESNET, 2)


@pytest.fixture(scope="module")
def unet_run():
    return _run(UNET, 1)


def _hold_first_step(run, kw):
    (metrics, g_grads, d_grads, pool), jax_out, port_out, ts, _ = run
    (jstate, jm), (tstate, tm) = jax_out[0], port_out[0]
    for k in ("gen_loss", "disc_loss"):
        assert abs(metrics[k].item() - tm[k]) <= 1e-5 * abs(tm[k])
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm, jm)
    # optax's first moment after one step is (1 - beta1) * grad
    b1 = Config(**kw).beta1
    for grads, mu in ((g_grads, jstate.g_opt.mu), (d_grads, jstate.d_opt.mu)):
        ref = jax.tree.map(lambda m: np.asarray(m) / (1 - b1), mu)
        assert set(ref) == {"a2b", "b2a"} or set(ref) == {"da", "db"}
        _close(bridge.params_to_jax(grads), ref, atol_of_max=2e-4)
    for name, opt in (("g_opt", jstate.g_opt), ("d_opt", jstate.d_opt)):
        assert tstate[name]["count"] == int(opt.count) == 1
        _close(tstate[name]["mu"], opt.mu,
               atol_of_max=2e-4 if name == "g_opt" else 0.0)
        _close(tstate[name]["nu"], opt.nu)
    # the pool holds the step's (fake_a, fake_b) pair and (mask_b, mask_a)
    assert pool.count == int(jstate.pool.count) == POOL
    _close({k: v.numpy() for k, v in pool.buffer.items()},
           dict(jstate.pool.buffer), atol_of_max=2e-4)


def test_resnet_cycle_step_matches_jax(resnet_run):
    _hold_first_step(resnet_run, RESNET)


def test_resnet_cycle_step_under_remat_matches_jax_and_without(resnet_run):
    """--remat in the cycle step recomputes both generators' resblocks in
    the backward, the schedule and not the math (as
    tests/test_cycle.py::test_cycle_remat_matches holds the JAX package):
    losses and every gradient as the port's step without it (rtol 1e-6)
    and as the JAX step's at this file's limits, on the head of
    ``resnet_run`` (pad-free, set explicitly: --remat's default is the
    pre-padded one)."""
    (metrics, g_grads, d_grads, _), jax_out, _, _, fed = resnet_run
    kw = dict(RESNET, remat=True, pad_free_head=True)
    cfg = Config(**kw)
    ts = bridge.train_state_from_jax(
        cfg, jax.tree.map(np.asarray, _jax_state(RESNET)))
    m, g, d, _ = tcycle.losses_and_grads(cfg, ts, *fed)
    for k in m:
        assert m[k].item() == pytest.approx(metrics[k].item(), rel=1e-6)
    for got, ref in ((g, g_grads), (d, d_grads)):
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       rtol=1e-6, atol=0, err_msg=k)
    jstate, jm = jax_out[0]
    for k in ("gen_loss", "disc_loss"):
        assert abs(m[k].item() - jm[k]) <= 1e-5 * abs(jm[k]), (k, m, jm)
    b1 = cfg.beta1
    for grads, mu in ((g, jstate.g_opt.mu), (d, jstate.d_opt.mu)):
        ref = jax.tree.map(lambda v: np.asarray(v) / (1 - b1), mu)
        _close(bridge.params_to_jax(grads), ref, atol_of_max=2e-4)


def test_resnet_cycle_second_step_matches_jax_in_losses_and_pool(resnet_run):
    """Step 2 runs the full pool (max_size 2, batch 2) with the JAX
    step's draws, so the discriminators see swapped history.  Its fakes
    come from parameters that Adam's first update moved by lr * sign(g):
    where g is within the packages' noise of 0 the signs differ, so the
    parameters differ by up to 2 lr, and the pooled fakes by 1.6e-3 on
    this batch.  A slot that took the other item's pair differs by
    ~1, so 1e-2 holds the pool's choices."""
    _, jax_out, port_out, ts, _ = resnet_run
    for (_, jm), (_, tm) in zip(jax_out, port_out):
        for k in ("gen_loss", "disc_loss"):
            assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, tm, jm)
    jbuf = jax_out[-1][0].pool.buffer
    assert ts.step == 2 and ts.g_opt.count == ts.d_opt.count == 2
    assert ts.pool.count == int(jax_out[-1][0].pool.count) == POOL
    np.testing.assert_allclose(ts.pool.buffer["fakes"].numpy(),
                               jbuf["fakes"], rtol=0, atol=1e-2)
    np.testing.assert_array_equal(ts.pool.buffer["masks"].numpy(),
                                  jbuf["masks"])


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


def test_init_names_draw_order_and_pool():
    cfg = Config(**RESNET)
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    assert list(ts.gen_params) == ["a2b", "b2a"]
    assert list(ts.disc_params) == ["da", "db"]
    assert "a2b.c1.w" in ts.g_opt.mu and "db.h4.b" in ts.d_opt.nu
    assert ts.g_opt.mu.keys() == dict(ts.gen_params.named_parameters()).keys()
    assert ts.pool.buffer["fakes"].shape == (POOL, 2, H, W, 3)
    assert ts.pool.buffer["masks"].shape == (POOL, 2, H // 8, W // 8, N_CLASS)
    assert ts.pool.count == 0 and ts.ema is None and ts.gen_bn == {}
    # the JAX split order: a2b, b2a, da, db from one stream
    g = torch.Generator().manual_seed(0)
    want = [tstep.new_generator(cfg, g), tstep.new_generator(cfg, g),
            tstep.new_discriminator(cfg, g), tstep.new_discriminator(cfg, g)]
    got = [ts.gen_params["a2b"], ts.gen_params["b2a"], ts.disc_params["da"],
           ts.disc_params["db"]]
    for a, b in zip(got, want):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sb)
    bf16 = tstep.init_state(cfg.replace(compute_dtype="bfloat16",
                                        max_size=0), torch.Generator(), "cpu")
    assert bf16.pool.buffer["fakes"].dtype == torch.bfloat16
    assert bf16.pool.buffer["fakes"].shape[0] == 1


def test_max_size_zero_passes_the_entry_through():
    """With no pool the discriminators judge this step's pair, which is
    what a pool still filling hands them on the first step."""
    cfg = Config(**RESNET)
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    draws = tpool.pool_draws(torch.Generator().manual_seed(2), B, POOL)
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    filled = tcycle.losses_and_grads(cfg, ts, tbatch, draws)
    off = cfg.replace(max_size=0)
    ts0 = tstep.init_state(off, torch.Generator().manual_seed(0), "cpu")
    m, _, d_grads, pool = tcycle.losses_and_grads(off, ts0, tbatch, None)
    assert pool is ts0.pool and pool.count == 0
    assert m["disc_loss"] == filled[0]["disc_loss"]
    for k, v in d_grads.items():
        assert torch.equal(v, filled[2][k]), k
    assert filled[3].count == POOL


@pytest.mark.parametrize("identity,calls", [(5.0, 6), (0.0, 4)])
def test_identity_term_adds_two_generator_calls(identity, calls):
    cfg = Config(**dict(RESNET, identity_lambda=identity))
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    for k in ("a2b", "b2a"):
        ts.gen_params[k].register_forward_pre_hook(
            lambda mod, args, k=k: seen.append(k))
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    m, *_ = tcycle.losses_and_grads(
        cfg, ts, tbatch, tpool.pool_draws(torch.Generator(), B, POOL))
    assert seen == ["a2b", "b2a", "b2a", "a2b", "a2b", "b2a"][:calls]
    assert np.isfinite(m["gen_loss"].item())


def test_cycle_refuses_remat_and_meshes():
    """Meshes are not ported (--remat is: tests/test_torch_remat.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.init_state(Config(**dict(RESNET, mesh_data=2)),
                         torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.build_step_fn(Config(**RESNET), axis_name="data")
    with pytest.raises(ValueError, match="four dropout mask sets"):
        cfg = Config(**UNET)
        tcycle.losses_and_grads(
            cfg, tstep.init_state(cfg, torch.Generator(), "cpu"),
            {k: torch.from_numpy(v) for k, v in _batch().items()}, None)
    quirk = Config(**dict(UNET, dropout_mode="keras_quirk"))
    assert tstep.dropout_masks(quirk, tstep.init_state(
        quirk, torch.Generator(), "cpu").gen_params, torch.Generator(),
        B) is None


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
