"""Port parity of ``--compat_fake_history``: the port's p2p step with the
reference's fake history (``sggan_tpu_torch.train.step``, the CLI's
default nets: the U-Net with dropout and the semantic discriminator)
against ``sggan_tpu.train.step`` on the CPU, f32, 32x32, ngf and ndf 4,
at an effective batch of 2 (history of 11) and 4 (history of 13), from
one JAX ``TrainState`` bridged into the port, the port fed the dropout
masks that each JAX step draws from its key (returned by the same
program).

Over 7 steps (the count 2, 4, 6, 8, 10, then reset to 2, 4 at b_eff 2):
the losses at rel 1e-4, the count exactly, the history buffer at atol
1e-3, as tests/test_torch_step.py holds three steps of the pool.  The
gradients of step 1 and of step 4 (a history of 6 earlier fakes and this
step's) on the same state in both packages, the JAX ones read from its
Adam moments, at that file's ``_close`` limits.  The JAX step is compiled
once per batch, without XLA's LLVM passes.

Then, on the port alone: the chunk loop (``--scan_steps 3``) bitwise
equal to the per-step loop; ``train_state_from_jax`` and the checkpoint
carry the history and its count, and a resumed trainer continues the
count; ``--use_pix2pix`` ignores the flag, as in JAX."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.train import pool as jpool  # noqa: E402
from sggan_tpu.train import step as jstep  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from test_torch_step import FAST, _close  # noqa: E402
from test_torch_trainer import N_CLASS, _cfg, dataset  # noqa: E402,F401

H = W = 32
N_STEPS = 7
LR = 1e-3
KW = dict(image_height=H, image_width=W, ngf=4, ndf=4, segment_class=N_CLASS,
          batch_size=2, compute_dtype="float32", loss_mode="p2p",
          compat_fake_history=True)
# b_eff -> the flags that give it: batch 2, doubled or not
B_EFF = {2: dict(use_augmentation=False), 4: dict(use_augmentation=True)}
GRAD_STEPS = (0, 3)  # the steps whose gradients are held (0-based)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST)


def _batch(b: int) -> dict:
    r = np.random.default_rng(2)
    return {"real_a": r.uniform(size=(b, H, W, 3)).astype(np.float32),
            "seg_a": r.uniform(size=(b, H, W, 3)).astype(np.float32),
            "mask_a": np.eye(N_CLASS, dtype=np.float32)[
                r.integers(0, N_CLASS, (b, H // 8, W // 8))]}


def _jax_step(jcfg, b: int):
    """The JAX step with, as a further output of the same program, the
    d1-d3 keep masks it draws from its key (the generator's half, split
    three ways, as generator_unet.py:96 splits it)."""
    step = jstep.build_step_fn(jcfg)

    def fn(state, batch, lr, rng):
        masks = [jax.random.bernoulli(k, 0.5, (b, H, W, 32))
                 for k in jax.random.split(jax.random.split(rng)[0], 3)]
        return (*step(state, batch, lr, rng), masks)
    return fn


def _jax_state(cfg, jcfg):
    """A JAX TrainState of the port's seeded nets, optax's state and the
    history's buffer from the JAX initialiser."""
    tree = bridge.train_state_to_jax(
        tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu"))
    tx = jstep._tx(cfg.beta1)
    gp, dp = tree["gen_params"], tree["disc_params"]
    b_eff = jcfg.batch_size * (2 if jcfg.use_augmentation else 1)
    return jstep.TrainState(gp, {}, dp, {}, tx.init(gp), tx.init(dp),
                            jpool.pool_init(9 + b_eff, (H, W, 3)),
                            jnp.zeros((), jnp.int32), None)


@pytest.fixture(scope="module", params=sorted(B_EFF), ids=lambda b:
                f"b_eff{b}")
def runs(request):
    """N_STEPS steps of each package from one state; the port's gradients
    at GRAD_STEPS on the JAX state of that step, bridged."""
    b = request.param
    cfg, jcfg = Config(**KW, **B_EFF[b]), JConfig(**KW, **B_EFF[b])
    js = _jax_state(cfg, jcfg)
    np_state = lambda s: jax.tree.map(np.asarray, s)  # noqa: E731
    ts = bridge.train_state_from_jax(cfg, np_state(js))
    batch = _batch(b)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    rngs = [jax.random.PRNGKey(21 + i) for i in range(N_STEPS)]
    jfn = _compile(_jax_step(jcfg, b), js, batch, jnp.float32(LR), rngs[0])
    tfn = tstep.build_step_fn(cfg)
    jax_out, port_out, grads = [(np_state(js), None)], [], {}
    for i, rng in enumerate(rngs):
        js, jm, masks = jfn(js, batch, jnp.float32(LR), rng)
        m = [torch.from_numpy(np.array(x)) for x in masks]
        if i in GRAD_STEPS:
            grads[i] = tstep.losses_and_grads(
                cfg, bridge.train_state_from_jax(cfg, jax_out[-1][0]),
                tbatch, None, m)
        jax_out.append((np_state(js), {k: float(v) for k, v in jm.items()}))
        ts, tm = tfn(ts, tbatch, LR, None, m)
        port_out.append(({k: v.item() for k, v in tm.items()},
                         ts.pool.count,
                         ts.pool.buffer["fake"].clone().numpy()))
    return cfg, jax_out, port_out, grads


def test_history_step_matches_jax_in_losses_count_and_buffer(runs):
    cfg, jax_out, port_out, _ = runs
    b = cfg.batch_size * (2 if cfg.use_augmentation else 1)
    counts = []
    for (js, jm), (tm, count, buf) in zip(jax_out[1:], port_out):
        for k in ("gen_loss", "disc_loss"):
            assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, tm, jm)
        assert count == int(js.pool.count)
        np.testing.assert_allclose(buf, js.pool.buffer, rtol=0, atol=1e-3)
        counts.append(count)
    want = [2, 4, 6, 8, 10, 2, 4] if b == 2 else [4, 8, 12, 4, 8, 12, 4]
    assert counts == want
    assert port_out[-1][2].shape == (9 + b, H, W, 3)


@pytest.mark.parametrize("at", GRAD_STEPS)
def test_history_gradients_match_jax(runs, at):
    """The gradients of one step on the same state: JAX's are its Adam
    first moment's increment over (1 - beta1); the metrics at rel 1e-5."""
    cfg, jax_out, _, grads = runs
    metrics, g_grads, d_grads, pool, _ = grads[at]
    before, (after, jm) = jax_out[at][0], jax_out[at + 1]
    b1 = cfg.beta1
    for k in ("gen_loss", "disc_loss"):
        ref = jm[k]
        assert abs(metrics[k].item() - ref) <= 1e-5 * abs(ref), k
    for got, mu0, mu1 in ((g_grads, before.g_opt.mu, after.g_opt.mu),
                          (d_grads, before.d_opt.mu, after.d_opt.mu)):
        ref = jax.tree.map(lambda m1, m0: (np.asarray(m1)
                                           - b1 * np.asarray(m0)) / (1 - b1),
                           mu1, mu0)
        _close(bridge.params_to_jax(got), ref, atol_of_max=2e-4)
    assert pool.count == int(after.pool.count)


def test_history_gradient_reaches_only_this_steps_rows():
    """The history's earlier entries are constants: the generator's
    gradient is the same with them zeroed, when none is valid beyond this
    step's rows; and with a valid history the loss is the mean over the
    valid entries."""
    cfg = Config(**KW, **B_EFF[2])
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    masks = tstep.dropout_masks(cfg, ts.gen_params,
                                torch.Generator().manual_seed(1), 2)
    m0, g0, *_ = tstep.losses_and_grads(cfg, ts, tbatch, None, masks)
    ts.pool.buffer["fake"].uniform_(-1, 1)  # count 0: none of it is valid
    m1, g1, *_ = tstep.losses_and_grads(cfg, ts, tbatch, None, masks)
    assert m0["gen_loss"] == m1["gen_loss"]
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    ts = ts._replace(pool=ts.pool._replace(count=6))
    m2, *_, pool, _ = tstep.losses_and_grads(cfg, ts, tbatch, None, masks)
    assert pool.count == 8 and m2["gen_loss"] != m1["gen_loss"]


def test_hist_plan_matches_the_jax_update():
    """Rows, valid prefix and count of ``pool.hist_plan`` against the JAX
    step's dynamic_update_slice on a history of labelled entries."""
    k, b = 11, 2
    buf = np.arange(k, dtype=np.float32)
    fake = np.array([100.0, 101.0], np.float32)
    valid, rows, count = tpool.plan_hist_steps(k, 0, b, 8)
    c = 0
    for v, r in zip(valid, rows):
        offset = 0 if c >= 10 else c
        ref = np.asarray(jax.lax.dynamic_update_slice(
            jnp.asarray(buf), jnp.asarray(fake), (offset,)))
        np.testing.assert_array_equal(np.concatenate([buf, fake])[r], ref)
        np.testing.assert_array_equal(v, np.arange(k) < offset + b)
        c = offset + b
    assert count == c == 6  # 2, 4, 6, 8, 10, 2, 4, 6
    plan = tpool.hist_plan(k, 10, b, "cpu")
    assert plan.count == 2 and plan.valid.tolist() == [1, 1] + [0] * 9
    with pytest.raises(ValueError, match="cannot take"):
        tpool.hist_plan(k, 9, 3, "cpu")


def _hist_cfg(dataset, tmp_path, **kw):
    return _cfg(dataset, tmp_path, use_resnet=False, loss_mode="p2p",
                compat_fake_history=True, **kw)


def test_chunk_loop_equals_the_per_step_loop(dataset, tmp_path):
    """--scan_steps 3 over a resident split of 4 triplets at batch 1 (4
    steps: a chunk of 3 and a tail of 1) against --scan_steps 1, bitwise:
    losses, every state tensor, the history and its count."""
    out = []
    for k in (1, 3):
        tr = Trainer(_hist_cfg(dataset, tmp_path / f"k{k}", batch_size=1,
                               scan_steps=k, epoch=1), device="cpu")
        tr.train()
        out.append(tr)
    a, b = out
    assert a.state.pool.count == b.state.pool.count == 8
    assert a.state.step == b.state.step == 4
    ta, tb = tstep.state_tensors(a.state), tstep.state_tensors(b.state)
    assert ta.keys() == tb.keys()
    assert all(torch.equal(ta[k], tb[k]) for k in ta)


def test_bridge_and_checkpoint_carry_the_history(dataset, tmp_path):
    """The JAX history (buffer f32, count) becomes the port's through the
    bridge; the checkpoint round trips it; a resumed trainer continues the
    count where the saved run stopped."""
    cfg = Config(**KW, **B_EFF[2])
    js = _jax_state(cfg, JConfig(**KW, **B_EFF[2]))
    buf = np.random.default_rng(3).uniform(-1, 1, (11, H, W, 3)).astype(
        np.float32)
    js = js._replace(pool=jpool.PoolState(jnp.asarray(buf),
                                          jnp.asarray(6, jnp.int32)))
    ts = bridge.train_state_from_jax(cfg, jax.tree.map(np.asarray, js))
    assert ts.pool.count == 6
    assert ts.pool.buffer["fake"].dtype == torch.float32
    np.testing.assert_array_equal(ts.pool.buffer["fake"].numpy(), buf)
    ckpt.save(ts, str(tmp_path / "ck"), "city", 0)
    template = tstep.init_state(cfg, torch.Generator().manual_seed(1), "cpu")
    got = ckpt.load(template, str(tmp_path / "ck"), "city")
    assert got.pool.count == 6
    assert torch.equal(got.pool.buffer["fake"], ts.pool.buffer["fake"])

    run = _hist_cfg(dataset, tmp_path / "run", batch_size=1, epoch=1)
    tr = Trainer(run, device="cpu")
    tr.train()  # 4 steps of b_eff 2: count 8
    assert tr.state.pool.count == 8
    again = Trainer(run.replace(continue_train=True), device="cpu")
    again.train()  # 10, then 2, 4, 6
    assert again.state.pool.count == 6 and again.state.step == 8
    latest = ckpt.load(tstep.init_state(run, torch.Generator(), "cpu"),
                       run.checkpoint_dir, run.dataset_dir)
    assert latest.pool.count == 6


def test_pix2pix_ignores_the_flag_and_trains():
    """--use_pix2pix --loss_mode p2p --compat_fake_history trains as the
    plain p2p pix2pix step, as the JAX step's _compat_hist excludes the
    pix2pix nets: the one-slot pool, the same losses as without the
    flag."""
    kw = {**KW, "use_pix2pix": True, "image_height": 32, "image_width": 32}
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    out = []
    for flag in (True, False):
        cfg = Config(**{**kw, "compat_fake_history": flag})
        assert not tstep.compat_hist(cfg)
        ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
        assert ts.pool.buffer["fake"].shape[0] == 1
        masks = tstep.dropout_masks(cfg, ts.gen_params,
                                    torch.Generator().manual_seed(1), 2)
        ts, m = tstep.build_step_fn(cfg)(ts, tbatch, LR, None, masks)
        out.append({k: v.item() for k, v in m.items()})
        assert ts.step == 1 and all(np.isfinite(v) for v in out[-1].values())
    assert out[0] == out[1]
    assert jstep._compat_hist(JConfig(**kw)) is False
    assert tstep.compat_hist(Config(**KW)) is jstep._compat_hist(
        JConfig(**KW)) is True
