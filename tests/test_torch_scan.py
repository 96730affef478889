"""``--scan_steps`` on the CPU: what a CUDA graph of the step needs, held
where no card is.

* the step keeps every state tensor's storage (parameters, Adam's moments
  and count, the pool's buffer, batch norms' stats, the EMA) in each loss
  mode: the precondition of a graph, which replays on fixed addresses;
* Adam with its count a tensor and ``lr`` a device scalar against optax;
* the pool's K updates planned at once (``pool.plan_steps``) against K
  single updates and the JAX pool, through the filling phase and the
  full one;
* the trainer's chunk loop (``scan_steps`` 2 and 3) against the per-step
  loop (``scan_steps`` 1): the same eager ops on the CPU, so the losses
  and the state are bitwise equal; prints and saves land where the JAX
  chunk loop puts them (``sggan_tpu/train/fused.py:262-281``);
* ``--pad_free_head`` true, false or by default reaches the ResNet's
  head at every entry point.

32x32, ngf and ndf 4, 8 classes, one torch thread."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
from PIL import Image  # noqa: E402

from sggan_tpu.train import pool as jpool  # noqa: E402
from sggan_tpu_torch import serve  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.models import generator_resnet  # noqa: E402
from sggan_tpu_torch.models.generator_resnet import GeneratorResnet  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402

B, H, W, N_CLASS = 2, 32, 32, 8
BASE = dict(image_height=H, image_width=W, ngf=4, ndf=4,
            segment_class=N_CLASS, batch_size=B, max_size=3,
            compute_dtype="float32", gen_ema=0.5)
MODES = {
    "sggan_resnet": dict(loss_mode="sggan", use_resnet=True),
    "p2p_unet": dict(loss_mode="p2p", use_resnet=False,
                     dropout_mode="intended"),
    "pix2pix": dict(loss_mode="p2p", use_pix2pix=True,
                    dropout_mode="intended"),
    "cycle_resnet": dict(loss_mode="cycle", use_resnet=True),
}
# the pool's decisions are integer and select work, unchanged without
# XLA's LLVM passes (tests/test_torch_pool.py)
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """4-channel nets at 32x32, and bitwise comparisons: one torch thread,
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    r = np.random.default_rng(seed)
    hm, wm = cfg.mask_hw
    out = {}
    for d in ("a", "b") if cfg.loss_mode == "cycle" else ("a",):
        out[f"real_{d}"] = r.uniform(size=(B, H, W, 3))
        out[f"seg_{d}"] = r.uniform(size=(B, H, W, 3))
        out[f"mask_{d}"] = np.eye(N_CLASS)[r.integers(0, N_CLASS,
                                                      (B, hm, wm))]
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in out.items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_step_keeps_the_state_storage(mode):
    """Two steps: every tensor a step writes keeps its storage, and moves
    (the BN stats under pix2pix, the pool where the mode pools)."""
    cfg = Config(**BASE, **MODES[mode])
    g = torch.Generator().manual_seed(0)
    state = tstep.init_state(cfg, g, "cpu")
    before = {k: (t.data_ptr(), t.clone())
              for k, t in tstep.state_tensors(state).items()}
    step_fn = tstep.build_step_fn(cfg)
    lr = torch.tensor(1e-3)
    for i in range(2):
        draws = tpool.pool_draws(g, B, cfg.max_size)
        masks = tstep.dropout_masks(cfg, state.gen_params, g, B)
        state, m = step_fn(state, _batch(cfg, i), lr, draws, masks)
        assert all(torch.isfinite(v) for v in m.values())
    after = tstep.state_tensors(state)
    assert after.keys() == before.keys()
    for k, t in after.items():
        assert t.data_ptr() == before[k][0], k
    assert state.step == 2 and int(state.g_opt.count) == 2
    moved = {k for k, t in after.items() if not torch.equal(t,
                                                             before[k][1])}
    want = {"g_opt.count", "d_opt.count", "gen.", "disc.", "ema."}
    if tstep.pools(cfg):
        want.add("pool.")
    if cfg.use_pix2pix:
        want |= {"gen_bn.", "disc_bn."}
    assert all(any(k.startswith(w) for k in moved) for w in want), \
        sorted(want - {w for w in want if any(k.startswith(w)
                                              for k in moved)})


def test_adam_with_a_count_tensor_and_device_lr_matches_optax():
    """Three in-place updates with ``lr`` a 0-d tensor, against optax's
    scale_by_adam(eps=1e-7) and the step's -lr scaling, at
    test_adam_matches_optax's limits; the moments and the count keep
    their storage."""
    r = np.random.default_rng(1)
    params = {"a.w": r.standard_normal((3, 4, 2, 2)).astype(np.float32),
              "a.b": r.standard_normal(4).astype(np.float32)}
    grads = [{k: (r.standard_normal(v.shape) * 10.0 ** -r.integers(0, 8))
              .astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    net = torch.nn.Module()
    net.a = torch.nn.ParameterDict({k[2:]: torch.nn.Parameter(
        torch.from_numpy(v.copy())) for k, v in params.items()})
    opt = tstep.adam_init(net)
    ptrs = [t.data_ptr() for t in (opt.count, *opt.mu.values(),
                                   *opt.nu.values())]
    lr = 2e-3
    tx = optax.scale_by_adam(b1=0.5, b2=0.999, eps=1e-7)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = tx.init(jp)
    for g in grads:
        opt = tstep.adam_update(net, opt, {k: torch.from_numpy(v) for k, v
                                           in g.items()},
                                torch.tensor(lr, dtype=torch.float32), 0.5)
        upd, jo = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jo, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: -lr * u, upd))
    assert opt.count.dtype == torch.int32 and int(opt.count) == 3
    assert [t.data_ptr() for t in (opt.count, *opt.mu.values(),
                                   *opt.nu.values())] == ptrs
    got = dict(net.named_parameters())
    for k in params:
        np.testing.assert_allclose(got[k].detach().numpy(), jp[k],
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(opt.mu[k].numpy(), jo.mu[k], rtol=1e-6)
        np.testing.assert_allclose(opt.nu[k].numpy(), jo.nu[k], rtol=1e-6)


def _jax_draws(keys, b, max_size):
    """The draws ``jpool.pool_update`` takes from each of ``keys`` (per
    item i: ``split(fold_in(key, i))``), as PoolDraws."""
    def one(key, i):
        k_use, k_idx = jax.random.split(jax.random.fold_in(key, i))
        return (jax.random.uniform(k_use),
                jax.random.randint(k_idx, (), 0, max_size))
    ks = jnp.stack(keys)
    u, idx = jax.jit(lambda ks: jax.vmap(lambda k: jax.vmap(
        lambda i: one(k, i))(jnp.arange(b)))(ks)).lower(ks) \
        .compile(FAST)(ks)
    return [tpool.PoolDraws(torch.from_numpy(np.array(a)),
                            torch.from_numpy(np.array(c)).long())
            for a, c in zip(u, idx)]


def test_staged_pool_plan_matches_single_updates_and_jax():
    """Five updates of 2 items into 3 slots, planned at once: the first
    fills, the second fills the last slot and swaps, the rest swap.  Each
    planned update gives the outputs and buffer of the single update and
    of the JAX pool, and the count after the last."""
    shapes = {"fake": (4, 6, 3), "mask": (2, 3, 5)}
    keys = [jax.random.PRNGKey(40 + i) for i in range(5)]
    draws = _jax_draws(keys, B, 3)
    r = np.random.default_rng(5)
    items = [{"fake": r.standard_normal((B, 4, 6, 3)).astype(np.float32),
              "mask": np.eye(5, dtype=np.float32)[
                  r.integers(0, 5, (B, 2, 3))]} for _ in keys]
    out_rows, buf_rows, count = tpool.plan_steps(3, 0, draws)
    assert out_rows.shape == (5, B) and buf_rows.shape == (5, 3)
    staged = single = tpool.pool_init(3, shapes, device="cpu")
    jstate = jpool.pool_init(3, shapes)
    update = jax.jit(jpool.pool_update).lower(jstate, keys[0], items[0]) \
        .compile(FAST)
    for k, (key, it) in enumerate(zip(keys, items)):
        t_it = {n: torch.from_numpy(v) for n, v in it.items()}
        plan = tpool.PoolPlan(torch.from_numpy(out_rows[k]),
                              torch.from_numpy(buf_rows[k]), -1)
        staged, s_out = tpool.pool_update(staged, t_it, plan)
        single, o_out = tpool.pool_update(single, t_it, draws[k])
        jstate, j_out = update(jstate, key, it)
        for n in shapes:
            for a, b in ((staged.buffer[n], single.buffer[n]),
                         (s_out[n], o_out[n])):
                assert torch.equal(a, b), (k, n)
            np.testing.assert_array_equal(staged.buffer[n].numpy(),
                                          np.asarray(jstate.buffer[n]))
            np.testing.assert_array_equal(s_out[n].numpy(),
                                          np.asarray(j_out[n]))
    assert count == single.count == int(jstate.count) == 3


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """4 triplets in trainA and in trainB, 1 in testA, 64x64 PNGs."""
    root = tmp_path_factory.mktemp("datasets") / "city"
    rng = np.random.default_rng(7)
    for split, n in (("trainA", 4), ("trainB", 4), ("testA", 1)):
        for sub in ("", "_seg", "_seg_class"):
            os.makedirs(root / f"{split}{sub}")
        for i in range(n):
            for sub, shape, hi in (("", (64, 64, 3), 256),
                                   ("_seg", (64, 64, 3), 256),
                                   ("_seg_class", (64, 64), N_CLASS)):
                Image.fromarray(rng.integers(0, hi, shape, np.uint8)).save(
                    root / f"{split}{sub}" / f"v{i}.png")
    return str(root)


PRINT_FREQ, SAVE_FREQ = 2, 3


def _jax_chunk_events(nb: int, k: int, pf: int, sf: int):
    """The steps the JAX chunk loop prints at and the global steps it
    saves at, over one epoch of ``nb`` steps in chunks of ``k``
    (sggan_tpu/train/fused.py:262-281)."""
    prints, saves, done = [], [], 0
    while done < nb:
        kc = min(k, nb - done)
        if done == 0 or (done - 1) // pf != (done + kc - 1) // pf:
            prints.append(done + kc - 1)
        if done // sf != (done + kc) // sf:
            saves.append(done + kc)
        done += kc
    return prints, saves


def _train(dataset, tmp_path, mode, k, monkeypatch, capsys):
    """One epoch of 4 steps (batch 1 doubled), with every step's losses,
    the printed steps and the global steps of the saves."""
    dirs = {f"{d}_dir": str(tmp_path / f"{mode}_{k}" / d)
            for d in ("checkpoint", "sample", "test", "log")}
    cfg = Config(dataset_dir=dataset, **{**BASE, "batch_size": 1},
                 **MODES[mode], epoch=1, scan_steps=k,
                 print_freq=PRINT_FREQ, save_freq=SAVE_FREQ, **dirs)
    tr = Trainer(cfg, device="cpu")
    losses, saves, step_fn = [], [], tr.step_fn

    def recording(*args):
        state, m = step_fn(*args)
        losses.append(torch.stack([m["gen_loss"], m["disc_loss"]]).clone())
        return state, m
    monkeypatch.setattr(tr, "step_fn", recording)
    save = tr._save
    monkeypatch.setattr(tr, "_save", lambda epoch: (
        saves.append(tr.state.step), save(epoch)))
    capsys.readouterr()
    tr.train()
    out = capsys.readouterr().out
    prints = [int(ln.split("]")[1].strip(" [")) for ln in out.splitlines()
              if ln.startswith("Epoch: ")]
    return tr, torch.stack(losses), prints, saves


@pytest.mark.parametrize("mode,k", [("sggan_resnet", 2), ("sggan_resnet", 3),
                                    ("cycle_resnet", 3)])
def test_chunk_loop_equals_the_per_step_loop(dataset, tmp_path, mode, k,
                                             monkeypatch, capsys):
    """``scan_steps`` k against 1 on the resident split(s): the same steps
    on the same draws, so every loss and every state tensor bitwise
    equal, the step and the pool's count too; 4 steps in chunks of k (3
    leaves a tail of 1).  Prints and saves follow the JAX chunk loop's
    formula for k, and for 1, where it is the per-step loop's."""
    ref, ref_losses, ref_prints, ref_saves = _train(
        dataset, tmp_path, mode, 1, monkeypatch, capsys)
    tr, losses, prints, saves = _train(dataset, tmp_path, mode, k,
                                       monkeypatch, capsys)
    assert len(losses) == len(ref_losses) == 4
    assert torch.equal(losses, ref_losses)
    a, b = tstep.state_tensors(tr.state), tstep.state_tensors(ref.state)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert (tr.state.step, tr.state.pool.count) \
        == (ref.state.step, ref.state.pool.count) == (4, 3)
    for got_p, got_s, kk in ((prints, saves, k), (ref_prints, ref_saves, 1)):
        want_p, want_s = _jax_chunk_events(4, kk, PRINT_FREQ, SAVE_FREQ)
        assert got_p == want_p
        assert got_s == want_s + [4]  # and the save at the end of train()


@pytest.mark.parametrize("pad_free_head", [True, False, None])
@pytest.mark.parametrize("entry", ["step", "cycle_step", "trainer",
                                   "service"])
def test_explicit_pad_free_head_is_refused(entry, pad_free_head, tmp_path,
                                           monkeypatch):
    """--pad_free_head true, false or by default (None: pad-free unless
    --remat) is honoured at every entry point that the JAX package passes
    it to: the step, the cycle step, the trainer's eval and the service
    build, and the ResNet's head takes the branch the JAX rule gives
    (``step._gen_fwd``, ``cycle.py:87-100``, ``evaluate.py:59-62``): the
    pad-free head, or the reflect pad before the strided conv."""
    cfg = Config(**BASE, **MODES["sggan_resnet"],
                 checkpoint_dir=str(tmp_path / "ck"),
                 pad_free_head=pad_free_head)
    want = True if pad_free_head is None else pad_free_head
    assert tstep.pad_free_head(cfg) is want
    heads, pads = [], []
    head, pad = GeneratorResnet._head, generator_resnet.reflect_pad

    def spy_head(self, y, cd, pad_free):
        heads.append(pad_free)
        return head(self, y, cd, pad_free)

    def spy_pad(y, p):
        pads.append(p)
        return pad(y, p)
    monkeypatch.setattr(GeneratorResnet, "_head", spy_head)
    monkeypatch.setattr(generator_resnet, "reflect_pad", spy_pad)
    g = torch.Generator().manual_seed(0)
    if entry in ("step", "cycle_step"):
        c = cfg if entry == "step" else cfg.replace(loss_mode="cycle")
        state = tstep.init_state(c, g, "cpu")
        _, m = tstep.build_step_fn(c)(state, _batch(c, 0), 1e-3,
                                      tpool.pool_draws(g, B, c.max_size))
        assert all(torch.isfinite(v) for v in m.values())
    elif entry == "trainer":
        out = Trainer(cfg, device="cpu").generate(np.zeros((1, H, W, 3)))
        assert out.shape == (1, H, W, 3)
    else:
        assert serve._Service(cfg, device="cpu").loaded is False
    assert heads and set(heads) == {want}, heads
    # the pre-padded head reflect-pads its input by 3; nothing else does
    assert pads == ([] if want else [3] * len(heads))
