"""Port parity of the sggan train step: ``sggan_tpu_torch.train.step``
against ``sggan_tpu.train.step`` on the CPU, f32, from one JAX
``TrainState`` bridged into the port, with the same batch and the pool
draws the JAX step takes from its key.

Tolerances: losses rel 1e-5 after one step and 1e-4 after three (the
losses are means; their f32 sums differ in order).  The discriminator's
first Adam moment and both nets' second moments are held elementwise at
rtol 1e-4, atol 1e-6.  The gradients and the generator's first moment
cannot be: the two generator forwards already differ by ~1e-5 (XLA's and
oneDNN's convs sum in other orders, and the 23 instance norms rescale
that, see tests/test_torch_generator.py), and the generator's gradients,
which reach 0.9 under the L1 term, inherit it as up to 5.9e-5 of a
tensor's largest element.  They are held at rtol 1e-4 plus an atol of
2e-4 of the tensor's largest magnitude.  The optimizer alone, fed the
same gradients, matches optax at rtol 1e-6."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.train import pool as jpool  # noqa: E402
from sggan_tpu.train import step as jstep  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.ops import norm as tnorm  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402

B, H, W, N_CLASS, POOL = 2, 32, 64, 8, 2
KW = dict(image_height=H, image_width=W, ngf=4, ndf=4,
          segment_class=N_CLASS, batch_size=B, max_size=POOL,
          compute_dtype="float32", loss_mode="sggan", use_resnet=True)
LR = 1e-3
RNGS = [jax.random.PRNGKey(10 + i) for i in range(3)]
# XLA without its LLVM optimisation and fusion emitters: the JAX step
# compiles in ~6 s instead of ~17 s on one core, f32 results equal to
# rounding
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's nets here have 4 channels at 32x64: one thread runs them
    as fast as several, and it does not contend with the other test
    workers' threads for the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    hm, wm = H // 8, W // 8
    return {"real_a": r.uniform(size=(B, H, W, 3)).astype(np.float32),
            "seg_a": r.uniform(size=(B, H, W, 3)).astype(np.float32),
            "mask_a": np.eye(N_CLASS, dtype=np.float32)[
                r.integers(0, N_CLASS, (B, hm, wm))]}


def _draws(rngs):
    """The pool draws the JAX step takes from each of ``rngs``, as one
    program."""
    def one(rng, i):
        key = jax.random.split(rng)[1]
        k_use, k_idx = jax.random.split(jax.random.fold_in(key, i))
        return (jax.random.uniform(k_use),
                jax.random.randint(k_idx, (), 0, POOL))

    def draws(rs):
        return jax.vmap(lambda r: jax.vmap(lambda i: one(r, i))(
            jnp.arange(B)))(rs)
    # the draws are the same without XLA's expensive LLVM passes, which
    # take seconds on threefry code
    rs = jnp.stack(rngs)
    u, idx = jax.jit(draws).lower(rs).compile(FAST)(rs)
    return [tpool.PoolDraws(torch.from_numpy(np.array(a)),
                            torch.from_numpy(np.array(b)).long())
            for a, b in zip(u, idx)]


def _jax_state(cfg):
    """A JAX TrainState whose nets are the port's seeded init (JAX's own
    RNG init costs ~20 s of XLA compile here), with JAX's optax and pool
    initialisers for the rest."""
    tree = bridge.train_state_to_jax(
        tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu"))
    tx = jstep._tx(cfg.beta1)
    gp, dp = tree["gen_params"], tree["disc_params"]
    pool = jpool.pool_init(POOL, {"fake": (H, W, 3),
                                  "mask": (H // 8, W // 8, N_CLASS)})
    return jstep.TrainState(gp, {}, dp, {}, tx.init(gp), tx.init(dp), pool,
                            jnp.zeros((), jnp.int32), None)


@pytest.fixture(scope="module")
def start():
    """The JAX state the steps start from and the pool draws of RNGS,
    made once for the module."""
    return _jax_state(JConfig(**KW)), _draws(RNGS)


@pytest.fixture(scope="module")
def runs(start):
    """Three steps of each package from the same state."""
    cfg = Config(**KW)
    js, draws = start
    np_state = lambda s: jax.tree.map(np.asarray, s)  # noqa: E731
    ts = bridge.train_state_from_jax(cfg, np_state(js))
    batch = _batch()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    first_grads = tstep.losses_and_grads(cfg, ts, tbatch, draws[0])
    jfn = jax.jit(jstep.build_step_fn(JConfig(**KW))).lower(
        js, batch, jnp.float32(LR), RNGS[0]).compile(FAST)
    tfn = tstep.build_step_fn(cfg)
    jax_out, port_out = [], []
    for rng, d in zip(RNGS, draws):
        js, jm = jfn(js, batch, jnp.float32(LR), rng)
        jax_out.append((np_state(js), {k: float(v) for k, v in jm.items()}))
        ts, tm = tfn(ts, tbatch, LR, d)
        port_out.append((bridge.train_state_to_jax(ts),
                         {k: v.item() for k, v in tm.items()}))
    return first_grads, jax_out, port_out, ts


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _close(got, ref, atol_of_max=0.0):
    """Elementwise |got - ref| <= 1e-6 + 1e-4 |ref| + atol_of_max
    * max |ref|, for every tensor of two trees of the same keys."""
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(
            got[k], ref[k], rtol=1e-4,
            atol=1e-6 + atol_of_max * np.abs(ref[k]).max(), err_msg=k)


def test_one_step_matches_jax(runs):
    (metrics, g_grads, d_grads, pool, _), jax_out, port_out, _ = runs
    (jstate, jm), (tstate, tm) = jax_out[0], port_out[0]
    for k in ("gen_loss", "disc_loss"):
        # the same computation as the step's; oneDNN's threads may sum in
        # another order from one call to the next
        assert abs(metrics[k].item() - tm[k]) <= 1e-5 * abs(tm[k])
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k])
    # optax's first moment after one step is (1 - beta1) * grad
    b1 = Config(**KW).beta1
    for grads, mu in ((g_grads, jstate.g_opt.mu), (d_grads, jstate.d_opt.mu)):
        ref = jax.tree.map(lambda m: np.asarray(m) / (1 - b1), mu)
        _close(bridge.params_to_jax(grads), ref, atol_of_max=2e-4)
    for name, opt in (("g_opt", jstate.g_opt), ("d_opt", jstate.d_opt)):
        assert tstate[name]["count"] == int(opt.count) == 1
        _close(tstate[name]["mu"], opt.mu,
               atol_of_max=2e-4 if name == "g_opt" else 0.0)
        _close(tstate[name]["nu"], opt.nu)
    assert pool.count == int(jstate.pool.count) == POOL


def test_one_step_under_remat_matches_jax_and_without(runs, start):
    """--remat recomputes the resblocks in the backward: the same ops on the
    same inputs, so the same losses and gradients as the port's step
    without it (rtol 1e-6, as tests/test_models.py:194 holds the JAX
    package), and the JAX step's at this file's limits (the head set to
    the pad-free one of ``runs``; jax.checkpoint itself is held to the
    port's recompute in tests/test_torch_remat.py)."""
    (metrics, g_grads, d_grads, _, _), jax_out, _, _ = runs
    cfg = Config(**KW, remat=True, pad_free_head=True)
    js, draws = start
    ts = bridge.train_state_from_jax(cfg, jax.tree.map(np.asarray, js))
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    m, g, d, *_ = tstep.losses_and_grads(cfg, ts, tbatch, draws[0])
    for k in m:
        assert m[k].item() == pytest.approx(metrics[k].item(), rel=1e-6)
    for got, ref in ((g, g_grads), (d, d_grads)):
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       rtol=1e-6, atol=0, err_msg=k)
    jstate, jm = jax_out[0]
    for k in ("gen_loss", "disc_loss"):
        assert abs(m[k].item() - jm[k]) <= 1e-5 * abs(jm[k])
    b1 = cfg.beta1
    for grads, mu in ((g, jstate.g_opt.mu), (d, jstate.d_opt.mu)):
        ref = jax.tree.map(lambda v: np.asarray(v) / (1 - b1), mu)
        _close(bridge.params_to_jax(grads), ref, atol_of_max=2e-4)


def test_one_step_updates_params_as_jax(runs):
    """Adam's first update is -lr * g / (|g| + eps), which is -lr * sign(g)
    wherever the gradient stands clear of the two packages' noise (above
    1e-3 of the tensor's largest gradient; the noise is below 5.9e-5 of
    it): there the new params agree to 1e-6.  Below it the sign is noise;
    the update is still at most lr."""
    _, jax_out, port_out, _ = runs
    (jstate, _), (tstate, _) = jax_out[0], port_out[0]
    b1 = Config(**KW).beta1
    for net, opt in (("gen_params", jstate.g_opt), ("disc_params",
                                                      jstate.d_opt)):
        got = dict(_leaves(tstate[net]))
        ref = dict(_leaves(getattr(jstate, net)))
        grads = {k: np.abs(v) / (1 - b1) for k, v in _leaves(opt.mu)}
        for k in ref:
            sure = grads[k] > 1e-3 * grads[k].max()
            d = np.abs(got[k] - ref[k])
            assert d[sure].max(initial=0) <= 1e-6, k
            assert d.max() <= 2 * LR * (1 + 1e-5), k


def test_three_steps_match_jax_in_losses_and_pool(runs):
    """Steps 2 and 3 run the full pool (max_size 2, batch 2) with the
    injected draws, so the discriminator sees swapped history."""
    _, jax_out, port_out, ts = runs
    for (_, jm), (_, tm) in zip(jax_out, port_out):
        for k in ("gen_loss", "disc_loss"):
            assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, tm, jm)
    jpool_state = jax_out[-1][0].pool
    assert ts.step == 3 and ts.pool.count == int(jpool_state.count)
    for k, buf in ts.pool.buffer.items():
        np.testing.assert_allclose(buf.numpy(), jpool_state.buffer[k],
                                   rtol=0, atol=1e-3)


def test_dead_biases_get_zero_grads_and_every_param_a_moment(runs):
    (_, g_grads, d_grads, _, _), _, _, ts = runs
    assert g_grads.keys() == dict(ts.gen_params.named_parameters()).keys()
    assert d_grads.keys() == dict(ts.disc_params.named_parameters()).keys()
    for k in ("c1.b", "c2.b", "c3.b", "r1.conv1.b", "r9.conv2.b", "d1.b",
              "d2.b"):
        assert not g_grads[k].any(), k
    for k in ("h1.b", "h2.b", "h3.b", "v0.b"):
        assert not d_grads[k].any(), k
    assert g_grads["out.b"].any() and d_grads["h4.b"].any()


def _faulty_bwd(fault):
    """The plain instance-norm backward with one planted fault."""
    ref = tnorm.instance_norm_bwd_ref

    def bwd(x, dy, gamma, beta, mean, rstd, act=None, alpha=0.3):
        if fault == "gate dropped":
            return ref(x, dy, gamma, beta, mean, rstd, None, alpha)
        if fault == "alpha 0.2":
            return ref(x, dy, gamma, beta, mean, rstd, act, 0.2)
        if fault == "saved mean zero":
            return ref(x, dy, gamma, beta, torch.zeros_like(mean), rstd, act,
                       alpha)
        dx, dgamma, dbeta = ref(x, dy, gamma, beta, mean, rstd, act, alpha)
        return dx, dbeta, dgamma  # "dgamma and dbeta swapped"
    return bwd


@pytest.mark.parametrize("fault", ["gate dropped", "alpha 0.2",
                                   "saved mean zero",
                                   "dgamma and dbeta swapped"])
def test_full_width_step_limits_catch_a_planted_fault(fault, monkeypatch):
    """chip_smoke.py holds the card's full-width f32 step to the CPU's
    only at STEP_MAX_REL of a gradient's largest element and STEP_NORM_REL
    in norm, since f32 summation order alone moves whole-net gradients by
    a few percent there.  A fault in the instance-norm backward still
    moves them by more."""
    import chip_smoke
    cfg = Config(**KW)
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    draws = tpool.pool_draws(torch.Generator().manual_seed(4), B, POOL)

    def grads():
        ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
        _, g, d, *_ = tstep.losses_and_grads(cfg, ts, tbatch, draws)
        return {**{f"gen.{k}": v for k, v in g.items()},
                **{f"disc.{k}": v for k, v in d.items()}}
    clean = grads()
    monkeypatch.setattr(tnorm, "instance_norm_bwd_ref", _faulty_bwd(fault))
    rows = chip_smoke.grad_rows(clean, grads())
    assert (max(r[0] for r in rows) > chip_smoke.STEP_MAX_REL
            or max(r[1] for r in rows) > chip_smoke.STEP_NORM_REL), rows[-3:]


@pytest.mark.parametrize("beta1", [0.5, 0.9])
def test_adam_matches_optax(beta1):
    """Two updates of the port's Adam, fed the same gradients, against
    optax.scale_by_adam(eps=1e-7) and the step's -lr scaling."""
    r = np.random.default_rng(0)
    params = {"a.w": r.standard_normal((3, 4, 2, 2)).astype(np.float32),
              "a.b": r.standard_normal(4).astype(np.float32)}
    grads = [{k: (r.standard_normal(v.shape) * 10.0 ** -r.integers(0, 8))
              .astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    grads[0]["a.b"][0] = 0.0
    net = torch.nn.Module()
    net.a = torch.nn.ParameterDict({k[2:]: torch.nn.Parameter(
        torch.from_numpy(v.copy())) for k, v in params.items()})
    opt = tstep.adam_init(net)
    tx = optax.scale_by_adam(b1=beta1, b2=0.999, eps=1e-7)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = tx.init(jp)
    for g in grads:
        opt = tstep.adam_update(net, opt, {k: torch.from_numpy(v) for k, v
                                           in g.items()}, LR, beta1)
        upd, jo = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jo, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: -LR * u, upd))
    assert opt.count == int(jo.count) == 2
    got = dict(net.named_parameters())
    for k in params:
        np.testing.assert_allclose(got[k].detach().numpy(), jp[k],
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(opt.mu[k].numpy(), jo.mu[k], rtol=1e-6)
        np.testing.assert_allclose(opt.nu[k].numpy(), jo.nu[k], rtol=1e-6)


@pytest.mark.parametrize("kw,epoch", [
    ({}, 0), ({"compat_lr_override": False}, 5),
    ({"compat_lr_override": False, "epoch": 10, "epoch_step": 4}, 7),
    ({"compat_lr_override": False, "epoch": 4, "epoch_step": 4}, 4)])
def test_lr_schedule_matches_jax(kw, epoch):
    assert tstep.lr_schedule(Config(**kw), epoch) \
        == jstep.lr_schedule(JConfig(**kw), epoch)


def test_ema_matches_jax():
    r = np.random.default_rng(1)
    p = {"c1.w": r.standard_normal((4, 3, 7, 7)).astype(np.float32),
         "c1.b": r.standard_normal(4).astype(np.float32)}
    e = {k: r.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    net = torch.nn.Module()
    net.c1 = torch.nn.ParameterDict({k[3:]: torch.nn.Parameter(
        torch.from_numpy(v)) for k, v in p.items()})
    cfg = Config(gen_ema=0.999)
    got = tstep._ema_update(cfg, {k: torch.from_numpy(v.copy())
                                  for k, v in e.items()}, net)
    ref = jstep._ema_update(JConfig(gen_ema=0.999), e, p)
    for k in p:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert tstep._ema_update(Config(), None, net) is None


@pytest.mark.parametrize("mode", ["p2p", "simple"])
def test_p2p_and_simple_branches_step_without_the_pool(mode):
    cfg = Config(**{**KW, "loss_mode": mode, "gen_ema": 0.5})
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    assert ts.pool.buffer["fake"].shape == (1, H, W, 3)
    before = ts.pool
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    ts, m = tstep.build_step_fn(cfg)(ts, tbatch, LR, None)
    assert ts.pool is before and ts.step == 1
    assert all(np.isfinite(v.item()) for v in m.values())
    assert ts.ema is not None


def test_bf16_step_stores_the_pool_in_bf16_and_restores_tf32():
    cfg = Config(**{**KW, "compute_dtype": "bfloat16"})
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    ts, m = tstep.make_train_step(cfg)(
        ts, tbatch, LR, tpool.pool_draws(torch.Generator(), B, POOL))
    assert ts.pool.buffer["fake"].dtype == torch.bfloat16
    assert all(np.isfinite(v.item()) for v in m.values())
    prev = torch.backends.cudnn.allow_tf32
    with tstep._conv_precision(torch.float32):
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == prev


@pytest.mark.parametrize("kw", [
    {"mesh_space": 2}, {"mesh_data": 2}])
def test_unported_modes_raise_naming_the_roadmap(kw):
    cfg = Config(**{**KW, **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.build_step_fn(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.init_state(cfg, torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.build_step_fn(Config(**KW), axis_name="data")


def test_init_state_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.init_state(Config(**KW), torch.Generator())

