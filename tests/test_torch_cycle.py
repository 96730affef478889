"""Port parity of the cycle-consistency mode (``--loss_mode cycle``),
the ResNet half: (a) of ``tests/_torch_cycle_common.py``'s docstring, the
ResNet cycle step with identity and gradient loss on, LSGAN, two steps
against ``sggan_tpu.train.cycle`` (the first under ``--remat`` too), and
the port-only units: the init's names, draw order and pool, ``max_size``
0, the identity term's calls, the mesh and mask refusals.  The U-Net
step, the trainer and the CLI are in ``tests/test_torch_cycle_unet.py``;
the two files share the helpers so that each JAX step compiles once."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_cycle_common import (B, H, N_CLASS, POOL, RESNET,  # noqa: E402,F401
                                 UNET, W, Config, JConfig, _batch, _close,
                                 _hold_first_step, _jax_state, _run, bridge,
                                 jcycle, jpool, one_thread, tcycle, tpool,
                                 tstep)


@pytest.fixture(scope="module")
def resnet_run():
    return _run(RESNET, 2)


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
    """Under ``--mesh_data 2`` a rank's pool keeps ``max_size`` pair
    slots, its rows of the JAX state's pool of 2 x max_size
    (``init_cycle_state(..., n_data=2)``, by shape), which the bridge
    takes by rank; the cycle step built with a process group of another
    size than ``--mesh_data`` is refused, naming both (``--remat`` is
    ported: tests/test_torch_remat.py)."""
    cfg2 = Config(**dict(RESNET, mesh_data=2))
    jshape = jax.eval_shape(lambda k: jcycle.init_cycle_state(
        JConfig(**dict(RESNET, mesh_data=2)), k, n_data=2),
        jax.random.PRNGKey(0))
    one = tstep.init_state(Config(**RESNET), torch.Generator(), "cpu")
    js = _jax_state(RESNET)
    rng = np.random.default_rng(0)
    buf = {k: rng.uniform(size=v.shape).astype(np.float32)
           for k, v in jshape.pool.buffer.items()}
    js = jax.tree.map(np.asarray, js)._replace(
        pool=jpool.PoolState(buf, np.int32(POOL)))
    for r in range(2):
        ts = bridge.train_state_from_jax(cfg2, js, "cpu", r, 2)
        for k, v in ts.pool.buffer.items():
            assert v.shape == one.pool.buffer[k].shape == (
                POOL, *jshape.pool.buffer[k].shape[1:])
            np.testing.assert_array_equal(v.numpy(),
                                          buf[k][r * POOL:(r + 1) * POOL])
        assert ts.pool.count == POOL
    from _torch_dist import one_rank_group
    with one_rank_group() as group:
        with pytest.raises(ValueError, match="--mesh_data 2 must equal the "
                                             "world size, 1"):
            tstep.build_step_fn(cfg2, group)
        with pytest.raises(ValueError, match="--mesh_data 2 must equal the "
                                             "world size, 1"):
            tstep.init_state(cfg2, torch.Generator(), "cpu", group)
        assert callable(tstep.build_step_fn(Config(**RESNET), group))
    with pytest.raises(ValueError, match="four dropout mask sets"):
        cfg = Config(**UNET)
        tcycle.losses_and_grads(
            cfg, tstep.init_state(cfg, torch.Generator(), "cpu"),
            {k: torch.from_numpy(v) for k, v in _batch().items()}, None)
    quirk = Config(**dict(UNET, dropout_mode="keras_quirk"))
    assert tstep.dropout_masks(quirk, tstep.init_state(
        quirk, torch.Generator(), "cpu").gen_params, torch.Generator(),
        B) is None
