"""Port parity of data parallelism (``--mesh_data 2``): the port's
data-parallel step, two gloo ranks on the CPU (``tests/_torch_dp_worker.py
steps``), against the JAX package's ``make_dp_train_step`` on a 2-device
mesh of ``conftest.py``'s 8 CPU devices, in every loss mode the JAX dp
mesh runs: the ResNet sggan step with its pool and the EMA, the p2p U-Net
with dropout, the pix2pix pair with batch norm and dropout, and the ResNet
cycle step with its pair pool (its identity and gradient terms off: they
add generator calls, no data-parallel code, and ~20 s to the JAX compile;
``tests/test_torch_cycle.py`` holds them against JAX on one device,
``tests/test_torch_dp_shards.py`` in the data-parallel step).  32x32, ngf and ndf 4, 8
classes, f32, a global batch of 4 (2 a shard), two steps each.

Each mode starts from the JAX package's own ``init_state(...,
n_data=2)`` (its pool of 2 x max_size slots), and each step from the
state the JAX step before it left, which each rank bridges at its own
pool rows (``bridge.train_state_from_jax(..., rank, n_data)``).
Each shard's draws are those the JAX step takes from ``fold_in(rng,
shard)``: the pool's from its ``rng_pool`` key, the dropout masks from
its generator key, drawn by one JAX program per mode and fed to the
ranks.  The JAX programs are compiled without XLA's LLVM passes and
fusion emitters, as ``tests/test_torch_step.py`` compiles its step
(``make_dp_train_step`` is ``jax.jit`` of the same shard_mapped body,
``make_dp_step_body``).

Limits are ``tests/test_parallel.py:43-73``'s: losses rtol 2e-4,
parameters (and the EMA and batch-norm stats) rtol 5e-3, atol 2.5e-4,
each parameter element where its gradient stands clear of the two
packages' noise in every step so far (``_sure``; where it does not, its
sign is noise and Adam moves the element by up to lr either way, so it
is held within that move);
the pools after two steps at ``tests/test_torch_cycle.py``'s 1e-2 (a slot
that took the other item differs by ~1), the masks in them exactly.  The
ranks' replicas are bitwise equal; the p2p ResNet on two shards equals
the port's one-process step on the global batch at the same limits.
Adam's moments are held at rtol 1e-3 plus 2e-3 of a tensor's largest:
its update is blind to the gradients' scale, its moments are not.

The batch seeds are ones on which the two packages' f32 gradients agree
element by element; on most they do not: a value within f32's rounding
of 0 where the gradient takes its sign (a gate, an L1's abs) falls on
the other side in the other package and moves whole tensors' gradients
by up to a few % of their largest.  The f64 witness
(``tests/_torch_dp_witness.py``) shows that the gap is f32 rounding in
both packages and not the data-parallel step: on the cycle case's first
step, seeds 0-15 with its identity and gradient terms off and 0-7 with
them on, the two packages in f64 agree to 7.1e-12 of each tensor's
largest gradient, while each package's f32 departs from its f64 by up to
1.1e-1 (the port) and 7.7e-2 (JAX); the first step's gradients meet the
first-moment limit below on seeds 2, 8, 11 and 13 with the terms off
(seed 8 passes every check here) and on seed 0 alone with them on.  The
data-parallel step itself is held on every seed of 0-3, in every mode
and with the cycle's terms on, bit for bit against one process over both
shards (``tests/test_torch_dp_shards.py``)."""

import pickle
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_dist import one_rank_group, run_ranks  # noqa: E402
from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.parallel import make_mesh, replicate, shard_batch  # noqa: E402
from sggan_tpu.parallel.dp import make_dp_step_body  # noqa: E402
from sggan_tpu.train import cycle as jcycle  # noqa: E402
from sggan_tpu.train import step as jstep  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_step import FAST, _leaves  # noqa: E402

N, B, H, W, N_CLASS, POOL = 2, 4, 32, 32, 8, 2  # B: the global batch
LR = 1e-3
RNGS = [jax.random.PRNGKey(40 + t) for t in range(2)]
BASE = dict(image_height=H, image_width=W, ngf=4, ndf=4,
            segment_class=N_CLASS, batch_size=B // 2, max_size=POOL,
            compute_dtype="float32", mesh_data=N)
MODES = {
    "sggan_resnet": dict(BASE, loss_mode="sggan", use_resnet=True,
                         gen_ema=0.9),
    "p2p_unet": dict(BASE, loss_mode="p2p", use_resnet=False,
                     dropout_mode="intended"),
    "pix2pix": dict(BASE, loss_mode="p2p", use_pix2pix=True,
                    dropout_mode="intended"),
    "cycle_resnet": dict(BASE, loss_mode="cycle", use_resnet=True,
                         use_lsgan=True, L1_lambda=10.0, identity_lambda=0.0,
                         Lg_lambda=0.0),
}
# held to the port's one-process step on the global batch, not to JAX
SINGLE = {"p2p_resnet": dict(BASE, loss_mode="p2p", use_resnet=True)}
SEED = {"sggan_resnet": 0, "p2p_unet": 2, "pix2pix": 0, "cycle_resnet": 8,
        "p2p_resnet": 0}
PARAM_TOL = dict(rtol=5e-3, atol=2.5e-4)
# Adam's moments: the gradients' noise between the packages, up to 7e-4
# of a tensor's largest on these batches
MOMENT_ATOL = 2e-3


def _batch(cycle: bool, seed: int) -> dict:
    r = np.random.default_rng(seed)
    out = {}
    for d in ("ab" if cycle else "a"):
        out[f"real_{d}"] = r.uniform(size=(B, H, W, 3)).astype(np.float32)
        out[f"seg_{d}"] = r.uniform(size=(B, H, W, 3)).astype(np.float32)
        out[f"mask_{d}"] = np.eye(N_CLASS, dtype=np.float32)[
            r.integers(0, N_CLASS, (B, H // 8, W // 8))]
    return out


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST)(*args)


def _shard_draws(kw, rngs):
    """Each step's and shard's draws as the JAX dp step takes them from
    ``fold_in(rng, shard)``: the pool's (u, idx) of its ``b`` items
    (pool.py:74-79) and the generator's dropout keep masks (the U-Net's
    d1-d3 or the pix2pix up0-up2, three keys of its generator key)."""
    cfg = Config(**{**kw, "mesh_data": 1})
    b = B // N
    drop = None
    if not cfg.use_resnet:
        drop = tstep.new_generator(cfg).drop_shapes(b, H, W)

    def one(key):
        if cfg.loss_mode == "cycle":
            keys = jax.random.split(key, 5)
            k_gen, k_pool = keys[0], keys[4]
        else:
            k_gen, k_pool = jax.random.split(key)

        def item(i):
            k_use, k_idx = jax.random.split(jax.random.fold_in(k_pool, i))
            return (jax.random.uniform(k_use),
                    jax.random.randint(k_idx, (), 0, POOL))
        u, idx = jax.vmap(item)(jnp.arange(b))
        masks = None if drop is None else [
            jax.random.bernoulli(k, 0.5, s)
            for k, s in zip(jax.random.split(k_gen, 3), drop)]
        return (u, idx), masks

    def fn(rs):
        return [[one(jax.random.fold_in(r, s)) for s in range(N)] for r in rs]
    out = _compile(fn, jnp.stack(rngs))
    pools = cfg.max_size > 0 and cfg.loss_mode in ("sggan", "cycle")
    return ([[(np.array(u), np.array(i)) if pools else None
              for (u, i), _ in row] for row in out],
            [[None if m is None else [np.array(x) for x in m]
              for _, m in row] for row in out])


def _plain(js) -> SimpleNamespace:
    """A JAX TrainState as numpy trees with attribute access, which a rank
    unpickles without JAX or optax."""
    def n(tree):
        return jax.tree.map(np.asarray, tree)

    def opt(o):
        return SimpleNamespace(count=np.asarray(o.count), mu=n(o.mu),
                               nu=n(o.nu))
    return SimpleNamespace(
        gen_params=n(js.gen_params), gen_bn=n(js.gen_bn),
        disc_params=n(js.disc_params), disc_bn=n(js.disc_bn),
        g_opt=opt(js.g_opt), d_opt=opt(js.d_opt),
        pool=SimpleNamespace(buffer=n(js.pool.buffer),
                             count=np.asarray(js.pool.count)),
        step=np.asarray(js.step), ema=None if js.ema is None else n(js.ema))


def _jax_case(name, kw, mesh, compiles):
    """The JAX init_state(n_data=2), the global batches, each shard's
    draws and masks, and the JAX dp step, lowered here and compiled in
    ``compiles`` (a thread pool: XLA compiles outside the GIL, so the
    modes' compiles overlap one another and the next mode's tracing);
    returns a function that runs both steps and returns the ranks' inputs
    and the JAX losses and states."""
    jcfg = JConfig(**kw)
    init = jcycle.init_cycle_state if kw["loss_mode"] == "cycle" \
        else jstep.init_state
    js = _compile(lambda k: init(jcfg, k, n_data=N), jax.random.PRNGKey(7))
    # one batch for both steps: the second swaps pooled history
    batches = [_batch(kw["loss_mode"] == "cycle", SEED[name])] * len(RNGS)
    draws, masks = _shard_draws(kw, RNGS)
    jstate = replicate(js, mesh)
    fn = compiles.submit(jax.jit(make_dp_step_body(jcfg, mesh)).lower(
        jstate, shard_batch(batches[0], mesh), jnp.float32(LR),
        RNGS[0]).compile, FAST)

    def run():
        nonlocal jstate
        step = fn.result()
        states, ref = [_plain(js)], []
        for batch, rng in zip(batches, RNGS):
            jstate, jm = step(jstate, shard_batch(batch, mesh),
                              jnp.float32(LR), rng)
            ref.append(({k: float(v) for k, v in jm.items()},
                        _plain(jstate)))
            states.append(ref[-1][1])
        return {"kw": kw, "states": states[:-1], "batches": batches,
                "draws": draws, "masks": masks, "lr": LR}, ref
    return run


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX references (the cycle mode's, the longest compile, first),
    then one 2-rank gloo job over every case."""
    mesh = make_mesh(data=N, space=1, devices=jax.devices()[:N])
    cases, refs = {}, {}
    order = sorted(MODES, key=lambda k: MODES[k]["loss_mode"] != "cycle")
    with ThreadPoolExecutor(len(MODES)) as compiles:
        runs = {name: _jax_case(name, MODES[name], mesh, compiles)
                for name in order}
        done = {name: run() for name, run in runs.items()}
    for name in MODES:  # the modes' order for the ranks
        cases[name], refs[name] = done[name]
    for name, kw in SINGLE.items():
        cfg = Config(**{**kw, "mesh_data": 1})
        js = bridge.train_state_to_jax(
            tstep.init_state(cfg, torch.Generator().manual_seed(3), "cpu"))
        state = SimpleNamespace(
            **{k: js[k] for k in ("gen_params", "gen_bn", "disc_params",
                                  "disc_bn", "ema")},
            g_opt=SimpleNamespace(**js["g_opt"]),
            d_opt=SimpleNamespace(**js["d_opt"]),
            pool=SimpleNamespace(buffer=np.concatenate(
                [js["pool"]["buffer"]["fake"]] * N), count=0), step=0)
        cases[name] = {"kw": kw, "states": [state], "lr": LR,
                       "batches": [_batch(False, SEED[name])] * 2,
                       "draws": [[None] * N] * 2, "masks": [[None] * N] * 2}
    work = tmp_path_factory.mktemp("dp")
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    outs = run_ranks("steps", [work / "cases.pkl", work])
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
    ranks = []
    for r in range(N):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return cases, refs, ranks, [out for _, out in outs]


def _held(got: dict, ref, what: str, sure=None) -> None:
    """Elementwise at ``PARAM_TOL``; with ``sure`` (masks by name), there
    only, and elsewhere within Adam's largest move of ``sure["bound"]``."""
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys(), what
    for k in ref:
        s = np.ones(ref[k].shape, bool) if sure is None else sure[k]
        np.testing.assert_allclose(got[k][s], ref[k][s],
                                   err_msg=f"{what} {k}", **PARAM_TOL)
        if sure is not None:
            assert np.abs(got[k] - ref[k]).max(initial=0) <= sure["bound"], \
                (what, k)


def _sure(cases, refs, mode, t: int, opt: str) -> dict:
    """Where step ``t``'s gradient stands clear of the two packages' noise
    (above 1e-3 of its tensor's largest, as
    ``tests/test_torch_step.py::test_one_step_updates_params_as_jax``
    holds its update), from the JAX Adam moments before and after it:
    g = (mu_t - b1 mu_(t-1)) / (1 - b1).  Below that the gradient's sign
    is noise, and Adam's update of the element may differ by up to twice
    its move, ~1.1 lr in the first steps (``bound``)."""
    b1 = Config(**MODES[mode]).beta1
    before = dict(_leaves(getattr(cases[mode]["states"][t], opt).mu))
    after = dict(_leaves(getattr(refs[mode][t][1], opt).mu))
    out = {"bound": 2 * 1.1 * LR}
    for k, mu in after.items():
        g = np.abs(mu - b1 * before[k])
        out[k] = g > 1e-3 * g.max()
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_steps_match_jax(job, mode):
    """Both steps, each from the JAX state it starts from (so that one
    step's noise does not move the next step's inputs): the losses every
    rank returns, then the parameters, the EMA and the batch-norm stats;
    the step and Adam counts; after the second, which swaps pooled
    history, the pool in the JAX global layout."""
    cases, refs, ranks, _ = job
    for t, (jm, js) in enumerate(refs[mode]):
        tm, ts = ranks[0][mode]["steps"][t]
        for k in ("gen_loss", "disc_loss"):
            assert tm[k] == pytest.approx(jm[k], rel=2e-4), (t, k)
        g_sure = _sure(cases, refs, mode, t, "g_opt")
        _held(ts["gen_params"], js.gen_params, f"step {t} gen", g_sure)
        _held(ts["disc_params"], js.disc_params, f"step {t} disc",
              _sure(cases, refs, mode, t, "d_opt"))
        for part in ("gen_bn", "disc_bn"):
            _held(ts[part], getattr(js, part), f"step {t} {part}")
        if js.ema is not None:
            _held(ts["ema"], js.ema, f"step {t} ema", g_sure)
        # Adam's update is blind to the gradients' scale; its moments are
        # not (a sum over ranks in place of the mean shows here)
        for opt in ("g_opt", "d_opt"):
            for part in ("mu", "nu"):
                got, ref = (dict(_leaves(x)) for x in (
                    ts[opt][part], getattr(getattr(js, opt), part)))
                for k in ref:
                    np.testing.assert_allclose(
                        got[k], ref[k], rtol=1e-3,
                        atol=MOMENT_ATOL * np.abs(ref[k]).max(),
                        err_msg=f"step {t} {opt}.{part} {k}")
        assert int(ts["step"]) == int(js.step) == t + 1
        assert int(ts["g_opt"]["count"]) == int(js.g_opt.count) == t + 1
    jbuf = js.pool.buffer
    if not isinstance(jbuf, dict):
        jbuf = {"fake": jbuf}
    assert int(ts["pool"]["count"]) == int(js.pool.count)
    for k, v in jbuf.items():
        got = ts["pool"]["buffer"][k]
        assert got.shape == v.shape, k
        if k.startswith("mask"):
            np.testing.assert_array_equal(got, v)
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-2)


def test_replicas_stay_bitwise_equal(job):
    """After every step both ranks hold the same parameters, Adam moments
    and counts, EMA, batch-norm stats and gathered pool, bit for bit."""
    cases, _, ranks, _ = job
    for mode in cases:
        for (m0, s0), (m1, s1) in zip(ranks[0][mode]["steps"],
                                      ranks[1][mode]["steps"]):
            assert m0 == m1, mode
            a, b = dict(_leaves(_drop_none(s0))), dict(_leaves(
                _drop_none(s1)))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=mode + k)


def _drop_none(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if v is not None}


def test_pool_rows_per_rank(job):
    """Rank r bridges rows [r * max_size, (r + 1) * max_size) of the JAX
    state's pool of 2 x max_size slots, and keeps max_size slots."""
    cases, _, ranks, _ = job
    for mode in ("sggan_resnet", "cycle_resnet"):
        jbuf = cases[mode]["states"][0].pool.buffer
        assert next(iter(jbuf.values())).shape[0] == N * POOL
        for r in range(N):
            rows = ranks[r][mode]["pool_rows_at_init"]
            assert rows.keys() == jbuf.keys()
            for k, v in rows.items():
                np.testing.assert_array_equal(
                    v, jbuf[k][r * POOL:(r + 1) * POOL])


def test_p2p_resnet_on_two_shards_equals_one_process_on_the_batch(job):
    """The mean of the two shards' gradients is the global batch's: the
    two-rank steps equal the port's one-process steps on the whole batch
    from the same state, at the limits above."""
    cases, _, ranks, _ = job
    case = cases["p2p_resnet"]
    cfg = Config(**{**case["kw"], "mesh_data": 1,
                    "batch_size": case["kw"]["batch_size"] * N})
    start = case["states"][0]
    js = SimpleNamespace(**{**vars(start), "pool": SimpleNamespace(
        buffer=start.pool.buffer[:1], count=0)})
    ts = bridge.train_state_from_jax(cfg, js)
    step = tstep.build_step_fn(cfg)
    for t, batch in enumerate(case["batches"]):
        ts, m = step(ts, {k: torch.from_numpy(v) for k, v in batch.items()},
                     LR, None)
        got_m, got = ranks[0]["p2p_resnet"]["steps"][t]
        for k in m:
            assert got_m[k] == pytest.approx(m[k].item(), rel=2e-4), (t, k)
        ref = bridge.train_state_to_jax(ts)
        for part in ("gen_params", "disc_params"):
            _held(got[part], ref[part], f"step {t} {part}")


def test_each_step_makes_two_all_reduces_of_one_bucket_per_net(job):
    """Two collectives a step, each one flat f32 bucket of a net's
    gradients, batch-norm stats and loss."""
    cases, _, ranks, _ = job
    for mode, case in cases.items():
        cfg = Config(**{**case["kw"], "mesh_data": 1})
        ts = tstep.init_state(cfg, torch.Generator(), "cpu")
        numel = sum(t.numel() for k, t in tstep.state_tensors(ts).items()
                    if k.split(".")[0] in ("gen", "disc", "gen_bn",
                                           "disc_bn"))
        n_steps = len(case["batches"])
        assert ranks[0][mode]["reductions"] == (2 * n_steps,
                                                4 * n_steps * (numel + 2))


def test_ranks_import_no_jax(job):
    for out in job[3]:
        assert "OK imported no JAX module: True" in out, out


def test_a_group_of_another_size_is_refused():
    """In a one-rank process group, ``--mesh_data 2`` names both numbers,
    ``--mesh_space 2`` (the semantic nets or the pix2pix pair) the ranks
    it needs, and passes ``mesh.check_space`` in a world of 2;
    ``--mesh_data 1`` builds the one-process step, which averages
    nothing."""
    from sggan_tpu_torch.parallel import mesh
    with one_rank_group() as group:
        for kw, err, what in (
                (dict(mesh_data=2), ValueError,
                 "--mesh_data 2 must equal the world size, 1"),
                (dict(mesh_space=2), ValueError,
                 "= 2 ranks must equal the world size, 1"),
                (dict(mesh_space=2, use_pix2pix=True, loss_mode="p2p"),
                 ValueError, "= 2 ranks must equal the world size, 1")):
            cfg = Config(**{**MODES["sggan_resnet"], "mesh_data": 1, **kw})
            with pytest.raises(err, match=what):
                tstep.build_step_fn(cfg, group)
            with pytest.raises(err, match=what):
                tstep.init_state(cfg, torch.Generator(), "cpu", group)
            if mesh.is_spatial(cfg):
                mesh.check_space(cfg, 2)
        one = Config(**{**MODES["sggan_resnet"], "mesh_data": 1})
        ts = tstep.init_state(one, torch.Generator().manual_seed(0), "cpu",
                              group)
        batch = {k: torch.from_numpy(v) for k, v in _batch(False, 0).items()}
        _, m = tstep.build_step_fn(one, group)(
            ts, batch, LR, tpool.pool_draws(torch.Generator(), B, POOL))
        assert all(np.isfinite(v.item()) for v in m.values())
