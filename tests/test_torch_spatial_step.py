"""Port parity of the spatial train step (``sggan_tpu_torch/parallel/
spatial_step.py``, reached through ``train/step.py::build_step_fn``): the
ranks as gloo processes on the CPU (``tests/_torch_sp_worker.py steps``)
against the JAX package's ``make_sp_train_step`` (its body,
``make_sp_step_body``, jitted and compiled without XLA's LLVM passes and
fusion emitters as ``tests/test_torch_step.py`` compiles) on 2 or 4 of
``conftest.py``'s 8 CPU devices, and against the port's one-process step
on the whole plane and global batch.

Cases: the ResNet sggan step at data 2 x space 2 (with the EMA) and at
space 2 x wspace 2, the U-Net sggan step at space 2 with each shard's
dropout masks as the JAX step draws them, and the ResNet cycle step at
space 2 with its pair pool and every loss term (identity 5).  32x32, ngf
and ndf 4, 8 classes, f32, pool 2, 2 samples a data row, the gradient
loss 5, LSGAN.

Each starts from the JAX package's own ``init_sp_state`` (or
``init_sp_cycle_state``) with ``n_data`` data rows, bridged at each
rank's (d, s, w) (``bridge.train_state_from_jax(..., rank, n_data)``);
two steps, each from the state the JAX step before it left, the second
swapping pooled history.  The pool's draws of each data row and the
dropout masks of each shard are those the JAX step takes from its key
(spatial_step.py:263-264, spatial.py:394-399), drawn by one JAX program
and fed to the ranks.

Limits: losses rel 2e-4; gradients, read from Adam's first moments (g =
(mu_t - b1 mu_(t-1)) / (1 - b1)), as ``tests/test_spatial_step.py:104-155``
holds the JAX sp gradients against one device: rtol 2e-3, atol 1e-5 (the
cycle step: atol 1e-4 of each tensor's largest.  Its chain of six
generator calls with the L1 weight 10 puts f32 noise beyond the rtol of
up to 3.5e-5 of a tensor's largest into small elements on the seeds free
of flips, 2, 6 and 7, and past 1e-5 absolute on each of them.  The f64
witness ``tests/_torch_sp_witness.py`` shows it is f32 rounding: on the
first step of seeds 3, 6 and 7 the packages in f64 agree within 2.7e-13
of a tensor's largest, JAX's f32 departs from f64 by up to 1.0e-4 of it,
the ranks' f32 by up to 7.2e-5); the pool in the JAX
global layout after the second step, its fakes within 1e-4 and its masks
exact; the step and pool counts.  Batch seeds 1 (the ResNet cases), 0
(U-Net) and 7 (cycle): on them no sign that a gradient follows flips
between the two packages' f32 forwards (ROADMAP Queue 3); seeds 0, 2-4
flip at data 2 x space 2, 0 and 3 at space 2 x wspace 2, 0, 1, 3-5 and
8-11 in the cycle step."""

import pickle
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_dist import start_ranks, wait_ranks  # noqa: E402
from _torch_sp_common import assemble  # noqa: E402
from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.parallel import make_mesh  # noqa: E402
from sggan_tpu.parallel.spatial_step import (init_sp_cycle_state,  # noqa
                                             init_sp_state,
                                             make_sp_step_body, place_sp,
                                             shard_sp_batch)
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.train import cycle as tcycle  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_step import CYCLE_FAST, FAST, _leaves  # noqa: E402

H, W, N_CLASS, POOL, B_ROW, LR = 32, 32, 8, 2, 2, 1e-3
RNGS = [jax.random.PRNGKey(60 + t) for t in range(2)]
BASE = dict(image_height=H, image_width=W, ngf=4, ndf=4,
            segment_class=N_CLASS, max_size=POOL, compute_dtype="float32",
            use_lsgan=True, L1_lambda=10.0, Lg_lambda=5.0)
CASES = {
    "resnet_d2s2": dict(BASE, loss_mode="sggan", use_resnet=True,
                        gen_ema=0.9, mesh_data=2, mesh_space=2),
    "resnet_s2w2": dict(BASE, loss_mode="sggan", use_resnet=True,
                        mesh_space=2, mesh_space_w=2),
    "unet_s2": dict(BASE, loss_mode="sggan", use_resnet=False,
                    dropout_mode="intended", mesh_space=2),
    "cycle_s2": dict(BASE, loss_mode="cycle", use_resnet=True,
                     identity_lambda=5.0, mesh_space=2),
}
SEED = {"resnet_d2s2": 1, "resnet_s2w2": 1, "unet_s2": 0, "cycle_s2": 7}
LOSS_RTOL, GRAD_TOL, POOL_ATOL = 2e-4, dict(rtol=2e-3, atol=1e-5), 1e-4
# the cycle step's absolute floor, of each tensor's largest gradient
CYCLE_ATOL_OF_MAX = 1e-4


def _sizes(kw) -> tuple:
    return (kw.get("mesh_data", 1), kw.get("mesh_space", 1),
            kw.get("mesh_space_w", 1))


def _batch(kw, seed: int) -> dict:
    r = np.random.default_rng(seed)
    b = B_ROW * _sizes(kw)[0]
    out = {}
    for d in ("ab" if kw["loss_mode"] == "cycle" else "a"):
        out[f"real_{d}"] = r.uniform(size=(b, H, W, 3)).astype(np.float32)
        out[f"seg_{d}"] = r.uniform(size=(b, H, W, 3)).astype(np.float32)
        out[f"mask_{d}"] = np.eye(N_CLASS, dtype=np.float32)[
            r.integers(0, N_CLASS, (b, H // 8, W // 8))]
    return out


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST)(*args)


def _draws(kw, rngs, drop_shapes):
    """Each step's draws as the JAX sp step takes them: per data row d
    (rng folded by d) the pool's (u, idx) of its items (pool.py:71-76),
    from ``rng`` itself (sggan) or the fifth of its five keys (cycle); per
    shard (d, s, w) in rank order the U-Net's d1-d3 keep masks, from
    ``fold_in(rng_d, 1)`` folded by s (and w), split in three."""
    D, S, Wn = _sizes(kw)
    cycle = kw["loss_mode"] == "cycle"

    def pool(k_pool):
        def item(i):
            k_use, k_idx = jax.random.split(jax.random.fold_in(k_pool, i))
            return (jax.random.uniform(k_use),
                    jax.random.randint(k_idx, (), 0, POOL))
        return jax.vmap(item)(jnp.arange(B_ROW))

    def fn(rs):
        out = []
        for rng in rs:
            rows, shards = [], []
            for d in range(D):
                rd = jax.random.fold_in(rng, d)
                rows.append(pool(jax.random.split(rd, 5)[4] if cycle
                                 else rd))
                for s in range(S):
                    for w in range(Wn):
                        if drop_shapes is None:
                            continue
                        k = jax.random.fold_in(jax.random.fold_in(rd, 1), s)
                        if Wn > 1:
                            k = jax.random.fold_in(k, w)
                        shards.append([
                            jax.random.bernoulli(kk, 0.5, sh) for kk, sh in
                            zip(jax.random.split(k, 3), drop_shapes)])
            out.append((rows, shards))
        return out
    got = _compile(fn, jnp.stack(rngs))
    draws = [[(np.array(u), np.array(i)) for u, i in rows]
             for rows, _ in got]
    masks = [[[np.array(m) for m in sh] for sh in shards] or
             [None] * (D * S * Wn) for _, shards in got]
    return draws, masks


def _plain(js) -> SimpleNamespace:
    """A JAX TrainState as numpy trees with attribute access."""
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


def _jax_case(name, kw, compiles=None):
    """The case's JAX init state, draws and step, lowered; the step's
    compile goes to ``compiles`` (a thread pool: XLA compiles outside the
    GIL, so the cases' compiles overlap one another and the next case's
    tracing) or runs here.  Returns a function that runs both steps and
    returns the ranks' inputs and the references."""
    D, S, Wn = _sizes(kw)
    jcfg = JConfig(**kw, batch_size=B_ROW * D)
    init = init_sp_cycle_state if kw["loss_mode"] == "cycle" \
        else init_sp_state
    js = _compile(lambda k: init(jcfg, k, n_data=D), jax.random.PRNGKey(9))
    mesh = make_mesh(data=D, space=S, wspace=Wn,
                     devices=jax.devices()[:D * S * Wn])
    batches = [_batch(kw, SEED[name])] * len(RNGS)
    drop = None
    if not kw["use_resnet"]:
        cfg = Config(**kw)
        drop = tstep.new_generator(cfg).drop_shapes(B_ROW, H // S, W // Wn)
    draws, masks = _draws(kw, RNGS, drop)
    jstate = place_sp(js, mesh)
    lowered = jax.jit(make_sp_step_body(jcfg, mesh)).lower(
        jstate, shard_sp_batch(batches[0], mesh), jnp.float32(LR), RNGS[0])
    opts = CYCLE_FAST if kw["loss_mode"] == "cycle" else FAST
    fn = (compiles.submit(lowered.compile, opts) if compiles is not None
          else SimpleNamespace(result=lambda: lowered.compile(opts)))

    def run():
        nonlocal jstate
        step = fn.result()
        states, ref = [_plain(js)], []
        for batch, rng in zip(batches, RNGS):
            jstate, jm = step(jstate, shard_sp_batch(batch, mesh),
                              jnp.float32(LR), rng)
            ref.append(({k: float(v) for k, v in jm.items()},
                        _plain(jstate)))
            states.append(ref[-1][1])
        return {"kw": dict(kw, batch_size=B_ROW * D), "states": states[:-1],
                "batches": batches, "draws": draws, "masks": masks,
                "lr": LR}, ref
    return run


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX references, the cycle case's (the longest compile) lowered
    first, and one gloo job per world size over its cases, each started
    as soon as its cases' references are in (the 4-rank job's while the
    cycle case still compiles)."""
    torch.set_num_threads(1)
    cases, refs, jobs = {}, {}, {}

    def world(name):
        return int(np.prod(_sizes(CASES[name])))

    def has_cycle(w):
        return any(CASES[k]["loss_mode"] == "cycle" for k in CASES
                   if world(k) == w)
    order = sorted(CASES, key=lambda k: CASES[k]["loss_mode"] != "cycle")
    with ThreadPoolExecutor(len(CASES)) as compiles:
        runs = {name: _jax_case(name, CASES[name], compiles)
                for name in order}
        for w in sorted({world(k) for k in CASES}, key=has_cycle):
            mine = {}
            for name in CASES:  # the cases' order for the ranks
                if world(name) == w:
                    cases[name], refs[name] = runs[name]()
                    mine[name] = cases[name]
            work = tmp_path_factory.mktemp(f"sp_steps{w}")
            with open(work / "cases.pkl", "wb") as f:
                pickle.dump(mine, f)
            jobs[w] = work, start_ranks("steps", [work / "cases.pkl", work],
                                        world=w,
                                        worker="_torch_sp_worker.py")
    ranks = {}
    for w, (work, procs) in jobs.items():
        outs = wait_ranks(procs)
        for r, (rc, out) in enumerate(outs):
            assert rc == 0, f"rank {r} failed:\n{out}"
            assert "OK imported no JAX module: True" in out, out
        for r in range(w):
            with open(work / f"rank{r}.pkl", "rb") as f:
                for name, got in pickle.load(f).items():
                    ranks.setdefault(name, []).append(got)
    return cases, refs, ranks


def _grads(mu_after: dict, mu_before: dict, b1: float) -> dict:
    a, b = dict(_leaves(mu_after)), dict(_leaves(mu_before))
    return {k: (a[k] - b1 * b[k]) / (1 - b1) for k in a}


def _held_grads(got: dict, ref: dict, what: str, cycle: bool) -> None:
    assert got.keys() == ref.keys(), what
    for k in ref:
        tol = dict(GRAD_TOL)
        if cycle:
            tol["atol"] = CYCLE_ATOL_OF_MAX * np.abs(ref[k]).max()
        np.testing.assert_allclose(got[k], ref[k], err_msg=f"{what} {k}",
                                   **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_sp_steps_match_jax(job, name):
    """Both steps: the losses every rank returns, both nets' gradients,
    the step and Adam counts; after the second, the pool put together in
    the JAX global layout, and the ranks' replicas bitwise equal."""
    cases, refs, ranks = job
    b1 = Config(**CASES[name]).beta1
    for t, (jm, js) in enumerate(refs[name]):
        start = cases[name]["states"][t]
        for rk in ranks[name]:
            tm, ts = rk["steps"][t]
            for k in ("gen_loss", "disc_loss"):
                assert tm[k] == pytest.approx(jm[k], rel=LOSS_RTOL), \
                    (t, k)
        tm, ts = ranks[name][0]["steps"][t]
        for opt in ("g_opt", "d_opt"):
            got = _grads(ts[opt]["mu"], getattr(start, opt).mu, b1)
            ref = _grads(getattr(js, opt).mu, getattr(start, opt).mu, b1)
            _held_grads(got, ref, f"{name} step {t} {opt}",
                        name.startswith("cycle"))
        assert int(ts["step"]) == int(js.step) == t + 1
        assert int(ts["g_opt"]["count"]) == int(js.g_opt.count) == t + 1
        for rk in ranks[name][1:]:
            other = dict(_leaves({k: v for k, v in rk["steps"][t][1].items()
                                  if v is not None}))
            for k, v in _leaves({k: v for k, v in ts.items()
                                 if v is not None}):
                np.testing.assert_array_equal(v, other[k], err_msg=k)
    assert int(ts["pool"]["count"]) == int(js.pool.count)
    for k, v in js.pool.buffer.items():
        got = ts["pool"]["buffer"][k]
        assert got.shape == v.shape, k
        if k.startswith("mask"):
            np.testing.assert_array_equal(got, v)
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=POOL_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sp_first_step_matches_one_process(job, name):
    """The first step (the pool filling, so that it passes this step's
    fakes on, as one pool of every data row's slots does): the ranks'
    losses and gradients against the port's one-process step on the whole
    plane and the global batch, from the same JAX state with the
    patch-head discriminator(s) and the shards' masks put together."""
    cases, _, ranks = job
    case, kw = cases[name], CASES[name]
    sizes = _sizes(kw)
    one = Config(**{**case["kw"], "mesh_data": 1, "mesh_space": 1,
                    "mesh_space_w": 1})
    js = case["states"][0]
    st = bridge.train_state_from_jax(one, js, head="patch")
    batch = {k: torch.from_numpy(v) for k, v in case["batches"][0].items()}
    b = next(iter(batch.values())).shape[0]
    draws = tpool.pool_draws(torch.Generator().manual_seed(0), b,
                             POOL * sizes[0])
    masks = case["masks"][0]
    if masks[0] is not None:
        masks = tuple(torch.from_numpy(assemble([m[i] for m in masks],
                                                sizes)) for i in range(3))
    else:
        masks = None
    mod = tcycle if one.loss_mode == "cycle" else tstep
    m, g_grads, d_grads = mod.losses_and_grads(one, st, batch, draws,
                                               masks)[:3]
    tm, ts = ranks[name][0]["steps"][0]
    for k in ("gen_loss", "disc_loss"):
        assert tm[k] == pytest.approx(m[k].item(), rel=LOSS_RTOL), k
    b1 = one.beta1
    for opt, grads in (("g_opt", g_grads), ("d_opt", d_grads)):
        got = _grads(ts[opt]["mu"], getattr(js, opt).mu, b1)
        ref = dict(_leaves(bridge.params_to_jax(
            {k: g.detach() for k, g in grads.items()})))
        _held_grads(got, ref, f"{name} {opt}", name.startswith("cycle"))


def test_ranks_pool_blocks_and_refusals(job):
    """A rank bridges its block of the JAX state's pool (slots of its data
    row, its rows and columns); a spatial config in one process, the
    semantic nets' or the pix2pix pair's, names the world size."""
    cases, _, _ = job
    kw = CASES["resnet_d2s2"]
    js = cases["resnet_d2s2"]["states"][0]
    cfg = Config(**cases["resnet_d2s2"]["kw"])
    for rank in range(4):
        st = bridge.train_state_from_jax(cfg, js, "cpu", rank, 2)
        d, s = rank // 2, rank % 2
        for k, v in js.pool.buffer.items():
            hh = v.shape[1] // 2
            np.testing.assert_array_equal(
                st.pool.buffer[k].numpy(),
                v[d * POOL:(d + 1) * POOL, s * hh:(s + 1) * hh])
    assert kw["mesh_space"] == 2
    with pytest.raises(ValueError, match="= 4 ranks must equal the world "
                                         "size, 1"):
        tstep.build_step_fn(cfg)
    with pytest.raises(ValueError, match="= 4 ranks must equal the world "
                                         "size, 1"):
        tstep.init_state(cfg.replace(use_pix2pix=True, loss_mode="p2p"),
                         torch.Generator(), "cpu")
