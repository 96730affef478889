"""Port parity of the pix2pix spatial step (``--mesh_space`` with
``--use_pix2pix --loss_mode p2p``: ``sggan_tpu_torch/parallel/
spatial_step.py``, reached through ``train/step.py::build_step_fn``): the
ranks as gloo processes on the CPU (``tests/_torch_sp_worker.py steps``)
against the JAX package's ``make_sp_train_step`` (its body,
``make_sp_step_body``, jitted and compiled as ``tests/test_torch_step.py``
compiles) on 2 or 4 of ``conftest.py``'s 8 CPU devices, and against the
port's one-process step on the whole plane of each data row; then the
trainer over 2 ranks on the host iterator (``--device_dataset_mb 0``)
and the bridge.

Cases: space 2 with dropout (``--dropout_mode intended``), data 2 x space
2 with dropout and the EMA, space 2 x wspace 2 under ``keras_quirk`` (no
dropout, every batch norm on its moving stats), and space 4 with dropout,
whose up block 0 runs replicated with one mask for the data row.  32x32,
ngf and ndf 4, f32, 2 samples a data row.  Each starts from the JAX
package's own pix2pix ``init_sp_state`` with ``n_data`` data rows,
bridged at each rank's (d, s, w); two steps, each from the state the JAX
step before it left.  The dropout masks are those the JAX step draws from
its key (spatial_step.py:349, spatial.py:512-518): per shard where an up
block runs sharded, per data row where it runs replicated, drawn by one
JAX program and fed to the ranks.

Limits, those of ``chip_smoke.py`` phase 37: losses rel 1e-6; gradients,
read from Adam's first moments (g = (mu_t - b1 mu_(t-1)) / (1 - b1)),
within 1e-4 of each tensor's largest, plus the absolute 1e-6 that
``tests/test_torch_step.py::_close`` gives the one-card pix2pix step's
JAX parity (under ``keras_quirk`` the fresh discriminator's logits sit
near 0 on real and fake alike, so its last bias's gradient, a sum of
terms of about 0.06, cancels to about 1e-5, and the packages' f32
rounding of those terms, about 1e-7, is most of 1e-4 of it); both nets'
new BN states rtol 1e-4, atol 1e-5; the ranks' replicas bitwise equal.
Batch seed 0 in every case.  The seed search of ROADMAP Queue 3 (sign
and gate flips) over seeds 0-3: 0, 1 and 2 hold every case; on 3 the
space 2 case's first generator loss is 51.455708 against JAX's
51.455650, rel 1.1e-6."""

import os
import pickle
import re
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_dist import start_ranks, wait_ranks, write_dataset  # noqa: E402
from _torch_sp_common import assemble  # noqa: E402
from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.parallel import make_mesh  # noqa: E402
from sggan_tpu.parallel.spatial_step import (init_sp_state,  # noqa: E402
                                             make_sp_step_body, place_sp,
                                             shard_sp_batch)
from sggan_tpu_torch import main as tmain  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.parallel import spatial as tsp  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_spatial_pix2pix import _grid_like  # noqa: E402
from test_torch_step import FAST, _leaves  # noqa: E402

H, W, B_ROW, LR = 32, 32, 2, 1e-3
RNGS = [jax.random.PRNGKey(60 + t) for t in range(2)]
BASE = dict(image_height=H, image_width=W, ngf=4, ndf=4,
            compute_dtype="float32", use_pix2pix=True, loss_mode="p2p")
CASES = {
    "p2p_s2": dict(BASE, dropout_mode="intended", mesh_space=2),
    "p2p_d2s2": dict(BASE, dropout_mode="intended", gen_ema=0.9,
                     mesh_data=2, mesh_space=2),
    "p2p_s2w2": dict(BASE, dropout_mode="keras_quirk", mesh_space=2,
                     mesh_space_w=2),
    "p2p_s4": dict(BASE, dropout_mode="intended", mesh_space=4),
}
SEED = dict.fromkeys(CASES, 0)
LOSS_REL, GRAD_OF_MAX, GRAD_ATOL = 1e-6, 1e-4, 1e-6
BN_TOL = dict(rtol=1e-4, atol=1e-5)
N_TRAIN, N_TEST = 8, 2


def _sizes(kw) -> tuple:
    return (kw.get("mesh_data", 1), kw.get("mesh_space", 1),
            kw.get("mesh_space_w", 1))


def _batch(kw, seed: int) -> dict:
    r = np.random.default_rng(seed)
    b = B_ROW * _sizes(kw)[0]
    return {k: r.uniform(size=(b, H, W, 3)).astype(np.float32)
            for k in ("real_a", "seg_a")}


def _submit(compiles, fn, *args):
    """``fn(*args)`` lowered here, compiled in ``compiles`` (a thread pool:
    XLA compiles outside the GIL) and run when the result is asked for."""
    done = compiles.submit(jax.jit(fn).lower(*args).compile, FAST)
    return lambda: done.result()(*args)


def _up_sharded(kw) -> list:
    """Whether each of up blocks 0-2 runs sharded (its skip is)."""
    _, s, w = _sizes(kw)
    n = int(np.log2(H))
    down = tsp.pix2pix_sharded(n, H // s, W // w, _grid_like(_sizes(kw)))
    return [down[n - 2 - i] for i in range(3)]


def _masks(kw, rngs, compiles):
    """Each step's dropout masks, per rank in rank order, as the JAX sp
    step draws them: ``fold_in(fold_in(rng, d), 1)`` split in three, a
    block's key folded by s (and w) where it runs sharded, a bernoulli(0.5)
    at the block's shape (the shard's, or the data row's whole plane's);
    a function that returns them, the program compiled in ``compiles``."""
    D, S, Wn = _sizes(kw)
    if kw["dropout_mode"] == "keras_quirk":
        return lambda: [[None] * (D * S * Wn) for _ in rngs]
    shapes = tstep.new_generator(Config(**kw)).drop_shapes(B_ROW, H, W)
    up = _up_sharded(kw)

    def fn(rs):
        out = []
        for rng in rs:
            shards = []
            for d in range(D):
                keys = jax.random.split(jax.random.fold_in(
                    jax.random.fold_in(rng, d), 1), 3)
                for s in range(S):
                    for w in range(Wn):
                        ms = []
                        for k, sh, sharded in zip(keys, shapes, up):
                            if sharded:
                                k = jax.random.fold_in(k, s)
                                if Wn > 1:
                                    k = jax.random.fold_in(k, w)
                                sh = (sh[0], sh[1] // S, sh[2] // Wn, sh[3])
                            ms.append(jax.random.bernoulli(k, 0.5, sh))
                        shards.append(ms)
            out.append(shards)
        return out
    got = _submit(compiles, fn, jnp.stack(rngs))
    return lambda: [[[np.array(m) for m in ms] for ms in shards]
                    for shards in got()]


def _jax_case(name, kw, compiles):
    """The case's JAX init state, masks and step, lowered here (the step
    on a placed state of zeros of the init's shapes) and compiled in
    ``compiles``; returns a function that runs the init and both steps and
    returns the ranks' inputs and the references."""
    D, S, Wn = _sizes(kw)
    jcfg = JConfig(**kw, batch_size=B_ROW * D)
    key = jax.random.PRNGKey(9)
    init = _submit(compiles, lambda k: init_sp_state(jcfg, k, n_data=D), key)
    masks = _masks(kw, RNGS, compiles)
    mesh = make_mesh(data=D, space=S, wspace=Wn,
                     devices=jax.devices()[:D * S * Wn])
    batches = [_batch(kw, SEED[name])] * len(RNGS)
    shell = place_sp(jax.tree.map(
        lambda a: jnp.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda k: init_sp_state(jcfg, k, n_data=D), key)),
        mesh)
    lowered = jax.jit(make_sp_step_body(jcfg, mesh)).lower(
        shell, shard_sp_batch(batches[0], mesh), jnp.float32(LR), RNGS[0])
    fn = compiles.submit(lowered.compile, FAST)
    # the p2p step takes no pool draws: zeros of their shapes
    draws = [[(np.zeros(B_ROW, np.float32), np.zeros(B_ROW, np.int32))] * D
             for _ in RNGS]

    def run():
        from test_torch_spatial_step import _plain
        js = init()
        jstate = place_sp(js, mesh)
        step = fn.result()
        states, ref = [_plain(js)], []
        for batch, rng in zip(batches, RNGS):
            jstate, jm = step(jstate, shard_sp_batch(batch, mesh),
                              jnp.float32(LR), rng)
            ref.append(({k: float(v) for k, v in jm.items()},
                        _plain(jstate)))
            states.append(ref[-1][1])
        return {"kw": dict(kw, batch_size=B_ROW * D), "states": states[:-1],
                "batches": batches, "draws": draws, "masks": masks(),
                "lr": LR}, ref
    return run


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The trainer's 2-rank job started first; then the JAX references
    lowered and compiled in a thread pool, and one gloo job per world size
    over its cases, each started as soon as its cases' references are
    in."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("datasets") / "city"
    write_dataset(root, N_TRAIN, N_TEST)
    twork = tmp_path_factory.mktemp("p2p_trainer")
    trainer = start_ranks("trainer", [root, twork, "p2p"],
                          worker="_torch_sp_worker.py")
    cases, refs, jobs = {}, {}, {}

    def world(name):
        return int(np.prod(_sizes(CASES[name])))
    with ThreadPoolExecutor(len(CASES)) as compiles:
        runs = {name: _jax_case(name, CASES[name], compiles)
                for name in CASES}
        for w in sorted({world(k) for k in CASES}):
            mine = {}
            for name in CASES:
                if world(name) == w:
                    cases[name], refs[name] = runs[name]()
                    mine[name] = cases[name]
            work = tmp_path_factory.mktemp(f"p2p_steps{w}")
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
    touts = wait_ranks(trainer)
    for r, (rc, out) in enumerate(touts):
        assert rc == 0, f"trainer rank {r} failed:\n{out}"
        assert "OK imported no JAX module: True" in out, out
    return cases, refs, ranks, (root, twork, [o for _, o in touts])


def _grads(mu_after: dict, mu_before: dict, b1: float) -> dict:
    a, b = dict(_leaves(mu_after)), dict(_leaves(mu_before))
    return {k: (a[k] - b1 * b[k]) / (1 - b1) for k in a}


def _held_grads(got: dict, ref: dict, what: str) -> None:
    assert got.keys() == ref.keys(), what
    for k in ref:
        np.testing.assert_allclose(
            got[k], ref[k], rtol=0,
            atol=GRAD_ATOL + GRAD_OF_MAX * np.abs(ref[k]).max(),
            err_msg=f"{what} {k}")


def _held_bn(got: dict, ref: dict, what: str) -> None:
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys() and ref, what
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=f"{what} {k}",
                                   **BN_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sp_steps_match_jax(job, name):
    """Both steps: the losses every rank returns, both nets' gradients and
    new BN states, the step and Adam counts, the pool's global layout; the
    ranks' replicas (the EMA among them) bitwise equal."""
    cases, refs, ranks, _ = job
    b1 = Config(**CASES[name]).beta1
    for t, (jm, js) in enumerate(refs[name]):
        start = cases[name]["states"][t]
        for rk in ranks[name]:
            tm = rk["steps"][t][0]
            for k in ("gen_loss", "disc_loss"):
                assert tm[k] == pytest.approx(jm[k], rel=LOSS_REL), (t, k)
        ts = ranks[name][0]["steps"][t][1]
        for opt in ("g_opt", "d_opt"):
            got = _grads(ts[opt]["mu"], getattr(start, opt).mu, b1)
            ref = _grads(getattr(js, opt).mu, getattr(start, opt).mu, b1)
            _held_grads(got, ref, f"{name} step {t} {opt}")
        for bn in ("gen_bn", "disc_bn"):
            _held_bn(ts[bn], getattr(js, bn), f"{name} step {t} {bn}")
        assert int(ts["step"]) == int(js.step) == t + 1
        assert int(ts["g_opt"]["count"]) == int(js.g_opt.count) == t + 1
        for rk in ranks[name][1:]:
            other = dict(_leaves({k: v for k, v in rk["steps"][t][1].items()
                                  if v is not None}))
            for k, v in _leaves({k: v for k, v in ts.items()
                                 if v is not None}):
                np.testing.assert_array_equal(v, other[k], err_msg=k)
    assert {k: v.shape for k, v in ts["pool"]["buffer"].items()} == \
        {"fake": js.pool.buffer.shape}


@pytest.mark.parametrize("name", list(CASES))
def test_sp_first_step_matches_one_process(job, name):
    """The first step against the port's one-process step on each data
    row's whole plane (batch norm couples a row's samples, so one process
    a row), from the same JAX state with the shards' masks put together:
    the rows' losses and gradients averaged, and their new BN states
    averaged, as the spatial step averages them over the data rows."""
    cases, _, ranks, _ = job
    case, kw = cases[name], CASES[name]
    D, S, Wn = _sizes(kw)
    one = Config(**{**case["kw"], "mesh_data": 1, "mesh_space": 1,
                    "mesh_space_w": 1, "batch_size": B_ROW})
    js = case["states"][0]
    up = _up_sharded(kw)
    got_m, got_g, got_d, got_bn = [], [], [], []
    for d in range(D):
        st = bridge.train_state_from_jax(one, js)
        batch = {k: torch.from_numpy(v[d * B_ROW:(d + 1) * B_ROW])
                 for k, v in case["batches"][0].items()}
        masks = None
        shards = case["masks"][0]
        if shards[0] is not None:
            row = shards[d * S * Wn:(d + 1) * S * Wn]
            masks = tuple(torch.from_numpy(
                assemble([m[i] for m in row], (1, S, Wn)) if up[i]
                else row[0][i]) for i in range(3))
        m, g, dg, _, bns = tstep.losses_and_grads(one, st, batch, None,
                                                  masks)
        got_m.append(m)
        got_g.append(g)
        got_d.append(dg)
        got_bn.append(bridge.train_state_to_jax(st._replace(
            gen_bn=bns[0], disc_bn=bns[1])))
    tm, ts = ranks[name][0]["steps"][0]
    for k in ("gen_loss", "disc_loss"):
        want = np.mean([m[k].item() for m in got_m])
        assert tm[k] == pytest.approx(want, rel=LOSS_REL), k
    b1 = one.beta1
    for opt, grads in (("g_opt", got_g), ("d_opt", got_d)):
        got = _grads(ts[opt]["mu"], getattr(js, opt).mu, b1)
        ref = dict(_leaves(bridge.params_to_jax(
            {k: sum(g[k].detach() for g in grads) / D for k in grads[0]})))
        _held_grads(got, ref, f"{name} {opt}")
    for bn in ("gen_bn", "disc_bn"):
        want = jax.tree.map(lambda *a: np.mean(a, 0),
                            *[b[bn] for b in got_bn])
        _held_bn(ts[bn], want, f"{name} {bn}")


def test_bridge_of_a_jax_pix2pix_sp_state(job):
    """Each rank of the data 2 x space 2 case bridges the JAX pix2pix
    ``init_sp_state``: the pix2pix pair, both nets' BN states, the EMA and
    its block of the unused pool of one slot a data row; the state back
    in the JAX layout puts the same tree together."""
    cases, _, _, _ = job
    case = cases["p2p_d2s2"]
    cfg = Config(**case["kw"])
    js = case["states"][0]
    for rank in range(4):
        st = bridge.train_state_from_jax(cfg, js, "cpu", rank, 2)
        d, s = rank // 2, rank % 2
        assert type(st.disc_params).__name__ == "DiscriminatorPix2pix"
        np.testing.assert_array_equal(
            st.pool.buffer["fake"].numpy(),
            js.pool.buffer[d:d + 1, s * H // 2:(s + 1) * H // 2])
        back = bridge.train_state_to_jax(st)
        for tree in ("gen_params", "gen_bn", "disc_params", "disc_bn",
                     "ema"):
            want = dict(_leaves(getattr(js, tree)))
            got = dict(_leaves(back[tree]))
            assert got.keys() == want.keys(), tree
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)


def _line(out: str, what: str) -> dict:
    m = re.search(rf"OK {what} rank \d step (\d+) count (\d+) gen_loss "
                  rf"(\S+) digest (\w+)", out)
    assert m, out
    return {"step": int(m[1]), "loss": float(m[3]), "digest": m[4]}


def test_trainer_epoch_resume_and_test(job, tmp_path, monkeypatch):
    """``main`` over 2 ranks: one epoch of 4 steps, then a resume; both
    ranks end each run with the same losses and state bit for bit (both
    nets' BN states in it); the coordinator's checkpoint holds both nets'
    BN states and the pool in the JAX global layout (one slot, the whole
    plane); ``--phase test`` of it in one process loads the pix2pix pair
    and writes the fakes."""
    _, _, _, (root, work, outs) = job
    for what, step in (("trainer", 4), ("resume", 8)):
        a, b = (_line(o, what) for o in outs)
        assert a == b and a["step"] == step and np.isfinite(a["loss"]), what
    assert " [*] spatially sharded over 2 ranks (gloo)" in outs[0]
    assert "from the host iterator (the split is not resident: " \
        "--device_dataset_mb 0)" in outs[0]
    assert " [*] Load SUCCESS" in outs[0] and "Epoch:" not in outs[1]
    gen = torch.load(work / "ckpt" / "city" / "gen" / "cp-0001.pt",
                     weights_only=True)
    disc = torch.load(work / "ckpt" / "city" / "disc" / "cp-0001.pt",
                      weights_only=True)
    saved = torch.load(work / "ckpt" / "city" / "train" / "cp-0001.pt",
                       weights_only=True)
    assert "down1_bn" in gen["bn"] and "conv_bn" in disc["bn"]
    assert not torch.equal(disc["bn"]["conv_bn"]["moving_var"],
                           torch.ones(32))
    assert saved["step"] == 8
    assert tuple(saved["pool_buffer"]["fake"].shape) == (1, H, W, 3)
    monkeypatch.chdir(tmp_path)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    tmain.main(["--phase", "test", "--dataset_dir", str(root),
                "--img_height", "32", "--img_width", "32", "--ngf", "4",
                "--ndf", "4", "--compute_dtype", "float32",
                "--use_pix2pix", "--loss_mode", "p2p", "--mesh_space", "2",
                "--checkpoint_dir", str(work / "ckpt"), "--test_dir",
                str(tmp_path / "out")], device="cpu")
    assert {"v0.png", "v1.png"} <= set(os.listdir(tmp_path / "out"))
    assert not torch.distributed.is_initialized()
