"""The port's data-parallel step against one process, on every batch seed
of ``SEEDS``: two gloo ranks (``tests/_torch_dp_worker.py steps``) run
two steps of each mode of ``tests/test_torch_dp.py`` (the ResNet cycle
with its identity and gradient terms on), and this process runs each
shard's forward and backward with the same state, draws and masks,
averages the two shards' gradients, batch-norm stats and losses, and
applies the same updates.  The ranks' losses, parameters, Adam states,
EMA and batch-norm stats equal the one process's bit for bit, and each
rank's pool rows equal its shard's.  The port's own init starts each
mode, with a full pool whose rows differ between the ranks; the second
step starts from the state the first left.

This is the check that does not depend on the batch:
``tests/test_torch_dp.py`` holds the steps to the JAX package on the
batches where the two packages' f32 gradients agree element by element,
which they do not on every batch (PERF.md, open questions, has the seeds
that miss and the f64 witness, ``tests/_torch_dp_witness.py``)."""

import copy
import pickle
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_dist import start_ranks, wait_ranks  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.train import cycle as tcycle  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402

N, B, H, W, N_CLASS, POOL = 2, 4, 32, 32, 8, 2  # B: the global batch
LR = 1e-3
SEEDS = range(4)
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
                         use_lsgan=True, L1_lambda=10.0, identity_lambda=5.0,
                         Lg_lambda=5.0),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as each rank runs: the shards' arithmetic is then
    the ranks' own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cycle: bool, seed: int) -> dict:
    r = np.random.default_rng(seed)
    out = {}
    for d in ("ab" if cycle else "a"):
        out[f"real_{d}"] = r.uniform(size=(B, H, W, 3)).astype(np.float32)
        out[f"seg_{d}"] = r.uniform(size=(B, H, W, 3)).astype(np.float32)
        out[f"mask_{d}"] = np.eye(N_CLASS, dtype=np.float32)[
            r.integers(0, N_CLASS, (B, H // 8, W // 8))]
    return out


def _start(cfg) -> SimpleNamespace:
    """The port's init as a JAX-layout state of N shards whose pool is
    full, each rank's rows its own."""
    js = bridge.train_state_to_jax(
        tstep.init_state(cfg, torch.Generator().manual_seed(3), "cpu"))
    r = np.random.default_rng(11)
    buf = {k: np.concatenate([r.uniform(-1, 1, v.shape).astype(v.dtype)
                              for _ in range(N)])
           for k, v in js["pool"]["buffer"].items()}
    for k in buf:  # the pooled masks stay one-hot
        if k.startswith("mask"):
            buf[k] = np.eye(N_CLASS, dtype=np.float32)[
                r.integers(0, N_CLASS, buf[k].shape[:-1])]
    return SimpleNamespace(
        **{k: js[k] for k in ("gen_params", "gen_bn", "disc_params",
                              "disc_bn", "ema")},
        g_opt=SimpleNamespace(**js["g_opt"]),
        d_opt=SimpleNamespace(**js["d_opt"]),
        pool=SimpleNamespace(buffer=buf["fake"] if list(buf) == ["fake"]
                             else buf, count=POOL),
        step=0)


def _draws(cfg, seed: int):
    """Each step's and shard's pool draws and dropout keep masks."""
    r = np.random.default_rng(100 + seed)
    b = B // N
    shapes = tstep.new_generator(cfg).drop_shapes(b, H, W) \
        if not cfg.use_resnet else []
    pools = cfg.loss_mode in ("sggan", "cycle")
    draws = [[(r.uniform(size=b).astype(np.float32),
               r.integers(0, POOL, b)) if pools else None
              for _ in range(N)] for _ in range(2)]
    masks = [[[r.uniform(size=s) < 0.5 for s in shapes] or None
              for _ in range(N)] for _ in range(2)]
    return draws, masks


def _cases() -> dict:
    cases = {}
    for mode, kw in MODES.items():
        cfg = Config(**{**kw, "mesh_data": 1})
        for seed in SEEDS:
            draws, masks = _draws(cfg, seed)
            cases[f"{mode}/{seed}"] = {
                "kw": kw, "states": [_start(cfg)], "lr": LR,
                "batches": [_batch(cfg.loss_mode == "cycle", seed)] * 2,
                "draws": draws, "masks": masks}
    return cases


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 2-rank gloo job over every case, and while it runs, each case's
    one-process steps over both shards."""
    cases = _cases()
    work = tmp_path_factory.mktemp("dp_shards")
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    procs = start_ranks("steps", [work / "cases.pkl", work])
    try:
        ones = {name: _one_process(case) for name, case in cases.items()}
    finally:
        outs = wait_ranks(procs)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
    ranks = []
    for r in range(N):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return cases, ranks, ones


def _mean(a, b):
    if isinstance(a, dict):
        return {k: _mean(a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(map(_mean, a, b))
    return (a + b) / 2


def _one_process(case) -> list:
    """Each step as one process computes it: both shards' forward and
    backward, their mean, the updates.  Returns per step the losses and
    each rank's state in the JAX layout."""
    cfg = Config(**{**case["kw"], "mesh_data": 1})
    cycle = cfg.loss_mode == "cycle"
    states = [bridge.train_state_from_jax(cfg, case["states"][0], "cpu", r,
                                          N) for r in range(N)]
    b = B // N
    out = []
    for t, batch in enumerate(case["batches"]):
        res = []
        for r in range(N):
            shard = {k: torch.from_numpy(v[r * b:(r + 1) * b])
                     for k, v in batch.items()}
            d = case["draws"][t][r]
            if d is not None:
                d = tpool.PoolDraws(torch.from_numpy(d[0]),
                                    torch.from_numpy(d[1]).long())
            m = case["masks"][t][r]
            m = None if m is None else tuple(torch.from_numpy(x) for x in m)
            fn = tcycle.losses_and_grads if cycle else tstep.losses_and_grads
            res.append(fn(cfg, states[r], shard, d, m))
        metrics = _mean(res[0][0], res[1][0])
        g, d = _mean(res[0][1], res[1][1]), _mean(res[0][2], res[1][2])
        bn = None if cycle else _mean(res[0][4], res[1][4])
        for r, st in enumerate(states):
            tstep.adam_update(st.gen_params, st.g_opt, g, LR, cfg.beta1)
            tstep.adam_update(st.disc_params, st.d_opt, d, LR, cfg.beta1)
            if bn is not None:
                tstep._assign(st.gen_bn, bn[0])
                tstep._assign(st.disc_bn, bn[1])
            tstep._ema_update(cfg, st.ema, st.gen_params)
            states[r] = tstep._keep_pool(st, res[r][3])._replace(
                step=st.step + 1)
        # copies: the pool's arrays share the live buffers' memory
        out.append(({k: v.item() for k, v in metrics.items()},
                    copy.deepcopy([bridge.train_state_to_jax(st)
                                   for st in states])))
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif tree is not None:
        yield prefix[:-1], np.asarray(tree)


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_steps_equal_one_process_over_both_shards(job, mode):
    cases, ranks, ones = job
    for seed in SEEDS:
        name = f"{mode}/{seed}"
        for t, (m, refs) in enumerate(ones[name]):
            for r in range(N):
                got_m, got = ranks[r][name]["steps"][t]
                assert got_m == m, (name, t, r)
                ref = dict(_leaves({k: v for k, v in refs[r].items()
                                    if k != "pool"}))
                have = dict(_leaves({k: v for k, v in got.items()
                                     if k != "pool"}))
                assert have.keys() == ref.keys()
                for k in ref:
                    np.testing.assert_array_equal(
                        have[k], ref[k], err_msg=f"{name} step {t} {k}")
                for k, v in refs[r]["pool"]["buffer"].items():
                    rows = len(v)  # this rank's, rank after rank
                    np.testing.assert_array_equal(
                        got["pool"]["buffer"][k][r * rows:(r + 1) * rows], v,
                        err_msg=f"{name} step {t} pool {k} rank {r}")
                assert got["pool"]["count"] == refs[r]["pool"]["count"]
