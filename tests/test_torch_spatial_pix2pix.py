"""Port parity of the pix2pix pair's sharded ops and nets
(``sggan_tpu_torch/parallel/spatial.py``): ``batch_norm_sp`` (training
and on the moving stats), the gathers and scatters, and
``generator_pix2pix_sp`` and ``discriminator_pix2pix_sp`` (training, and
on the moving stats as ``--dropout_mode keras_quirk`` runs them), on the
ranks' blocks of one global input, as gloo processes on the CPU
(``tests/_torch_sp_worker.py p2p``): two ranks (space 2) and four (space 2
x wspace 2, and space 4, whose deepest skip and so up block 0 run
replicated).  Each is held against the JAX package's
``sggan_tpu/parallel/spatial.py`` under ``jax.shard_map`` and ``jax.vjp``
on 2 or 4 of ``conftest.py``'s 8 CPU devices, compiled as
``tests/test_torch_step.py`` compiles, in a thread pool while the ranks
run.  The generator is fed the dropout masks the JAX forward draws:
per shard (its key folded by the space and wspace index) where an up
block runs sharded, one for the whole plane where it runs replicated.

The nets are the port's, drawn from a torch seed and bridged to the JAX
tree, with random moving stats.  32x32, 2 samples, ngf and ndf 4, f32.
Limits, as ``tests/test_spatial.py:159-220`` holds the JAX package's own
sp batch norm: rtol 1e-4, atol 1e-5 for outputs, new moving stats and
every gradient (a parameter's summed over the ranks, as the JAX vjp of a
replicated parameter sums the shards'; the input's put together), the
atol of a net's gradients 1e-5 of its largest; the new BN states equal
on every rank bitwise."""

import pickle
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_dist import start_ranks, wait_ranks  # noqa: E402
from _torch_sp_common import assemble  # noqa: E402
from sggan_tpu.parallel import make_mesh  # noqa: E402
from sggan_tpu.parallel import spatial as jsp  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.parallel import spatial as tsp  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_step import FAST  # noqa: E402

N, H, W, C = 2, 32, 32, 4
GRIDS = {"space2": (1, 2, 1), "space2x2": (1, 2, 2), "space4": (1, 4, 1)}
# name -> (kind, train)
CASES = {"bn_train": ("bn", True), "bn_eval": ("bn", False),
         "gather": ("gather", True), "gen": ("gen", True),
         "gen_quirk": ("gen", False), "disc": ("disc", True),
         "disc_eval": ("disc", False)}
SEED, DROP_KEY = 5, 11
RTOL, ATOL = 1e-4, 1e-5


def _cfg(sizes) -> Config:
    return Config(image_height=H, image_width=W, ngf=4, ndf=4,
                  compute_dtype="float32", use_pix2pix=True,
                  loss_mode="p2p", mesh_data=sizes[0], mesh_space=sizes[1],
                  mesh_space_w=sizes[2])


def _nets(cfg):
    g = torch.Generator().manual_seed(SEED)
    return tstep.new_generator(cfg, g), tstep.new_discriminator(cfg, g)


def _moving(net, r) -> dict:
    """Random moving stats of every batch norm of ``net`` (``r``: numpy's
    generator)."""
    return {k: {"moving_mean": (0.1 * r.standard_normal(c)
                                ).astype(np.float32),
                "moving_var": r.uniform(0.5, 1.5, c).astype(np.float32)}
            for k, c in net._bn_ch.items()}


def _case_data(name, sizes) -> dict:
    """The case's global inputs, parameters, BN state and cotangent."""
    kind, train = CASES[name]
    r = np.random.default_rng(3)
    cfg = _cfg(sizes)
    gen, disc = _nets(cfg)
    out = {"kind": kind, "train": train, "seed": SEED}
    if kind == "bn":
        out["inputs"] = {"x": (0.4 + r.standard_normal((N, H, W, C))
                               ).astype(np.float32)}
        out["params"] = {"gamma": r.uniform(0.5, 1.5, C).astype(np.float32),
                         "beta": (0.1 * r.standard_normal(C)
                                  ).astype(np.float32)}
        out["state"] = {"bn": {
            "moving_mean": (0.1 * r.standard_normal(C)).astype(np.float32),
            "moving_var": r.uniform(0.5, 1.5, C).astype(np.float32)}}
        shape = (N, H, W, C)
    elif kind == "gather":
        out["inputs"] = {"x": r.standard_normal((N, H, W, C)).astype(
            np.float32)}
        shape = (N, H, W, C)
    elif kind == "gen":
        out["inputs"] = {"x": r.uniform(-1, 1, (N, H, W, 3)).astype(
            np.float32)}
        out["state"] = _moving(gen, r)
        shape = (N, H, W, 3)
    else:
        out["inputs"] = {k: r.uniform(-1, 1, (N, H, W, 3)).astype(
            np.float32) for k in ("inp", "x")}
        out["state"] = _moving(disc, r)
        shape = (N, H // 8 - 2, W // 8 - 2, 1)
    out["ct"] = r.standard_normal(shape).astype(np.float32)
    return out


def _masks(sizes, gen) -> list:
    """Each rank's keep masks of up blocks 0-2 as ``generator_pix2pix_sp``
    draws them: ``split(key, 3)``, the block's key folded by the space (and
    wspace) index where the block runs sharded, one bernoulli(0.5) each at
    the block's shape (the shard's, or the whole plane's); rank order."""
    _, s_n, w_n = sizes
    down = tsp.pix2pix_sharded(len(gen.down_ch), H // s_n, W // w_n,
                               _grid_like(sizes))
    shapes = gen.drop_shapes(N, H, W)

    def fn(key):
        out = []
        for s in range(s_n):
            for w in range(w_n):
                ms = []
                for i, (k, sh) in enumerate(zip(jax.random.split(key, 3),
                                                shapes)):
                    if down[len(down) - 2 - i]:
                        k = jax.random.fold_in(k, s)
                        if w_n > 1:
                            k = jax.random.fold_in(k, w)
                        sh = (sh[0], sh[1] // s_n, sh[2] // w_n, sh[3])
                    ms.append(jax.random.bernoulli(k, 0.5, sh))
                out.append(ms)
        return out
    key = jax.random.PRNGKey(DROP_KEY)
    got = jax.jit(fn).lower(key).compile(FAST)(key)
    return [[np.asarray(m) for m in ms] for ms in got]


def _grid_like(sizes):
    """A stand-in with the sizes ``pix2pix_sharded`` reads."""
    from types import SimpleNamespace
    return SimpleNamespace(data=sizes[0], space=sizes[1], wspace=sizes[2])


def _jax_grid(sizes, cases, compiles):
    """Every case's JAX output, new BN state and vjp on this grid, one
    program each, compiled in ``compiles``; returns a function that runs
    them and returns {case: {"y", "dx", "dparams" (torch layout), "new"}}.
    """
    _, s, w = sizes
    mesh = make_mesh(data=1, space=s, wspace=w,
                     devices=jax.devices()[:s * w])
    aw = "wspace" if w > 1 else None
    spec = P(None, "space", "wspace") if aw else P(None, "space")
    f32 = jnp.float32
    gen, disc = _nets(_cfg(sizes))
    nets = {"gen": bridge.params_to_jax(gen.state_dict()),
            "disc": bridge.params_to_jax(disc.state_dict())}

    def program(name):
        kind, train = CASES[name]
        case = cases[name]
        if kind == "bn":
            def f(p, st, x):
                y, new = jsp.batch_norm_sp({**p, **st["bn"]}, x, "space",
                                           training=train, axis_w=aw)
                return y, {"bn": {k: new[k] for k in ("moving_mean",
                                                      "moving_var")}}
            out = (spec, P())
            params = case["params"]
        elif kind == "gather":
            def f(p, st, x):
                y = jsp.all_gather_h(x, "space")
                if aw:
                    y = jsp.all_gather_w(y, aw)
                y = jnp.flip(y, (1, 2) if aw else (1,))
                y = jsp.scatter_h(y, "space")
                return (jsp.scatter_w(y, aw) if aw else y), {}
            out = (spec, P())
            params = {}
        elif kind == "gen":
            def f(p, st, x):
                return jsp.generator_pix2pix_sp(
                    p, st, x, "space", f32, rng=jax.random.PRNGKey(DROP_KEY),
                    deterministic=not train, train=train, ngf=4, axis_w=aw)
            out = (spec, P())
            params = nets["gen"]
        else:
            def f(p, st, x, inp):
                return jsp.discriminator_pix2pix_sp(p, st, inp, x, "space",
                                                    f32, train=train,
                                                    axis_w=aw)
            out = (P(), P())
            params = nets["disc"]
        n_in = 4 if kind == "disc" else 3
        mapped = jax.shard_map(f, mesh=mesh,
                               in_specs=(P(), P(), *[spec] * (n_in - 2)),
                               out_specs=out, check_vma=False)

        def run(p, st, ins, ct):
            y, vjp, new = jax.vjp(lambda p_, x_: mapped(p_, st, x_, *ins[1:]),
                                  p, ins[0], has_aux=True)
            dp, dx = vjp(ct)
            return {"y": y, "dx": dx, "dparams": dp, "new": new}
        ins = [jnp.asarray(case["inputs"]["x"])]
        if kind == "disc":
            ins.append(jnp.asarray(case["inputs"]["inp"]))
        args = (params, case.get("state", {}), ins,
                jnp.asarray(case["ct"]))
        return args, compiles.submit(jax.jit(run).lower(*args).compile,
                                     FAST)
    progs = {name: program(name) for name in CASES}

    def results():
        ref = {}
        for name, (args, c) in progs.items():
            r = jax.tree.map(np.asarray, c.result()(*args))
            if CASES[name][0] in ("gen", "disc"):
                r["dparams"] = {k: v.numpy() for k, v in
                                bridge.params_from_jax(r["dparams"]).items()}
            ref[name] = r
        return ref
    return results


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """One gloo job a world size (the space 2 x wspace 2 and space 4 grids
    in one job of 4 ranks), started first; the JAX programs of every grid
    compile in a thread pool while they run."""
    torch.set_num_threads(1)
    jobs, grid_cases = {}, {}
    for gname, sizes in GRIDS.items():
        cfg = _cfg(sizes)
        kw = {k: getattr(cfg, k) for k in (
            "image_height", "image_width", "ngf", "ndf", "compute_dtype",
            "use_pix2pix", "loss_mode", "mesh_data", "mesh_space",
            "mesh_space_w")}
        cases = {}
        for name in CASES:
            cases[name] = dict(_case_data(name, sizes), kw=kw)
        cases["gen"]["masks"] = _masks(sizes, _nets(cfg)[0])
        cases["gen_quirk"]["masks"] = [None] * (sizes[1] * sizes[2])
        grid_cases[gname] = cases
    for world in sorted({s[1] * s[2] for s in GRIDS.values()}):
        mine = {f"{g}/{n}": c for g, cs in grid_cases.items()
                if GRIDS[g][1] * GRIDS[g][2] == world for n, c in cs.items()}
        work = tmp_path_factory.mktemp(f"p2p{world}")
        with open(work / "cases.pkl", "wb") as f:
            pickle.dump(mine, f)
        jobs[world] = work, start_ranks("p2p", [work / "cases.pkl", work],
                                        world=world,
                                        worker="_torch_sp_worker.py")
    with ThreadPoolExecutor(len(CASES) * len(GRIDS)) as compiles:
        runs = {g: _jax_grid(GRIDS[g], grid_cases[g], compiles)
                for g in GRIDS}
        refs = {g: run() for g, run in runs.items()}
    ranks, outs = {}, []
    for world, (work, procs) in jobs.items():
        got = wait_ranks(procs)
        for r, (rc, o) in enumerate(got):
            assert rc == 0, f"rank {r} failed:\n{o}"
        outs += [o for _, o in got]
        for r in range(world):
            with open(work / f"rank{r}.pkl", "rb") as f:
                for key, v in pickle.load(f).items():
                    g, n = key.split("/")
                    ranks.setdefault(g, {}).setdefault(n, []).append(v)
    return refs, ranks, outs


def _close(got, ref, what, atol=ATOL) -> None:
    assert np.shape(got) == np.shape(ref), what
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol, err_msg=what)


def _held(job, name: str) -> None:
    refs, ranks, _ = job
    kind = CASES[name][0]
    for gname, sizes in GRIDS.items():
        ref, blocks = refs[gname][name], ranks[gname][name]
        what = f"{gname} {name}"
        if kind == "disc":  # replicated logits: every rank's the same
            for b in blocks[1:]:
                np.testing.assert_array_equal(b["y"], blocks[0]["y"])
            got_y = blocks[0]["y"]
        else:
            got_y = assemble([b["y"] for b in blocks], sizes)
        _close(got_y, ref["y"], f"{what} y")
        scale = max([np.abs(v).max() for v in ref["dparams"].values()]
                    + [np.abs(ref["dx"]).max()]) if kind in ("gen", "disc") \
            else 1.0
        _close(assemble([b["dx"] for b in blocks], sizes), ref["dx"],
               f"{what} dx", ATOL * scale)
        assert ref["dparams"].keys() == blocks[0]["dparams"].keys(), what
        for k, v in ref["dparams"].items():
            _close(sum(b["dparams"][k] for b in blocks), v, f"{what} d{k}",
                   ATOL * scale)
        new = blocks[0]["new"]
        assert new.keys() == ref["new"].keys(), what
        for k, v in ref["new"].items():
            for n in v:
                for b in blocks[1:]:
                    np.testing.assert_array_equal(b["new"][k][n], new[k][n])
                _close(new[k][n], v[n], f"{what} {k}.{n}")


@pytest.mark.parametrize("name", ["bn_train", "bn_eval"])
def test_batch_norm_sp_matches_jax(job, name):
    """The sharded batch norm on every grid: output, the moving stats it
    returns, and the vjp of the input, gamma and beta."""
    _held(job, name)


def test_gather_and_scatter_match_jax(job):
    """The plane gathered (H, then W on the 2-D grid), flipped, and each
    rank's block taken back: output and the input's gradient, which needs
    the gather's backward to sum every rank's cotangent of a block."""
    _held(job, "gather")


@pytest.mark.parametrize("name", ["gen", "gen_quirk", "disc", "disc_eval"])
def test_sharded_net_matches_jax(job, name):
    """The sharded pix2pix net on every grid, in training (the generator
    with the JAX forward's masks) and on its moving stats: output (the
    discriminator's replicated), the new BN state, the input's and every
    parameter's gradient."""
    _held(job, name)


def test_ranks_import_no_jax(job):
    for out in job[2]:
        assert "OK imported no JAX module: True" in out, out


def test_where_the_plane_is_gathered():
    """``pix2pix_sharded`` at the CLI's 256x512 on space 2 (every block
    but the deepest sharded) and on the test grids: space 4 gathers two
    blocks from the bottom, so up block 0 (whose skip is down block 3's
    output) runs replicated; the 2 x 2 grid gathers where space 2 does."""
    def at(h, w, sizes, n):
        return tsp.pix2pix_sharded(n, h // sizes[1], w // sizes[2],
                                   _grid_like(sizes))
    assert at(256, 512, (1, 2, 1), 8) == [True] * 7 + [False]
    assert at(H, W, GRIDS["space2"], 5) == [True] * 4 + [False]
    assert at(H, W, GRIDS["space2x2"], 5) == [True] * 4 + [False]
    assert at(H, W, GRIDS["space4"], 5) == [True] * 3 + [False] * 2
