"""Port parity of the sharded nets (``sggan_tpu_torch/parallel/spatial.py``):
``generator_resnet_sp``, ``generator_unet_sp`` (deterministic, and with
each shard's dropout masks as the JAX forward draws them) and the patch
head ``discriminator_sp``, on the ranks' blocks of one global input, two
gloo ranks (space 2) on the CPU (``tests/_torch_sp_worker.py nets``).
Each is held against the JAX package's sp forward and ``jax.vjp`` under
``jax.shard_map`` on 2 CPU devices (one program, compiled as
``tests/test_torch_step.py`` compiles), and
against the port's own one-process forward on the whole plane (the
masks put together in the mesh's layout).

The nets are the port's, drawn from a torch seed and bridged to the JAX
tree (``bridge.params_to_jax``), so that no JAX initializer is compiled.
32x32, 2 samples, ngf and ndf 4, 8 classes, f32.  Limits: outputs within
1e-5 of the output's largest element, the input's and every parameter's
gradient within 1e-4 of its largest (a parameter's gradient summed over
the ranks, as the JAX vjp of a replicated parameter sums the shards'),
the largest taken at no less than 1e-3 of the net's largest parameter
gradient (a gradient that is 0 in exact arithmetic, as the U-Net's d1-d3
biases' without dropout, holds only rounding).
Input seed 3: no gate of either package's forward sits within f32's
rounding of 0 in a way that flips (ROADMAP Queue 3)."""

import pickle
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_dist import start_ranks, wait_ranks  # noqa: E402
from _torch_sp_common import assemble, rel_err  # noqa: E402
from sggan_tpu.parallel import make_mesh  # noqa: E402
from sggan_tpu.parallel import spatial as jsp  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_step import FAST  # noqa: E402

N, H, W, N_CLASS = 2, 32, 32, 8
# the 2-D grid's halos and corners are held op by op
# (test_torch_spatial_ops.py) and in a step (test_torch_spatial_step.py)
GRIDS = {"space2": (1, 2, 1)}
NETS = {"resnet": dict(use_resnet=True), "unet": dict(use_resnet=False),
        "unet_masks": dict(use_resnet=False),
        "disc": dict(use_resnet=True)}
SEED, INPUT_SEED, DROP_KEY = 5, 3, 11
FWD_LIMIT, GRAD_LIMIT = 1e-5, 1e-4
NOISE_FLOOR = 1e-3


def _cfg(net: str, sizes) -> Config:
    return Config(image_height=H, image_width=W, ngf=4, ndf=4,
                  segment_class=N_CLASS, compute_dtype="float32",
                  loss_mode="sggan", mesh_data=sizes[0],
                  mesh_space=sizes[1], mesh_space_w=sizes[2], **NETS[net])


def _nets(cfg):
    g = torch.Generator().manual_seed(SEED)
    return tstep.new_generator(cfg, g), tstep.new_discriminator(cfg, g)


def _inputs() -> dict:
    r = np.random.default_rng(INPUT_SEED)
    return {"x": r.uniform(-1, 1, (N, H, W, 3)).astype(np.float32),
            "mask": np.eye(N_CLASS, dtype=np.float32)[
                r.integers(0, N_CLASS, (N, H // 8, W // 8))]}


def _shard_masks(sizes, drop_shapes):
    """Each shard's d1-d3 keep masks as ``generator_unet_sp`` draws them:
    the key folded by the space (and wspace) index, split in three, one
    ``bernoulli(k, 0.5, shape)`` each, at the shard's shapes; in rank
    order."""
    _, s_n, w_n = sizes

    def one(key):
        return [jax.random.bernoulli(k, 0.5, sh)
                for k, sh in zip(jax.random.split(key, 3), drop_shapes)]

    def fn(key):
        out = []
        for s in range(s_n):
            for w in range(w_n):
                k = jax.random.fold_in(key, s)
                out.append(one(jax.random.fold_in(k, w) if w_n > 1 else k))
        return out
    key = jax.random.PRNGKey(DROP_KEY)
    masks = jax.jit(fn).lower(key).compile(FAST)(key)
    return [[np.asarray(m) for m in ms] for ms in masks]


def _jax_grid(sizes, inputs, cts, compiles):
    """The JAX sp forward and vjp of every net on this grid, a program
    each, lowered here and compiled in ``compiles`` (a thread pool: XLA
    compiles outside the GIL, so the nets' compiles overlap one another and
    the next net's tracing); returns a function that runs them and returns
    {net: {"y", "dx", "dparams" (torch layout)}}."""
    _, s, w = sizes
    mesh = make_mesh(data=1, space=s, wspace=w,
                     devices=jax.devices()[:s * w])
    aw = "wspace" if w > 1 else None
    spec = P(None, "space", "wspace") if aw else P(None, "space")
    f32 = jnp.float32
    params = {}
    for net in NETS:
        gen, disc = _nets(_cfg(net, sizes))
        params[net] = bridge.params_to_jax(
            (disc if net == "disc" else gen).state_dict())

    def body(net):
        def f(p, x, mask):
            if net == "resnet":
                return jsp.generator_resnet_sp(p, x, "space", f32,
                                               axis_w=aw)
            if net == "disc":
                return jsp.discriminator_sp(p, x, mask, "space", f32,
                                            axis_w=aw)
            return jsp.generator_unet_sp(
                p, x, "space", f32, rng=jax.random.PRNGKey(DROP_KEY),
                deterministic=net == "unet", axis_w=aw)
        return jax.shard_map(f, mesh=mesh, in_specs=(P(), spec, spec),
                             out_specs=spec, check_vma=False)

    def fn(net):
        def vjp_of(p, x, mask, ct):
            f = body(net)
            y, vjp = jax.vjp(lambda p_, x_: f(p_, x_, mask), p, x)
            dp, dx = vjp(ct)
            return {"y": y, "dx": dx, "dparams": dp}
        return vjp_of
    x, mask = jnp.asarray(inputs["x"]), jnp.asarray(inputs["mask"])
    args = {net: (params[net], x, mask, jnp.asarray(cts[net]))
            for net in NETS}
    compiled = {net: compiles.submit(jax.jit(fn(net)).lower(
        *args[net]).compile, FAST) for net in NETS}

    def run():
        ref = {net: jax.tree.map(np.asarray, c.result()(*args[net]))
               for net, c in compiled.items()}
        for r in ref.values():
            r["dparams"] = {k: v.numpy() for k, v in
                            bridge.params_from_jax(r["dparams"]).items()}
        return ref
    return run


def _one_process(net, sizes, inputs, ct, masks):
    """The port's forward and autograd on the whole plane."""
    cfg = _cfg(net, sizes)
    gen, disc = _nets(cfg)
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    if net == "disc":
        mod = disc
        y = disc(x, torch.from_numpy(inputs["mask"]), torch.float32)
    else:
        mod = gen
        full = None
        if masks is not None:
            full = [torch.from_numpy(assemble([m[i] for m in masks], sizes))
                    for i in range(3)]
        y = gen(x, {}, torch.float32, full, train=full is not None,
                pad_free_head=False)[0]
    names, params = zip(*mod.named_parameters())
    grads = torch.autograd.grad(y, [x, *params], torch.from_numpy(ct),
                                allow_unused=True)
    return {"y": y.detach().numpy(), "dx": grads[0].numpy(),
            "dparams": {k: (np.zeros(p.shape, np.float32) if g is None
                            else g.numpy())
                        for k, p, g in zip(names, params, grads[1:])}}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Per grid: one gloo job of the grid's ranks over every net, started
    first; while they run, the JAX references (both grids' compiles at
    once) and the one-process results."""
    torch.set_num_threads(1)
    inputs = _inputs()
    grids = {}
    for gname, sizes in GRIDS.items():
        cases, cts = {}, {}
        for net in NETS:
            cfg = _cfg(net, sizes)
            shape = (N, H // 8, W // 8, 1) if net == "disc" \
                else (N, H, W, 3)
            ct = np.random.default_rng(7).standard_normal(shape).astype(
                np.float32)
            masks = None
            if net == "unet_masks":
                gen = _nets(cfg)[0]
                masks = _shard_masks(sizes, gen.drop_shapes(
                    N, H // sizes[1], W // sizes[2]))
            cases[net] = {"kw": {k: getattr(cfg, k) for k in (
                "image_height", "image_width", "ngf", "ndf",
                "segment_class", "compute_dtype", "loss_mode", "use_resnet",
                "mesh_data", "mesh_space", "mesh_space_w")},
                "seed": SEED, "net": "disc" if net == "disc" else "gen",
                "inputs": inputs, "ct": ct, "masks": masks}
            cts[net] = ct
        work = tmp_path_factory.mktemp(gname)
        with open(work / "cases.pkl", "wb") as f:
            pickle.dump(cases, f)
        world = sizes[1] * sizes[2]
        grids[gname] = (sizes, cases, cts, work, start_ranks(
            "nets", [work / "cases.pkl", work], world=world,
            worker="_torch_sp_worker.py"))
    with ThreadPoolExecutor(len(NETS) * len(GRIDS)) as compiles:
        runs = {g: _jax_grid(v[0], inputs, v[2], compiles)
                for g, v in grids.items()}
        refs = {g: run() for g, run in runs.items()}
    out = {}
    for gname, (sizes, cases, cts, work, procs) in grids.items():
        ones = {net: _one_process(net, sizes, inputs, cts[net],
                                  cases[net]["masks"]) for net in NETS}
        outs = wait_ranks(procs)
        for r, (rc, o) in enumerate(outs):
            assert rc == 0, f"rank {r} failed:\n{o}"
            assert "OK imported no JAX module: True" in o, o
        ranks = []
        for r in range(len(procs)):
            with open(work / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        out[gname] = (sizes, refs[gname], ones, ranks)
    return out


def _got(sizes, ranks, net) -> dict:
    blocks = [rk[net] for rk in ranks]
    return {"y": assemble([b["y"] for b in blocks], sizes),
            "dx": assemble([b["dx"] for b in blocks], sizes),
            "dparams": {k: sum(0.0 if b["dparams"][k] is None
                               else b["dparams"][k] for b in blocks)
                        for k in blocks[0]["dparams"]}}


def _held(got, ref, what) -> None:
    assert got["y"].shape == ref["y"].shape, what
    err = rel_err(got["y"], ref["y"])
    assert err <= FWD_LIMIT, (what, "y", err)
    err = rel_err(got["dx"], ref["dx"])
    assert err <= GRAD_LIMIT, (what, "dx", err)
    assert got["dparams"].keys() == ref["dparams"].keys(), what
    # a tensor whose gradient is 0 in exact arithmetic (the U-Net's d1-d3
    # biases without dropout: an instance norm follows) holds only noise;
    # its scale is NOISE_FLOOR of the net's largest parameter gradient
    floor = NOISE_FLOOR * max(np.abs(v).max() for v in
                              ref["dparams"].values())
    for k, v in ref["dparams"].items():
        d = np.abs(np.asarray(got["dparams"][k], np.float64) - v).max()
        err = d / max(np.abs(v).max(), floor)
        assert err <= GRAD_LIMIT, (what, k, err)


@pytest.mark.parametrize("net", list(NETS))
def test_sharded_net_matches_jax(job, net):
    """The ranks' outputs and vjps against the JAX sp forward's."""
    for gname, (sizes, refs, _, ranks) in job.items():
        _held(_got(sizes, ranks, net), refs[net], f"{gname} {net}")


@pytest.mark.parametrize("net", list(NETS))
def test_sharded_net_matches_one_process(job, net):
    """The ranks' outputs and vjps against the port's forward on the whole
    plane (the ResNet's head in the JAX sp forward's form: reflect pad and
    VALID conv)."""
    for gname, (sizes, _, ones, ranks) in job.items():
        _held(_got(sizes, ranks, net), ones[net], f"{gname} {net}")
