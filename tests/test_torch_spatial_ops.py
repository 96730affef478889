"""Port parity of the spatial ops (``sggan_tpu_torch/parallel/spatial.py``
and ``ops/norm.py::instance_norm_sp``): each op on the ranks' blocks of
one global input, two gloo ranks (space 2) and four (space 2 x wspace 2)
on the CPU (``tests/_torch_sp_worker.py ops``), against the JAX package's
``sggan_tpu/parallel/spatial.py`` under ``jax.shard_map`` on 2 and 4 of
``conftest.py``'s 8 CPU devices, compiled without XLA's LLVM passes and
fusion emitters (``tests/test_torch_step.py``'s ``FAST``).  Each op's
output and its vjp (the input's and the parameters') of one random
cotangent, the ranks' blocks put together in the mesh's layout: the
halo exchange along H and along W, ``conv2d_sp`` (k3 s1 and s2: every
conv of the semantic nets), the 7x7 VALID conv after a 3-row sharded
reflect pad (the ResNet's ends), ``conv2d_transpose_sp`` (k3 s1 and s2),
``reflect_pad_sp`` (p 1 and 3, the corners of the 2-D grid), the
instance norm with its moments across ranks (none, relu, leaky),
``seg_boundary_weight_sp`` and ``gradloss_criterion_sp`` (the global
mean of the ranks' local means).

2 samples of 32x32, 4 channels, f32.  Limits: outputs within 1e-5 of the
output's largest element, gradients within 1e-4 of the gradient's
largest.  Then the relu gate at an exact 0 (JAX's ``maximum`` passes half
of dy there) and the conditioning-aware f32 output limit of K1's
checks (``chip_smoke.f32_out_limit``) on a plane of 5 elements."""

import math
import pickle
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _torch_dist import start_ranks, wait_ranks  # noqa: E402
from _torch_sp_common import ACTS, OPS, assemble, rel_err  # noqa: E402
from sggan_tpu.parallel import make_mesh  # noqa: E402
from sggan_tpu.parallel import spatial as jsp  # noqa: E402
from sggan_tpu_torch.ops import norm as tnorm  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_step import FAST  # noqa: E402

N, H, W, C = 2, 32, 32, 4
GRIDS = {"space2": (1, 2, 1), "space2x2": (1, 2, 2)}
FWD_LIMIT, GRAD_LIMIT = 1e-5, 1e-4


def _inputs(seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    # class regions of 6 px: their edges cross the shards' at other rows
    lab = r.integers(0, 3, (N, H // 6 + 1, W // 6 + 1))
    seg = np.eye(3, dtype=np.float32)[lab.repeat(6, 1).repeat(6, 2)[
        :, :H, :W]]
    return {"x": (0.3 + 0.7 * r.standard_normal((N, H, W, C))
                  ).astype(np.float32),
            "seg": seg,
            "tgt": r.uniform(size=(N, H, W, C)).astype(np.float32),
            "wt": (r.uniform(size=(N, H, W, 1)) > 0.5).astype(np.float32)}


def _params(seed: int = 1) -> dict:
    """Each op's tensors in the JAX package's (TF) layout."""
    r = np.random.default_rng(seed)

    def a(*shape, scale=0.3):
        return (scale * r.standard_normal(shape)).astype(np.float32)
    out = {}
    for s in (1, 2):
        out[f"conv_s{s}"] = {"w": a(3, 3, C, 5), "b": a(5)}
        out[f"convT_s{s}"] = {"w": a(3, 3, 5, C), "b": a(5)}
    out["conv_reflect7"] = {"w": a(7, 7, C, 3, scale=0.1), "b": a(3)}
    for name in ACTS:
        out[name] = {"gamma": (0.5 + r.uniform(size=C)).astype(np.float32),
                     "beta": a(C, scale=0.1)}
    return out


def _jax_op(name, p, x, seg, tgt, wt, aw):
    """The JAX package's op ``name`` on a shard (inside shard_map)."""
    f32 = jnp.float32
    if name == "halo_h":
        return jsp.halo_exchange(x, 1, 2, "space", 1)
    if name == "halo_w":
        return jsp.halo_exchange(x, 2, 1, "wspace", 2)
    if name.startswith("conv_s"):
        return jsp.conv2d_sp(p, x, int(name[-1]), "space", f32, axis_w=aw)
    if name == "conv_reflect7":
        return jsp.conv2d_valid_after_reflect_sp(
            p, jsp.reflect_pad_sp(x, 3, "space", axis_w=aw), "space", f32)
    if name.startswith("convT_s"):
        return jsp.conv2d_transpose_sp(p, x, int(name[-1]), "space", f32,
                                       axis_w=aw)
    if name.startswith("reflect"):
        return jsp.reflect_pad_sp(x, int(name[-1]), "space", axis_w=aw)
    if name in ACTS:
        return jsp.instance_norm_sp(p, x, "space", act=ACTS[name],
                                    axis_w=aw)
    if name == "seg_weight":
        return jsp.seg_boundary_weight_sp(seg, "space", axis_w=aw)
    axes = ("space",) + ((aw,) if aw else ())
    return jax.lax.pmean(jsp.gradloss_criterion_sp(
        x, tgt, wt, "space", axis_w=aw), axes)


def _jax_case(sizes, inputs, params, compiles):
    """The JAX outputs and vjps of every op on this grid, one program,
    lowered here and compiled in ``compiles`` (a thread pool: XLA compiles
    outside the GIL); the cotangents drawn at the outputs' shapes.
    Returns a function that runs it, the cotangents and the ops' names."""
    _, s, w = sizes
    mesh = make_mesh(data=1, space=s, wspace=w,
                     devices=jax.devices()[:s * w])
    aw = "wspace" if w > 1 else None
    spec = P(None, "space", "wspace") if aw else P(None, "space")
    names = [k for k, (need_w, _) in OPS.items() if aw or not need_w]

    def mapped(name):
        out = P() if name == "gradloss" else spec
        return jax.shard_map(
            lambda x, p, seg, tgt, wt: _jax_op(name, p, x, seg, tgt, wt,
                                               aw),
            mesh=mesh, in_specs=(spec, P(), spec, spec, spec),
            out_specs=out, check_vma=False)

    ins = [jnp.asarray(inputs[k]) for k in ("x", "seg", "tgt", "wt")]
    shapes = {n: jax.eval_shape(mapped(n), ins[0], params.get(n, {}),
                                *ins[1:]).shape for n in names}
    r = np.random.default_rng(2)
    cts = {n: r.standard_normal(shapes[n]).astype(np.float32)
           for n in names if OPS[n][1] and n != "gradloss"}

    def fn(x, ps, seg, tgt, wt, cts):
        out = {}
        for n in names:
            f = mapped(n)
            if not OPS[n][1]:
                out[n] = {"y": f(x, ps.get(n, {}), seg, tgt, wt)}
                continue
            y, vjp = jax.vjp(lambda x_, p_: f(x_, p_, seg, tgt, wt), x,
                             ps.get(n, {}))
            dx, dp = vjp(cts[n] if n in cts else jnp.ones((), jnp.float32))
            out[n] = {"y": y, "dx": dx, "dparams": dp}
        return out
    args = (ins[0], params, *ins[1:], cts)
    compiled = compiles.submit(jax.jit(fn).lower(*args).compile, FAST)
    return (lambda: jax.tree.map(np.asarray, compiled.result()(*args)),
            cts, names)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Per grid: the JAX program lowered, then one gloo job of its ranks
    started; both grids' compiles and jobs run at once."""
    inputs, params = _inputs(), _params()
    tparams = {k: {n: t.numpy() for n, t in
                   bridge.params_from_jax(v).items()}
               for k, v in params.items()}
    grids = {}
    with ThreadPoolExecutor(len(GRIDS)) as compiles:
        for gname, sizes in GRIDS.items():
            run, cts, names = _jax_case(sizes, inputs, params, compiles)
            work = tmp_path_factory.mktemp(gname)
            case = {"kw": dict(image_height=H, image_width=W, mesh_data=1,
                               mesh_space=sizes[1], mesh_space_w=sizes[2]),
                    "inputs": inputs, "params": tparams, "cts": cts}
            with open(work / "case.pkl", "wb") as f:
                pickle.dump(case, f)
            grids[gname] = (sizes, run, names, work, start_ranks(
                "ops", [work / "case.pkl", work], world=sizes[1] * sizes[2],
                worker="_torch_sp_worker.py"))
        refs = {g: v[1]() for g, v in grids.items()}
    out = {}
    for gname, (sizes, _, names, work, procs) in grids.items():
        outs = wait_ranks(procs)
        for r, (rc, o) in enumerate(outs):
            assert rc == 0, f"rank {r} failed:\n{o}"
            assert "OK imported no JAX module: True" in o, o
        ranks = []
        for r in range(len(procs)):
            with open(work / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        out[gname] = (sizes, refs[gname], ranks, names)
    return out


def _tf(name: str, t):
    """A torch-layout parameter gradient in the JAX (TF) layout."""
    return np.transpose(t, (2, 3, 1, 0)) if t.ndim == 4 else t


def _held(job, prefix: str) -> None:
    for gname, (sizes, ref, ranks, names) in job.items():
        for n in (n for n in names if n.startswith(prefix)):
            blocks = [rk[n] for rk in ranks]
            if n == "gradloss":
                got = np.mean([b["y"] for b in blocks])
            else:
                got = assemble([b["y"] for b in blocks], sizes)
            assert np.shape(got) == np.shape(ref[n]["y"]), (gname, n)
            err = rel_err(got, ref[n]["y"])
            assert err <= FWD_LIMIT, (gname, n, "y", err)
            if "dx" not in ref[n]:
                continue
            dx = assemble([b["dx"] for b in blocks], sizes)
            err = rel_err(dx, ref[n]["dx"])
            assert err <= GRAD_LIMIT, (gname, n, "dx", err)
            for k, v in ref[n]["dparams"].items():
                got_p = _tf(k, sum(b["dparams"][k] for b in blocks))
                err = rel_err(got_p, v)
                assert err <= GRAD_LIMIT, (gname, n, k, err)


@pytest.mark.parametrize("prefix", [
    "halo", "conv_s", "conv_reflect7", "convT", "reflect", "in_",
    "seg_weight", "gradloss"])
def test_ops_match_jax(job, prefix):
    """Outputs and vjps of the ops named ``prefix*`` on both grids."""
    _held(job, prefix)


def test_relu_gate_at_an_exact_zero_follows_jax():
    """A plane whose pre-activation is exactly 0 at one element (a
    symmetric plane, gamma 1, beta 0): ``jnp.maximum``'s gradient there is
    half of dy, which the spatial norm's twin follows; the one-card norm's
    gate (``pre > 0``) passes none, and differs by more than the limit."""
    x = np.array([-2.0, -1.0, 0.0, 1.0, 2.0, -0.5, 0.5, 3.0, -3.0],
                 np.float32).reshape(1, 3, 3, 1)
    dy = np.arange(1, 10, dtype=np.float32).reshape(1, 3, 3, 1)
    p = {"gamma": np.ones(1, np.float32), "beta": np.zeros(1, np.float32)}
    mesh = make_mesh(data=1, space=1, devices=jax.devices()[:1])
    f = jax.shard_map(
        lambda x_: jsp.instance_norm_sp(p, x_, "space", act="relu"),
        mesh=mesh, in_specs=P(None, "space"), out_specs=P(None, "space"),
        check_vma=False)
    def grad(x_, dy_):
        return jax.vjp(f, x_)[1](dy_)[0]
    args = (jnp.asarray(x), jnp.asarray(dy))
    ref = np.asarray(jax.jit(grad).lower(*args).compile(FAST)(*args))
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    y = tnorm.instance_norm_sp(pt, xt, 9, None, act="relu")
    assert y[0, 0, 2, 0].item() == 0.0  # the planted tie
    got = torch.autograd.grad(y, xt, torch.from_numpy(dy))[0].numpy()
    assert rel_err(got, ref) <= GRAD_LIMIT
    xo = torch.from_numpy(x).requires_grad_(True)
    one_card = torch.autograd.grad(
        tnorm.instance_norm(pt, xo, act="relu"), xo,
        torch.from_numpy(dy))[0].numpy()
    assert rel_err(one_card, ref) > 10 * GRAD_LIMIT


def test_f32_output_limit_of_an_ill_conditioned_plane():
    """The K1 checks' f32 output limit (``chip_smoke.f32_out_limit``,
    derived there from the plane's conditioning) on the semantic D's last
    site, planes of (1, 5) whose variance is 1e-2 of mean^2: the plain
    twin in f32 is within it of an f64 reference of the same function,
    while the fixed limit 1e-5 (abs + rel) fails."""
    import chip_smoke
    g = torch.Generator().manual_seed(0)
    x = 3.0 + 0.3 * torch.randn(16, 1, 5, 512, generator=g)
    gam = 0.5 + torch.rand(512, generator=g)
    bet = 0.1 * torch.randn(512, generator=g)
    y = tnorm.instance_norm_ref(x, gam, bet, 1e-3, "leaky_relu", 0.3)
    xd = x.double()
    mean = xd.mean((1, 2), keepdim=True)
    var = ((xd - mean) ** 2).mean((1, 2), keepdim=True)
    ref = (xd - mean) * torch.rsqrt(var + 1e-3) * gam.double() \
        + bet.double()
    ref = torch.where(ref >= 0, ref, 0.3 * ref)
    d = (y.double() - ref).abs()
    lim = chip_smoke.f32_out_limit(x, gam, ref, mean[:, 0, 0],
                                   torch.rsqrt(var + 1e-3)[:, 0, 0])
    assert (d <= lim).all()
    assert (d > 1e-5 + 1e-5 * ref.abs()).any()
    # the limit adds to the fixed one only where the plane's mean is large
    # against its spread: none on a centred plane
    xc = x - x.mean((1, 2), keepdim=True)
    m0 = xc.double().mean((1, 2))
    r0 = torch.rsqrt(xc.double().var((1, 2), unbiased=False) + 1e-3)
    extra = chip_smoke.f32_out_limit(xc, gam, ref, m0, r0) \
        - (1e-5 + 1e-5 * ref.abs())
    assert extra.max().item() <= (math.ceil(math.log2(5)) + 3) \
        * 2.0 ** -24 * 2 * gam.max().item()
