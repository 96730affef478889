"""Port parity: the fused conv3x3 + instance norm op (K2) against the JAX
package's Pallas kernel (interpret mode, as tests/test_pallas_conv_in.py
runs it) and its XLA composition ``conv3_in_xla``, case for case with that
file: forward f32 at rtol/atol 2e-5, bf16 at 5e-2, the saved y16, mean and
rsig, gradients at 2e-4, the tall multi-tile plane (the gradients, the
tall plane, the bf16 moments and the no-JAX import are in
``tests/test_torch_conv_in_grads.py``).  On the CPU the port's
``conv3_in`` runs its plain twin ``conv3_in_ref`` and the plain backward;
the CUDA kernel is held against the twin on the card by
tests/test_torch_cuda.py.  Inputs are made with numpy from a seed.  Each
JAX reference is one program compiled without XLA's LLVM passes and CPU
fusion emitters, as tests/test_torch_step.py compiles the JAX step (f32
results equal to rounding)."""

import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.models import generator_resnet as jgen  # noqa: E402
from sggan_tpu.ops import layers as jlayers  # noqa: E402
from sggan_tpu.ops import pallas_conv_in as pci  # noqa: E402
from sggan_tpu_torch import perf_conv_in  # noqa: E402
from sggan_tpu_torch.models.generator_resnet import GeneratorResnet  # noqa: E402
from sggan_tpu_torch.ops import cuda_conv_in as cci  # noqa: E402
from sggan_tpu_torch.ops import cuda_in  # noqa: E402
from sggan_tpu_torch.ops import layers as tlayers  # noqa: E402
from sggan_tpu_torch.utils.bridge import params_from_jax  # noqa: E402

ACTS = [None, "relu", "leaky_relu"]
SHAPES = [(2, 8, 16, 8, 8), (1, 16, 8, 16, 8)]
TALL = (1, 64, 8, 8, 16)
F32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}


def _fast(fn, *args):
    """``fn(*args)`` as one program compiled with ``FAST``."""
    return jax.jit(fn).lower(*args).compile(FAST)(*args)


def _setup(shape, seed=0):
    """x, the kernel in the JAX layout (3, 3, cin, cout), gamma, beta."""
    n, h, w, cin, cout = shape
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, h, w, cin)).astype(np.float32)
    wk = (r.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)) \
        .astype(np.float32)
    gamma = (1.0 + 0.1 * r.standard_normal(cout)).astype(np.float32)
    beta = (0.1 * r.standard_normal(cout)).astype(np.float32)
    return x, wk, gamma, beta


def _torch_args(x, wk, gamma, beta, dtype=torch.float32):
    """The same numbers as the port takes them: the kernel through the
    bridge, (cout, cin, 3, 3)."""
    w = params_from_jax({"w": wk})["w"]
    return (torch.from_numpy(x).to(dtype), w, torch.from_numpy(gamma),
            torch.from_numpy(beta))


@functools.cache
def _pallas(shape, act, dtype="float32", seed=0):
    """(y, y16, mean, rsig) of the Pallas kernel in interpret mode."""
    out = _fast(lambda x, wk, gamma, beta: pci._pallas_forward(
        x.astype(dtype), wk, gamma, beta, pci.IN_EPS, act, 0.3,
        interpret=True), *_setup(shape, seed))
    return [np.asarray(o, np.float32) for o in out]


def _xla(shape, act, dtype="float32", seed=0):
    y = _fast(lambda x, wk, gamma, beta: pci.conv3_in_xla(
        {"w": wk}, {"gamma": gamma, "beta": beta}, x.astype(dtype),
        act=act), *_setup(shape, seed))
    return np.asarray(y, np.float32)


@functools.cache
def _port(shape, act, dtype=torch.float32, seed=0):
    """(y, y16, mean, rsig) of the port on the CPU: y from ``conv3_in``,
    the rest from its plain twin, whose y must be the same."""
    x, w, g, b = _torch_args(*_setup(shape, seed), dtype)
    before = cci.launches
    y = cci.conv3_in(x, w, g, b, act=act)
    assert cci.launches == before  # a CPU tensor launches no kernel
    ref = cci.conv3_in_ref(x, w, g, b, cci.IN_EPS, act, 0.3)
    assert y.dtype == dtype and torch.equal(y, ref[0])
    return [t.float().numpy() for t in ref]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas_interpret(shape, act):
    np.testing.assert_allclose(_port(shape, act)[0], _pallas(shape, act)[0],
                               **F32)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_xla(shape, act):
    np.testing.assert_allclose(_port(shape, act)[0], _xla(shape, act), **F32)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_saved_tensors_match_pallas_forward(shape, act):
    """y16, mean and rsig as the Pallas forward saves them for its VJP;
    the port keeps the moments as (N, C), the JAX kernel as (N, 1, 1, C)."""
    n, cout = shape[0], shape[-1]
    _, y16, mean, rsig = _port(shape, act)
    _, jy16, jmean, jrsig = _pallas(shape, act)
    assert mean.shape == rsig.shape == (n, cout)
    np.testing.assert_allclose(y16, jy16, **F32)
    np.testing.assert_allclose(mean, jmean.reshape(n, cout), **F32)
    np.testing.assert_allclose(rsig, jrsig.reshape(n, cout), **F32)


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_forward_bf16_close(ref):
    """bf16 activations: one rounding of the f32 conv accumulator, moments
    of the rounded value; agreement to ~1 bf16 ulp of the normalized
    scale."""
    shape = (2, 16, 16, 8, 8)
    got = _port(shape, "relu", torch.bfloat16)[0]
    want = (_pallas(shape, "relu", "bfloat16")[0] if ref == "pallas"
            else _xla(shape, "relu", "bfloat16"))
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def _port_grads(fn, shape, act, seed):
    leaves = [t.requires_grad_(True)
              for t in _torch_args(*_setup(shape, seed))]
    dx, dw, dg, db = torch.autograd.grad(fn(*leaves, act).square().sum(),
                                         leaves)
    # dw back in the JAX layout
    return dx, dw.permute(2, 3, 1, 0), dg, db


@pytest.mark.parametrize("x_shape,w_shape,ok", [
    ((1, 16, 16, 8), (8, 8, 3, 3), True),
    ((1, 7, 5, 3), (6, 3, 3, 3), True),      # no row-tile or lane gate
    ((1, 2, 2, 8), (8, 8, 3, 3), True),
    ((1, 16, 16, 4), (8, 8, 3, 3), False),   # cin mismatch
    ((1, 16, 16, 8), (8, 8, 5, 5), False),   # not 3x3
    ((1, 1, 16, 8), (8, 8, 3, 3), False),    # reflect pad 1 needs H >= 2
    ((1, 16, 1, 8), (8, 8, 3, 3), False),
])
def test_supported_gate(x_shape, w_shape, ok):
    assert cci.supported(torch.zeros(x_shape), torch.zeros(w_shape)) is ok


@pytest.mark.parametrize("lo,hi,axis", [(1, 1, 1), (1, 1, 2), (2, 0, 1),
                                        (0, 3, 2), (2, 1, 2), (1, 3, 1)])
def test_unpad_reflect_transpose_matches_jax(lo, hi, axis):
    dy = np.random.default_rng(7).standard_normal((2, 9, 8, 3)) \
        .astype(np.float32)
    want = jlayers._unpad_reflect_transpose(jnp.asarray(dy), lo, hi, axis)
    t = torch.from_numpy(dy.copy())
    got = tlayers.unpad_reflect_transpose(t, lo, hi, axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(t.numpy(), dy)  # the input is not changed


def test_unpad_reflect_transpose_is_the_adjoint_of_reflect_pad():
    r = np.random.default_rng(8)
    x = torch.from_numpy(r.standard_normal((1, 6, 5, 2))).requires_grad_(True)
    pad = ((0, 0), (2, 1), (1, 3), (0, 0))
    y = tlayers.reflect_pad(x, pad)
    dy = torch.from_numpy(r.standard_normal(tuple(y.shape)))
    (want,) = torch.autograd.grad(y, x, dy)
    got = tlayers.unpad_reflect_transpose(dy, 2, 1, axis=1)
    got = tlayers.unpad_reflect_transpose(got, 1, 3, axis=2)
    torch.testing.assert_close(got, want)


def _unfused(x, w, g, b, act):
    return cci.conv3_in_unfused({"w": w}, {"gamma": g, "beta": b}, x, act=act)


@pytest.mark.parametrize("act", ACTS)
def test_backward_matches_autograd_of_unfused(act):
    """The explicit backward against plain autograd through the port's
    reflect pad, conv and instance norm, at an odd plane."""
    shape = (2, 7, 9, 5, 6)
    got = _port_grads(lambda x, w, g, b, a: cci.conv3_in(x, w, g, b, act=a),
                      shape, act, seed=11)
    want = _port_grads(_unfused, shape, act, seed=11)
    for a, r, name in zip(got, want, ("dx", "dw", "dgamma", "dbeta")):
        torch.testing.assert_close(a, r, msg=name, **GRAD)


def test_planted_fault_dgrad_straight_to_the_plane_is_caught(monkeypatch):
    """A dgrad with padding=1 straight to (H, W) drops the mirrored border
    terms of the reflect pad; the comparison above must see it."""
    def faulty(x, w, d_y16):
        wc = w.to(x.dtype)
        g = d_y16.permute(0, 3, 1, 2)
        dx = torch.nn.grad.conv2d_input(
            (x.shape[0], x.shape[3], x.shape[1], x.shape[2]), wc, g,
            padding=1).permute(0, 2, 3, 1)
        xp = tlayers.reflect_pad(x, 1).permute(0, 3, 1, 2)
        return dx, torch.nn.grad.conv2d_weight(xp, wc.shape, g)

    shape = (2, 7, 9, 5, 6)
    want = _port_grads(_unfused, shape, "relu", seed=11)
    monkeypatch.setattr(cci, "conv_grads", faulty)
    got = _port_grads(lambda x, w, g, b, a: cci.conv3_in(x, w, g, b, act=a),
                      shape, "relu", seed=11)
    torch.testing.assert_close(got[1], want[1], **GRAD)  # dw is untouched
    # the lost strips are the pad's rows and columns, which mirror onto
    # row 1 and row H - 2 (column 1 and column W - 2) of the plane
    err = (got[0] - want[0]).abs()
    hit = torch.zeros(err.shape[1:3], dtype=torch.bool)
    hit[[1, -2], :] = True
    hit[:, [1, -2]] = True
    assert err[:, ~hit].max() <= 2e-4
    assert err[:, hit].max() > 1e-2


def _res_block_tree(c, seed):
    """A JAX resblock subtree (HWIO kernels, dead biases, gamma, beta)."""
    r = np.random.default_rng(seed)
    tree = {}
    for i in (1, 2):
        tree[f"conv{i}"] = {
            "w": (r.standard_normal((3, 3, c, c)) / np.sqrt(9 * c))
            .astype(np.float32), "b": np.zeros(c, np.float32)}
        tree[f"in{i}"] = {
            "gamma": (1 + 0.1 * r.standard_normal(c)).astype(np.float32),
            "beta": (0.1 * r.standard_normal(c)).astype(np.float32)}
    return tree


def test_resblock_through_k2_matches_res_block():
    """x + conv3_in(act=None)(conv3_in(act=relu)(x)) on a JAX resblock's
    weights carried over by the bridge: the port's ``_res_block`` and the
    JAX package's, forward and the gradient to x."""
    c = 8
    tree = _res_block_tree(c, seed=13)
    x = np.random.default_rng(14).standard_normal((2, 12, 10, c)) \
        .astype(np.float32)
    flat = params_from_jax(tree)
    blk = {k: {leaf: flat[f"{k}.{leaf}"] for leaf in tree[k]} for k in tree}

    def k2_block(x):
        h = cci.conv3_in(x, blk["conv1"]["w"], blk["in1"]["gamma"],
                         blk["in1"]["beta"], act="relu")
        return x + cci.conv3_in(h, blk["conv2"]["w"], blk["in2"]["gamma"],
                                blk["in2"]["beta"], act=None)

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fn(xt)
        return y.detach(), torch.autograd.grad(y.square().sum(), xt)[0]

    y, dx = grads(k2_block)
    y_ref, dx_ref = grads(lambda xt: GeneratorResnet._res_block(
        blk, xt, torch.float32))
    torch.testing.assert_close(y, y_ref, **F32)
    torch.testing.assert_close(dx, dx_ref, **GRAD)

    jy, jdx = _fast(jax.value_and_grad(
        lambda xj, jtree: jnp.sum(jgen._res_block(jtree, xj, jnp.float32,
                                                  False) ** 2)), x, tree)
    np.testing.assert_allclose(y.square().sum().item(), float(jy), rtol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **GRAD)


@pytest.mark.parametrize("case", ["cpu_tensor", "bad_act", "five_by_five",
                                  "cin_mismatch"])
def test_wrapper_refuses(case):
    x = torch.zeros(1, 8, 8, 8)
    w, g, b = torch.zeros(8, 8, 3, 3), torch.ones(8), torch.zeros(8)
    before = cci.launches, cuda_in.launches
    if case == "cpu_tensor":
        with pytest.raises(ValueError, match="CUDA tensor"):
            cci.conv3_in_cuda(x, w, g, b)
    elif case == "bad_act":
        with pytest.raises(ValueError, match="act="):
            cci.conv3_in(x, w, g, b, act="gelu")
    elif case == "five_by_five":
        with pytest.raises(ValueError, match="3, 3"):
            cci.conv3_in(x, torch.zeros(8, 8, 5, 5), g, b)
    else:
        with pytest.raises(ValueError, match="cin"):
            cci.conv3_in(x, torch.zeros(8, 4, 3, 3), g, b)
    assert (cci.launches, cuda_in.launches) == before


def test_function_saves_what_the_backward_needs():
    x, w, g, b = _torch_args(*_setup((2, 8, 8, 8, 8)))
    assert cci.conv3_in(x, w, g, b).grad_fn is None
    y = cci.conv3_in(x.requires_grad_(True), w, g, b)
    shapes = [tuple(t.shape) for t in y.grad_fn.saved_tensors]
    assert shapes == [(2, 8, 8, 8), (8, 8, 3, 3), (8,), (8,), (2, 8, 8, 8),
                      (2, 8), (2, 8)]


def test_perf_conv_in_cpu_prints_its_json_line(capsys):
    out = perf_conv_in.main([], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and line["backend"] == "cpu"
    (row,) = line["rows"]
    assert row["shape"] == [2, 16, 16, 8, 8]
    assert row["max_abs_diff"] < perf_conv_in.CHECK_LIMIT
    for k in ("fwd_k2", "fwd_unfused", "fwd_conv_reflect", "fwd_conv_only",
              "fwdbwd_k2", "fwdbwd_unfused"):
        assert row[k + "_ms"] > 0 and row[k + "_tfs"] > 0


def test_perf_conv_in_raises_on_a_failed_check(monkeypatch):
    monkeypatch.setattr(perf_conv_in, "CHECK_LIMIT", 0.0)
    with pytest.raises(AssertionError, match="mismatch"):
        perf_conv_in.main([], device="cpu")


def test_perf_conv_in_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run the full table")
    with pytest.raises(RuntimeError, match="CUDA"):
        perf_conv_in.main([])
