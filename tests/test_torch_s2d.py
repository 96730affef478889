"""Port parity: ``sggan_tpu_torch.ops.s2d`` against ``sggan_tpu.ops.s2d``
on the CPU, f32, the same numpy inputs and kernels (the port's kernels in
OIHW through ``utils.bridge``).

Mirrors ``tests/test_ops.py``'s s2d tests: ``best_block`` (the TPU's cost
model, which the port copies) and the applicability rules equal to JAX's
over a grid; ``_s2d_weights`` equal after the layout change; the strided
forms' values and gradients (to the kernel and the input) against the
JAX functions at blocks (8, 4), (4, 4) and (2, 1), and against the direct
conv: rtol 1e-5 / atol 1e-5 of the values' scale, as
``tests/test_torch_layers.py`` holds the convs (both sides sum in f32 in
other orders).  ``head_block``, the port's choice, is measured on the
card (``chip_smoke.py`` phase 31); here it is held admissible."""

import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.ops import conv2d as jconv2d  # noqa: E402
from sggan_tpu.ops import reflect_pad as jreflect_pad  # noqa: E402
from sggan_tpu.ops import s2d as js  # noqa: E402
from sggan_tpu_torch.ops import layers as tl  # noqa: E402
from sggan_tpu_torch.ops import s2d as ts  # noqa: E402
from sggan_tpu_torch.utils.bridge import params_from_jax  # noqa: E402

BLOCKS = [(8, 4), (4, 4), (2, 1)]
GRID = list(itertools.product((3, 7), (1, 3, 8, 34), (16, 30, 256),
                              (16, 38, 512)))


def _data(seed, x_shape, k=7, cin=8, cout=3):
    r = np.random.default_rng(seed)
    x = r.uniform(size=x_shape).astype(np.float32)
    w = (r.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = r.standard_normal(cout).astype(np.float32)
    return x, {"w": w, "b": b}


def _close(got, ref, scale=None):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("k,cout,h,w", GRID)
def test_best_block_matches_jax(k, cout, h, w):
    assert ts.best_block(k, cout, h, w) == js.best_block(k, cout, h, w)
    assert ts._block_cost(k, cout, 4, 8) == js._block_cost(k, cout, 4, 8)


def test_best_block_at_the_head_and_head_block_admissible():
    assert ts.best_block(7, 3, 256, 512) == (8, 4)
    for h, w in ((256, 512), (32, 32), (30, 30), (1024, 2048)):
        rh, rw = ts.head_block(7, 3, h, w)
        assert h % rh == 0 and w % rw == 0 and rh * rw * 3 <= 128


@pytest.mark.parametrize("r", BLOCKS + [(1, 1), (4, 8)])
@pytest.mark.parametrize("shape", [(2, 22, 38, 8), (1, 24, 40, 8),
                                   (1, 9, 13, 8), (1, 30, 30, 8)])
def test_applicability_matches_jax(shape, r):
    _, p = _data(0, shape)
    w = params_from_jax(p)["w"]
    x = torch.zeros(shape)
    assert ts.applicable(x, w, r) == js.applicable(jnp.zeros(shape),
                                                   p["w"], r)
    assert ts.applicable_reflect(x, w, r) == js.applicable_reflect(
        jnp.zeros(shape), p["w"], r)


@pytest.mark.parametrize("r", BLOCKS)
def test_s2d_weights_match_jax(r):
    _, p = _data(1, (1, 8, 8, 8), cin=5, cout=4)
    ref = np.asarray(js._s2d_weights(jnp.asarray(p["w"]), *r))
    got = ts._s2d_weights(params_from_jax(p)["w"], *r).numpy()
    # JAX's (P, Q, cin, (pi, pj, o)) is the port's ((pi, pj, o), cin, P, Q)
    np.testing.assert_array_equal(got, ref.transpose(3, 2, 0, 1))


# one program, without XLA's LLVM passes and CPU fusion emitters, as
# tests/test_torch_step.py compiles the JAX step
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}


def _vjp_jax(fn, p, x, ct):
    def f(w, x, b, ct):
        y, vjp = jax.vjp(lambda w, x: fn({"w": w, "b": b}, x), w, x)
        return (y, *vjp(ct))
    args = [jnp.asarray(a) for a in (p["w"], x, p["b"], ct)]
    return jax.jit(f).lower(*args).compile(FAST)(*args)


def _vjp_port(fn, p, x, ct):
    tp = params_from_jax(p)
    w = tp["w"].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn({"w": w, "b": tp["b"]}, xt)
    dw, dx = torch.autograd.grad(y, (w, xt), torch.from_numpy(ct))
    # the kernel's gradient back in JAX's HWIO
    return y.detach().numpy(), dw.permute(2, 3, 1, 0).numpy(), dx.numpy()


@pytest.mark.parametrize("r", BLOCKS)
@pytest.mark.parametrize("form", ["valid", "reflect"])
def test_s2d_forms_match_jax_and_the_direct_conv(form, r):
    if form == "valid":
        x, p = _data(2, (2, 22, 38, 8))
        jfn = lambda p, x: js.conv2d_valid_s2d(p, x, r=r)  # noqa: E731
        tfn = lambda p, x: ts.conv2d_valid_s2d(p, x, r)  # noqa: E731
        direct = lambda p, x: tl.conv2d(p, x, 1, "VALID")  # noqa: E731
    else:
        x, p = _data(3, (2, 24, 40, 8))
        jfn = lambda p, x: js.conv2d_reflect_s2d(p, x, r=r)  # noqa: E731
        tfn = lambda p, x: ts.conv2d_reflect_s2d(p, x, r)  # noqa: E731
        direct = tl.conv2d_reflect_ref
    ct = np.random.default_rng(4).standard_normal(
        (2, 16, 32, 3) if form == "valid" else (2, 24, 40, 3)).astype(
        np.float32)
    ref = _vjp_jax(jfn, p, x, ct)
    got = _vjp_port(tfn, p, x, ct)
    plain = _vjp_port(direct, p, x, ct)
    for g, rf, d in zip(got, ref, plain):
        _close(g, rf)
        _close(g, d)
    if form == "reflect":  # the JAX package's own oracle, the padded form
        _close(got[0], jconv2d(p, jreflect_pad(jnp.asarray(x), 3), 1,
                               "VALID"))
