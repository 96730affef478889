"""Port parity: the plain instance norm (the CUDA kernels' twins) against
the JAX package's XLA path, its Pallas kernel (interpret mode, as
tests/test_pallas.py runs it) and its custom VJP (``jax.vjp`` of
``sggan_tpu.ops.norm.instance_norm`` reaches ``_in_fused_bwd``).
Tolerances are tests/test_pallas.py's: forward f32 1e-5, bf16 2e-2;
gradients f32 rtol 1e-4 / atol 1e-5.  The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from sggan_tpu.ops import pallas_in  # noqa: E402
from sggan_tpu.ops import norm as jnorm  # noqa: E402
from sggan_tpu.ops.norm import _instance_norm_xla  # noqa: E402
from sggan_tpu_torch.ops import cuda_in  # noqa: E402
from sggan_tpu_torch.ops import norm as tnorm  # noqa: E402

SHAPES = [(2, 8, 8, 64), (1, 16, 8, 128), (2, 8, 4, 256), (1, 4, 4, 34)]
# XLA without its LLVM optimisation and fusion emitters, as
# tests/test_torch_step.py compiles its step: the same f32 results to
# rounding, in a fraction of the compile time
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}
ACTS = [None, "relu", "leaky_relu"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(shape, seed=0):
    r = np.random.default_rng(seed)
    c = shape[-1]
    x = (r.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    gamma = r.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (r.standard_normal(c) * 0.1).astype(np.float32)
    return x, gamma, beta


def _compile(fn, *args):
    """``fn(*args)`` as one program compiled with ``FAST``."""
    return jax.jit(fn).lower(*args).compile(FAST)(*args)


def _close(got, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _ref(x, gamma, beta, act, dtype):
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    y = tnorm.instance_norm_ref(xt, torch.from_numpy(gamma),
                                torch.from_numpy(beta), 1e-3, act, 0.3)
    assert y.dtype == xt.dtype
    return y.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_xla(shape, act, dtype):
    x, gamma, beta = _inputs(shape)
    ref = _compile(lambda x, g, b: _instance_norm_xla(x, g, b, 1e-3, act,
                                                      0.3),
                   jnp.asarray(x).astype(dtype), jnp.asarray(gamma),
                   jnp.asarray(beta))
    _close(_ref(x, gamma, beta, act, dtype), ref, dtype)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_pallas_interpret(shape, act):
    x, gamma, beta = _inputs(shape, seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = _compile(lambda x, g, b: pallas_in.instance_norm_pallas(
            x, g, b, 1e-3, act, 0.3), jnp.asarray(x), jnp.asarray(gamma),
            jnp.asarray(beta))
    _close(_ref(x, gamma, beta, act, "float32"), ref, "float32")


def test_instance_norm_cpu_takes_plain_version_without_counting():
    x, gamma, beta = _inputs((2, 4, 4, 8), seed=2)
    params = {"gamma": torch.from_numpy(gamma), "beta": torch.from_numpy(beta)}
    before = cuda_in.launches
    got = tnorm.instance_norm(params, torch.from_numpy(x), act="relu")
    assert cuda_in.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  _ref(x, gamma, beta, "relu", "float32"))


def test_kernel_wrapper_refuses_cpu_tensor_and_bad_act():
    x = torch.zeros(1, 4, 4, 8)
    g, b = torch.ones(8), torch.zeros(8)
    before = cuda_in.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_in.instance_norm_cuda(x, g, b)
    with pytest.raises(ValueError, match="act="):
        tnorm.instance_norm({"gamma": g, "beta": b}, x, act="gelu")
    assert cuda_in.launches == before


@pytest.mark.parametrize("n,s,c", [
    (1, 256 * 512, 64), (16, 64 * 128, 256), (1, 16, 34), (3, 1, 5),
    (16, 256 * 512, 64), (1, 1000, 1)])
def test_split_rows_covers_the_plane(n, s, c):
    rows, n_split = cuda_in.split_rows(n, s, c)
    assert rows * n_split >= s > rows * (n_split - 1)  # no empty split
    assert rows >= min(s, cuda_in._MIN_ROWS)


GRAD_SHAPES = SHAPES + [(2, 1, 5, 8)]  # H*W = 5: the D chain's last site
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _jax_vjp(x, gamma, beta, dy, act):
    def f(x, g, b):
        return jnorm.instance_norm({"gamma": g, "beta": b}, x, act=act)
    _, vjp = jax.vjp(f, x, gamma, beta)
    return vjp(dy)




def _grad_inputs(shape, dtype, seed=5):
    x, gamma, beta = _inputs(shape, seed)
    dy = np.random.default_rng(seed + 1).standard_normal(shape) \
        .astype(np.float32)
    td = getattr(torch, dtype)
    return (x, gamma, beta, dy,
            torch.from_numpy(x).to(td), torch.from_numpy(dy).to(td))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_backward_matches_jax_custom_vjp(shape, act, dtype):
    """dx, dgamma, dbeta of the port's autograd Function (on the CPU: the
    plain backward) against jax.vjp of the JAX package's instance norm."""
    x, gamma, beta, dy, xt, dyt = _grad_inputs(shape, dtype)
    ref = _compile(functools.partial(_jax_vjp, act=act),
                   jnp.asarray(x).astype(dtype), jnp.asarray(gamma),
                   jnp.asarray(beta), jnp.asarray(dy).astype(dtype))
    xt.requires_grad_(True)
    g = torch.from_numpy(gamma).requires_grad_(True)
    b = torch.from_numpy(beta).requires_grad_(True)
    y = tnorm.instance_norm({"gamma": g, "beta": b}, xt, act=act)
    got = torch.autograd.grad(y, (xt, g, b), dyt)
    assert got[0].dtype == xt.dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r, np.float32),
                                   **GRAD_TOL[dtype])


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 1, 5, 8)])
def test_backward_ref_matches_autograd_of_forward_ref(shape, act):
    x, gamma, beta, dy, xt, dyt = _grad_inputs(shape, "float32", seed=7)
    xt.requires_grad_(True)
    g = torch.from_numpy(gamma).requires_grad_(True)
    b = torch.from_numpy(beta).requires_grad_(True)
    y = tnorm.instance_norm_ref(xt, g, b, 1e-3, act, 0.3)
    ref = torch.autograd.grad(y, (xt, g, b), dyt)
    _, mean, rstd = tnorm._ref_forward(xt.detach(), g, b, 1e-3, act, 0.3)
    got = tnorm.instance_norm_bwd_ref(xt.detach(), dyt, g.detach(),
                                      b.detach(), mean, rstd, act, 0.3)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)


def test_function_saves_only_when_grad_is_needed_and_counts_nothing():
    x, gamma, beta, dy, xt, dyt = _grad_inputs((2, 4, 4, 8), "float32")
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    f0, b0 = cuda_in.launches, cuda_in.bwd_launches
    y = tnorm.instance_norm({"gamma": g, "beta": b}, xt, act="relu")
    assert y.grad_fn is None
    xg = xt.clone().requires_grad_(True)
    y = tnorm.instance_norm({"gamma": g, "beta": b}, xg, act="relu")
    saved = y.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(2, 4, 4, 8), (8,), (8,),
                                               (2, 8), (2, 8)]
    assert all(t.dtype == torch.float32 for t in saved)
    (dx,) = torch.autograd.grad(y, xg, dyt)
    _, mean, rstd = tnorm._ref_forward(xt, g, b, 1e-3, "relu", 0.3)
    np.testing.assert_array_equal(
        dx.numpy(), tnorm.instance_norm_bwd_ref(xt, dyt, g, b, mean, rstd,
                                                "relu")[0].numpy())
    assert (cuda_in.launches, cuda_in.bwd_launches) == (f0, b0)


def test_backward_wrapper_refuses_cpu_tensor():
    x = torch.zeros(1, 4, 4, 8)
    g, b, m = torch.ones(8), torch.zeros(8), torch.zeros(1, 8)
    before = cuda_in.bwd_launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_in.instance_norm_bwd_cuda(x, x, g, b, m, m)
    assert cuda_in.bwd_launches == before
