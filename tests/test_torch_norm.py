"""Port parity: the plain instance norm (the CUDA kernel's twin) against
the JAX package's XLA path and its Pallas kernel (interpret mode, as
tests/test_pallas.py runs it).  Tolerances are tests/test_pallas.py's:
f32 1e-5, bf16 2e-2.  The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from sggan_tpu.ops import pallas_in  # noqa: E402
from sggan_tpu.ops.norm import _instance_norm_xla  # noqa: E402
from sggan_tpu_torch.ops import cuda_in  # noqa: E402
from sggan_tpu_torch.ops import norm as tnorm  # noqa: E402

SHAPES = [(2, 8, 8, 64), (1, 16, 8, 128), (2, 8, 4, 256), (1, 4, 4, 34)]
ACTS = [None, "relu", "leaky_relu"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(shape, seed=0):
    r = np.random.default_rng(seed)
    c = shape[-1]
    x = (r.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    gamma = r.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (r.standard_normal(c) * 0.1).astype(np.float32)
    return x, gamma, beta


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
    xj = jnp.asarray(x).astype(dtype)
    ref = _instance_norm_xla(xj, jnp.asarray(gamma), jnp.asarray(beta),
                             1e-3, act, 0.3)
    _close(_ref(x, gamma, beta, act, dtype), ref, dtype)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_pallas_interpret(shape, act):
    x, gamma, beta = _inputs(shape, seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_in.instance_norm_pallas(
            jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 1e-3,
            act, 0.3)
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

