"""Port parity of the fused conv3x3 + instance norm op (K2), the
gradients half (split from ``tests/test_torch_conv_in.py``, whose
docstring states the limits and the references): dx, dw, dgamma and
dbeta of the port's autograd Function against ``jax.grad`` of the Pallas
op (interpret mode) and of the XLA composition at 2e-4; the tall
multi-tile plane at 2e-5; the bf16 moments of the rounded conv output;
and a process that imports the new modules without JAX."""

import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.ops import pallas_conv_in as pci  # noqa: E402
from sggan_tpu_torch.ops import cuda_conv_in as cci  # noqa: E402
from test_torch_conv_in import (ACTS, F32, GRAD, TALL, _fast,  # noqa: E402
                                _pallas, _port, _port_grads, _setup,
                                _torch_args, _xla)


def test_moments_are_of_the_rounded_conv_output():
    """In bf16 the moments are those of y16 after its rounding, not of the
    f32 accumulator."""
    x, w, g, b = _torch_args(*_setup((2, 16, 16, 8, 8)), torch.bfloat16)
    _, y16, mean, rsig = cci.conv3_in_ref(x, w, g, b, 1e-3, None, 0.3)
    yf = y16.float()
    m = yf.mean((1, 2))
    torch.testing.assert_close(mean, m, rtol=1e-6, atol=1e-6)
    var = (yf * yf).mean((1, 2)) - m * m
    torch.testing.assert_close(rsig, torch.rsqrt(var + 1e-3), rtol=1e-5,
                               atol=1e-5)


def _jax_grads(fn, shape, act, seed):
    return _fast(jax.grad(lambda *a: jnp.sum(fn(*a, act) ** 2),
                          argnums=(0, 1, 2, 3)), *_setup(shape, seed))


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("act", ACTS)
def test_grads_match_jax(act, ref):
    """dx, dw, dgamma, dbeta of the port's autograd Function against
    jax.grad of the Pallas op (its hand-written VJP) and of the XLA
    composition."""
    shape = (2, 8, 8, 8, 8)
    if ref == "pallas":
        want = _jax_grads(lambda x, w, g, b, act: pci.conv3_in(
            x, w, g, b, act=act, interpret=True), shape, act, seed=3)
    else:
        want = _jax_grads(lambda x, w, g, b, act: pci.conv3_in_xla(
            {"w": w}, {"gamma": g, "beta": b}, x, act=act), shape, act,
            seed=3)
    got = _port_grads(lambda x, w, g, b, act: cci.conv3_in(
        x, w, g, b, act=act), shape, act, seed=3)
    for a, r, name in zip(got, want, ("dx", "dw", "dgamma", "dbeta")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name,
                                   **GRAD)


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_tall_multi_tile(ref):
    """H spans several of the TPU kernel's row tiles, and several of the
    CUDA kernel's."""
    got = _port(TALL, "relu", seed=5)[0]
    want = (_pallas(TALL, "relu", seed=5)[0] if ref == "pallas"
            else _xla(TALL, "relu", seed=5))
    np.testing.assert_allclose(got, want, **F32)


def test_new_modules_import_no_jax():
    code = """
import sys
import torch
from sggan_tpu_torch import perf_conv_in
from sggan_tpu_torch.ops import cuda_conv_in
x = torch.ones(1, 4, 4, 2).cumsum(2)
y = cuda_conv_in.conv3_in(x, torch.ones(3, 2, 3, 3), torch.ones(3),
                          torch.zeros(3))
assert y.shape == (1, 4, 4, 3)
bad = sorted(m for m in sys.modules if m in ("jax", "sggan_tpu")
             or m.startswith(("jax.", "sggan_tpu.")))
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
