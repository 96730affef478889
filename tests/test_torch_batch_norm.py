"""``ops/norm.py::batch_norm`` (the pix2pix nets' batch norm, Keras's
semantics: eps 1e-3, f32 statistics, the biased variance, moving stats
m * old + (1 - m) * batch with m = 0.99) against the JAX package's
``sggan_tpu.ops.norm.batch_norm``, training and inference, f32 and bf16
(split from ``tests/test_torch_pix2pix.py``, which holds the nets)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.ops import norm as jnorm  # noqa: E402
from sggan_tpu_torch.ops import norm as tnorm  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(training, dtype):
    r = np.random.default_rng(0)
    x = (r.standard_normal((3, 5, 7, 6)) * 2 + 0.7).astype(np.float32)
    params = {"gamma": r.uniform(0.5, 1.5, 6).astype(np.float32),
              "beta": r.standard_normal(6).astype(np.float32) * 0.1}
    state = {"moving_mean": r.standard_normal(6).astype(np.float32),
             "moving_var": r.uniform(0.5, 2.0, 6).astype(np.float32)}
    ry, rnew = jnorm.batch_norm({**params, **state},
                                jnp.asarray(x, dtype), training=training)
    ty, tnew = tnorm.batch_norm(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in state.items()},
        torch.from_numpy(x).to(getattr(torch, dtype)), training)
    assert ty.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(ry, np.float32),
                               rtol=tol, atol=tol)
    for k in state:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(rnew[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    if training and dtype == "float32":
        # the biased variance, moved by m = 0.99 (torch's own batch norm
        # keeps the unbiased one, with the inverse momentum)
        v = x.reshape(-1, 6).var(0)
        np.testing.assert_allclose(tnew["moving_var"].numpy(),
                                   0.99 * state["moving_var"] + 0.01 * v,
                                   rtol=1e-5)
    if not training:
        assert all(torch.equal(tnew[k], torch.from_numpy(state[k]))
                   for k in state)
