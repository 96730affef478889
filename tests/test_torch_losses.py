"""Port parity of the derivative filters (``ops/deriv.py``) and every loss
(``losses.py``) against the JAX package, on the same numpy inputs.  All
of it is f32 elementwise work and means: rtol 1e-5, atol 1e-6."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu import losses as jl  # noqa: E402
from sggan_tpu.ops import deriv as jd  # noqa: E402
from sggan_tpu_torch import losses as tl  # noqa: E402
from sggan_tpu_torch.ops import deriv as td  # noqa: E402

N, H, W = 2, 8, 16


def _arrays(seed=0):
    r = np.random.default_rng(seed)
    seg = np.eye(3, dtype=np.float32)[r.integers(0, 3, (N, H, W))]
    seg[:, :, :4] = seg[:, :1, :1]  # flat regions: zero boundary weight
    return {
        "real": r.uniform(size=(N, H, W, 3)).astype(np.float32),
        "fake": np.tanh(r.standard_normal((N, H, W, 3))).astype(np.float32),
        "seg": seg,
        "logits": (r.standard_normal((N, 4, 8, 1)) * 3).astype(np.float32),
        "logits2": r.standard_normal((N, 4, 8, 1)).astype(np.float32),
        "valid": np.array([True, False]),
    }


def _close(got, ref):
    got = [got] if isinstance(got, torch.Tensor) else got
    ref = [ref] if not isinstance(ref, (tuple, list)) else ref
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


DERIV = {
    "sobel_xy": lambda m, a: m.sobel_xy(a["fake"]),
    "seg_boundary_weight": lambda m, a: m.seg_boundary_weight(a["seg"]),
    "tf_deriv_same": lambda m, a: m.tf_deriv(a["fake"]),
    "tf_deriv_valid": lambda m, a: m.tf_deriv(a["fake"], "VALID"),
    "diff_valid": lambda m, a: m.depthwise_conv2d(
        a["seg"], m.deriv_kernel_diff(3), "VALID"),
}


@pytest.mark.parametrize("case", sorted(DERIV))
def test_deriv_matches_jax(case):
    a = _arrays()
    ref = DERIV[case](jd, {k: jnp.asarray(v) for k, v in a.items()})
    got = DERIV[case](td, {k: torch.from_numpy(v) for k, v in a.items()})
    _close(got, ref)
    if case == "seg_boundary_weight":
        w = got.numpy()
        assert set(np.unique(w)) == {0.0, 1.0} and w.shape == (N, H, W, 1)


LOSSES = {
    "abs_criterion": lambda m, a: m.abs_criterion(a["real"], a["fake"]),
    "mae_criterion": lambda m, a: m.mae_criterion(a["logits"], a["logits2"]),
    "sigmoid_ce": lambda m, a: m.sigmoid_ce(a["logits"], a["logits2"] > 0),
    "sce_criterion": lambda m, a: m.sce_criterion(a["fake"], a["seg"]),
    "bce_from_logits": lambda m, a: m.bce_from_logits(a["logits2"] > 0,
                                                      a["logits"]),
    "gradloss_criterion": lambda m, a: m.gradloss_criterion(
        a["fake"], a["real"], m.seg_boundary_weight(a["seg"])),
    "gen_loss_p2p": lambda m, a: m.gen_loss_p2p(a["logits"], a["fake"],
                                                a["seg"]),
    "disc_loss_p2p": lambda m, a: m.disc_loss_p2p(a["logits"], a["logits2"]),
    "gen_loss_p2p_hist": lambda m, a: m.gen_loss_p2p_hist(
        a["logits"], a["fake"], a["seg"], a["valid"]),
    "disc_loss_p2p_hist": lambda m, a: m.disc_loss_p2p_hist(
        a["logits"], a["logits2"], a["valid"]),
    "gen_loss_sggan_lsgan_real": lambda m, a: m.gen_loss_sggan(
        a["logits"], a["real"], a["fake"], a["seg"], use_lsgan=True,
        l1_lambda=10.0, lg_lambda=5.0, l1_target="real"),
    "gen_loss_sggan_sce_seg": lambda m, a: m.gen_loss_sggan(
        a["logits"], a["real"], a["fake"], a["seg"], use_lsgan=False,
        l1_lambda=10.0, lg_lambda=5.0, l1_target="seg"),
    "gen_loss_sggan_no_lg": lambda m, a: m.gen_loss_sggan(
        a["logits"], a["real"], a["fake"], a["seg"], use_lsgan=True,
        l1_lambda=10.0, lg_lambda=0.0),
    "disc_loss_sggan_lsgan": lambda m, a: m.disc_loss_sggan(
        a["logits"], a["logits2"], use_lsgan=True),
    "disc_loss_sggan_sce": lambda m, a: m.disc_loss_sggan(
        a["logits"], a["logits2"], use_lsgan=False),
    "gen_loss_simple": lambda m, a: m.gen_loss_simple(
        a["logits"], a["fake"], a["seg"], alpha_recip=0.1),
    "disc_loss_simple": lambda m, a: m.disc_loss_simple(a["logits"],
                                                        a["logits2"]),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_jax(case):
    a = _arrays(seed=1)
    ref = LOSSES[case](jl, {k: jnp.asarray(v) for k, v in a.items()})
    got = LOSSES[case](tl, {k: torch.from_numpy(v) for k, v in a.items()})
    assert got.dim() == (0 if case != "sigmoid_ce" else 4)
    _close(got, ref)

