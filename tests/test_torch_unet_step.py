"""Port parity of the CLI's default p2p step with the U-Net generator and
the semantic discriminator (split from ``tests/test_torch_unet.py``, whose
docstring states the nets' parity): f32, ngf and ndf 4, 32x32, 8 classes.

* one p2p train step with the U-Net (the CLI default: ``--dropout_mode
  intended``) against the JAX step with the masks that step draws: losses
  rel 1e-5, gradients and Adam moments held as tests/test_torch_step.py's
  ``_close`` holds the ResNet's.  The two forwards differ by ~1e-5 (conv
  summation order), so a pre-activation nearer 0 than that can fall on
  the other side of its gate, and every gradient upstream of it then
  moves by up to 1% of its largest (the batch of seed 0 has one at e7,
  |pre| 7.6e-7; seeds 1 and 6 at e5 and e6).  The step's batch is seed 2,
  and ``test_generator_gates_agree`` holds both packages' gate decisions
  equal on it, so the comparison is between the same branches;
* ``sigmoid_ce``'s gradient at a logit of exactly 0, where the semantic
  discriminator's logits sit at init, equals JAX's.

The JAX sides are compiled as one program each without XLA's LLVM passes,
as tests/test_torch_step.py compiles its step."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu import losses as jlosses  # noqa: E402
from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.ops import layers as jlayers  # noqa: E402
from sggan_tpu.ops import norm as jnorm  # noqa: E402
from sggan_tpu.train import pool as jpool  # noqa: E402
from sggan_tpu.train import step as jstep  # noqa: E402
from sggan_tpu_torch import losses as tlosses  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch import ops as tops  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_step import _close  # noqa: E402
from test_torch_unet import (B, H, KW, LR, RNG, STEP_SEED, W,  # noqa: E402,F401
                             _batch, _compile, _unet_masks, one_thread)


def _jax_state(cfg):
    """A JAX TrainState whose nets are the port's seeded init, with optax's
    state and the p2p pool (one slot)."""
    tree = bridge.train_state_to_jax(
        tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu"))
    tx = jstep._tx(cfg.beta1)
    gp, dp = tree["gen_params"], tree["disc_params"]
    return jstep.TrainState(gp, tree["gen_bn"], dp, tree["disc_bn"],
                            tx.init(gp), tx.init(dp),
                            jpool.pool_init(1, (H, W, 3)),
                            jnp.zeros((), jnp.int32), None)


@pytest.fixture(scope="module")
def unet_step():
    """One step of each package from the same state and batch, the port
    fed the dropout masks that the JAX step draws from its key."""
    cfg = Config(**KW)
    js = _jax_state(JConfig(**KW))
    ts = bridge.train_state_from_jax(cfg, jax.tree.map(np.asarray, js))
    batch = _batch(STEP_SEED)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    masks = _step_masks()
    grads = tstep.losses_and_grads(cfg, ts, tbatch, None, masks)
    js, jm = _compile(jstep.build_step_fn(JConfig(**KW)), js, batch,
                      jnp.float32(LR), RNG)
    ts, tm = tstep.build_step_fn(cfg)(ts, tbatch, LR, None, masks)
    return (grads, (jax.tree.map(np.asarray, js),
                    {k: float(v) for k, v in jm.items()}),
            (bridge.train_state_to_jax(ts), {k: v.item() for k, v in
                                             tm.items()}, ts))


@functools.cache
def _step_masks():
    """The d1-d3 masks the JAX step draws: the generator's half of the
    step key, split three ways (drawn once for the module; the tensors
    are only read)."""
    return _unet_masks(jax.random.split(RNG)[0], (B, H, W, 32))


def _gates(conv, convt, norm, where, params, x, masks):
    """The pre-activations of the U-Net's 10 gates (e1-e8 after IN, the
    sums before the relus of d3 and d7), with one package's ops."""
    pres, y, enc = [], x, []
    for i in range(1, 9):
        pre = norm(params[f"e{i}_in"], conv(params[f"e{i}"], y))
        pres.append(pre)
        y = where(pre >= 0, pre, 0.0 if i == 8 else 0.3 * pre)
        enc.append(y)
    for i in range(1, 8):
        y = convt(params[f"d{i}"], y, i <= 3)
        if i <= 3:
            y = where(masks[i - 1], y / 0.5, 0.0)
        y = norm(params[f"d{i}_in"], y) + enc[7 - i]
        if i in (3, 7):
            pres.append(y)
            y = where(y >= 0, y, 0.0)
    return pres


def test_generator_gates_agree():
    """On the step's batch, every gate of the generator takes the same
    branch in both packages' forwards (the precondition of holding the
    step's gradients elementwise)."""
    cfg = Config(**KW)
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    tree = bridge.train_state_to_jax(ts)["gen_params"]
    x = _batch(STEP_SEED)["real_a"]
    masks = _step_masks()
    f32 = jnp.float32
    ref = _compile(lambda p, x, m: _gates(
        lambda q, v: jlayers.conv2d(q, v, 1, "SAME", f32, bias=False),
        lambda q, v, b: jlayers.conv2d_transpose(q, v, 1, "SAME", f32,
                                                 bias=b),
        jnorm.instance_norm, jnp.where, p, x, m),
        tree, x, [jnp.asarray(m.numpy()) for m in masks])
    with torch.no_grad():
        got = _gates(
            lambda q, v: tops.conv2d(q, v, 1, "SAME", torch.float32,
                                     bias=False),
            lambda q, v, b: tops.conv2d_transpose(q, v, 1, "SAME",
                                                  torch.float32, bias=b),
            tops.instance_norm, torch.where,
            {k: {n: t for n, t in getattr(ts.gen_params, k).items()}
             for k in tree}, torch.from_numpy(x), masks)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4)
        assert ((g.numpy() >= 0) == (r >= 0)).all(), f"gate {i} flips"


@pytest.mark.parametrize("z", [0.0, 1.0, 0.5])
def test_sigmoid_ce_gradient_at_zero_logits_matches_jax(z):
    x = np.array([0.0, 0.3, -2.0, 0.0], np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    tlosses.sigmoid_ce(tx, torch.full((4,), z)).sum().backward()
    ref = jax.grad(lambda v: jlosses.sigmoid_ce(v, jnp.full((4,), z))
                   .sum())(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref), rtol=1e-6)
    assert tx.grad[0] == -z


def test_unet_p2p_step_matches_jax(unet_step):
    (metrics, g_grads, d_grads, pool, bns), (jstate, jm), (tstate, tm, ts) \
        = unet_step
    for k in ("gen_loss", "disc_loss"):
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm, jm)
        assert abs(metrics[k].item() - tm[k]) <= 1e-5 * abs(tm[k])
    b1 = Config(**KW).beta1
    for grads, mu in ((g_grads, jstate.g_opt.mu), (d_grads, jstate.d_opt.mu)):
        ref = jax.tree.map(lambda m: np.asarray(m) / (1 - b1), mu)
        _close(bridge.params_to_jax(grads), ref, atol_of_max=2e-4)
    for name, opt in (("g_opt", jstate.g_opt), ("d_opt", jstate.d_opt)):
        assert tstate[name]["count"] == int(opt.count) == 1
        _close(tstate[name]["mu"], opt.mu,
               atol_of_max=2e-4 if name == "g_opt" else 0.0)
        _close(tstate[name]["nu"], opt.nu)
    # the p2p branch takes no pool; the IN nets carry no BN state
    assert pool is ts.pool and bns == ({}, {}) and ts.step == 1
    assert ts.gen_bn == {} and ts.disc_bn == {}


def test_unet_dead_biases_get_zero_grads(unet_step):
    (_, g_grads, _, _, _), _, (_, _, ts) = unet_step
    assert g_grads.keys() == dict(ts.gen_params.named_parameters()).keys()
    for i in range(1, 9):
        assert not g_grads[f"e{i}.b"].any(), i
    for i in range(4, 8):
        assert not g_grads[f"d{i}.b"].any(), i
    # d1-d3 keep theirs: dropout between the conv-transpose and IN
    assert all(g_grads[f"d{i}.b"].any() for i in (1, 2, 3, 8))
