"""Helpers of the port's cycle-mode tests (not collected), split by net
into ``tests/test_torch_cycle.py`` (the ResNet step, the port-only
units) and ``tests/test_torch_cycle_unet.py`` (the U-Net step, the
trainer, the CLI), so that each JAX cycle step is compiled once.

Port parity of the cycle-consistency mode (``--loss_mode cycle``):
``sggan_tpu_torch.train.cycle`` against ``sggan_tpu.train.cycle`` on the
CPU, f32, 32x32, b=2, ngf and ndf 4, 8 classes, pool 2, from one JAX
cycle ``TrainState`` bridged into the port, with the same batch (numpy
from a seed) and the pool draws the JAX step takes from its ``rng_pool``
key.

* (a) the ResNet cycle step with identity and gradient loss on, LSGAN:
  two steps (the second swaps pooled history);
* (b) the U-Net cycle step with the sigmoid cross entropy and dropout,
  the port fed the four mask sets that the JAX step draws from r1..r4
  (r3 for F(G(a)) and G(b), r4 for G(F(b)) and F(a)).

For each: the losses (rel 1e-5 after one step, 1e-4 after two), every
gradient of the four nets and the generators' first Adam moment under
``tests/test_torch_step.py``'s ``_close`` with ``atol_of_max`` 2e-4 (the
two packages' convolutions sum in other orders, see that file), the
discriminators' moments and the second moments at its plain limits, and
the pooled entries.  The JAX steps are compiled once each, without XLA's
LLVM passes, as ``test_torch_step.py`` compiles its step but with the
fusion emitters (its ``CYCLE_FAST``), each one program that also returns
the draws and masks it takes from its key.

The two packages' forwards differ by up to ~2e-4 (conv summation order,
rescaled by the instance norms), so a value that close to 0 where the
gradient takes its sign — a generator's or discriminator's gate, an L1's
or the gradient loss's abs — can fall on the other side in the other
package.  One such flip among the ~10^5 signs of a step moves whole
tensors' gradients by up to 3% of their largest: the gradient loss's
per-pixel terms have random signs and cancel to ~1/sqrt(N) of their sum.
At 32x64 every batch seed from 0 to 15 had one to five flips; at 32x32
the batches of seeds 9 (ResNet) and 10 (U-Net with the step's masks)
have none, so the comparison is between the same branches.  Without a
flip the ResNet step's gradients still differ by up to 1.6e-4 of a
tensor's largest (b2a.r8.in1.gamma; the U-Net's by under 5e-5): the
gradient that reaches a generator through the other one's backward
carries both nets' summation noise, so the limit holds it with little
room.

Port-only: the init's names, draw order and pool; ``max_size`` 0 passes
the entry through; four generator calls without the identity term;
six mask sets drawn apart break parity with (b); the EMA shadows both
generators and the eval runs the one of ``--which_direction``; the
resident two-domain epoch equals the host iterators'; ``main`` trains,
tests both directions and resumes; a checkpoint round trip."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.train import cycle as jcycle  # noqa: E402
from sggan_tpu.train import pool as jpool  # noqa: E402
from sggan_tpu.train import step as jstep  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.train import cycle as tcycle  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_step import CYCLE_FAST, _close  # noqa: E402

B, H, W, N_CLASS, POOL = 2, 32, 32, 8, 2
KW = dict(image_height=H, image_width=W, ngf=4, ndf=4, segment_class=N_CLASS,
          batch_size=B, max_size=POOL, compute_dtype="float32",
          loss_mode="cycle", L1_lambda=10.0, identity_lambda=5.0,
          Lg_lambda=5.0)
RESNET = dict(KW, use_resnet=True, use_lsgan=True)
UNET = dict(KW, use_resnet=False, use_lsgan=False, dropout_mode="intended")
# the batch seeds of (a) and (b): batches on which every sign the step's
# gradient follows agrees between the packages (the module docstring)
SEED = {True: 9, False: 10}
LR = 1e-3
RNGS = [jax.random.PRNGKey(30 + i) for i in range(2)]
MASK_C = 32  # the U-Net's d1-d3 width at ngf 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """4-channel nets at 32x32: one torch thread runs them as fast as
    several and does not contend with the other test workers (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    hm, wm = H // 8, W // 8
    out = {}
    for d in "ab":
        out[f"real_{d}"] = r.uniform(size=(B, H, W, 3)).astype(np.float32)
        out[f"seg_{d}"] = r.uniform(size=(B, H, W, 3)).astype(np.float32)
        out[f"mask_{d}"] = np.eye(N_CLASS, dtype=np.float32)[
            r.integers(0, N_CLASS, (B, hm, wm))]
    return out


def _jax_step(kw, masks: bool):
    """The JAX cycle step with, as further outputs of the same program, the
    pool draws it takes from its ``rng_pool`` key and, with ``masks``, the
    U-Net's dropout masks it draws from r1..r4 (three each, as
    generator_unet.py:96 splits its key)."""
    step = jcycle.build_cycle_step_fn(JConfig(**kw))

    def one(key, i):
        k_use, k_idx = jax.random.split(jax.random.fold_in(key, i))
        return (jax.random.uniform(k_use),
                jax.random.randint(k_idx, (), 0, POOL))

    def fn(state, batch, lr, rng):
        keys = jax.random.split(rng, 5)
        draws = jax.vmap(lambda i: one(keys[4], i))(jnp.arange(B))
        sets = None
        if masks:
            sets = [[jax.random.bernoulli(k, 0.5, (B, H, W, MASK_C))
                     for k in jax.random.split(keys[j], 3)]
                    for j in range(4)]
        return (*step(state, batch, lr, rng), draws, sets)
    return fn


_STATES = {}


def _jax_state(kw):
    """A JAX cycle TrainState whose nets are the port's seeded init (JAX's
    own RNG init costs seconds of XLA compile here), with optax's state and
    the JAX pair pool; made once for each config (its arrays are
    immutable)."""
    key = tuple(sorted(kw.items()))
    if key not in _STATES:
        _STATES[key] = _new_jax_state(kw)
    return _STATES[key]


def _new_jax_state(kw):
    cfg = Config(**kw)
    tree = bridge.train_state_to_jax(
        tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu"))
    tx = jstep._tx(cfg.beta1)
    gp, dp = tree["gen_params"], tree["disc_params"]
    pool = jpool.pool_init(POOL, {"fakes": (2, H, W, 3),
                                  "masks": (2, H // 8, W // 8, N_CLASS)})
    return jstep.TrainState(gp, {}, dp, {}, tx.init(gp), tx.init(dp), pool,
                            jnp.zeros((), jnp.int32), None)


def _run(kw, n_steps: int):
    """``n_steps`` steps of each package from the same state and batch,
    the port fed the draws and masks of the JAX step's program; the
    port's first-step losses and grads apart."""
    cfg = Config(**kw)
    js = _jax_state(kw)
    np_state = lambda s: jax.tree.map(np.asarray, s)  # noqa: E731
    ts = bridge.train_state_from_jax(cfg, np_state(js))
    batch = _batch(SEED[cfg.use_resnet])
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jfn = jax.jit(_jax_step(kw, not cfg.use_resnet)).lower(
        js, batch, jnp.float32(LR), RNGS[0]).compile(CYCLE_FAST)
    tfn = tstep.build_step_fn(cfg)
    jax_out, port_out, first = [], [], None
    for rng in RNGS[:n_steps]:
        js, jm, (u, idx), sets = jfn(js, batch, jnp.float32(LR), rng)
        draws = tpool.PoolDraws(torch.from_numpy(np.array(u)),
                                torch.from_numpy(np.array(idx)).long())
        masks = None if sets is None else tuple(
            tuple(torch.from_numpy(np.array(m)) for m in s) for s in sets)
        if first is None:
            first = tcycle.losses_and_grads(cfg, ts, tbatch, draws, masks)
            fed = (tbatch, draws, masks)
        jax_out.append((np_state(js), {k: float(v) for k, v in jm.items()}))
        ts, tm = tfn(ts, tbatch, LR, draws, masks)
        port_out.append((bridge.train_state_to_jax(ts),
                         {k: v.item() for k, v in tm.items()}))
    return first, jax_out, port_out, ts, fed


def _hold_first_step(run, kw):
    (metrics, g_grads, d_grads, pool), jax_out, port_out, ts, _ = run
    (jstate, jm), (tstate, tm) = jax_out[0], port_out[0]
    for k in ("gen_loss", "disc_loss"):
        assert abs(metrics[k].item() - tm[k]) <= 1e-5 * abs(tm[k])
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm, jm)
    # optax's first moment after one step is (1 - beta1) * grad
    b1 = Config(**kw).beta1
    for grads, mu in ((g_grads, jstate.g_opt.mu), (d_grads, jstate.d_opt.mu)):
        ref = jax.tree.map(lambda m: np.asarray(m) / (1 - b1), mu)
        assert set(ref) == {"a2b", "b2a"} or set(ref) == {"da", "db"}
        _close(bridge.params_to_jax(grads), ref, atol_of_max=2e-4)
    for name, opt in (("g_opt", jstate.g_opt), ("d_opt", jstate.d_opt)):
        assert tstate[name]["count"] == int(opt.count) == 1
        _close(tstate[name]["mu"], opt.mu,
               atol_of_max=2e-4 if name == "g_opt" else 0.0)
        _close(tstate[name]["nu"], opt.nu)
    # the pool holds the step's (fake_a, fake_b) pair and (mask_b, mask_a)
    assert pool.count == int(jstate.pool.count) == POOL
    _close({k: v.numpy() for k, v in pool.buffer.items()},
           dict(jstate.pool.buffer), atol_of_max=2e-4)
