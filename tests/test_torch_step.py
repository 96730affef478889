"""The sggan train step's port-only tests and the helpers that the port's
parity files import (``FAST``, ``_close``, ``_leaves``): the full-width
limits against planted faults in the instance norm's backward, Adam
against optax, the p2p and simple branches, the bf16 pool and TF32, and
the refusals.  The step's parity with the JAX step, the EMA's and the
learning-rate schedule's are ``tests/test_torch_step_parity.py`` (its
docstring gives the tolerances and why)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.ops import norm as tnorm  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402

B, H, W, N_CLASS, POOL = 2, 32, 64, 8, 2
KW = dict(image_height=H, image_width=W, ngf=4, ndf=4,
          segment_class=N_CLASS, batch_size=B, max_size=POOL,
          compute_dtype="float32", loss_mode="sggan", use_resnet=True)
LR = 1e-3
RNGS = [jax.random.PRNGKey(10 + i) for i in range(3)]
# XLA without its LLVM optimisation and fusion emitters: the JAX step
# compiles in ~6 s instead of ~17 s on one core, f32 results equal to
# rounding
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}
# the cycle steps (four to six generator calls in one program) compile
# 25-35% faster with the fusion emitters, to the same bits: the one-card
# ResNet and U-Net cycle steps and the spatial cycle step of the parity
# tests give bitwise equal outputs either way; the smaller programs of
# the other files compile no faster with them
CYCLE_FAST = {**FAST, "xla_cpu_use_fusion_emitters": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's nets here have 4 channels at 32x64: one thread runs them
    as fast as several, and it does not contend with the other test
    workers' threads for the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    hm, wm = H // 8, W // 8
    return {"real_a": r.uniform(size=(B, H, W, 3)).astype(np.float32),
            "seg_a": r.uniform(size=(B, H, W, 3)).astype(np.float32),
            "mask_a": np.eye(N_CLASS, dtype=np.float32)[
                r.integers(0, N_CLASS, (B, hm, wm))]}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _close(got, ref, atol_of_max=0.0):
    """Elementwise |got - ref| <= 1e-6 + 1e-4 |ref| + atol_of_max
    * max |ref|, for every tensor of two trees of the same keys."""
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(
            got[k], ref[k], rtol=1e-4,
            atol=1e-6 + atol_of_max * np.abs(ref[k]).max(), err_msg=k)


def _faulty_bwd(fault):
    """The plain instance-norm backward with one planted fault."""
    ref = tnorm.instance_norm_bwd_ref

    def bwd(x, dy, gamma, beta, mean, rstd, act=None, alpha=0.3):
        if fault == "gate dropped":
            return ref(x, dy, gamma, beta, mean, rstd, None, alpha)
        if fault == "alpha 0.2":
            return ref(x, dy, gamma, beta, mean, rstd, act, 0.2)
        if fault == "saved mean zero":
            return ref(x, dy, gamma, beta, torch.zeros_like(mean), rstd, act,
                       alpha)
        dx, dgamma, dbeta = ref(x, dy, gamma, beta, mean, rstd, act, alpha)
        return dx, dbeta, dgamma  # "dgamma and dbeta swapped"
    return bwd


@pytest.mark.parametrize("fault", ["gate dropped", "alpha 0.2",
                                   "saved mean zero",
                                   "dgamma and dbeta swapped"])
def test_full_width_step_limits_catch_a_planted_fault(fault, monkeypatch):
    """chip_smoke.py holds the card's full-width f32 step to the CPU's
    only at STEP_MAX_REL of a gradient's largest element and STEP_NORM_REL
    in norm, since f32 summation order alone moves whole-net gradients by
    a few percent there.  A fault in the instance-norm backward still
    moves them by more."""
    import chip_smoke
    cfg = Config(**KW)
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    draws = tpool.pool_draws(torch.Generator().manual_seed(4), B, POOL)

    def grads():
        ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
        _, g, d, *_ = tstep.losses_and_grads(cfg, ts, tbatch, draws)
        return {**{f"gen.{k}": v for k, v in g.items()},
                **{f"disc.{k}": v for k, v in d.items()}}
    clean = grads()
    monkeypatch.setattr(tnorm, "instance_norm_bwd_ref", _faulty_bwd(fault))
    rows = chip_smoke.grad_rows(clean, grads())
    assert (max(r[0] for r in rows) > chip_smoke.STEP_MAX_REL
            or max(r[1] for r in rows) > chip_smoke.STEP_NORM_REL), rows[-3:]


@pytest.mark.parametrize("beta1", [0.5, 0.9])
def test_adam_matches_optax(beta1):
    """Two updates of the port's Adam, fed the same gradients, against
    optax.scale_by_adam(eps=1e-7) and the step's -lr scaling."""
    r = np.random.default_rng(0)
    params = {"a.w": r.standard_normal((3, 4, 2, 2)).astype(np.float32),
              "a.b": r.standard_normal(4).astype(np.float32)}
    grads = [{k: (r.standard_normal(v.shape) * 10.0 ** -r.integers(0, 8))
              .astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    grads[0]["a.b"][0] = 0.0
    net = torch.nn.Module()
    net.a = torch.nn.ParameterDict({k[2:]: torch.nn.Parameter(
        torch.from_numpy(v.copy())) for k, v in params.items()})
    opt = tstep.adam_init(net)
    tx = optax.scale_by_adam(b1=beta1, b2=0.999, eps=1e-7)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = tx.init(jp)
    for g in grads:
        opt = tstep.adam_update(net, opt, {k: torch.from_numpy(v) for k, v
                                           in g.items()}, LR, beta1)
        upd, jo = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jo, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: -LR * u, upd))
    assert opt.count == int(jo.count) == 2
    got = dict(net.named_parameters())
    for k in params:
        np.testing.assert_allclose(got[k].detach().numpy(), jp[k],
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(opt.mu[k].numpy(), jo.mu[k], rtol=1e-6)
        np.testing.assert_allclose(opt.nu[k].numpy(), jo.nu[k], rtol=1e-6)


@pytest.mark.parametrize("mode", ["p2p", "simple"])
def test_p2p_and_simple_branches_step_without_the_pool(mode):
    cfg = Config(**{**KW, "loss_mode": mode, "gen_ema": 0.5})
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    assert ts.pool.buffer["fake"].shape == (1, H, W, 3)
    before = ts.pool
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    ts, m = tstep.build_step_fn(cfg)(ts, tbatch, LR, None)
    assert ts.pool is before and ts.step == 1
    assert all(np.isfinite(v.item()) for v in m.values())
    assert ts.ema is not None


def test_bf16_step_stores_the_pool_in_bf16_and_restores_tf32():
    cfg = Config(**{**KW, "compute_dtype": "bfloat16"})
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    ts, m = tstep.make_train_step(cfg)(
        ts, tbatch, LR, tpool.pool_draws(torch.Generator(), B, POOL))
    assert ts.pool.buffer["fake"].dtype == torch.bfloat16
    assert all(np.isfinite(v.item()) for v in m.values())
    prev = torch.backends.cudnn.allow_tf32
    with tstep._conv_precision(torch.float32):
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == prev


@pytest.mark.parametrize("kw,err,what", [
    ({"mesh_space": 2}, ValueError,
     "--mesh_space 2 x --mesh_space_w 1 = 2 ranks must equal the world "
     "size, 1"),
    ({"mesh_space": 2, "use_pix2pix": True, "loss_mode": "p2p"},
     ValueError,
     "--mesh_space 2 x --mesh_space_w 1 = 2 ranks must equal the world "
     "size, 1"),
    ({"mesh_data": 2}, ValueError,
     "--mesh_data 2 must equal the world size, 1")])
def test_unported_modes_raise_naming_the_roadmap(kw, err, what):
    """``--mesh_space 2`` (the semantic nets or the pix2pix pair) and
    ``--mesh_data 2`` outside a group of 2 ranks (none here, then a group
    of this process alone, passed where the JAX step took ``axis_name``)
    name the numbers and the world size; at its own world size each mode
    passes ``mesh.check_space``, and a spatial one's step builds (on a
    grid of that size)."""
    from _torch_dist import one_rank_group
    from sggan_tpu_torch.parallel import mesh, spatial_step
    cfg = Config(**{**KW, **kw})
    with pytest.raises(err, match=what):
        tstep.build_step_fn(cfg)
    with pytest.raises(err, match=what):
        tstep.init_state(cfg, torch.Generator(), "cpu")
    with one_rank_group() as group:
        with pytest.raises(err, match=what):
            tstep.build_step_fn(cfg, group)
    sizes = (cfg.mesh_data, cfg.mesh_space, cfg.mesh_space_w)
    mesh.check_space(cfg, int(np.prod(sizes)))
    if mesh.is_spatial(cfg):
        edge = mesh.Axis(None, None, None)
        grid = mesh.Grid(*sizes, 0, 0, 0, 0, None, None, edge, edge, None)
        assert callable(spatial_step.build_sp_step_fn(cfg, grid))


def test_init_state_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.init_state(Config(**KW), torch.Generator())
