"""Port parity of the semantic discriminator: the bridge for both heads,
the forward against ``sggan_tpu.models.discriminator.apply`` (f32, 1e-4:
summation order of the convs, rescaled by the instance norms), the golden
fixture, and the input and parameter gradients against ``jax.grad``."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.models import discriminator as jdisc  # noqa: E402
from sggan_tpu_torch.models.discriminator import (Discriminator,  # noqa: E402
                                                  _valid_chain)
from sggan_tpu_torch.utils.bridge import params_from_jax, params_to_jax  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "disc.npy")
# XLA without its LLVM optimisation and fusion emitters, as
# tests/test_torch_step.py compiles its step: the same f32 results to
# rounding, in a fraction of the compile time
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}
N_CLASS, NDF = 8, 4


def _port(hw, head, seed=0):
    return Discriminator(ndf=NDF, n_class=N_CLASS, image_size=hw, head=head,
                         generator=torch.Generator().manual_seed(seed))


def _inputs(hw, seed=1):
    r = np.random.default_rng(seed)
    x = r.uniform(size=(2, *hw, 3)).astype(np.float32)
    mask = np.eye(N_CLASS, dtype=np.float32)[
        r.integers(0, N_CLASS, (2, hw[0] // 8, hw[1] // 8))]
    return x, mask


def _leaves(tree):
    return {"/".join(k.key for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("head", ["global", "patch"])
def test_bridge_round_trips_both_heads(head):
    hw = (256, 512)  # the slice's chain [2, 2, 2, 1]
    shapes = jax.eval_shape(lambda k: jdisc.init(
        k, ndf=NDF, n_class=N_CLASS, image_size=hw, head=head),
        jax.random.PRNGKey(0))
    disc = _port(hw, head)
    tree = params_to_jax(disc.state_dict())
    assert {k: v.shape for k, v in _leaves(tree).items()} \
        == {k: v.shape for k, v in _leaves(shapes).items()}
    back = params_from_jax(tree)
    assert back.keys() == disc.state_dict().keys()
    for k, v in disc.state_dict().items():
        assert torch.equal(back[k], v)
    assert _valid_chain(hw[0] // 8, hw[1] // 8) == [2, 2, 2, 1]
    assert ("v3.w" in back) == (head == "global")


@pytest.mark.parametrize("head", ["global", "patch"])
@pytest.mark.parametrize("hw", [(32, 64), (64, 64)])
def test_forward_matches_jax(hw, head):
    disc = _port(hw, head)
    x, mask = _inputs(hw)
    args = (params_to_jax(disc.state_dict()), x, mask)
    ref = jax.jit(lambda p, x, m: jdisc.apply(p, x, m, head=head)).lower(
        *args).compile(FAST)(*args)
    with torch.no_grad():
        got = disc(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert got.shape == (2, hw[0] // 8, hw[1] // 8, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def _golden_case():
    """The params and inputs of test_golden._case("disc"): patch head,
    ndf 8, 6 classes, 32x32."""
    p = jdisc.init(jax.random.PRNGKey(42), ndf=8, n_class=6,
                   image_size=(32, 32), head="patch")
    x = jax.random.uniform(jax.random.PRNGKey(7), (1, 32, 32, 3))
    mask = jax.nn.one_hot(
        jax.random.randint(jax.random.PRNGKey(3), (1, 4, 4), 0, 6), 6)
    return p, x, mask


def test_golden_fixture_through_the_bridge():
    # XLA's LLVM passes spend ~13 s on the threefry draws here; without
    # them the draws are the same and the glorot scaling differs by at
    # most 1 ulp, far inside the golden tolerance
    p, x, mask = jax.jit(_golden_case).lower().compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})()
    disc = Discriminator(ndf=8, n_class=6, image_size=(32, 32), head="patch")
    disc.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = disc(torch.from_numpy(np.array(x)),
                   torch.from_numpy(np.array(mask)))
    np.testing.assert_allclose(got.numpy(), np.load(GOLDEN), rtol=2e-3,
                               atol=2e-4)


def test_input_and_param_grads_match_jax():
    hw = (64, 64)
    disc = _port(hw, "global", seed=2)
    x, mask = _inputs(hw, seed=3)
    w = np.random.default_rng(4).standard_normal((2, 8, 8, 1)) \
        .astype(np.float32)

    def loss(p, x):
        return jnp.sum(jdisc.apply(p, x, mask) * w)

    args = (params_to_jax(disc.state_dict()), x)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1))).lower(*args).compile(
        FAST)(*args)
    xt = torch.from_numpy(x).requires_grad_(True)
    names, params = zip(*disc.named_parameters())
    out = (disc(xt, torch.from_numpy(mask)) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(out, (xt, *params), materialize_grads=True)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), rtol=1e-3,
                               atol=1e-5)
    ref = params_from_jax(gp)
    for k, g in zip(names, grads[1:]):
        scale = ref[k].abs().max().item()
        assert (g - ref[k]).abs().max().item() <= 1e-4 * scale + 1e-6, k
    # the IN-fed conv biases are dead: zero gradient on both sides
    for k in ("h1.b", "h2.b", "h3.b", "v0.b", "v1.b"):
        assert not ref[k].any() and not dict(zip(names, grads[1:]))[k].any()
