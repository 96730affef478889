"""Port parity of the pix2pix pair (``--use_pix2pix``): the U-Net generator
and the PatchGAN discriminator with batch norm, against the JAX package on
the CPU: f32, ngf and ndf 4, 32x32.

* (``batch_norm`` itself: ``tests/test_torch_batch_norm.py``);
* the generator forward on the JAX package's weights through the bridge,
  in inference mode and in training mode with dropout (the port fed the
  keep masks that JAX draws from its key), with its new BN state: atol
  1e-4, as tests/test_torch_generator.py holds the ResNet; the golden
  fixture at its policy (rtol 2e-3 / atol 2e-4);
* the discriminator against ``discriminator_pix2pix.apply``, both modes;
* the nets' names and depth plan.

The train step, the bridge, the checkpoint, ``main`` and the service are
in ``tests/test_torch_pix2pix_step.py``.  The JAX sides are compiled as
one program each without XLA's LLVM passes, as tests/test_torch_step.py
compiles its step."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.models import discriminator_pix2pix as jdisc  # noqa: E402
from sggan_tpu.models import generator_pix2pix as jgen  # noqa: E402
from sggan_tpu_torch.models.discriminator_pix2pix import (  # noqa: E402
    DiscriminatorPix2pix)
from sggan_tpu_torch.models.generator_pix2pix import (  # noqa: E402
    GeneratorPix2pix)
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_step import FAST  # noqa: E402

GOLDEN_PATH = "golden/pix2pix.npy"
B, H, W = 2, 32, 32
KW = dict(image_height=H, image_width=W, ngf=4, ndf=4, segment_class=8,
          batch_size=B, compute_dtype="float32", loss_mode="p2p",
          use_pix2pix=True, dropout_mode="intended")
LR = 1e-3
RNG = jax.random.PRNGKey(31)
CLI = ["--img_height", str(H), "--img_width", str(W), "--ngf", "4", "--ndf",
       "4", "--segment_class", "8", "--batch_size", "2", "--compute_dtype",
       "float32", "--print_freq", "1", "--use_pix2pix"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """4-channel nets at 32x32: one torch thread runs them as fast as
    several and does not contend with the other test workers (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST)(*args)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bn_t(tree):
    return {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
            for k, v in tree.items()}


def _bn_close(got, ref, rtol=1e-6, atol=1e-6):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].keys() == ref[k].keys(), k
        for n in ref[k]:
            np.testing.assert_allclose(got[k][n].numpy(), np.asarray(
                ref[k][n]), rtol=rtol, atol=atol, err_msg=f"{k}.{n}")


@pytest.fixture(scope="module")
def golden_case():
    """The params, state and input of test_golden._case("pix2pix"), drawn
    as one program without XLA's LLVM passes (the same draws)."""
    def draws():
        p, st = jgen.init(jax.random.PRNGKey(42), ngf=4, image_size=32)
        return p, st, jax.random.uniform(jax.random.PRNGKey(7),
                                         (1, 32, 32, 3))
    return _np(_compile(draws))


def _port_gen(p):
    gen = GeneratorPix2pix(ngf=4, image_size=H)
    gen.load_state_dict(bridge.params_from_jax(p))
    return gen


def test_pix2pix_generator_matches_golden_fixture(golden_case):
    p, st, x = golden_case
    with torch.no_grad():
        got, new = _port_gen(p)(torch.from_numpy(x.copy()), _bn_t(st))
    path = os.path.join(os.path.dirname(__file__), GOLDEN_PATH)
    np.testing.assert_allclose(got.numpy(), np.load(path), rtol=2e-3,
                               atol=2e-4)
    _bn_close(new, st, rtol=0, atol=0)  # inference returns the state


def _pix2pix_masks(rng, gen):
    """The keep masks the JAX pix2pix generator draws for up0-up2 from
    ``rng`` (generator_pix2pix.py:118-121)."""
    shapes = gen.drop_shapes(B, H, W)

    def draw(r):
        return [jax.random.bernoulli(k, 0.5, s)
                for k, s in zip(jax.random.split(r, 3), shapes)]
    return [torch.from_numpy(np.array(m)) for m in _compile(draw, rng)]


@pytest.mark.parametrize("train", [False, True], ids=["inference",
                                                      "train_dropout"])
def test_pix2pix_generator_matches_jax(golden_case, train):
    p, st, _ = golden_case
    x = np.random.default_rng(1).uniform(size=(B, H, W, 3)).astype(np.float32)
    ry, rnew = _compile(lambda p, st, x: jgen.apply(
        p, st, x, compute_dtype=jnp.float32, rng=RNG if train else None,
        deterministic=not train, train=train, ngf=4), p, st, x)
    gen = _port_gen(p)
    masks = _pix2pix_masks(RNG, gen) if train else None
    with torch.no_grad():
        got, new = gen(torch.from_numpy(x), _bn_t(st), torch.float32, masks,
                       train=train)
    assert got.shape == (B, H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ry), rtol=0,
                               atol=1e-4)
    _bn_close(new, _np(rnew), rtol=1e-5, atol=1e-6)
    assert [tuple(m.shape) for m in (masks or [])] == (
        [(B, 2, 2, 32), (B, 4, 4, 32), (B, 8, 8, 16)] if train else [])


@pytest.mark.parametrize("train", [False, True])
def test_pix2pix_discriminator_matches_jax(train):
    disc = DiscriminatorPix2pix(ndf=4,
                                generator=torch.Generator().manual_seed(3))
    st = disc.init_bn_state()
    tree = bridge.params_to_jax(disc.state_dict())
    r = np.random.default_rng(2)
    inp, tar = (r.uniform(size=(B, H, W, 3)).astype(np.float32)
                for _ in range(2))
    ry, rnew = _compile(lambda p, s, a, b: jdisc.apply(
        p, s, a, b, compute_dtype=jnp.float32, train=train), tree,
        bridge._bn_to_jax(st), inp, tar)
    with torch.no_grad():
        got, new = disc(torch.from_numpy(inp), torch.from_numpy(tar), st,
                        torch.float32, train=train)
    assert got.shape == (B, 2, 2, 1) == np.asarray(ry).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ry), rtol=0,
                               atol=1e-5)
    _bn_close(new, _np(rnew), rtol=1e-5, atol=1e-6)


def test_pix2pix_nets_have_the_jax_names_and_plan():
    gen = GeneratorPix2pix(ngf=4, image_size=256)
    assert gen.down_ch == [4, 8, 16, 32, 32, 32, 32, 32]
    assert gen.up_ch == [32, 32, 32, 32, 32, 16, 8]
    # at 256x512 the depth follows H: the bottom is 1x2
    assert gen.drop_shapes(1, 256, 512)[0] == (1, 2, 4, 32)
    assert "last.b" in gen.state_dict() and "down0.b" not in gen.state_dict()
    assert set(gen.init_bn_state()) == {
        *(f"down{i}_bn" for i in range(1, 8)),
        *(f"up{i}_bn" for i in range(7))}
    disc = DiscriminatorPix2pix(ndf=4)
    assert set(disc.init_bn_state()) == {"down1_bn", "down2_bn", "conv_bn"}
    with pytest.raises(ValueError, match="depth"):
        gen(torch.zeros(1, 32, 32, 3), gen.init_bn_state())
