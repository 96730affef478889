"""Port parity of ``--remat``: the ResNet's resblocks and the U-Net's
stages recomputed in the backward (``torch.utils.checkpoint``) against the
JAX package's ``jax.checkpoint``, on the CPU, f32.

* The generators at ngf 4, 16x16, b=2 (the U-Net fed the keep masks the
  JAX U-Net draws): the gradient of ``sum(out * t)`` with ``remat`` equal
  to the one without (rtol 1e-6, as ``tests/test_models.py:194`` holds the
  JAX package) and to JAX's with ``remat=True`` (the two packages' convs
  sum in other orders: 1e-4 of a tensor's largest, as
  ``tests/test_torch_generator.py`` holds the forward).

The sggan and cycle steps under ``--remat`` are held to the JAX steps in
``tests/test_torch_step.py`` and ``tests/test_torch_cycle.py``, on the
programs those files compile.

The JAX programs are compiled without XLA's LLVM passes and CPU fusion
emitters, as ``tests/test_torch_step.py`` compiles its step."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.models import generator_resnet as jres  # noqa: E402
from sggan_tpu.models import generator_unet as junet  # noqa: E402
from sggan_tpu_torch.models.generator_resnet import GeneratorResnet  # noqa: E402
from sggan_tpu_torch.models.generator_unet import GeneratorUnet  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
import test_torch_step as ts_  # noqa: E402

B, S = 2, 16
MASK_C = 32  # the U-Net's d1-d3 width at ngf 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """4-channel nets: one torch thread runs them as fast as several, does
    not contend with the other test workers, and sums the same way from
    one call to the next (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(ts_.FAST)(*args)


def _grads(gen, x, t, masks, **kw):
    names, params = zip(*gen.named_parameters())
    y, _ = gen(torch.from_numpy(x), {}, torch.float32, masks, train=True,
               **kw)
    gs = torch.autograd.grad((y * torch.from_numpy(t)).sum(), params,
                             materialize_grads=True)
    return dict(zip(names, gs))


@pytest.mark.parametrize("net", ["resnet", "unet"])
def test_generator_remat_matches_without_and_jax(net):
    r = np.random.default_rng(3)
    x = r.uniform(size=(B, S, S, 3)).astype(np.float32)
    t = r.standard_normal((B, S, S, 3)).astype(np.float32)
    gen = (GeneratorResnet if net == "resnet" else GeneratorUnet)(
        ngf=4, generator=torch.Generator().manual_seed(0))
    p = bridge.params_to_jax({k: v.detach() for k, v in
                              gen.state_dict().items()})
    rng = jax.random.PRNGKey(4)
    if net == "resnet":
        # the head --remat takes by default
        kw = {"pad_free_head": False}
        masks = None
        fn = lambda p, x: jres.apply(  # noqa: E731
            p, x, compute_dtype=jnp.float32, remat=True, **kw)
    else:
        kw = {}
        masks = [torch.from_numpy(np.array(m)) for m in _compile(
            lambda r: [jax.random.bernoulli(k, 0.5, (B, S, S, MASK_C))
                       for k in jax.random.split(r, 3)], rng)]
        fn = lambda p, x: junet.apply(  # noqa: E731
            p, x, compute_dtype=jnp.float32, rng=rng, deterministic=False,
            remat=True)
    plain = _grads(gen, x, t, masks, **kw)
    remat = _grads(gen, x, t, masks, remat=True, **kw)
    for k, g in plain.items():
        np.testing.assert_allclose(remat[k].numpy(), g.numpy(), rtol=1e-6,
                                   atol=0, err_msg=k)
    ref = _compile(jax.grad(lambda p: jnp.sum(fn(p, x) * t)), p)
    ts_._close(bridge.params_to_jax(remat), ref, atol_of_max=1e-4)
