"""Port parity: the ResNet generator, the parameter bridge and the
inference helpers of sggan_tpu_torch against the JAX package on the CPU.

The generator runs in f32 at ngf 8, 32x32, on the JAX package's own
weights through the bridge.  atol 1e-4: the two sides sum each conv in
f32 in different orders, and the 23 instance norms rescale that noise;
the golden policy (rtol 2e-3 / atol 2e-4, tests/test_golden.py) is the
ceiling."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.config import Config  # noqa: E402
from sggan_tpu.models import generator_resnet as jgen  # noqa: E402
from sggan_tpu.train import evaluate as jeval  # noqa: E402
from sggan_tpu_torch.models.generator_resnet import GeneratorResnet  # noqa: E402
from sggan_tpu_torch.train import evaluate as teval  # noqa: E402
from sggan_tpu_torch.utils.bridge import params_from_jax, params_to_jax  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "resnet.npy")


def _golden_draws():
    p = jgen.init(jax.random.PRNGKey(42), ngf=8)
    x = jax.random.uniform(jax.random.PRNGKey(7), (1, 32, 32, 3))
    return p, x


@pytest.fixture(scope="module")
def golden_case():
    """The params and input of test_golden._case("resnet").  XLA's LLVM
    passes spend ~10 s on the threefry draws here; without them (and
    without the CPU fusion emitters, ~1 s less again) the draws are the
    same and the glorot scaling differs by at most 1 ulp, far inside the
    golden tolerance (the parity tests feed both sides the same
    params)."""
    p, x = jax.jit(_golden_draws).lower().compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True,
         "xla_cpu_use_fusion_emitters": False})()
    return jax.tree.map(np.array, p), np.array(x)


def _port(p):
    gen = GeneratorResnet(ngf=8)
    gen.load_state_dict(params_from_jax(p))
    return gen


def test_bridge_round_trips_every_key_and_shape(golden_case):
    p, _ = golden_case
    sd = params_from_jax(p)
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(p)}
    assert sorted(k.replace(".", "/") for k in sd) == sorted(flat)
    assert set(sd) == set(GeneratorResnet(ngf=8).state_dict())
    back = params_to_jax(sd)
    for path, v in jax.tree_util.tree_leaves_with_path(p):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(v))
    # conv HWIO -> OIHW; conv-transpose (kh, kw, cout, cin) -> (cin, cout, ..)
    assert sd["c2.w"].shape == (16, 8, 3, 3)
    assert sd["d1.w"].shape == (32, 16, 3, 3)


@pytest.mark.parametrize("pad_free_head", [True, False])
def test_generator_matches_jax(golden_case, pad_free_head):
    p, x = golden_case
    # one program without XLA's LLVM passes and CPU fusion emitters, as
    # tests/test_torch_step.py compiles the JAX step (f32 results equal to
    # rounding; the op-by-op eager forward compiled each op at -O3)
    ref = jax.jit(lambda p, x: jgen.apply(
        p, x, compute_dtype=jnp.float32, pad_free_head=pad_free_head)) \
        .lower(p, x).compile({"xla_backend_optimization_level": 0,
                              "xla_llvm_disable_expensive_passes": True,
                              "xla_cpu_use_fusion_emitters": False})(p, x)
    with torch.inference_mode():
        got, st = _port(p)(torch.from_numpy(x.copy()), {}, torch.float32,
                           pad_free_head=pad_free_head)
    assert st == {}
    assert got.dtype == torch.float32 and got.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_generator_matches_golden_fixture(golden_case):
    p, x = golden_case
    with torch.inference_mode():
        got, _ = _port(p)(torch.from_numpy(x.copy()), {})
    np.testing.assert_allclose(got.numpy(), np.load(GOLDEN), rtol=2e-3,
                               atol=2e-4)


@pytest.mark.parametrize("t", [2.0, float("inf")])
def test_sharpen_matches_jax(t):
    y = np.random.default_rng(0).uniform(-1, 1, (2, 4, 4, 3)) \
        .astype(np.float32)
    y[0, 0, 0] = [0.0, 1.0, -1.0]
    ref = jeval.sharpen(jnp.asarray(y), t)
    got = teval.sharpen(torch.from_numpy(y), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_build_generator_is_seeded_and_follows_config():
    cfg = Config(use_resnet=True, ngf=4, data_seed=5)
    a, b = teval.build_generator(cfg), teval.build_generator(cfg)
    c = teval.build_generator(cfg.replace(data_seed=6))
    assert a.c1["w"].shape == (4, 3, 7, 7)
    assert torch.equal(a.c1["w"], b.c1["w"])
    assert not torch.equal(a.c1["w"], c.c1["w"])
    assert teval.compute_dtype(cfg) == torch.bfloat16
    assert teval.compute_dtype(cfg.replace(compute_dtype="float32")) \
        == torch.float32
