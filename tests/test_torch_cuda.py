"""The port on the card: the CUDA instance-norm kernel against its plain
version, the wrapper's refusals, and the generator's CUDA forward against
its CPU forward.  Every test needs an NVIDIA GPU and skips without one.

Imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from sggan_tpu_torch.models.generator_resnet import GeneratorResnet  # noqa: E402
from sggan_tpu_torch.ops import cuda_in  # noqa: E402
from sggan_tpu_torch.ops import norm as tnorm  # noqa: E402

pytestmark = pytest.mark.cuda

ACTS = [None, "relu", "leaky_relu"]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dev, dtype, seed=3):
    r = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy((r.standard_normal(shape) * 2 + 0.5)
                         .astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(r.uniform(0.5, 1.5, c).astype(np.float32)).to(dev)
    b = torch.from_numpy((r.standard_normal(c) * 0.1)
                         .astype(np.float32)).to(dev)
    return x, g, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 16, 8, 128),
                                   (2, 8, 4, 256), (1, 4, 4, 34),
                                   (2, 33, 17, 64), (3, 64, 40, 5)])
def test_kernel_matches_plain(dev, shape, act, dtype):
    x, g, b = _inputs(shape, dev, dtype)
    before = cuda_in.launches
    got = tnorm.instance_norm({"gamma": g, "beta": b}, x, act=act)
    assert cuda_in.launches == before + 1
    ref = tnorm.instance_norm_ref(x, g, b, 1e-3, act, 0.3)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, g, b = _inputs((1, 8, 8, 16), dev, torch.float32)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        cuda_in.instance_norm_cuda(x.permute(0, 2, 1, 3), g, b)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_in.instance_norm_cuda(x.half(), g, b)
    with pytest.raises(ValueError, match="gamma"):
        cuda_in.instance_norm_cuda(x, g.bfloat16(), b)
    with pytest.raises(ValueError, match="beta"):
        cuda_in.instance_norm_cuda(x, g, b[:8])


def test_generator_cuda_forward_matches_cpu(dev, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = GeneratorResnet(ngf=8, generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 32, 48, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = gen(x)
        gen_d = gen.to(dev)
        before = cuda_in.launches
        got = gen_d(x.to(dev))
        assert cuda_in.launches == before + 23
        got16 = gen_d(x.to(dev), compute_dtype=torch.bfloat16)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
    assert got16.dtype == torch.float32 and torch.isfinite(got16).all()
    assert (got16.float().cpu() - ref).abs().max().item() < 0.25
