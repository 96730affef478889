"""Port parity: sggan_tpu_torch.ops.layers against sggan_tpu.ops.layers on
the CPU, f32, same numpy inputs and kernels (atol 1e-5: both sides sum
in f32, in different orders).

Pins the two TF-padding traps of the port: stride-2 SAME conv pads
(0, 1), which F.conv2d(padding=1) gets wrong, and stride-2 SAME
conv-transpose crops the END of the full output, which
F.conv_transpose2d(padding=1, output_padding=1) gets wrong."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.ops import layers as jl  # noqa: E402
from sggan_tpu_torch.ops import layers as tl  # noqa: E402
from sggan_tpu_torch.utils.bridge import params_from_jax  # noqa: E402

ATOL = 1e-5


def _data(seed, x_shape, w_shape):
    r = np.random.default_rng(seed)
    x = r.standard_normal(x_shape).astype(np.float32)
    w = (r.standard_normal(w_shape) * 0.2).astype(np.float32)
    b = r.standard_normal(w_shape[-1]).astype(np.float32)
    return x, {"w": w, "b": b}


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("hw", [(9, 7), (8, 10)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 4])
def test_conv2d(k, stride, padding, hw):
    x, p = _data(0, (2, *hw, 3), (k, k, 3, 5))
    ref = jl.conv2d(p, jnp.asarray(x), stride, padding)
    got = tl.conv2d(params_from_jax(p), torch.from_numpy(x), stride, padding)
    assert got.is_contiguous()
    _close(got, ref)


@pytest.mark.parametrize("hw,stride", [((15, 31), 2), ((7, 15), 2),
                                       ((3, 7), 1)])
def test_conv2d_valid_at_the_discriminator_chain_sizes(hw, stride):
    """The 256x512 discriminator's VALID chain: (32,64) -> (15,31) ->
    (7,15) -> (3,7) -> (1,5), odd sizes at stride 2."""
    x, p = _data(3, (2, *hw, 8), (3, 3, 8, 8))
    ref = jl.conv2d(p, jnp.asarray(x), stride, "VALID")
    got = tl.conv2d(params_from_jax(p), torch.from_numpy(x), stride, "VALID",
                    bias=False)
    assert got.shape == ((2, (hw[0] - 3) // stride + 1,
                          (hw[1] - 3) // stride + 1, 8))
    _close(got + torch.from_numpy(p["b"]), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaky_relu_is_keras(dtype):
    x = np.linspace(-3, 3, 25, dtype=np.float32).reshape(1, 5, 5, 1)
    ref = jl.leaky_relu(jnp.asarray(x).astype(dtype))
    got = tl.leaky_relu(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert got.float()[0, 0, 0, 0].item() == pytest.approx(-0.9, rel=1e-2)


def test_reflect_pad_index_cached_under_inference_mode_trains():
    """A forward under inference_mode caches the pad's index; a later
    forward that autograd records must be able to use it."""
    x = torch.rand(1, 6, 5, 2)
    with torch.inference_mode():
        tl.reflect_pad(x, 1)
    w = torch.ones(2, requires_grad=True)
    (tl.reflect_pad(x * w, 1).sum()).backward()
    assert w.grad.shape == (2,)


@pytest.mark.parametrize("hw", [(5, 7), (4, 6)])
@pytest.mark.parametrize("k,stride,padding", [
    (3, 2, "SAME"), (4, 2, "SAME"), (3, 1, "SAME"), (3, 2, "VALID")])
def test_conv2d_transpose(k, stride, padding, hw):
    # TF Conv2DTranspose layout (kh, kw, cout, cin)
    x, p = _data(1, (2, *hw, 6), (k, k, 4, 6))
    p["b"] = p["b"][:4]
    ref = jl.conv2d_transpose(p, jnp.asarray(x), stride, padding)
    got = tl.conv2d_transpose(params_from_jax(p), torch.from_numpy(x),
                              stride, padding)
    if padding == "SAME":
        assert got.shape == (2, hw[0] * stride, hw[1] * stride, 4)
    _close(got, ref)


@pytest.mark.parametrize("pad", [1, 3, ((0, 0), (2, 1), (0, 3), (0, 0))])
def test_reflect_pad(pad):
    x = np.random.default_rng(2).standard_normal((2, 7, 6, 3)) \
        .astype(np.float32)
    ref = jl.reflect_pad(jnp.asarray(x), pad)
    got = tl.reflect_pad(torch.from_numpy(x), pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_reflect_pad_rejects_pad_not_smaller_than_size():
    with pytest.raises(ValueError, match="size > pad"):
        tl.reflect_pad(torch.zeros(1, 3, 8, 2), 3)
    with pytest.raises(ValueError, match="only H and W"):
        tl.reflect_pad(torch.zeros(1, 4, 4, 2),
                       ((0, 0), (1, 1), (1, 1), (1, 0)))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k", [3, 7])
def test_conv2d_reflect(k, bias):
    x, p = _data(3, (2, 10, 9, 4), (k, k, 4, 5))
    ref = jl.conv2d_reflect(p, jnp.asarray(x), bias=bias)
    got = tl.conv2d_reflect(params_from_jax(p), torch.from_numpy(x),
                            bias=bias)
    _close(got, ref)


# one program, without XLA's LLVM passes and CPU fusion emitters, as
# tests/test_torch_step.py compiles the JAX step
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}


def _fast(fn, *args):
    args = [jnp.asarray(a) for a in args]
    return jax.jit(fn).lower(*args).compile(FAST)(*args)


REFLECT_PADS = [1, 3, ((0, 0), (2, 1), (0, 3), (0, 0)),
                ((0, 0), (0, 2), (3, 1), (0, 0))]


@pytest.mark.parametrize("hw", [(7, 9), (8, 5)])
@pytest.mark.parametrize("pad", REFLECT_PADS)
def test_reflect_pad_gradient_matches_jax_vjp(pad, hw):
    """The Function's strip-add adjoint and the plain twin's index adjoint
    against ``jax.vjp`` of the JAX package's ``reflect_pad`` (its custom
    VJP), odd and even H and W; the one-copy adjoint equals
    ``unpad_reflect_transpose`` applied per axis, W then H, bitwise."""
    x = np.random.default_rng(5).standard_normal((2, *hw, 3)) \
        .astype(np.float32)
    y = np.asarray(jl.reflect_pad(jnp.asarray(x), pad))
    ct = np.random.default_rng(6).standard_normal(y.shape).astype(np.float32)
    ref = np.asarray(_fast(lambda v, c: jax.vjp(
        lambda u: jl.reflect_pad(u, pad), v)[1](c)[0], x, ct))
    for fn in (tl.reflect_pad, tl.reflect_pad_ref):
        xt = torch.from_numpy(x).requires_grad_(True)
        got = fn(xt, pad)
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(y))
        dx, = torch.autograd.grad(got, xt, torch.from_numpy(ct))
        np.testing.assert_allclose(dx.numpy(), ref, rtol=1e-5, atol=1e-5)
    (ht, hb), (wl, wr) = ((pad, pad), (pad, pad)) if isinstance(pad, int) \
        else pad[1:3]
    dyt = torch.from_numpy(ct)
    per_axis = tl.unpad_reflect_transpose(
        tl.unpad_reflect_transpose(dyt, wl, wr, 2), ht, hb, 1)
    assert torch.equal(tl.reflect_pad_adjoint(dyt, ht, hb, wl, wr), per_axis)


@functools.lru_cache(maxsize=None)
def _conv2d_reflect_vjp(k, bias, hw):
    """(x, params, cotangent, (y, dw, dx)) of the JAX ``conv2d_reflect``,
    one reference for every form."""
    x, p = _data(7, (2, *hw, 4), (k, k, 4, 5))
    ct = np.random.default_rng(8).standard_normal((2, *hw, 5)) \
        .astype(np.float32)

    def f(w, v, b, c):
        y, vjp = jax.vjp(lambda w, v: jl.conv2d_reflect(
            {"w": w, "b": b}, v, bias=bias), w, v)
        return (y, *vjp(c))
    return x, p, ct, _fast(f, p["w"], x, p["b"], ct)


# the nets' conv2d_reflect is one of these (test_conv2d_reflect_is_a_form)
CONV_FORMS = {"pad_free": tl.conv2d_reflect_pad_free,
              "gather": tl.conv2d_reflect_gather, "ref": tl.conv2d_reflect_ref}


def test_conv2d_reflect_is_a_form():
    assert tl.conv2d_reflect in (tl.conv2d_reflect_pad_free,
                                 tl.conv2d_reflect_gather)


@pytest.mark.parametrize("hw", [(10, 9), (13, 11)])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("form", list(CONV_FORMS))
def test_conv2d_reflect_vjp_matches_jax(form, k, bias, hw):
    """Value, dx and dw of each form of the reflect conv against
    ``jax.vjp`` of the JAX package's ``conv2d_reflect`` (its pad-free
    custom VJP), as tests/test_ops.py holds it against the padded form;
    rtol 1e-5 / atol 1e-5 of each tensor's scale."""
    x, p, ct, (y, jdw, jdx) = _conv2d_reflect_vjp(k, bias, hw)
    tp = params_from_jax(p)
    w = tp["w"].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = CONV_FORMS[form]({"w": w, "b": tp["b"]}, xt, bias=bias)
    dw, dx = torch.autograd.grad(got, (w, xt), torch.from_numpy(ct))
    for g, r in ((got.detach().numpy(), y), (dx.numpy(), jdx),
                 (dw.permute(2, 3, 1, 0).numpy(), jdw)):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_conv2d_reflect_without_grad_is_its_forward_body():
    """Where no input needs a gradient the reflect conv and pad record no
    Function (``torch.export`` then sees plain ops), with the same values;
    an even kernel is refused."""
    x, p = _data(9, (1, 6, 7, 3), (3, 3, 3, 2))
    tp = params_from_jax(p)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y = tl.conv2d_reflect_pad_free(tp, xt)
        assert y.grad_fn is None
    w = tp["w"].clone().requires_grad_(True)
    y2 = tl.conv2d_reflect_pad_free({"w": w, "b": tp["b"]}, xt)
    assert y2.grad_fn is not None
    assert torch.equal(y, y2.detach())
    assert tl.reflect_pad(xt, 1).grad_fn is None
    with pytest.raises(ValueError, match="odd kernel"):
        tl.conv2d_reflect_pad_free({"w": torch.zeros(2, 3, 4, 4)}, xt)


def test_glorot_uniform_bounds_and_layouts():
    g = torch.Generator().manual_seed(0)
    conv = tl.conv2d_init(3, 3, 16, 32, g)
    tconv = tl.conv2d_transpose_init(3, 3, 16, 32, g)
    assert conv["w"].shape == (32, 16, 3, 3)       # (cout, cin, kh, kw)
    assert tconv["w"].shape == (16, 32, 3, 3)      # (cin, cout, kh, kw)
    limit = np.sqrt(6.0 / (9 * 16 + 9 * 32))
    for w in (conv["w"], tconv["w"]):
        a = w.abs().max().item()
        assert limit * 0.95 < a <= limit
    assert not conv["b"].any()
