"""The port on the card: the CUDA instance-norm kernels (forward, its
saved moments, backward) and the fused conv3x3 + instance norm kernel
(both conv routes, and the gradients of its autograd Function) against
their plain versions, the wrappers' refusals, the generator's CUDA forward
and the gradients of one train step and of one cycle step against the
CPU, a generator exported on the card (one K1 op node per instance
norm, each launching K1 on its planned route), and the CUDA graphs: the
trainer's step graph in every loss mode against its eager steps, the
forward graph against the eager forward, its capture when a weight
moves.  Every test needs an NVIDIA GPU and skips without one.

Imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from sggan_tpu_torch.models.generator_resnet import GeneratorResnet  # noqa: E402
from sggan_tpu_torch.ops import cuda_conv_in as cci  # noqa: E402
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (3, 64, 40, 5),
                                   (2, 33, 17, 64), (2, 1, 5, 8)])
def test_forward_saves_the_plain_moments(dev, shape, dtype):
    x, g, b = _inputs(shape, dev, dtype)
    y, mean, rstd = cuda_in.instance_norm_cuda(x, g, b, 1e-3, "relu",
                                               save_stats=True)
    _, mean_ref, rstd_ref = tnorm._ref_forward(x, g, b, 1e-3, "relu", 0.3)
    torch.cuda.synchronize()
    assert mean.shape == rstd.shape == (shape[0], shape[-1])
    torch.testing.assert_close(mean, mean_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(y, tnorm.instance_norm_ref(x, g, b, 1e-3,
                                                          "relu"),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(3, 64, 40, 5), (2, 33, 17, 64),
                                   (2, 1, 5, 8), (2, 8, 4, 256)])
def test_backward_kernel_matches_plain(dev, shape, act, dtype):
    """dx in x's dtype at tests/test_pallas.py's gradient tolerance (f32)
    or 2e-2 of max |dx| (bf16); dgamma, dbeta at rel 1e-4."""
    x, g, b = _inputs(shape, dev, dtype)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(shape)
                          .astype(np.float32)).to(dev, dtype)
    _, mean, rstd = tnorm._ref_forward(x, g, b, 1e-3, act, 0.3)
    before = cuda_in.bwd_launches
    dx, dg, db = cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean, rstd, act)
    assert cuda_in.bwd_launches == before + 1
    rdx, rdg, rdb = tnorm.instance_norm_bwd_ref(x, dy, g, b, mean, rstd, act)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(dx, rdx, rtol=1e-4, atol=1e-5)
    else:
        scale = rdx.float().abs().max().item()
        assert (dx.float() - rdx.float()).abs().max().item() <= 2e-2 * scale
    for got, ref in ((dg, rdg), (db, rdb)):
        assert (got - ref).abs().max().item() <= 1e-4 * max(
            ref.abs().max().item(), 1e-3)


def test_autograd_runs_both_kernels(dev):
    x, g, b = _inputs((2, 16, 8, 32), dev, torch.float32)
    x.requires_grad_(True)
    g.requires_grad_(True)
    f0, b0 = cuda_in.launches, cuda_in.bwd_launches
    y = tnorm.instance_norm({"gamma": g, "beta": b}, x, act="leaky_relu")
    dx, dg = torch.autograd.grad(y.square().sum(), (x, g))
    assert (cuda_in.launches, cuda_in.bwd_launches) == (f0 + 1, b0 + 1)
    xc, gc = x.detach().cpu().requires_grad_(True), g.detach().cpu() \
        .requires_grad_(True)
    yc = tnorm.instance_norm({"gamma": gc, "beta": b.cpu()}, xc,
                             act="leaky_relu")
    rdx, rdg = torch.autograd.grad(yc.square().sum(), (xc, gc))
    torch.testing.assert_close(dx.cpu(), rdx, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dg.cpu(), rdg, rtol=1e-4, atol=1e-4)


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
    mean = torch.zeros(1, 16, device=dev)
    with pytest.raises(ValueError, match="dy must match"):
        cuda_in.instance_norm_bwd_cuda(x, x.bfloat16(), g, b, mean, mean)
    with pytest.raises(ValueError, match="rstd"):
        cuda_in.instance_norm_bwd_cuda(x, x, g, b, mean, mean[:, :8])


def _check_fwd_bwd(x, g, b, dy, act, p_fwd, p_bwd):
    """The forward (y, mean, rstd) and the backward (dx, dgamma, dbeta) on
    the given plans against the plain twins at the tolerances above, and
    two calls bitwise equal."""
    dtype = x.dtype
    got = cuda_in._forward(x, g, b, 1e-3, act, 0.3, p_fwd)
    again = cuda_in._forward(x, g, b, 1e-3, act, 0.3, p_fwd)
    ry, rmean, rrstd = tnorm._ref_forward(x, g, b, 1e-3, act, 0.3)
    _, mean, rstd = got
    dgot = cuda_in._backward(x, dy, g, b, mean, rstd, act, 0.3, p_bwd)
    dagain = cuda_in._backward(x, dy, g, b, mean, rstd, act, 0.3, p_bwd)
    rdx, rdg, rdb = tnorm.instance_norm_bwd_ref(x, dy, g, b, mean, rstd, act)
    torch.cuda.synchronize()
    for a, c in zip((*got, *dgot), (*again, *dagain)):
        assert torch.equal(a, c)
    y, dx = got[0], dgot[0]
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-4, atol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(dx, rdx, rtol=1e-4, atol=1e-5)
    else:
        scale = rdx.float().abs().max().item()
        assert (dx.float() - rdx.float()).abs().max().item() <= 2e-2 * scale
    for a, r in ((dgot[1], rdg), (dgot[2], rdb)):
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert (a - r).abs().max().item() <= 1e-4 * max(
            r.abs().max().item(), 1e-3)


# one shape that every route takes, a ragged channel tile (C 48), an
# H*W = 5 plane, batch 1, and a 1x1 plane (the semantic discriminator's
# last at 128x128: variance 0, rstd from eps alone)
ROUTE_SHAPES = [(2, 16, 12, 64), (3, 9, 7, 48), (2, 1, 5, 64), (1, 32, 24, 32),
                (2, 1, 1, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("route", ["cluster", "stream", "scalar"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_every_route_matches_plain(dev, shape, route, act, dtype):
    x, g, b = _inputs(shape, dev, dtype, seed=11)
    dy = torch.from_numpy(np.random.default_rng(12).standard_normal(shape)
                          .astype(np.float32)).to(dev, dtype)
    plans = [cuda_in.plan(*shape, dtype, d, route=route)
             for d in ("fwd", "bwd")]
    assert all(p.route == route for p in plans)
    _check_fwd_bwd(x, g, b, dy, act, *plans)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 8, 16])
def test_cluster_sizes_match_plain(dev, k, dtype):
    """The cluster route at each cluster size the plan uses, one plane
    split over k CTAs (k = 16 needs the non-portable attribute)."""
    shape = (2, 32, 32, 64)
    x, g, b = _inputs(shape, dev, dtype, seed=13)
    dy = torch.from_numpy(np.random.default_rng(14).standard_normal(shape)
                          .astype(np.float32)).to(dev, dtype)
    plans = []
    for d, tensors in (("fwd", 1), ("bwd", 2)):
        rows = -(-32 * 32 // k)
        plans.append(cuda_in.Plan("cluster", 32, k, 2 * 2 * k,
                                  rows * 32 * x.element_size() * tensors,
                                  rows, 1))
        assert cuda_in.max_active_clusters(plans[-1], d, dtype) > 0
    _check_fwd_bwd(x, g, b, dy, "leaky_relu", *plans)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,route", [
    ((2, 16, 12, 64), "cluster"), ((1, 128, 256, 128), "stream"),
    ((3, 8, 8, 5), "scalar"), ((2, 1, 5, 512), "cluster")])
def test_public_wrappers_take_the_planned_route(dev, shape, route, dtype):
    x, g, b = _inputs(shape, dev, dtype, seed=15)
    dy = torch.from_numpy(np.random.default_rng(16).standard_normal(shape)
                          .astype(np.float32)).to(dev, dtype)
    assert cuda_in.plan(*shape, dtype, "fwd").route == route
    _check_fwd_bwd(x, g, b, dy, "relu", cuda_in.plan(*shape, dtype, "fwd"),
                   cuda_in.plan(*shape, dtype, "bwd"))
    y, mean, rstd = cuda_in.instance_norm_cuda(x, g, b, 1e-3, "relu",
                                               save_stats=True)
    ref = cuda_in._forward(x, g, b, 1e-3, "relu", 0.3,
                           cuda_in.plan(*shape, dtype, "fwd"))
    dx, dg, db = cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean, rstd,
                                                "relu")
    dref = cuda_in._backward(x, dy, g, b, mean, rstd, "relu", 0.3,
                             cuda_in.plan(*shape, dtype, "bwd"))
    torch.cuda.synchronize()
    for a, c in zip((y, mean, rstd, dx, dg, db), (*ref, *dref)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_input_takes_the_scalar_route(dev, dtype):
    shape = (2, 8, 8, 64)
    numel = int(np.prod(shape))
    buf = torch.randn(numel + 1, device=dev).to(dtype)
    x = buf[1:].view(shape)  # starts 2 or 4 bytes past an aligned address
    assert x.data_ptr() % 16 and x.is_contiguous()
    _, g, b = _inputs(shape, dev, dtype, seed=17)
    dy = torch.randn(shape, device=dev).to(dtype)
    assert not cuda_in._aligned(x)
    assert cuda_in.plan(*shape, dtype, "fwd", cuda_in._aligned(x)).route \
        == "scalar"
    y, mean, rstd = cuda_in.instance_norm_cuda(x, g, b, 1e-3, "relu",
                                               save_stats=True)
    dx, dg, db = cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean, rstd,
                                                "relu")
    torch.cuda.synchronize()
    _check_fwd_bwd(x, g, b, dy, "relu",
                   cuda_in.plan(*shape, dtype, "fwd", False),
                   cuda_in.plan(*shape, dtype, "bwd", False))
    torch.testing.assert_close(
        y.float(), tnorm.instance_norm_ref(x, g, b, 1e-3, "relu").float(),
        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("shape", [(2, 16, 12, 64), (1, 64, 128, 256),
                                   (3, 8, 8, 5)])
def test_backward_launches_no_library_kernel(dev, shape):
    """Every device kernel of a backward call (any route) is one of K1's:
    dgamma and dbeta come from the kernel, not from a library reduction."""
    from torch.profiler import ProfilerActivity, profile
    x, g, b = _inputs(shape, dev, torch.bfloat16, seed=18)
    dy = torch.randn(shape, device=dev).to(torch.bfloat16)
    _, mean, rstd = cuda_in.instance_norm_cuda(x, g, b, 1e-3, "relu",
                                               save_stats=True)
    cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean, rstd, "relu")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean, rstd, "relu")
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA")]
    assert names and all("in_bwd_" in k for k in names), names


def test_generator_cuda_forward_matches_cpu(dev, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = GeneratorResnet(ngf=8, generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 32, 48, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref, _ = gen(x, {})
        gen_d = gen.to(dev)
        before = cuda_in.launches
        got, _ = gen_d(x.to(dev), {})
        assert cuda_in.launches == before + 23
        got16, _ = gen_d(x.to(dev), {}, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
    assert got16.dtype == torch.float32 and torch.isfinite(got16).all()
    assert (got16.float().cpu() - ref).abs().max().item() < 0.25


def test_train_step_cuda_matches_cpu(dev, monkeypatch):
    """One f32 sggan step's losses and gradients, card (kernels) vs CPU
    (plain versions), from the same seeded state, batch and pool draws."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.train import pool, step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = Config(image_height=32, image_width=64, ngf=4, ndf=4,
                 segment_class=8, batch_size=2, max_size=2,
                 compute_dtype="float32", loss_mode="sggan", use_resnet=True)
    r = np.random.default_rng(0)
    batch = {"real_a": r.uniform(size=(2, 32, 64, 3)),
             "seg_a": r.uniform(size=(2, 32, 64, 3)),
             "mask_a": np.eye(8)[r.integers(0, 8, (2, 4, 8))]}
    batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in
             batch.items()}
    draws = pool.pool_draws(torch.Generator().manual_seed(1), 2, 2)
    out = {}
    for d in ("cpu", dev):
        state = step.init_state(cfg, torch.Generator().manual_seed(0), d)
        f0, b0 = cuda_in.launches, cuda_in.bwd_launches
        out[str(d)] = step.losses_and_grads(
            cfg, state, {k: v.to(d) for k, v in batch.items()}, draws)
        if d == dev:  # 23 generator INs, 4 per D call at 32x64 (chain [2])
            assert cuda_in.launches - f0 == 31
            assert cuda_in.bwd_launches - b0 == 31
    (m_c, g_c, d_c, *_), (m_g, g_g, d_g, *_) = out["cpu"], out["cuda"]
    for k in m_c:
        assert abs(m_g[k].item() - m_c[k].item()) <= 1e-4 * abs(m_c[k].item())
    for ref, got in ((g_c, g_g), (d_c, d_g)):
        assert ref.keys() == got.keys()
        for k in ref:
            scale = ref[k].abs().max().item()
            assert (got[k].cpu() - ref[k]).abs().max().item() \
                <= 1e-3 * scale + 1e-7, k


def test_cycle_step_cuda_matches_cpu(dev, monkeypatch):
    """One f32 ResNet cycle step's losses and the gradients of all four
    nets, card (kernels) vs CPU (plain versions), from the same seeded
    state, two-domain batch and pool draws, with exactly 154 K1 calls
    each way on the card.  The gradients are held at 1e-3 of each
    tensor's largest, or at chip_smoke.py's full-width limits where a sign
    the gradient follows falls on opposite sides (phase 22)."""
    import chip_smoke
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.train import cycle, pool, step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = Config(image_height=32, image_width=64, ngf=4, ndf=4,
                 segment_class=8, batch_size=2, max_size=2,
                 compute_dtype="float32", loss_mode="cycle", use_resnet=True)
    batch = chip_smoke.cycle_batch(cfg, 2, "cpu", seed=0)
    draws = pool.pool_draws(torch.Generator().manual_seed(1), 2, 2)
    out, signs = {}, {}
    for d in ("cpu", dev):
        state = step.init_state(cfg, torch.Generator().manual_seed(0), d)
        on = {k: v.to(d) for k, v in batch.items()}
        f0, b0 = cuda_in.launches, cuda_in.bwd_launches
        out[str(d)] = cycle.losses_and_grads(cfg, state, on, draws)
        if d == dev:  # 6 x 23 generator INs, 4 x 4 in the D calls
            assert cuda_in.launches - f0 == 154
            assert cuda_in.bwd_launches - b0 == 154
        signs[str(d)] = chip_smoke.cycle_signs(state, on, None,
                                               torch.float32)
    flips = sum(int(((a >= 0) != (c >= 0)).sum())
                for a, c in zip(signs["cpu"], signs["cuda"]))
    (m_c, g_c, d_c, _), (m_g, g_g, d_g, _) = out["cpu"], out["cuda"]
    for k in m_c:
        assert abs(m_g[k].item() - m_c[k].item()) <= 1e-4 * abs(m_c[k].item())
    rows = []
    for ref, got in ((g_c, g_g), (d_c, d_g)):
        assert ref.keys() == got.keys()
        rows += chip_smoke.grad_rows(ref, {k: v.cpu() for k, v in
                                           got.items()})
    lim = (1e-3, float("inf")) if not flips else (chip_smoke.STEP_MAX_REL,
                                                   chip_smoke.STEP_NORM_REL)
    assert max(r[0] for r in rows) <= lim[0], (flips, rows[-3:])
    assert max(r[1] for r in rows) <= lim[1], (flips, rows[-3:])


# ----------------------------------------------------------------------
# K2: fused reflect-pad conv3x3 + instance norm
# ----------------------------------------------------------------------

# (N, H, W, Cin, Cout): the JAX tests' three, an odd plane, a Cin that is
# no multiple of 16, then shapes the wgmma route takes in bf16 (one ragged
# in rows, columns and the Cout tile; one whose Cin is 32 + 16; two ragged
# against its 8 x 64 pixel by 64 channel tile: W of 70 and 130, odd H,
# Cout 144 and 48, Cin 16 in one chunk, n > 1)
K2_SHAPES = [(2, 8, 16, 8, 8), (1, 16, 8, 16, 8), (1, 64, 8, 8, 16),
             (2, 7, 9, 5, 6), (1, 9, 33, 24, 40), (2, 16, 16, 16, 16),
             (1, 20, 37, 32, 80), (1, 8, 8, 48, 32), (1, 9, 70, 32, 144),
             (2, 5, 130, 16, 48)]


def _k2_inputs(shape, dev, dtype, seed=0):
    n, h, w, cin, cout = shape
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((n, h, w, cin))
                         .astype(np.float32)).to(dev, dtype)
    wk = torch.from_numpy((r.standard_normal((cout, cin, 3, 3))
                           / np.sqrt(9 * cin)).astype(np.float32)).to(dev)
    g = torch.from_numpy((1 + 0.1 * r.standard_normal(cout))
                         .astype(np.float32)).to(dev)
    b = torch.from_numpy((0.1 * r.standard_normal(cout))
                         .astype(np.float32)).to(dev)
    return x, wk, g, b


def _k2_route(shape, dtype):
    return cci.conv_plan(*shape, dtype).kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_conv3_in_kernel_matches_plain(dev, monkeypatch, shape, act, dtype):
    """y, y16, mean, rsig of the kernel against the plain twin (its f32
    conv with TF32 off): f32 at tests/test_pallas_conv_in.py's 2e-5, bf16
    at its 5e-2, y16 within one bf16 ulp; two calls agree bitwise."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, wk, g, b = _k2_inputs(shape, dev, dtype)
    route = _k2_route(shape, dtype)
    before = cci.launches, cci.route_launches[route]
    got = cci.conv3_in_cuda(x, wk, g, b, 1e-3, act, 0.3)
    assert (cci.launches, cci.route_launches[route]) \
        == (before[0] + 1, before[1] + 1)
    again = cci.conv3_in_cuda(x, wk, g, b, 1e-3, act, 0.3)
    ref = cci.conv3_in_ref(x, wk, g, b, 1e-3, act, 0.3)
    torch.cuda.synchronize()
    for a, c in zip(got, again):
        assert torch.equal(a, c)
    y, y16, mean, rsig = got
    assert y.dtype == y16.dtype == dtype and y.shape == ref[0].shape
    assert mean.shape == rsig.shape == (shape[0], shape[4])
    if dtype == torch.float32:
        tol, tol16, tolm = 2e-5, 2e-5, 2e-5
    else:
        tol, tol16, tolm = 5e-2, 2.0 ** -7, 2e-3
    torch.testing.assert_close(y.float(), ref[0].float(), rtol=tol, atol=tol)
    torch.testing.assert_close(y16.float(), ref[1].float(), rtol=tol16,
                               atol=tol16)
    torch.testing.assert_close(mean, ref[2], rtol=tolm, atol=tolm)
    torch.testing.assert_close(rsig, ref[3], rtol=tolm, atol=tolm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 8), (2, 7, 9, 5, 6),
                                   (2, 16, 16, 16, 16), (1, 20, 37, 32, 80)])
def test_conv3_in_function_gradients(dev, monkeypatch, shape, act, dtype):
    """dx, dw, dgamma, dbeta of ``conv3_in`` on the card (the K2 kernel,
    then K1's backward kernel) against the plain route on the same
    tensors: f32 at 2e-4 of each tensor's largest, bf16 at 2e-2."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, wk, g, b = _k2_inputs(shape, dev, dtype, seed=3)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (*shape[:3], shape[4])).astype(np.float32)).to(dev, dtype)
    leaves = [t.requires_grad_(True) for t in (x, wk, g, b)]
    before = cci.launches, cuda_in.bwd_launches
    y = cci.conv3_in(*leaves, act=act)
    got = torch.autograd.grad(y, leaves, dy)
    assert (cci.launches, cuda_in.bwd_launches) \
        == (before[0] + 1, before[1] + 1)
    xd, wd, gd, bd = (t.detach() for t in leaves)
    _, y16, mean, rsig = cci.conv3_in_ref(xd, wd, gd, bd, 1e-3, act, 0.3)
    d_y16, dg, db = tnorm.instance_norm_bwd_ref(y16, dy, gd, bd, mean, rsig,
                                                act, 0.3)
    ref = (*cci.conv_grads(xd, wd, d_y16), dg, db)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for a, r, name in zip(got, ref, ("dx", "dw", "dgamma", "dbeta")):
        scale = r.float().abs().max().item()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


def test_conv3_in_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, wk, g, b = _k2_inputs((1, 8, 8, 16, 16), dev, torch.float32)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        cci.conv3_in_cuda(x.permute(0, 2, 1, 3), wk, g, b)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cci.conv3_in_cuda(x.half(), wk, g, b)
    with pytest.raises(ValueError, match="gamma"):
        cci.conv3_in_cuda(x, wk, g.bfloat16(), b)
    with pytest.raises(ValueError, match="3, 3"):
        cci.conv3_in_cuda(x, wk[:, :, :, :2], g, b)
    with pytest.raises(ValueError, match="on cuda"):
        cci.conv3_in_cuda(x, wk.cpu(), g, b)
    # bf16 x 8 bytes past a 16-byte boundary, on the wgmma route
    x_mis = torch.empty(x.numel() + 4, dtype=torch.bfloat16,
                        device=dev)[4:].view(x.shape)
    x_mis.copy_(x)
    with pytest.raises(ValueError, match="16 bytes"):
        cci.conv3_in_cuda(x_mis, wk, g, b)


def test_device_ms_times_by_events_when_no_trace_holds_the_kernel(
        dev, monkeypatch):
    """perf_in.device_ms: when no trace records a kernel of ``keys``, the
    padded retries run, then the calls are timed by CUDA events and noted
    in EVENT_TIMED; a later call that finds its kernel clears the mark."""
    from sggan_tpu_torch import perf_in
    monkeypatch.setattr(perf_in, "EVENT_TIMED", [])
    monkeypatch.setattr(perf_in, "_last_empty", [False])
    x, g, b = _inputs((2, 64, 64, 64), dev, torch.bfloat16)

    def fn():
        cuda_in.instance_norm_cuda(x, g, b, 1e-3, "relu")
    ms = perf_in.device_ms(fn, 4, tries=3, keys=("no_such_kernel",))
    assert ms > 0 and perf_in.EVENT_TIMED == [(4, ("no_such_kernel",))]
    assert perf_in._last_empty[0]
    assert perf_in.device_ms(fn, 4) > 0 and not perf_in._last_empty[0]
    assert len(perf_in.EVENT_TIMED) == 1


def test_exported_generator_launches_k1_through_the_op(dev, tmp_path):
    """An artifact exported on the card: 23 op nodes, run from the saved
    file through its CUDA graph, whose capture makes one K1 call per node
    on the planned routes in the warm-up and one in the capture, against
    the eager forward of the same weights (TF32 off: another graph) and
    against the CPU artifact."""
    from sggan_tpu_torch.utils import export as gexport

    gen = GeneratorResnet(ngf=8, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(5).random(
        (1, 64, 64, 3), np.float32))
    cpu_y = gexport.export_generator(gen, (64, 64), 1, torch.float32)
    cpu_y = gexport.Artifact(cpu_y, {})(x)
    gen = gen.to(dev)
    path = str(tmp_path / "gen.pt2")
    gexport.save(path, gexport.export_generator(gen, (64, 64), 1,
                                                torch.float32))
    art = gexport.load(path, "cuda")
    ops = gexport.graph_ops(art.program)
    assert ops.get("sggan_tpu_torch.instance_norm.default") == 23
    routes = dict(cuda_in.route_launches)
    before = cuda_in.launches
    got = art(x.to(dev))  # captures its CUDA graph: a warm-up, a capture
    assert cuda_in.launches == before + 2 * 23
    want = {}
    for (h, w, c), k in (((64, 64, 8), 2), ((32, 32, 16), 2),
                         ((16, 16, 32), 19)):
        r = cuda_in.plan(1, h, w, c, torch.float32, "fwd").route
        want[r] = want.get(r, 0) + 2 * k
    assert {r: cuda_in.route_launches["fwd", r] - routes["fwd", r]
            for r in ("cluster", "stream", "scalar")
            if cuda_in.route_launches["fwd", r] != routes["fwd", r]} == want
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = art(x.to(dev))
        with torch.inference_mode():
            eager = gen(x.to(dev), {}, torch.float32)[0]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.testing.assert_close(got, eager, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.cpu(), cpu_y, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="runs on cuda"):
        art(x)


GRAPH_SMALL = dict(image_height=32, image_width=32, ngf=4, ndf=4,
                   segment_class=8, max_size=3, compute_dtype="float32",
                   save_freq=0, print_freq=1000, data_seed=29, gen_ema=0.5)
GRAPH_MODES = {
    "sggan_resnet": dict(batch_size=2, loss_mode="sggan", use_resnet=True),
    "p2p_unet": dict(batch_size=1, dropout_mode="intended"),
    "pix2pix": dict(batch_size=1, use_pix2pix=True, dropout_mode="intended"),
    "cycle_resnet": dict(batch_size=1, loss_mode="cycle", use_resnet=True),
    # --remat: the graph holds the backward's recompute
    "sggan_resnet_remat": dict(batch_size=2, loss_mode="sggan",
                               use_resnet=True, remat=True),
    "p2p_unet_remat": dict(batch_size=1, dropout_mode="intended",
                           remat=True),
}


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_step_graph_replays_the_eager_steps(dev, mode, monkeypatch):
    """--scan_steps on the card: from one snapshot of the state and both
    generators, 6 eager steps of the trainer's loop and the same 6 as
    replays of the step's CUDA graph in chunks of 4 (a tail of 2), with
    cuDNN deterministic: losses and every state tensor bitwise equal, the
    step and the pool's count equal; the capture trains nothing."""
    import chip_smoke
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.train import fused

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = Config(**GRAPH_SMALL, **GRAPH_MODES[mode])
    tr, ds = chip_smoke.graph_trainer(cfg, dev, 6)
    snap = chip_smoke.train_snapshot(tr)
    eager = chip_smoke.loop_epoch(tr, ds, 0)
    ref = chip_smoke.train_snapshot(tr)
    chip_smoke.train_restore(tr, snap)
    tr.cfg = tr.cfg.replace(scan_steps=4)
    graph = fused.StepGraph(tr, ds, fused.make_batch_fn(tr.cfg))
    got = chip_smoke.loop_epoch(tr, ds, 0, graph)
    after = chip_smoke.train_snapshot(tr)
    assert graph.graph is not None
    assert torch.equal(got, eager)
    assert chip_smoke.differing(ref[0], after[0]) == []
    assert after[1:3] == ref[1:3]


@pytest.mark.parametrize("k", [3, 7])
def test_reflect_forms_on_the_card_match_the_cpu(dev, k):
    """The reflect pad's Function and both reflect-conv forms on CUDA
    tensors, f32 with TF32 off, against the plain twin on the CPU: value,
    dx and dw within 1e-5 of each tensor's largest."""
    from sggan_tpu_torch.ops import layers as tl
    g = torch.Generator().manual_seed(k)
    x = torch.randn(2, 13, 11, 8, generator=g)
    w = torch.randn(6, 8, k, k, generator=g) * 0.1
    dy = torch.randn(2, 13, 11, 6, generator=g)

    def grads(f, device):
        xl = x.to(device).requires_grad_(True)
        wl = w.to(device).requires_grad_(True)
        y = f({"w": wl}, xl, bias=False)
        return [t.cpu() for t in (y, *torch.autograd.grad(
            y, (xl, wl), dy.to(device)))]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = grads(tl.conv2d_reflect_ref, "cpu")
        for f in (tl.conv2d_reflect_pad_free, tl.conv2d_reflect_gather):
            for got, r in zip(grads(f, dev), ref):
                torch.testing.assert_close(
                    got, r, rtol=0, atol=1e-5 * r.abs().max().item())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def test_forward_graph_equals_eager_and_replays_without_the_wrapper(dev):
    """evaluate.generate through ForwardGraphs: the first call captures
    (K1's 23 calls twice: the warm-up and the capture), a second replays
    (none), both bitwise the eager forward's; another batch size is
    another graph."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.train import evaluate
    from sggan_tpu_torch.utils.cuda_graph import ForwardGraphs

    cfg = Config(use_resnet=True, image_height=32, image_width=32, ngf=8,
                 compute_dtype="float32")
    gen = evaluate.build_generator(cfg).to(dev)
    graphs = ForwardGraphs()
    for b in (2, 1):
        x = torch.rand(b, 32, 32, 3, device=dev)
        eager = evaluate.generate(cfg, gen, x, dev)
        before = cuda_in.launches
        first = evaluate.generate(cfg, gen, x, dev, graphs=graphs)
        assert cuda_in.launches == before + 2 * 23
        again = evaluate.generate(cfg, gen, x, dev, graphs=graphs)
        assert cuda_in.launches == before + 2 * 23
        np.testing.assert_array_equal(first, eager)
        np.testing.assert_array_equal(again, eager)
    assert len(graphs) == 2


def test_forward_graph_never_runs_stale_weights(dev):
    """A parameter updated in place is read by the next replay; one
    replaced by a new tensor (as a load that swaps a Parameter) makes the
    next call capture again, on the new weights; so do new batch norm
    stats (a loaded checkpoint's) under pix2pix."""
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.train import evaluate
    from sggan_tpu_torch.utils.cuda_graph import ForwardGraphs

    cfg = Config(use_resnet=True, image_height=32, image_width=32, ngf=8,
                 compute_dtype="float32")
    gen = evaluate.build_generator(cfg).to(dev)
    graphs = ForwardGraphs()
    x = torch.rand(1, 32, 32, 3, device=dev)
    old = evaluate.generate(cfg, gen, x, dev, graphs=graphs)
    with torch.no_grad():
        gen.c1["w"].mul_(0.5)
    inplace = evaluate.generate(cfg, gen, x, dev, graphs=graphs)
    np.testing.assert_array_equal(inplace, evaluate.generate(cfg, gen, x,
                                                             dev))
    assert not np.array_equal(inplace, old)
    before = cuda_in.launches
    gen.c1["w"] = torch.nn.Parameter(gen.c1["w"].detach() * 2.0)
    swapped = evaluate.generate(cfg, gen, x, dev, graphs=graphs)
    assert cuda_in.launches == before + 2 * 23  # captured again
    np.testing.assert_array_equal(swapped, evaluate.generate(cfg, gen, x,
                                                             dev))
    assert not np.array_equal(swapped, inplace) and len(graphs) == 1

    p2p = Config(use_pix2pix=True, image_height=32, image_width=32, ngf=4,
                 compute_dtype="float32")
    gen = evaluate.build_generator(p2p).to(dev)
    bn = gen.init_bn_state(dev)
    y0 = evaluate.generate(p2p, gen, x, dev, gen_bn=bn, graphs=graphs)
    moved = {k: {"moving_mean": v["moving_mean"] + 0.5,
                 "moving_var": v["moving_var"] * 2.0} for k, v in bn.items()}
    y1 = evaluate.generate(p2p, gen, x, dev, gen_bn=moved, graphs=graphs)
    np.testing.assert_array_equal(y1, evaluate.generate(p2p, gen, x, dev,
                                                        gen_bn=moved))
    assert not np.array_equal(y0, y1)


# ----------------------------------------------------------------------
# K1's split passes, the spatial path's (parallel/spatial.py)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 1, 64, 512),
                                   (3, 5, 7, 13), (8, 32, 128, 256),
                                   (2, 16, 33, 34)])
def test_split_passes_match_the_twin(dev, shape, act, dtype):
    """One rank's plane (no all-reduce): ``sp_stats`` then ``sp_apply``
    (y, mean, rstd), ``sp_bwd_stats`` (dgamma, dbeta) then ``sp_bwd_apply``
    (dx), against ``instance_norm_sp_ref`` and ``_bwd_ref``; rows of one
    element (``(2, 1, 64, 512)``), odd C (the scalar route)."""
    x, g, b = _inputs(shape, dev, dtype)
    count = shape[1] * shape[2]
    sums = cuda_in.sp_stats(x)
    ref_sums = torch.stack([x.float().sum((1, 2)),
                            (x.float() ** 2).sum((1, 2))], 1)
    torch.testing.assert_close(sums, ref_sums, rtol=1e-5, atol=1e-4)
    y, mean, rstd = cuda_in.sp_apply(x, sums, g, b, count, 1e-3, act, 0.3)
    ry, rm, rr = tnorm.instance_norm_sp_ref(x, g, b, count, None, 1e-3, act,
                                            0.3)
    tol = TOL[dtype]
    assert ((y.float() - ry.float()).abs()
            <= tol + tol * ry.float().abs()).all()
    torch.testing.assert_close(mean, rm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rr, rtol=1e-4, atol=1e-5)
    dy = torch.randn(shape, device=dev).to(dtype)
    s, dg, db = cuda_in.sp_bwd_stats(x, dy, g, b, mean, rstd, act, 0.3)
    dx = cuda_in.sp_bwd_apply(x, dy, g, b, mean, rstd, s, count, act, 0.3)
    rdx, rdg, rdb = tnorm.instance_norm_sp_bwd_ref(x, dy, g, b, mean, rstd,
                                                   count, None, act, 0.3)
    if dtype == torch.float32:
        assert ((dx - rdx).abs() <= 1e-5 + 1e-4 * rdx.abs()).all()
    else:
        assert (dx.float() - rdx.float()).abs().max() \
            <= 2e-2 * rdx.float().abs().max()
    for got, want in ((dg, rdg), (db, rdb)):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_split_relu_gate_halves_dy_at_an_exact_zero(dev):
    """A symmetric plane whose pre-activation is exactly 0 at one element:
    the split backward passes half of dy there, as its twin and JAX's
    ``maximum`` do; the one-card kernel passes none."""
    x = torch.tensor([-2.0, -1.0, 0.0, 1.0, 2.0, -0.5, 0.5, 3.0, -3.0],
                     device=dev).reshape(1, 3, 3, 1)
    g, b = torch.ones(1, device=dev), torch.zeros(1, device=dev)
    dy = torch.arange(1.0, 10.0, device=dev).reshape(1, 3, 3, 1)
    y, mean, rstd = cuda_in.sp_apply(x, cuda_in.sp_stats(x), g, b, 9, 1e-3,
                                     "relu", 0.3)
    assert y[0, 0, 2, 0].item() == 0.0
    s, _, _ = cuda_in.sp_bwd_stats(x, dy, g, b, mean, rstd, "relu", 0.3)
    dx = cuda_in.sp_bwd_apply(x, dy, g, b, mean, rstd, s, 9, "relu", 0.3)
    rdx = tnorm.instance_norm_sp_bwd_ref(x, dy, g, b, mean, rstd, 9, None,
                                         "relu", 0.3)[0]
    torch.testing.assert_close(dx, rdx, rtol=1e-4, atol=1e-5)
    one = cuda_in.instance_norm_bwd_cuda(x, dy, g, b, mean, rstd, "relu")[0]
    assert (one - rdx).abs().max() > 1e-2


def test_split_autograd_never_takes_the_cluster_route(dev):
    """``ops.norm.instance_norm_sp`` on a CUDA tensor whose one-card plan
    is the cluster route runs the split entries, one of each pass a call
    each way, and no one-card launch."""
    x, g, b = _inputs((2, 8, 8, 64), dev, torch.float32)
    assert cuda_in.plan(2, 8, 8, 64, torch.float32, "fwd").route == "cluster"
    assert cuda_in.sp_plan(x, "fwd").route == "stream"
    x.requires_grad_(True)
    before = dict(cuda_in.sp_launches), cuda_in.launches, \
        cuda_in.bwd_launches
    y = tnorm.instance_norm_sp({"gamma": g, "beta": b}, x, 64, None,
                               act="leaky_relu")
    y.backward(torch.ones_like(y))
    assert {k: v - before[0][k] for k, v in cuda_in.sp_launches.items()} \
        == dict.fromkeys(("stats", "apply", "bwd_stats", "bwd_apply"), 1)
    assert (cuda_in.launches, cuda_in.bwd_launches) == before[1:]


def test_split_wrappers_refuse_what_they_do_not_take(dev):
    x, g, b = _inputs((2, 8, 8, 64), dev, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_in.sp_stats(x.cpu())
    with pytest.raises(ValueError, match="sums must be"):
        cuda_in.sp_apply(x, torch.zeros(2, 64, device=dev), g, b, 64)
