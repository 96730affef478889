"""The K1 kernels' launch plan (``cuda_in.plan``), pure Python: at every
instance-norm site of one b=16 train step, of the served forward at b=1,
of the cycle step (the ResNet's at b = 2-16 and the discriminators' at
b and 2b; the U-Net's discriminator at 128x128), and of the U-Net
generator (the CLI default: every site at full
resolution, C 64-512, batch 1 doubled to 2, at 128x128 and 256x512), in
bf16 and f32, the plan covers every row and channel exactly once, fits
the H100's shared memory and cluster limits, fills a wave of CTAs where
the stream route would, and takes the route the kernel source documents
for the site.  Odd C and misaligned tensors take the scalar route."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sggan_tpu_torch import perf_in  # noqa: E402
from sggan_tpu_torch.ops import cuda_in  # noqa: E402

# the generator's 23 sites per forward and the discriminator's 7 at
# 256x512 (batch 16 in the generator loss, 32 in the D call)
G_SITES = [(256, 512, 64), (128, 256, 128), (64, 128, 256)]
D_SITES = [(64, 128, 128), (32, 64, 256), (32, 64, 512), (15, 31, 512),
           (7, 15, 512), (3, 7, 512), (1, 5, 512)]
STEP = ([(16, *hwc) for hwc in G_SITES] + [(16, *hwc) for hwc in D_SITES]
        + [(32, *hwc) for hwc in D_SITES])
SERVE = [(1, *hwc) for hwc in G_SITES]
# the U-Net's 15 sites (e1-e8, d1-d7) have these four widths at full
# resolution; chip_smoke.py's K1 phase runs them at b=2
UNET_C = (64, 128, 256, 512)
UNET = [(2, h, w, c) for h, w in ((128, 128), (256, 512)) for c in UNET_C]
# the cycle step (--loss_mode cycle): the ResNet generator's sites at
# chip_smoke.py's cell b=8 and its sweep b (2 is also the eval's), the
# discriminator's at b and 2b; the U-Net cycle step at 128x128 b=2 adds
# the discriminator's sites at 128x128 (b=2 in the generator loss, 4 in
# the call over [real; pooled fake]) to the U-Net's generator sites above
CYCLE_B = (2, 4, 8, 12, 16)
D128_SITES = [(32, 32, 128), (16, 16, 256), (16, 16, 512), (7, 7, 512),
              (3, 3, 512), (1, 1, 512)]
CYCLE = sorted({(n, *hwc) for b in CYCLE_B
                for n, sites in ((b, G_SITES + D_SITES), (2 * b, D_SITES))
                for hwc in sites} - set(STEP + SERVE)) \
    + [(n, *hwc) for n in (2, 4) for hwc in D128_SITES]
DTYPES = [torch.bfloat16, torch.float32]
DIRS = ["fwd", "bwd"]
SMEM_OPTIN = 232448  # bytes a block may use on the H100
STATIC_SMEM = 4096   # the cluster kernels' static shared memory, at most


def _coverage(p, n, h, w, c, dtype):
    """How often the kernel's indexing visits each row and channel of one
    sample under plan ``p``."""
    s = h * w
    vec = 1 if p.route == "scalar" else 16 // (torch.finfo(dtype).bits // 8)
    rows = np.zeros(s, int)
    for q in range(p.cluster if p.route == "cluster" else p.splits):
        rows[q * p.rows:min((q + 1) * p.rows, s)] += 1
    chans = np.zeros(c, int)
    for t in range(-(-c // p.tile)):
        for v in range(p.tile // vec):
            ch0 = t * p.tile + v * vec
            if ch0 < c:
                chans[ch0:ch0 + vec] += 1
    return rows, chans


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("site", STEP + SERVE + UNET + CYCLE)
def test_plan_covers_fits_and_fills(site, dtype, direction):
    n, h, w, c = site
    p = cuda_in.plan(n, h, w, c, dtype, direction)
    rows, chans = _coverage(p, n, h, w, c, dtype)
    assert (rows == 1).all() and (chans == 1).all()
    per_slab = p.cluster if p.route == "cluster" else p.splits
    assert p.ctas == n * -(-c // p.tile) * per_slab
    assert p.smem + STATIC_SMEM <= SMEM_OPTIN
    assert 1 <= p.cluster <= 16
    if p.route == "cluster":
        tensors = 1 if direction == "fwd" else 2
        assert p.smem == p.rows * p.tile * x_bytes(dtype) * tensors
        assert p.splits == 1
    else:
        assert p.cluster == 1 and p.smem == 0
    # one wave of CTAs wherever the stream route puts one on the card
    stream = cuda_in.plan(n, h, w, c, dtype, direction, route="stream")
    assert p.ctas >= 132 or stream.ctas < 132


def x_bytes(dtype):
    return torch.finfo(dtype).bits // 8


def _expected_route(n, h, w, c, dtype, direction):
    """The route table of csrc/instance_norm.cu's sites: the widest plane
    streams; (128, 256, 128) takes a 16-CTA cluster forward in bf16 only,
    and streams at b <= 2, where no cluster of its slabs fills a wave
    (2 x 4 tiles x 16 = 128 CTAs) while the stream route does; every
    other site, the discriminator's 1x1 plane at 128x128 included, is
    held by a cluster."""
    if (h, w) == (256, 512) or (n <= 2 and (h, w) == (128, 256)):
        return "stream"
    if (h, w) == (128, 256):
        return "cluster" if (dtype, direction) == (torch.bfloat16, "fwd") \
            else "stream"
    return "cluster"


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("site", STEP + SERVE + CYCLE)
def test_plan_route_at_each_site(site, dtype, direction):
    p = cuda_in.plan(*site, dtype, direction)
    assert p.route == _expected_route(*site, dtype, direction)
    if p.route == "cluster" and p.cluster > 8:
        # a non-portable cluster only where 8 CTAs cannot hold the slab at
        # two CTAs per SM (or the launch would fall short of a wave)
        rows8 = -(-site[1] * site[2] // 8)
        tensors = 1 if direction == "fwd" else 2
        assert (rows8 * p.tile * x_bytes(dtype) * tensors
                > cuda_in._SMEM_PAIR or p.ctas // 2 < 132)


def _unet_route(h, c, dtype, direction):
    """The U-Net's route table at b=2: at 128x128 a 16-CTA cluster at C =
    64, 256 and 512, the stream route at C = 128 (a cluster of its 4
    slabs would give 128 CTAs, short of a wave, where the stream route
    gives 256); in f32 the backward streams at every C (two tensors of the
    plane); at 256x512 no cluster holds a plane, so every site streams."""
    if h == 256 or c == 128 or (dtype, direction) == (torch.float32, "bwd"):
        return "stream", 1
    return "cluster", 16


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("site", UNET)
def test_plan_route_at_unet_sites(site, dtype, direction):
    p = cuda_in.plan(*site, dtype, direction)
    assert (p.route, p.cluster) == _unet_route(site[1], site[3], dtype,
                                               direction)
    assert p.route != "scalar"


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 5), (torch.bfloat16, 34),
                                     (torch.bfloat16, 1), (torch.bfloat16, 12),
                                     (torch.float32, 5), (torch.float32, 34),
                                     (torch.float32, 1)])
def test_odd_channels_take_the_scalar_route(dtype, c):
    for direction in DIRS:
        p = cuda_in.plan(3, 64, 40, c, dtype, direction)
        assert p.route == "scalar"
        rows, chans = _coverage(p, 3, 64, 40, c, dtype)
        assert (rows == 1).all() and (chans == 1).all()
        with pytest.raises(ValueError, match="route"):
            cuda_in.plan(3, 64, 40, c, dtype, direction, route="stream")


@pytest.mark.parametrize("dtype", DTYPES)
def test_misaligned_tensor_takes_the_scalar_route(dtype):
    for direction in DIRS:
        assert cuda_in.plan(16, 64, 128, 256, dtype, direction,
                            aligned=False).route == "scalar"
    x = torch.zeros(2 * 8 * 8 * 64 + 1, dtype=dtype)[1:]
    assert not cuda_in._aligned(x)
    assert cuda_in._aligned(torch.zeros(8, dtype=dtype))


def test_plan_refuses_what_no_route_takes():
    with pytest.raises(ValueError, match="direction"):
        cuda_in.plan(1, 4, 4, 64, torch.float32, "both")
    with pytest.raises(ValueError, match="no cluster"):
        cuda_in.plan(16, 256, 512, 64, torch.bfloat16, "fwd",
                     route="cluster")


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("site", perf_in.SITES)
def test_perf_in_sweeps_plans_that_fit(site, direction):
    """The measuring entry point's alternatives at each of its sites: each
    covers the plane once and fits the card, and there is a cluster size
    and a stream block count to hold the plan's choice against."""
    plans = perf_in.alternatives(*site, torch.bfloat16, direction)
    routes = {p.route for p in plans}
    assert "stream" in routes
    assert cuda_in.plan(*site, torch.bfloat16, direction).route in routes
    for p in plans:
        rows, chans = _coverage(p, *site, torch.bfloat16)
        assert (rows == 1).all() and (chans == 1).all()
        assert p.smem + STATIC_SMEM <= SMEM_OPTIN and 1 <= p.cluster <= 16


def test_perf_in_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA device"):
        perf_in.main([], device="cpu")
