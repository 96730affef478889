"""K2's conv launch plan (``cuda_conv_in.conv_plan``), pure Python: at every
K2 shape of ``chip_smoke.py`` and at the generator's resblock shape for
batches 1, 16 and 24, in bf16 and f32, the plan takes the route the
kernel source documents, fits the H100's shared memory, names a Cout tile
of 64, 128 or 256 and the tile the source builds, and its tile count (the
size of the partial sums the wrapper allocates, and what the kernel's
entry checks) covers every output pixel and channel exactly once.  Shapes
outside the kernel raise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from sggan_tpu_torch.ops import cuda_conv_in as cci  # noqa: E402

SHAPES = (chip_smoke.K2_SMALL + chip_smoke.K2_FULL
          + [(b, 64, 128, 256, 256) for b in (1, 16, 24)])
DTYPES = [torch.bfloat16, torch.float32]


def _coverage(p, n, h, w, cout):
    """How often the kernel's block indexing (csrc/conv3_in.cu: ct =
    blockIdx.x % n_ct, sp = blockIdx.x / n_ct, tile origin (sp / tiles_w
    * tile_h, sp % tiles_w * tile_w)) visits each output pixel and channel
    of one sample."""
    tiles_w = -(-w // p.tile_w)
    n_ct = -(-cout // p.bn)
    assert p.grid == (p.tiles * n_ct, n)
    pix = np.zeros((h, w), int)
    chans = np.zeros(cout, int)
    for b in range(p.grid[0]):
        ct, sp = b % n_ct, b // n_ct
        h0, w0 = sp // tiles_w * p.tile_h, sp % tiles_w * p.tile_w
        if ct == 0:
            pix[h0:h0 + p.tile_h, w0:w0 + p.tile_w] += 1
        if sp == 0:
            chans[ct * p.bn:(ct + 1) * p.bn] += 1
    return pix, chans


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_routes_fits_and_covers(shape, dtype):
    n, h, w, cin, cout = shape
    p = cci.conv_plan(n, h, w, cin, cout, dtype)
    tensor_core = dtype == torch.bfloat16 and cin % 16 == 0 and cout % 16 == 0
    assert p.route == ("wgmma" if tensor_core else "scalar")
    assert p.kernel in cci.route_launches
    assert p.smem + cci.STATIC_SMEM <= cci.SMEM_OPTIN
    assert p.bn in (64, 128, 256)
    if p.route == "wgmma":
        # csrc/conv3_in.cu's kWgBN, 2 kWgR and kWgStages
        assert (p.bn, p.tile_h, p.tile_w, p.stages) == (64, 8, 64, 4)
        assert p.smem == cci.wgmma_smem(p.bn, p.tile_h, p.stages)
    else:
        assert (p.tile_h, p.tile_w, p.bn, p.smem) == (8, 16, 64, 0)
    # the count the kernel's entry requires of the partial sums' tiles
    assert p.tiles == -(-h // p.tile_h) * -(-w // p.tile_w)
    pix, chans = _coverage(p, n, h, w, cout)
    assert (pix == 1).all() and (chans == 1).all()


@pytest.mark.parametrize("args, match", [
    ((1, 1, 8, 16, 16, torch.bfloat16), "range"),
    ((1, 8, 1, 16, 16, torch.bfloat16), "range"),
    ((0, 8, 8, 16, 16, torch.bfloat16), "range"),
    ((70000, 8, 8, 16, 16, torch.bfloat16), "range"),
    ((1, 8, 8, 0, 16, torch.bfloat16), "range"),
    ((1, 8, 8, 16, 0, torch.bfloat16), "range"),
    ((1, 4096, 4096, 256, 16, torch.bfloat16), "range"),
    ((1, 4096, 4096, 16, 256, torch.float32), "range"),
    ((1, 8, 8, 16, 16, torch.float16), "dtype"),
    ((1, 8, 8, 16, 16, torch.float64), "dtype"),
])
def test_plan_refuses_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        cci.conv_plan(*args)
