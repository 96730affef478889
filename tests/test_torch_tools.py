"""The port's copies of the JAX package's framework-free tools, each held
to its original on the CPU:

* ``utils/flops.py``: every function equal to ``sggan_tpu.utils.flops``
  on a grid of shapes (pure Python: exact);
* ``data/segment_class.py`` and ``data/prepare_data.py``: the LUT, the
  conversion and both CLIs' outputs equal to the JAX ones' on a tmp_path.

The dense CRF is held in tests/test_torch_crf.py, the memory probe and
``cycle_recon_eval`` in tests/test_torch_probe.py."""

import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from sggan_tpu.data import prepare_data as jprep  # noqa: E402
from sggan_tpu.data import segment_class as jseg  # noqa: E402
from sggan_tpu.utils import flops as jflops  # noqa: E402
from sggan_tpu_torch.data import prepare_data as tprep  # noqa: E402
from sggan_tpu_torch.data import segment_class as tseg  # noqa: E402
from sggan_tpu_torch.utils import flops as tflops  # noqa: E402


# ------------------------------------------------------------- flops


@pytest.mark.parametrize("h,w", [(256, 512), (128, 128), (1024, 2048),
                                 (64, 96), (40, 72)])
def test_flops_matches_jax(h, w):
    for ngf, ndf, n_class in ((64, 64, 34), (32, 48, 8)):
        assert tflops.generator_resnet_fwd(h, w, ngf) \
            == jflops.generator_resnet_fwd(h, w, ngf)
        assert tflops.discriminator_dims(h, w) \
            == jflops.discriminator_dims(h, w)
        assert tflops.discriminator_fwd(h, w, ndf, n_class=n_class) \
            == jflops.discriminator_fwd(h, w, ndf, n_class=n_class)
        for b in (1, 16):
            assert tflops.sggan_train_step(h, w, b, ngf, ndf, n_class) \
                == jflops.sggan_train_step(h, w, b, ngf, ndf, n_class)
            for idt in (True, False):
                assert tflops.cycle_train_step(h, w, b, ngf, ndf, n_class,
                                               idt) \
                    == jflops.cycle_train_step(h, w, b, ngf, ndf, n_class,
                                               idt)
    assert tflops.conv_flops(h, w, 3, 5, 7, 2) \
        == jflops.conv_flops(h, w, 3, 5, 7, 2)


# --------------------------------------------------------- data tools


def _seg_dir(root, n=3, hw=(24, 40)):
    """``n`` seg maps of Cityscapes colours and a few unmapped ones."""
    rng = np.random.default_rng(0)
    colours = np.array([c for c, _ in jseg.CITYSCAPE_MAP]
                       + [(1, 2, 3), (0, 0, 0)], np.uint8)
    d = os.path.join(root, "trainA_seg")
    os.makedirs(d)
    for i in range(n):
        img = colours[rng.integers(0, len(colours), hw)]
        Image.fromarray(img).save(os.path.join(d, f"s{i}.png"))
    return d


def test_segment_class_matches_jax(tmp_path, capsys):
    lut = tseg.build_lut()
    np.testing.assert_array_equal(lut, jseg.build_lut())
    out = {}
    for name, mod in (("port", tseg), ("jax", jseg)):
        d = _seg_dir(str(tmp_path / name))
        mod.main([d])
        assert "converted 3 images" in capsys.readouterr().out
        out[name] = [np.asarray(Image.open(os.path.join(
            d.replace("_seg", "_seg_class"), f"s{i}.png"))) for i in range(3)]
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.uint8 and set(np.unique(a)) <= set(range(8))
    img = np.random.default_rng(1).integers(0, 256, (8, 8, 4), np.uint8)
    np.testing.assert_array_equal(tseg.rgb_to_class(img, lut),
                                  jseg.rgb_to_class(img, lut))


def test_prepare_data_matches_jax(tmp_path, capsys):
    src = tmp_path / "src"
    for sub in ("images", "labels"):
        os.makedirs(src / sub)
        for i in range(7):
            (src / sub / f"f{i}.png").write_bytes(f"{sub}{i}".encode())
    (src / "images" / "lonely.png").write_bytes(b"no label")
    listing = {}
    for name, mod in (("port", tprep), ("jax", jprep)):
        out = tmp_path / name
        mod.main(["-Ai", str(src / "images"), "-As", str(src / "labels"),
                  "-tr", "4", "-te", "2", "--out_img",
                  str(out / "trainA"), "--out_seg", str(out / "trainA_seg")])
        assert "candidates: 7" in capsys.readouterr().out
        listing[name] = {d: sorted(os.listdir(out / d)) for d in
                         ("trainA", "trainA_seg", "testA", "testA_seg")}
        assert (out / "testA" / listing[name]["testA"][0]).read_bytes() \
            .startswith(b"images")
    assert listing["port"] == listing["jax"]
    assert len(listing["port"]["trainA"]) == 4
    assert tprep.prepare(str(src / "images"), str(src / "labels"), "a/trainA",
                         "a/trainA_seg", 7, 1) == 0  # not enough pairs
