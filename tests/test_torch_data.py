"""Port parity of the data pipeline: ``sggan_tpu_torch.data`` (preprocess,
augment, loader) against ``sggan_tpu.data`` on the CPU, with the draws the
JAX functions take from their keys, and the port's copies of framework-free
modules (``utils/images``, ``utils/summary``, the host half of
``metrics/scores`` and of ``data/loader``) against their originals.

Tolerances: the antialiased resize, f32, max abs <= 1e-6 (the two sides
sum the same weights in other orders); the nearest-resized one-hot mask
exactly; ``affine_warp`` and ``photometric_augment`` <= 1e-5 abs on [0, 1]
images; ``preprocess_train`` images <= 1e-5 abs, masks and flips exactly;
``seg_labels_u8`` and ``fake_u8`` bit-exact against the host conversions.
The JAX programs compile without XLA's LLVM passes and CPU fusion
emitters, as tests/test_torch_step.py does (results equal to rounding)."""

import importlib
import inspect
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from sggan_tpu.data import augment as jaug  # noqa: E402
from sggan_tpu.data import loader as jloader  # noqa: E402
from sggan_tpu.data import preprocess as jpre  # noqa: E402
from sggan_tpu.utils import images as jimages  # noqa: E402
from sggan_tpu.utils import summary as jsummary  # noqa: E402
from sggan_tpu_torch.data import augment as taug  # noqa: E402
from sggan_tpu_torch.data import loader as tloader  # noqa: E402
from sggan_tpu_torch.data import preprocess as tpre  # noqa: E402
from sggan_tpu_torch.metrics import scores as tscores  # noqa: E402
from sggan_tpu_torch.utils import images as timages  # noqa: E402
from sggan_tpu_torch.utils import summary as tsummary  # noqa: E402

# the package's __init__ binds the name ``scores`` to the function
jscores = importlib.import_module("sggan_tpu.metrics.scores")

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}
B, SH, SW, OUT, MASK, N_CLASS = 4, 48, 64, (32, 32), (4, 4), 8
IMG_ATOL = 1e-5


def _jit(fn, *args):
    """``fn(*args)`` compiled without the expensive passes, as numpy."""
    out = jax.jit(fn).lower(*args).compile(FAST)(*args)
    return jax.tree.map(np.asarray, out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _photometric_draws(k_pho, hw):
    """The draws ``photometric_augment(k_pho, img)`` takes, in its split
    order (augment.py:159-195)."""
    ks = jax.random.split(k_pho, 8)
    return dict(
        blur_on=jax.random.bernoulli(ks[0], 0.5),
        sigma=jax.random.uniform(ks[1], (), minval=0.0, maxval=0.5),
        alpha=jax.random.uniform(ks[2], (), minval=0.75, maxval=1.5),
        noise_scale=jax.random.uniform(ks[3], (), minval=0.0, maxval=0.05),
        noise_per_channel=jax.random.bernoulli(ks[4], 0.5),
        noise=jax.random.normal(ks[5], (*hw, 3)),
        mult_per_channel=jax.random.bernoulli(ks[6], 0.2),
        mult=jax.random.uniform(ks[7], (3,), minval=0.8, maxval=1.2))


def _preprocess_draws(key):
    """The draws ``preprocess_train(..., key, ...)`` takes for B rows, as
    preprocess.py:111-160 splits the key: the square-frame affine of each
    row, its photometric draws, the final flips; with the uniforms of
    ``random_affine_params`` (augment.py:39-55) beside the matrix."""
    k_aug, k_flip = jax.random.split(key)

    def one(k):
        k_geo, k_pho = jax.random.split(k)
        p = jaug.random_affine_params(k_geo, SH, SH)
        _, kc, kt, kr = jax.random.split(k_geo, 4)
        raw = (jax.random.uniform(kc, (4,), minval=0.2, maxval=0.4),
               jax.random.uniform(kt, (2,), minval=-0.1, maxval=0.1),
               jax.random.uniform(kr, (), minval=-1.0, maxval=1.0)
               * math.pi / 180.0)
        return p.matrix, p.flip, raw, _photometric_draws(k_pho, OUT)

    m, f, raw, pho = jax.vmap(one)(jax.random.split(k_aug, B))
    return m, f, raw, pho, jax.random.bernoulli(k_flip, 0.5, (B,))


@pytest.fixture(scope="module")
def case():
    """uint8 sources, a key, its draws as the port's PreprocessDraws, and
    the raw uniforms of the affine draws."""
    r = np.random.default_rng(11)
    img = r.integers(0, 255, (B, SH, SW, 3), np.uint8)
    seg = r.integers(0, 255, (B, SH, SW, 3), np.uint8)
    cls = r.integers(0, N_CLASS + 2, (B, SH, SW), np.uint8)
    key = jax.random.PRNGKey(3)
    m, f, raw, pho, flip = _jit(_preprocess_draws, key)
    draws = tpre.PreprocessDraws(
        taug.AffineParams(_t(m), _t(f)),
        taug.PhotometricDraws(**{k: _t(v) for k, v in pho.items()}),
        _t(flip))
    return img, seg, cls, key, draws, raw


# ------------------------------------------------------------ resamplers

@pytest.mark.parametrize("src,hw", [((2, 64, 96, 3), (32, 48)),
                                    ((2, 40, 57, 3), (32, 48)),
                                    ((1, 32, 48, 3), (32, 48))],
                         ids=["2x_down", "non_integer", "identity"])
def test_resize_matches_jax(src, hw):
    x = np.random.default_rng(0).uniform(size=src).astype(np.float32)
    ref = _jit(lambda a: jpre._resize(a, hw), x)
    xt = torch.from_numpy(x)
    got = tpre._resize(xt, hw)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-6
    if src[1:3] == hw:
        assert got is xt  # the same-shape skip


@pytest.mark.parametrize("src,mhw", [((2, 37, 53), (4, 6)),
                                     ((1, 33, 31), (9, 7)),
                                     ((2, 64, 96), (8, 12))])
def test_one_hot_mask_matches_jax(src, mhw):
    c = np.random.default_rng(1).integers(0, N_CLASS + 2, src, np.uint8)
    ref = _jit(lambda a: jpre._one_hot_mask(a, mhw, N_CLASS), c)
    got = tpre._one_hot_mask(torch.from_numpy(c), mhw, N_CLASS)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------- augmentation

def test_affine_draws_warp_and_conjugation_match_jax(case):
    """The matrix from ``random_affine_params``'s uniforms, its
    conjugation into the output frame, and the warp of reference-drawn
    parameters, flipped and not."""
    img, _, _, _, draws, (crop, trans, theta) = case
    m = draws.affine.matrix
    got_m = taug.affine_matrix(_t(crop), _t(trans), _t(theta), SH, SH)
    np.testing.assert_allclose(got_m.numpy(), m.numpy(), rtol=1e-6,
                               atol=1e-6 * SH)
    flip = np.array([True, False, True, False])
    x = (img / 255.0).astype(np.float32)

    def ref_fn(xs, ms, fs):
        p = jax.vmap(lambda mm, ff: jaug.conjugate_affine(
            jaug.AffineParams(mm, ff), (SH, SH), (SH, SW)))(ms, fs)
        return p.matrix, jax.vmap(jaug.affine_warp)(xs, p)

    ref_c, ref_w = _jit(ref_fn, x, m.numpy(), flip)
    p = taug.conjugate_affine(taug.AffineParams(m, _t(flip)), (SH, SH),
                              (SH, SW))
    np.testing.assert_allclose(p.matrix.numpy(), ref_c, rtol=2e-7, atol=0)
    got = taug.affine_warp(torch.from_numpy(x), p)
    assert np.abs(got.numpy() - ref_w).max() <= IMG_ATOL


def test_photometric_augment_matches_jax(case):
    """The port fed the draws ``photometric_augment`` takes from its
    key."""
    r = np.random.default_rng(2)
    x = r.uniform(size=(B, *OUT, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)

    def ref_fn(xs, ks):
        return (jax.vmap(jaug.photometric_augment)(ks, xs),
                jax.vmap(lambda k: _photometric_draws(k, OUT))(ks))

    ref, draws = _jit(ref_fn, x, keys)
    got = taug.photometric_augment(
        taug.PhotometricDraws(**{k: _t(v) for k, v in draws.items()}),
        torch.from_numpy(x))
    assert draws["blur_on"].any() and not draws["blur_on"].all()
    assert np.abs(got.numpy() - ref).max() <= IMG_ATOL


# ------------------------------------------------------------ preprocess

@pytest.mark.parametrize("layout,photometric", [
    ("none", False), ("half", False), ("half", True), ("dynamic", False),
    ("dynamic", True)])
def test_preprocess_train_matches_jax(case, layout, photometric):
    img, seg, cls, key, draws, _ = case
    flags = {"none": np.zeros(B, bool), "half": np.arange(B) >= B // 2,
             "dynamic": np.array([True, False, True, True])}[layout]
    kw = dict(out_hw=OUT, mask_hw=MASK, n_class=N_CLASS,
              photometric=photometric, aug_layout=layout)
    ref = jax.tree.map(np.asarray, jpre.preprocess_train.lower(
        img, seg, cls, key, flags, **kw).compile(FAST)(
        img, seg, cls, key, flags))
    if not photometric:
        draws = draws._replace(photometric=None)
    got = tpre.preprocess_train(*map(torch.from_numpy, (img, seg, cls)),
                                draws, torch.from_numpy(flags), **kw)
    assert got.keys() == ref.keys()
    np.testing.assert_array_equal(got["mask_a"].numpy(), ref["mask_a"])
    for k in ("real_a", "seg_a"):
        assert got[k].dtype == torch.float32
        assert np.abs(got[k].numpy() - ref[k]).max() <= IMG_ATOL, k


def test_preprocess_train_refuses_what_it_cannot_do(case):
    """An odd batch under "half"; draws that are not the global batch's.
    The global-row call (a process's rows of a global batch, with the
    whole batch's draws) is the one-process preprocess of the global
    batch taken at those rows."""
    img, seg, cls, _, draws, _ = case
    args = (*map(torch.from_numpy, (img[:3], seg[:3], cls[:3])),
            draws, torch.ones(3, dtype=torch.bool))
    kw = dict(out_hw=OUT, mask_hw=MASK, n_class=N_CLASS)
    with pytest.raises(ValueError, match="even batch"):
        tpre.preprocess_train(*args, aug_layout="half", **kw)
    with pytest.raises(ValueError, match="draws of 4 rows for a global "
                                         "batch of 8"):
        tpre.preprocess_train(*args, global_b=8, **kw)
    flags = np.array([True, False, True, True])
    whole = tpre.preprocess_train(
        *map(torch.from_numpy, (img, seg, cls)), draws,
        torch.from_numpy(flags), photometric=True, **kw)
    rows = np.array([3, 0, 2], np.int32)
    got = tpre.preprocess_train(
        *map(torch.from_numpy, (img[rows], seg[rows], cls[rows])), draws,
        torch.from_numpy(flags[rows]), photometric=True, global_b=B,
        sample_rows=rows, **kw)
    for k, v in whole.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy()[rows],
                                      err_msg=k)


def test_preprocess_test_matches_jax(case):
    img, seg, cls, _, _, _ = case
    kw = dict(out_hw=OUT, mask_hw=MASK, n_class=N_CLASS)
    ref = _jit(lambda a, b, c: jpre.preprocess_test(a, b, c, **kw),
               img, seg, cls)
    tin = list(map(torch.from_numpy, (img, seg, cls)))
    got = tpre.preprocess_test(*tin, **kw)
    for g, r in zip(got[:2], ref[:2]):
        assert np.abs(g.numpy() - r).max() <= 1e-6
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(g.numpy(), r)
    lean = tpre.preprocess_test(*tin, with_masks=False, **kw)
    assert lean[2] is None and lean[3] is None
    assert torch.equal(lean[0], got[0])


def test_seg_labels_u8_bit_exact():
    """The host cast ``(255 * seg).astype(np.uint8)``, with its wrap mod
    256 of values outside [0, 1]."""
    r = np.random.default_rng(0).uniform(-0.1, 1.1, 100_000)
    r = r.astype(np.float32)
    with np.errstate(invalid="ignore"):
        host = (255 * r).astype(np.uint8)
    got = tpre.seg_labels_u8(torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(got, host)
    assert (r < 0).any() and (r > 1).any()


def test_fake_u8_bit_exact():
    """Against the f64 host ``inverse_transform`` on every lattice point
    x = 2k/255 - 1 with its 4 f32 neighbours each side, edges, and a
    random sample."""
    xb = (2.0 * np.arange(256) / 255.0 - 1.0).astype(np.float32)
    pts, dn, up = [xb], xb, xb
    for _ in range(4):
        dn = np.nextafter(dn, np.float32(-2))
        up = np.nextafter(up, np.float32(2))
        pts += [dn, up]
    edges = np.array([-1.0, 1.0, 0.0, -0.0, 0.5, -0.5], np.float32)
    rnd = (np.random.default_rng(7).random(200_000, np.float32) * 2 - 1)
    x = np.clip(np.concatenate(pts + [edges, rnd.astype(np.float32)]), -1, 1)
    got = tpre.fake_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, jimages.inverse_transform(x))


# ------------------------------------------------------- copies and data

@pytest.fixture(scope="module")
def fixture_ds(tmp_path_factory):
    """datasets/<name>/{trainA,testA}{,_seg,_seg_class}: 6 train and 3
    test triplets of 40x56 PNGs, RGBA segs and a grayscale photo."""
    root = tmp_path_factory.mktemp("datasets") / "synth"
    rng = np.random.default_rng(0)
    for split, n in (("trainA", 6), ("testA", 3)):
        for sub in ("", "_seg", "_seg_class"):
            os.makedirs(root / f"{split}{sub}")
        for i in range(n):
            name = f"img_{i:03d}.png"
            shape = (40, 56) if i == 1 else (40, 56, 3)
            Image.fromarray(rng.integers(0, 255, shape, np.uint8)).save(
                root / split / name)
            Image.fromarray(rng.integers(0, 255, (40, 56, 4), np.uint8)) \
                .save(root / f"{split}_seg" / name)
            Image.fromarray(rng.integers(0, N_CLASS, (40, 56), np.uint8)) \
                .save(root / f"{split}_seg_class" / name)
    return str(root)


@pytest.mark.parametrize("mod", [("images", timages, jimages),
                                 ("summary", tsummary, jsummary)],
                         ids=lambda m: m[0])
def test_copies_keep_the_originals_code(mod):
    """Every function and class of the copy has its original's source."""
    _, port, ref = mod
    names = [n for n, v in vars(ref).items()
             if (inspect.isfunction(v) or inspect.isclass(v))
             and v.__module__ == ref.__name__]
    assert names
    for n in names:
        assert inspect.getsource(getattr(port, n)) \
            == inspect.getsource(getattr(ref, n)), n


def test_images_copy_matches(tmp_path):
    r = np.random.default_rng(3)
    fake = (r.random((4, 8, 10, 3), np.float32) * 2 - 1)
    np.testing.assert_array_equal(timages.inverse_transform(fake),
                                  jimages.inverse_transform(fake))
    u8 = jimages.inverse_transform(fake)
    np.testing.assert_array_equal(timages.merge(u8, [2, 2]),
                                  jimages.merge(u8, [2, 2]))
    np.testing.assert_array_equal(timages.get_img(fake, [2, 2]),
                                  jimages.get_img(fake, [2, 2]))
    cls = r.integers(0, 9, (6, 7))
    np.testing.assert_array_equal(timages.one_hot(cls, 8),
                                  jimages.one_hot(cls, 8))
    timages.save_images(fake, [4, 1], str(tmp_path / "a.png"))
    jimages.save_images(fake, [4, 1], str(tmp_path / "b.png"))
    np.testing.assert_array_equal(timages.imread(str(tmp_path / "a.png")),
                                  jimages.imread(str(tmp_path / "b.png")))


def test_loader_copy_matches(fixture_ds):
    """Same files in the same order, same decoded (and host-downscaled)
    arrays, same epoch batches, flags and rows."""
    for split in ("trainA", "testA"):
        assert tloader.Dataset(fixture_ds, split).files() \
            == jloader.Dataset(fixture_ds, split).files()
    files = jloader.Dataset(fixture_ds, "trainA").files()
    for max_hw in (None, (20, 28)):
        for a, b in zip(tloader.load_batch(files, "trainA", max_hw=max_hw),
                        jloader.load_batch(files, "trainA", max_hw=max_hw)):
            np.testing.assert_array_equal(a, b)
    kw = dict(batch_size=2, seed=19, epoch=1, train_size=5, cache_mb=1)
    got = list(tloader.train_iterator(fixture_ds, **kw))
    ref = list(jloader.train_iterator(fixture_ds, **kw))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(g[k], r[k])
    assert tloader.test_files(fixture_ds) == jloader.test_files(fixture_ds)
    for a, b in zip(tloader.load_test_triplet(files[0], max_hw=(20, 28)),
                    jloader.load_test_triplet(files[0], max_hw=(20, 28))):
        np.testing.assert_array_equal(a, b)
    dirs = (os.path.join(fixture_ds, "trainA"),
            os.path.join(fixture_ds, "trainA_seg"))
    assert tloader.list_split(*dirs) == jloader.list_split(*dirs)


def test_device_dataset_matches_host_iterator(fixture_ds):
    """The resident split's epoch (on the CPU here) gathers the batches
    the host iterator decodes: same shuffle, same [plain, aug] layout."""
    ds = tloader.DeviceDataset(fixture_ds, "trainA", max_hw=(20, 28),
                               device="cpu")
    got = list(tloader.device_dataset_iterator(ds, 2, 19, epoch=2))
    ref = list(jloader.train_iterator(fixture_ds, 2, 19, epoch=2,
                                      max_src_hw=(20, 28)))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        for k in ("img", "seg", "cls", "aug"):
            np.testing.assert_array_equal(g[k].numpy(), r[k])


def test_scores_copy_matches():
    r = np.random.default_rng(4)
    lt = r.integers(-1, N_CLASS + 1, (3, 9, 11))
    lp = r.integers(0, N_CLASS, (3, 9, 11))
    np.testing.assert_array_equal(tscores.fast_hist(lt, lp, N_CLASS),
                                  jscores.fast_hist(lt, lp, N_CLASS))
    got = tscores.scores(list(lt), list(lp), N_CLASS)
    ref = jscores.scores(list(lt), list(lp), N_CLASS)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(
            np.asarray(list(got[k].values()) if k == "Class IoU" else got[k]),
            np.asarray(list(ref[k].values()) if k == "Class IoU" else ref[k]))
    seg = r.uniform(size=(2, 6, 5, 3)).astype(np.float32)
    fake = r.integers(0, 256, (2, 6, 5, 3)).astype(np.uint8)
    for compat in (False, True):
        for a, b in zip(tscores.scores_seg_fake(seg, fake, compat),
                        jscores.scores_seg_fake(seg, fake, compat)):
            np.testing.assert_array_equal(a, b)


def test_summary_copy_round_trip(tmp_path):
    """Each package reads the scalars the other's writer wrote."""
    for writer, reader, d in ((tsummary, jsummary, "port"),
                              (jsummary, tsummary, "jax")):
        w = writer.SummaryWriter(str(tmp_path / d))
        w.scalar("Images/sec", 123.5, 0)
        w.scalar("Mean IoU", 0.25, 2)
        w.image("Segmentation Epoch 0",
                np.zeros((2, 4, 5, 3), np.uint8), 0)
        w.close()
        (ev,) = os.listdir(tmp_path / d)
        got = reader.read_scalars(str(tmp_path / d / ev))
        assert got == {"Images/sec": [(0, 123.5)], "Mean IoU": [(2, 0.25)]}
    assert tsummary.crc32c(b"sggan") == jsummary.crc32c(b"sggan")
